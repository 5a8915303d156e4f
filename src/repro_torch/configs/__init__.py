"""Copies of the JAX package's configuration dataclasses and of the configs
of every id of its registry: the Llama family, mamba2-370m, deepseek-67b,
qwen2.5-32b, gemma2-27b, mixtral-8x22b, stablelm-12b, the hybrid
zamba2-2.7b, deepseek-v3-671b, qwen2-vl-7b (M-RoPE) and the encoder-only
hubert-xlarge."""
