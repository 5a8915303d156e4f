"""Copies of the JAX package's configuration dataclasses and of the configs
of the ids the port serves: the Llama family, mamba2-370m, deepseek-67b,
qwen2.5-32b, gemma2-27b, mixtral-8x22b, stablelm-12b and the hybrid
zamba2-2.7b."""
