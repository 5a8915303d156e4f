"""hubert-xlarge [audio]: encoder-only, 48L d_model=1280 16H d_ff=5120
vocab=504 (cluster targets) [arXiv:2106.07447].

The convolutional waveform frontend is a STUB: input_specs() provides
precomputed frame embeddings [B, S, d_model]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    causal=False, frontend="stub", act="gelu",
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
    causal=False, frontend="stub", act="gelu", remat="none",
)
