"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
    remat="none",
)
