"""Llama-3.2-3B-style variant (paper Fig 6/11 workload)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=32768,
    rope_theta=500000.0, remat="none",
)
SMOKE = CONFIG.scaled(name="llama3-3b-smoke", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
