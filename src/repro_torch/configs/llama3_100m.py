"""Llama-3-style 100M variant (paper Fig 6/11 workload)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
    rope_theta=500000.0, remat="none",
)
SMOKE = CONFIG.scaled(name="llama3-100m-smoke", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
