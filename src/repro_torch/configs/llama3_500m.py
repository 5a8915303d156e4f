"""Llama-3-style 500M variant (paper Fig 6/11 workload)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-500m", family="dense", num_layers=16, d_model=1536,
    num_heads=16, num_kv_heads=8, d_ff=4096, vocab_size=32768,
    rope_theta=500000.0, remat="none",
)
SMOKE = CONFIG.scaled(name="llama3-500m-smoke", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
