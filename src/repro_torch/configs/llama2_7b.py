"""Llama-2 7B (paper Fig 9 scale-out workload, ATLAHS configuration)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=32000,
    rope_theta=10000.0,
)
SMOKE = CONFIG.scaled(name="llama2-7b-smoke", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
                      remat="none")
