"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, d_ff=13824, vocab_size=100352,
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256, remat="none",
)
