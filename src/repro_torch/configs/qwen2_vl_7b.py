"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision tower is a STUB: the backbone consumes token ids plus
3-stream M-RoPE positions (t/h/w); patch embeddings are precomputed."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
    qkv_bias=True, mrope_sections=(4, 2, 2), remat="none",
)
