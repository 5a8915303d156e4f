"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense", num_layers=46, d_model=4608,
    num_heads=32, num_kv_heads=16, d_ff=36864, vocab_size=256000,
    head_dim=128, sliding_window=4096, local_global_pattern=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, act="gelu_tanh",
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    sliding_window=16, local_global_pattern=2, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, tie_embeddings=True, act="gelu_tanh",
    remat="none",
)
