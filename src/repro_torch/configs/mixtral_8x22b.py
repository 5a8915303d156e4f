"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8), 8 experts top-2
d_ff=16384, SWA 4096, vocab=32768 [arXiv:2401.04088]."""
from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", num_layers=56, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
    sliding_window=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    remat="none",
)
