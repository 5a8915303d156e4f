"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 + shared attention
block (32H kv=32) every 6 layers, ssm_state=64 [arXiv:2411.15242]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    hybrid_attn_every=2, remat="none",
)
