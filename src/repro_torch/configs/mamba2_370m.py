"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    tie_embeddings=True, remat="none",
)
