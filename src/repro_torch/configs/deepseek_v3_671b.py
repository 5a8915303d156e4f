"""deepseek-v3-671b [moe]: 61L d_model=7168, MLA, 1 shared + 256 routed
top-8 experts d_ff=2048, vocab=129280 [arXiv:2412.19437].

The JAX package's deviations from the published model, kept here: all
layers MoE (the real model's first 3 layers are dense); sigmoid top-k
routing without the group-limited device constraint; MTP head omitted."""
from .base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, d_ff=18432, vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared_experts=1, d_ff_shared=32),
    remat="none",
)
