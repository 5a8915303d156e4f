"""Model configuration: the same dataclasses as the JAX package, field for field.

One :class:`ModelConfig` describes any architecture of the zoo; one
:class:`ShapeConfig` describes a workload shape cell.  The only deliberate
difference from the reference is ``attn_impl``: it takes
``dense | chunked | kernel`` and defaults to ``"kernel"`` (the hand-written
kernels: flash attention for the attention families, the SSD scan for the
SSM family; the counterpart of the reference's ``"pallas"``), so the main
path on the card never runs a plain version by default.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block dims."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


ATTN_IMPLS = ("dense", "chunked", "kernel")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention features
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0        # >0: SWA width (all layers)
    local_global_pattern: int = 0  # >0: alternate local/global every N layers
    causal: bool = True            # False -> encoder (bidirectional)
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # Qwen2-VL M-RoPE (t, h, w) splits
    # substructures
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2-style): 1 shared attention block every N ssm layers
    hybrid_attn_every: int = 0
    # norm / misc
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"              # silu | gelu
    dtype: str = "bfloat16"
    # modality frontend: "none" means token ids; "stub" means the input is a
    # precomputed [B, S, d_model] embedding (audio frames / vision patches)
    frontend: str = "none"
    remat: str = "full"            # none | full (activation checkpointing)
    attn_impl: str = "kernel"      # dense | chunked | kernel
    attn_chunk: int = 1024
    scan_layers: bool = True       # kept for field parity; torch loops layers
    layer_barriers: bool = False
    loss_vocab_chunk: int = 0      # >0: stream CE over vocab chunks
    moe_dispatch_sharding: bool = False
    moe_ep_shardmap: bool = False
    pad_heads: int = 0             # pad Q heads; padded outputs are masked
    #                                before W_o, so the math is exact

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- analytical parameter counts (for 6·N·D model flops) ----
    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params). Active differs for MoE."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        if self.family in ("ssm", "hybrid"):
            s = self.ssm or SSMConfig()
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                   + s.d_conv * (di + 2 * s.n_groups * s.d_state)  # conv
                   + di * d                                        # out_proj
                   + 2 * nh + d)                                   # A, D, norm
            n_ssm = L
            attn_per = 0
            if self.family == "hybrid" and self.hybrid_attn_every:
                kvh = self.num_kv_heads
                attn_per = (d * self.num_heads * hd + 2 * d * kvh * hd
                            + self.num_heads * hd * d + d * self.d_ff * 3)
                total += attn_per  # shared block counted once
                active += attn_per
            total += n_ssm * per
            active += n_ssm * per
            return total, active
        kvh = self.num_kv_heads
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        else:
            attn = (d * self.num_heads * hd + 2 * d * kvh * hd
                    + self.num_heads * hd * d)
        if self.moe is not None:
            mo = self.moe
            ff_dense = 3 * d * mo.d_ff_shared * mo.num_shared_experts
            ff_all = 3 * d * mo.d_ff_expert * mo.num_experts + ff_dense
            ff_active = 3 * d * mo.d_ff_expert * mo.top_k + ff_dense
            router = d * mo.num_experts
            total += L * (attn + ff_all + router + 2 * d)
            active += L * (attn + ff_active + router + 2 * d)
        else:
            ff = 3 * d * self.d_ff
            total += L * (attn + ff + 2 * d)
            active += L * (attn + ff + 2 * d)
        return total, active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class RunConfig:
    """One training run: the reference's ``RunConfig``, field for field.
    ``mesh_shape`` and ``mesh_axes`` are kept for parity: the port's
    ``train`` takes a mesh its caller builds (``launch/mesh.py``)."""
    model: ModelConfig
    shape: ShapeConfig
    mesh_shape: tuple[int, ...] = (16, 16)
    mesh_axes: tuple[str, ...] = ("data", "model")
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    optimizer: str = "adamw"       # adamw | adafactor
    grad_clip: float = 1.0
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    microbatch: int = 0            # 0 = no gradient accumulation
    gradient_compression: bool = False
    seed: int = 0
    # long-context decode: shard the KV cache / SSM chunks along "data"
    sequence_sharded_cache: bool = False
