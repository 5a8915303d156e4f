"""Architecture registry: ``--arch <id>`` -> config.

The port serves the dense Llama family, the attention-free SSM family
(mamba2-370m), the dense deepseek-67b, qwen2.5-32b, gemma2-27b and
stablelm-12b, the sparse MoE mixtral-8x22b, the hybrid zamba2-2.7b (Mamba2
layers with one shared attention block) and deepseek-v3-671b (multi-head
latent attention and 256 experts); the other ids of the JAX registry raise
``NotImplementedError`` naming the ROADMAP item that ports them (Queue 1,
item 11: other families).
"""
from __future__ import annotations

import importlib

import torch

from ..configs.base import ModelConfig, ShapeConfig
from .params import DTYPES
from .transformer import cache_shapes

# the JAX registry's ids that are not ported yet, each with what it waits
# for
ARCH_IDS = ["hubert-xlarge", "qwen2-vl-7b"]
_WAITS_FOR = {
    "hubert-xlarge": "the stub front end",
    "qwen2-vl-7b": "M-RoPE and the stub front end",
}
# the paper's dense Llama workloads, the SSM family, the dense and MoE
# families whose attention K1 takes, the hybrid and the MLA family: the ids
# the port serves
PORTED_IDS = ["llama3-100m", "llama3-500m", "llama3-1b", "llama3-3b",
              "llama2-7b", "mamba2-370m", "deepseek-67b", "qwen2.5-32b",
              "gemma2-27b", "mixtral-8x22b", "stablelm-12b", "zamba2-2.7b",
              "deepseek-v3-671b"]


def _module(arch: str):
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet: it needs "
            f"{_WAITS_FOR[arch]} (ROADMAP, Queue 1 item 11: other "
            "families); ported ids: " + ", ".join(PORTED_IDS))
    if arch not in PORTED_IDS:
        raise KeyError(arch)
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_cells(cfg: ModelConfig) -> list[str]:
    """Which shape cells apply to this architecture (assignment rules)."""
    cells = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        cells.append("decode_32k")
        subquadratic = (cfg.family in ("ssm", "hybrid")
                        or (cfg.sliding_window > 0
                            and cfg.local_global_pattern == 0))
        if subquadratic:
            cells.append("long_500k")
    return cells


def skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    if shape_name in shape_cells(cfg):
        return None
    if cfg.is_encoder_only and shape_name in ("decode_32k", "long_500k"):
        return "encoder-only: no autoregressive decode step"
    if shape_name == "long_500k":
        return "full-quadratic attention at 524288 tokens (see DESIGN.md)"
    return "not applicable"


def _no_seq_sharding(name: str, seq_sharded: bool) -> None:
    if seq_sharded:
        raise NotImplementedError(
            f"{name}: the sequence-sharded rules are not ported yet "
            "(ROADMAP, Queue 1: tensor parallelism, the pod axis and "
            "sharded serving)")


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=DTYPES[dtype], device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                seq_sharded: bool = False) -> dict:
    """Meta tensors (no storage) standing for one step's inputs: the
    counterpart of the reference's ``ShapeDtypeStruct`` stand-ins.  With a
    mesh they are one rank's rows of the batch, laid out by the activation
    rules (``batch`` over ``pod`` and ``data``)."""
    from ..distributed.sharding import act_sharding, shard_shape

    _no_seq_sharding("input_specs", seq_sharded)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet "
                                  "(ROADMAP, Queue 1: other families)")

    def meta(shp, dtype, axes):
        if mesh is not None:
            shp = shard_shape(shp, act_sharding(axes, mesh, rules, shp),
                              mesh)
        return _meta(shp, dtype)

    b, s = shape.global_batch, shape.seq_len
    lead = (b, 1) if shape.kind == "decode" else (b, s)
    batch: dict = {}
    if cfg.frontend == "stub":
        batch["embeds"] = meta((*lead, cfg.d_model), cfg.dtype,
                               ("batch", "seq", "embed"))
    else:
        batch["tokens"] = meta(lead, "int32", ("batch", "seq"))
    if shape.kind == "train":
        batch["targets"] = meta(lead, "int32", ("batch", "seq"))
    return batch


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                         rules=None, seq_sharded: bool = False) -> dict:
    """Meta tensors for the decode cache of ``shape``'s batch and
    sequence length."""
    _no_seq_sharding("cache_specs_abstract", seq_sharded)
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "cache_specs_abstract: sharded serving is not ported yet "
            "(ROADMAP, Queue 1: tensor parallelism, the pod axis and "
            "sharded serving)")
    return {name: _meta(shp, dtype) for name, (shp, dtype, _) in cache_shapes(
        cfg, shape.global_batch, shape.seq_len).items()}
