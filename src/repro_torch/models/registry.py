"""Architecture registry: ``--arch <id>`` -> config.

The port serves the dense Llama family and the attention-free SSM family
(mamba2-370m); the other ids of the JAX registry raise
``NotImplementedError`` until their family is ported (ROADMAP, Queue 1:
other families).
"""
from __future__ import annotations

import importlib

import torch

from ..configs.base import ModelConfig, ShapeConfig
from .params import DTYPES
from .transformer import cache_shapes

ARCH_IDS = [
    "deepseek-67b", "stablelm-12b", "qwen2.5-32b",
    "gemma2-27b", "zamba2-2.7b", "deepseek-v3-671b", "mixtral-8x22b",
    "hubert-xlarge", "qwen2-vl-7b",
]
# the paper's dense Llama workloads and the SSM family: the ids the port
# serves
PORTED_IDS = ["llama3-100m", "llama3-500m", "llama3-1b", "llama3-3b",
              "llama2-7b", "mamba2-370m"]


def _module(arch: str):
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet (ROADMAP, Queue 1: "
            "other families); ported ids: " + ", ".join(PORTED_IDS))
    if arch not in PORTED_IDS:
        raise KeyError(arch)
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def _no_mesh(name: str, mesh, rules, seq_sharded: bool) -> None:
    if mesh is not None or rules is not None or seq_sharded:
        raise NotImplementedError(
            f"{name}: a mesh and sharding rules wait for the distribution "
            "slice (ROADMAP, Queue 1)")


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=DTYPES[dtype], device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                seq_sharded: bool = False) -> dict:
    """Meta tensors (no storage) standing for one step's inputs: the
    counterpart of the reference's ``ShapeDtypeStruct`` stand-ins."""
    _no_mesh("input_specs", mesh, rules, seq_sharded)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet "
                                  "(ROADMAP, Queue 1: other families)")
    b, s = shape.global_batch, shape.seq_len
    lead = (b, 1) if shape.kind == "decode" else (b, s)
    batch: dict = {}
    if cfg.frontend == "stub":
        batch["embeds"] = _meta((*lead, cfg.d_model), cfg.dtype)
    else:
        batch["tokens"] = _meta(lead, "int32")
    if shape.kind == "train":
        batch["targets"] = _meta(lead, "int32")
    return batch


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                         rules=None, seq_sharded: bool = False) -> dict:
    """Meta tensors for the decode cache of ``shape``'s batch and
    sequence length."""
    _no_mesh("cache_specs_abstract", mesh, rules, seq_sharded)
    return {name: _meta(shp, dtype) for name, (shp, dtype, _) in cache_shapes(
        cfg, shape.global_batch, shape.seq_len).items()}
