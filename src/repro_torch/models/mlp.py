"""Gated (SwiGLU/GeGLU) dense MLP.  MoE waits for the other families."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import activation, dense
from .params import ParamSpec


def mlp_specs(cfg: ModelConfig, stacked: int = 0, d_ff: int | None = None,
              suffix: str = "") -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.dtype

    def p(shape, axes):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             init="scaled", dtype=dt)
        return ParamSpec(shape, axes, init="scaled", dtype=dt)

    return {
        f"w_gate{suffix}": p((d, f), ("embed", "mlp")),
        f"w_up{suffix}": p((d, f), ("embed", "mlp")),
        f"w_down{suffix}": p((f, d), ("mlp", "embed")),
    }


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                suffix: str = "") -> torch.Tensor:
    act = activation(cfg.act)
    g = act(dense(x, p[f"w_gate{suffix}"]))
    u = dense(x, p[f"w_up{suffix}"])
    return dense(g * u, p[f"w_down{suffix}"])
