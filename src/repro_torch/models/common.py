"""Shared building blocks: norms, activations, embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import rmsnorm
from .params import ParamSpec


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (offset + weight)``, f32 inside, out in
    ``x.dtype``: the hand-written kernel K2 on the card."""
    return rmsnorm(x, weight, eps=eps, offset=offset)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x: [..., in] @ w: [in, out], output in ``x.dtype``.  A bf16 product
    accumulates in f32 (cuBLAS's compute type for bf16), as the reference's
    ``preferred_element_type=float32`` does."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embedding_spec(vocab: int, d_model: int, dtype: str) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"),
                     init="normal", dtype=dtype)


def norm_spec(d: int, dtype: str) -> ParamSpec:
    return ParamSpec((d,), ("norm",), init="ones", dtype=dtype)


def shard_act(x: torch.Tensor, axes) -> torch.Tensor:
    """Identity: this slice runs on one device, with no mesh to shard on."""
    return x
