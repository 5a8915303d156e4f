"""Shared building blocks: norms, activations, embeddings, the layer
barrier."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import current
from ..kernels.rmsnorm.ops import rmsnorm, rmsnorm_split_row
from ..library import call, define
from .params import ParamSpec


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (offset + weight)``, f32 inside, out in
    ``x.dtype``: the hand-written kernel K2 on the card."""
    return rmsnorm(x, weight, eps=eps, offset=offset)


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, d_whole: int,
                   eps: float = 1e-5, offset: float = 0.0) -> torch.Tensor:
    """:func:`rms_norm` of rows of ``d_whole`` columns of which x [..., d]
    and ``weight`` [d] are the rank's block, the others held by the other
    ranks of the model axis: each row's mean square is taken over the whole
    row, its block sums added over the model ranks (the split-row K2 and
    K2b on the card)."""
    return rmsnorm_split_row(x, weight, eps, offset, d_whole,
                             current().sum_rows)


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


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor,
                 vocab: int | None = None) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  A table of fewer rows than
    ``vocab`` is the rank's vocab block on a model axis: the lookup is then
    vocab-parallel (``distributed/tensor_parallel.py``)."""
    if vocab is not None and table.shape[0] < vocab:
        return current().embed(tokens, table)
    return table[tokens.long()]


def embedding_spec(vocab: int, d_model: int, dtype: str) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"),
                     init="normal", dtype=dtype)


def norm_spec(d: int, dtype: str) -> ParamSpec:
    return ParamSpec((d,), ("norm",), init="ones", dtype=dtype)


def shard_act(x: torch.Tensor, axes) -> torch.Tensor:
    """Identity: this slice runs on one device, with no mesh to shard on."""
    return x


_BARRIER = define("barrier(Tensor x) -> Tensor", torch.clone, torch.clone,
                  lambda x: torch.empty_like(x))


class _Barrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return call(_BARRIER, x)

    @staticmethod
    def backward(ctx, g):
        return call(_BARRIER, g)


def barrier(x: torch.Tensor) -> torch.Tensor:
    """The reference's differentiable ``optimization_barrier``: a copy of x
    here, and in an export an ``optimization_barrier`` on the value and on
    its cotangent, so per-layer regions stay apart in the forward and the
    backward segments of the text."""
    return _Barrier.apply(x)
