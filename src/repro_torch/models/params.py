"""Parameter specification trees, materialised as torch tensors.

Models declare parameters as nested dicts of :class:`ParamSpec` (shape +
dtype + logical axes + initializer), the same trees as the JAX package, so
``tree_paths`` names agree between the two and parameters carry across with
:func:`params_from_jax`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    init: str = "normal"        # normal | zeros | ones | scaled | ssm_a
    scale: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths(tree, prefix: str = "") -> dict[str, ParamSpec]:
    out: dict[str, ParamSpec] = {}
    if is_spec(tree):
        out[prefix.rstrip("/")] = tree
        return out
    for k, v in tree.items():
        out.update(tree_paths(v, f"{prefix}{k}/"))
    return out


def _rebuild(tree, values: dict, prefix: str = ""):
    if is_spec(tree):
        return values[prefix.rstrip("/")]
    return {k: _rebuild(v, values, f"{prefix}{k}/") for k, v in tree.items()}


def init_params(tree, generator: torch.Generator, device=None) -> dict:
    """Materialise a spec tree on ``device`` with draws from ``generator``
    (which must live on that device).  The initializers are the JAX
    package's; the random numbers are torch's, so they differ from
    ``jax.random`` for the same seed."""
    device = resolve_device(device)
    values: dict[str, torch.Tensor] = {}
    for name, s in sorted(tree_paths(tree).items()):
        dtype = DTYPES[s.dtype]
        if s.init == "zeros":
            v = torch.zeros(s.shape, dtype=dtype, device=device)
        elif s.init == "ones":
            v = torch.ones(s.shape, dtype=dtype, device=device)
        elif s.init == "ssm_a":   # Mamba A_log init: log(uniform[1, 16])
            v = torch.log(torch.linspace(1.0, 16.0, math.prod(s.shape),
                                         device=device)
                          ).reshape(s.shape).to(dtype)
        else:
            v = torch.randn(s.shape, generator=generator, device=device,
                            dtype=torch.float32)
            if s.init == "scaled":  # fan-in scaled normal
                fan_in = s.shape[0] if s.shape else 1
                v = v / math.sqrt(max(fan_in, 1))
            else:
                v = v * s.scale
            v = v.to(dtype)
        values[name] = v
    return _rebuild(tree, values)


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device=None) -> dict:
    """Nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray, p)``)
    -> the same tree of torch tensors, each leaf in its own dtype bit for
    bit (bf16 weights, the SSM's f32 ``a_log``).  An optimizer-state tree
    carries across the same way: the 0-d int32 ``step`` and the f32 moments
    (AdamW's ``m`` and ``v``, Adafactor's ``vr``/``vc``/``v``)."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_torch(x, device)

    return conv(tree)


def trainable(tree) -> dict:
    """The same tree with every leaf a tensor that requires grad: each a
    detached alias of the leaf (no copy), so ``torch.autograd.grad`` can
    differentiate a loss of the tree with respect to its leaves."""
    return {k: trainable(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in tree.items()}


def param_bytes(tree) -> int:
    return sum(int(np.prod(s.shape)) * DTYPES[s.dtype].itemsize
               for s in tree_paths(tree).values())


def param_count(tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_paths(tree).values())
