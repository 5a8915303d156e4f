"""Fused RMSNorm (K2) over arbitrary leading dims.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the hand-written kernel (``csrc/rmsnorm.cu``) or raises.
``rmsnorm.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rmsnorm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            offset: float = 0.0) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (offset + w)`` over the last dim, in
    f32 inside; x: [..., D] and w: [D], both f32 or both bf16 (the models
    keep their norm weights in the activations' dtype)."""
    if w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x is {x.dtype} but w is {w.dtype}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps, offset)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d
    vec = int(d * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    fn = _build.function("repro_rmsnorm", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
             float(offset), _DTYPE_CODES[x.dtype], vec,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
