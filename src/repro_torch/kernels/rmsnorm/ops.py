"""Fused RMSNorm (K2) over arbitrary leading dims, and its backward (K2b).

:func:`rmsnorm` is a ``torch.autograd.Function`` over two opaque operators,
``torch.ops.repro_torch.rmsnorm`` and ``rmsnorm_bwd``.  On a CPU tensor
each computes its plain version (``ref.py``); on a CUDA tensor the forward
launches the hand-written kernel (``csrc/rmsnorm.cu``) and the backward K2b
(``csrc/rmsnorm_bwd.cu``), or the call raises.  A trace on fake tensors
records one node per call and runs only the operators' fakes, which
allocate the outputs and launch nothing.  ``rmsnorm.launches`` counts K2's
launches and ``rmsnorm_bwd.launches`` K2b's (each of which runs its two
kernels: the rows and the dw reduction), and nothing else: a call
captured into a CUDA graph records the kernel and is not counted.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...library import call, define
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
# blocks of K2b's row kernel for each SM (its 512-thread blocks fill an SM):
# each writes one f32 row of partial dw sums
_BWD_BLOCKS_PER_SM = 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")


def _vec(*ts: torch.Tensor) -> int:
    # 16-byte rows and bases: the vector paths of K2 and K2b
    return int(ts[0].shape[-1] * ts[0].element_size() % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in ts))


def _forward(x, w, eps, offset):
    _check(x, w)
    d = x.shape[-1]
    y = torch.empty_like(x)
    fn = _build.function("repro_rmsnorm", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d,
             float(eps), float(offset), _DTYPE_CODES[x.dtype], _vec(x, w),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_rmsnorm")
    _build.count_launch(rmsnorm)
    return y


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, offset: float = 0.0):
    """K2b: (dx, dw) of :func:`rmsnorm` from x, w and dy; on CUDA tensors
    only.  dx has x's shape and dtype, dw w's."""
    _check(x, w)
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    dy = dy.to(x.dtype).contiguous()
    d = x.shape[-1]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    blocks = (_BWD_BLOCKS_PER_SM
              * torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             dw.data_ptr(), partial.data_ptr(), x.numel() // d, d, float(eps),
             float(offset), blocks, _DTYPE_CODES[x.dtype],
             _vec(x, w, dy, dx),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_rmsnorm_bwd")
    _build.count_launch(rmsnorm_bwd)
    return dx, dw


def _fake(x, w, eps, offset):
    return torch.empty_like(x)


def _bwd_fake(x, w, dy, eps, offset):
    return torch.empty_like(x), torch.empty_like(w)


_FWD = define("rmsnorm(Tensor x, Tensor w, float eps, float offset) -> Tensor",
              rmsnorm_ref, _forward, _fake)
_BWD = define("rmsnorm_bwd(Tensor x, Tensor w, Tensor dy, float eps, "
              "float offset) -> (Tensor, Tensor)",
              rmsnorm_bwd_ref, rmsnorm_bwd, _bwd_fake)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, offset):
        y = call(_FWD, x, w, eps, offset)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x, w)
            ctx.eps, ctx.offset = eps, offset
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = call(_BWD, x, w, dy, ctx.eps, ctx.offset)
        return dx, dw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            offset: float = 0.0) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (offset + w)`` over the last dim, in
    f32 inside; x: [..., D] and w: [D], both f32 or both bf16 (the models
    keep their norm weights in the activations' dtype).  Differentiable in
    x and w."""
    if w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x is {x.dtype} but w is {w.dtype}")
    return _RMSNorm.apply(x, w, float(eps), float(offset))


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
