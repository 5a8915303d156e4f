"""Fused RMSNorm (K2) over arbitrary leading dims, and its backward (K2b),
each with a whole-row and a split-row form.

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

:func:`rmsnorm_split_row` is the norm of a row held in blocks by the ranks
of a model axis: four more operators, two passes each way with the ranks'
sum between them (``rmsnorm_sumsq``, the sum, ``rmsnorm_split`` forward;
``rmsnorm_bwd_dot``, the sum, ``rmsnorm_bwd_split`` backward), each with
its plain version in ``ref.py`` and its kernel in ``csrc/rmsnorm.cu`` or
``csrc/rmsnorm_bwd.cu``, and each wrapper with its own ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...library import call, define
from .ref import (rmsnorm_bwd_dot_ref, rmsnorm_bwd_ref, rmsnorm_bwd_split_ref,
                  rmsnorm_ref, rmsnorm_split_ref, rmsnorm_sumsq_ref)

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


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    _check_x(x)
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for x {tuple(x.shape)}")
    if not w.is_contiguous():
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


# --------------------------------------------------------------------------
# the split-row form
# --------------------------------------------------------------------------

_SUMSQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
_DOT_ARGTYPES = ([ctypes.c_void_p] * 4
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p])
_BWD_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 8
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
# row chunks of the split backward for each SM: each writes one f32 row of
# partial dw sums
_SPLIT_CHUNKS_PER_SM = 2


def _rows_f32(x: torch.Tensor, t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.shape != x.shape[:-1] \
            or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"{name}: f32 row sums {tuple(t.shape)} "
                         f"{t.dtype} for x {tuple(x.shape)}")


def _check_dy(x: torch.Tensor, dy: torch.Tensor, name: str) -> torch.Tensor:
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    return dy.to(x.dtype).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Each row's f32 sum of squares over the block x [..., d] -> [...];
    on CUDA tensors only (x contiguous, f32 or bf16)."""
    _check_x(x)
    d = x.shape[-1]
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_sumsq", _SUMSQ_ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel() // d, d,
             _DTYPE_CODES[x.dtype], _vec(x), _stream(x))
    _build.check(err, "repro_rmsnorm_sumsq")
    _build.count_launch(rmsnorm_sumsq)
    return out


def rmsnorm_split(x: torch.Tensor, w: torch.Tensor, total: torch.Tensor,
                  eps: float, offset: float, d_whole: int) -> torch.Tensor:
    """K2's split-row form: x rsqrt(total / d_whole + eps) (offset + w) over
    the block x [..., d] with w [d], from each row's sum of squares over the
    whole row (``total``, f32 [...]); on CUDA tensors only."""
    _check(x, w)
    _rows_f32(x, total, "rmsnorm_split")
    d = x.shape[-1]
    y = torch.empty_like(x)
    fn = _build.function("repro_rmsnorm_split", _SPLIT_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), total.data_ptr(), y.data_ptr(),
             x.numel() // d, d, int(d_whole), float(eps), float(offset),
             _DTYPE_CODES[x.dtype], _vec(x, w, y), _stream(x))
    _build.check(err, "repro_rmsnorm_split")
    _build.count_launch(rmsnorm_split)
    return y


def rmsnorm_bwd_dot(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    offset: float) -> torch.Tensor:
    """Each row's f32 sum over the block of x (offset + w) dy -> [...]; on
    CUDA tensors only."""
    _check(x, w)
    dy = _check_dy(x, dy, "rmsnorm_bwd_dot")
    d = x.shape[-1]
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_bwd_dot", _DOT_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), out.data_ptr(),
             x.numel() // d, d, float(offset), _DTYPE_CODES[x.dtype],
             _stream(x))
    _build.check(err, "repro_rmsnorm_bwd_dot")
    _build.count_launch(rmsnorm_bwd_dot)
    return out


def rmsnorm_bwd_split(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      total: torch.Tensor, dot: torch.Tensor, eps: float,
                      offset: float, d_whole: int):
    """K2b's split-row form: the block's (dx, dw) from each row's sums over
    the whole row (``total`` of x^2, ``dot`` of x (offset + w) dy; f32
    [...]); on CUDA tensors only.  dx has x's shape and dtype, dw w's."""
    _check(x, w)
    _rows_f32(x, total, "rmsnorm_bwd_split")
    _rows_f32(x, dot, "rmsnorm_bwd_split")
    dy = _check_dy(x, dy, "rmsnorm_bwd_split")
    d = x.shape[-1]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = min(65535, _SPLIT_CHUNKS_PER_SM * sms)
    partial = torch.empty(chunks, d, dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_bwd_split", _BWD_SPLIT_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), total.data_ptr(),
             dot.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
             x.numel() // d, d, int(d_whole), float(eps), float(offset),
             chunks, _DTYPE_CODES[x.dtype], _stream(x))
    _build.check(err, "repro_rmsnorm_bwd_split")
    _build.count_launch(rmsnorm_bwd_split)
    return dx, dw


def _rows_fake(x, *_):
    return torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)


_SUMSQ = define("rmsnorm_sumsq(Tensor x) -> Tensor", rmsnorm_sumsq_ref,
                rmsnorm_sumsq, _rows_fake)
_SPLIT = define("rmsnorm_split(Tensor x, Tensor w, Tensor total, float eps, "
                "float offset, int d_whole) -> Tensor", rmsnorm_split_ref,
                rmsnorm_split, lambda x, *_: torch.empty_like(x))
_DOT = define("rmsnorm_bwd_dot(Tensor x, Tensor w, Tensor dy, float offset) "
              "-> Tensor", rmsnorm_bwd_dot_ref, rmsnorm_bwd_dot, _rows_fake)
_BWD_SPLIT = define(
    "rmsnorm_bwd_split(Tensor x, Tensor w, Tensor dy, Tensor total, "
    "Tensor dot, float eps, float offset, int d_whole) -> (Tensor, Tensor)",
    rmsnorm_bwd_split_ref, rmsnorm_bwd_split,
    lambda x, w, *_: (torch.empty_like(x), torch.empty_like(w)))


class _SplitRMSNorm(torch.autograd.Function):
    """Two passes each way with the ranks' sum of each row's sums between
    them; the forward's totals are saved, so the backward sums only its own
    row sums."""

    @staticmethod
    def forward(ctx, x, w, eps, offset, d_whole, reduce):
        total = reduce(call(_SUMSQ, x))
        y = call(_SPLIT, x, w, total, eps, offset, d_whole)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x, w, total)
            ctx.eps, ctx.offset, ctx.d_whole = eps, offset, d_whole
            ctx.reduce = reduce
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, total = ctx.saved_tensors
        dy = dy.contiguous()
        dot = ctx.reduce(call(_DOT, x, w, dy, ctx.offset))
        dx, dw = call(_BWD_SPLIT, x, w, dy, total, dot, ctx.eps, ctx.offset,
                      ctx.d_whole)
        return dx, dw, None, None, None, None


def rmsnorm_split_row(x: torch.Tensor, w: torch.Tensor, eps: float,
                      offset: float, d_whole: int, reduce) -> torch.Tensor:
    """The block x [..., d] of :func:`rmsnorm` over rows of ``d_whole``
    columns held in blocks by several ranks, with w [d] the block's
    weights: ``reduce`` sums a tensor of row sums (f32 [...]) over those
    ranks (an all-reduce; no gradient is taken through it).  Forward the
    ranks' sums of squares, backward their sums of x (offset + w) dy.  The
    gradient of w is the block's, summed over this rank's rows only.
    Differentiable in x and w."""
    if w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x is {x.dtype} but w is {w.dtype}")
    return _SplitRMSNorm.apply(x.contiguous(), w.contiguous(), float(eps),
                               float(offset), int(d_whole), reduce)


rmsnorm_sumsq.launches = 0
rmsnorm_split.launches = 0
rmsnorm_bwd_dot.launches = 0
rmsnorm_bwd_split.launches = 0
