"""Flash attention (K1) on [B, H, S, D] with GQA, and its backward (K1b).

:func:`flash_attention` is a ``torch.autograd.Function`` over three opaque
operators, ``torch.ops.repro_torch.flash_attention``, ``flash_attention_lse``
(which also returns each row's log-sum-exp) and ``flash_attention_bwd``.  On
CPU tensors each computes its plain version (``ref.py``); on CUDA tensors
the forward launches the hand-written kernel (``csrc/flash_attention.cu``),
writing each row's log-sum-exp when a gradient will be asked for, and the
backward launches K1b (``csrc/flash_attention_bwd.cu``), or the call raises.
A trace on fake tensors records one node per call and launches nothing.
``flash_attention.launches`` counts K1's launches and
``flash_attention_bwd.launches`` K1b's (each of which runs its three
kernels: delta, dK/dV and dQ), and nothing else: a call captured into a
CUDA graph records the kernel and is not counted.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...library import call, define
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

HEAD_DIMS = (32, 64, 80, 128, 160)
# (query/key width, value width) pairs K1 takes: each head_dim with itself,
# and MLA's 192 (128 without rope + 64 with) beside a value width of 128
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p]
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])


def _aligned(t: torch.Tensor) -> bool:
    # the kernels read 16 bytes at a time along the contiguous last dim
    return (t.stride(-1) == 1
            and not any(s * t.element_size() % 16 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not _aligned(t):
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         "dim and 16-byte aligned strides and base, got "
                         f"strides {t.stride()}")


def _check(q, k, v) -> None:
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; one of float32 or bfloat16 for all")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or hq % hkv or (d, v.shape[3]) not in HEAD_DIM_PAIRS):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; (query/key, "
                         f"value) widths must be one of {HEAD_DIM_PAIRS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)


def _forward(q, k, v, causal, window, logit_cap, q_offset, with_lse):
    """One launch of K1: (o, lse or None)."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    # written as [B, Sq, Hq, Dv]: the caller's transpose back is free
    o = torch.empty(b, sq, hq, dv, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(),
             b, hq, hkv, sq, skv, d, dv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], int(causal), int(window), float(logit_cap),
             int(q_offset), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "repro_flash_attention")
    _build.count_launch(flash_attention)
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, q_offset: int = 0):
    """K1b: (dq, dk, dv) of :func:`flash_attention` from q, k, v, its output
    o, its log-sum-exp lse ([B, Hq, Sq] f32) and dO; on CUDA tensors only.
    Each gradient has its input's shape, dtype and strides."""
    if v.shape[-1] != q.shape[-1]:
        raise ValueError(
            f"flash_attention_bwd: K1b takes one width for q, k and v, got "
            f"{q.shape[-1]} and a value width of {v.shape[-1]}; MLA's (192, "
            "128) backward comes with its training slice (ROADMAP, Queue 1 "
            "item 11.3)")
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, dO "
                         f"{tuple(do.shape)} for q {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != q.shape[:3] or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"[B, Hq, Sq] float32 tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    o, do = (t if t.dtype == q.dtype and _aligned(t)
             else t.to(q.dtype).contiguous() for t in (o, do))
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # the kernels' scratch: lse in log2 units and delta = rowsum(dO o), for
    # each (batch, query head), each padded to whole 128-row tiles
    sqp = -(-sq // 128) * 128
    delta = torch.empty(b * hq * 2 * sqp, dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    fn = _build.function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d,
             ctypes.cast(strides, ctypes.c_void_p), int(causal), int(window),
             float(logit_cap), int(q_offset), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "repro_flash_attention_bwd")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


def _plain_lse(q, k, v, causal, window, logit_cap, q_offset):
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset)


def _plain(*args):
    return _plain_lse(*args)[0]


def _plain_bwd(q, k, v, o, lse, do, causal, window, logit_cap, q_offset):
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                   window=window, logit_cap=logit_cap,
                                   q_offset=q_offset)


def _kernel(*args):
    return _forward(*args, with_lse=False)[0]


def _kernel_lse(*args):
    return _forward(*args, with_lse=True)


def _kernel_bwd(q, k, v, o, lse, do, causal, window, logit_cap, q_offset):
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window, logit_cap=logit_cap,
                               q_offset=q_offset)


def _fake(q, k, v, *_):
    # K1 writes o as [B, Sq, Hq, Dv]: V's width, not q's
    b, hq, sq, _ = q.shape
    return q.new_empty(b, sq, hq, v.shape[3]).transpose(1, 2)


def _fake_lse(q, k, v, *_):
    return _fake(q, k, v), q.new_empty(q.shape[:3], dtype=torch.float32)


def _fake_bwd(q, k, v, *_):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_ARGS = "bool causal, int window, float logit_cap, int q_offset"
_FWD = define(f"flash_attention(Tensor q, Tensor k, Tensor v, {_ARGS}) "
              "-> Tensor", _plain, _kernel, _fake)
_FWD_LSE = define(f"flash_attention_lse(Tensor q, Tensor k, Tensor v, "
                  f"{_ARGS}) -> (Tensor, Tensor)",
                  _plain_lse, _kernel_lse, _fake_lse)
_BWD = define(f"flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
              f"Tensor lse, Tensor dout, {_ARGS}) -> (Tensor, Tensor, Tensor)",
              _plain_bwd, _kernel_bwd, _fake_bwd)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, q_offset):
        args = (q, k, v, causal, window, logit_cap, q_offset)
        if not any(ctx.needs_input_grad[:3]):
            return call(_FWD, *args)
        o, lse = call(_FWD_LSE, *args)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = args[3:]
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = call(_BWD, q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Skv, D]; v: [B, Hkv, Skv, Dv] (Hq %
    Hkv == 0; (D, Dv) one of HEAD_DIM_PAIRS) -> [B, Hq, Sq, Dv], scaled by
    1/sqrt(D).  ``window`` > 0 keeps keys with 0 <= q - k < window (q
    counted from ``q_offset``); ``logit_cap`` > 0 applies a tanh cap.
    Differentiable in q, k and v (on the card only where Dv == D)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(logit_cap), int(q_offset))


flash_attention.launches = 0
flash_attention_bwd.launches = 0
