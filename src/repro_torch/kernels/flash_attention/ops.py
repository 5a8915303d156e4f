"""Flash attention forward (K1) on [B, H, S, D] with GQA.

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the hand-written kernel (``csrc/flash_attention.cu``) or raises.
``flash_attention.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p])


def _check_layout(name: str, t: torch.Tensor) -> None:
    # the kernel reads 16 bytes at a time along the contiguous last dim
    if (t.stride(-1) != 1
            or any(s * t.element_size() % 16 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         "dim and 16-byte aligned strides and base, got "
                         f"strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0)
    -> [B, Hq, Sq, D].  ``window`` > 0 keeps keys with 0 <= q - k < window
    (q counted from ``q_offset``); ``logit_cap`` > 0 applies a tanh cap."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset)
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; one of float32 or bfloat16 for all")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hkv or d not in HEAD_DIMS):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head_dim "
                         f"must be one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    # written as [B, Sq, Hq, D]: the caller's transpose back is free
    o = torch.empty(b, sq, hq, d, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             b, hq, hkv, sq, skv, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], int(causal), int(window), float(logit_cap),
             int(q_offset), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "repro_flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
