"""Mamba2 SSD scan (the chunked dual form) through the kernel K3.

:func:`ssd_scan` is the counterpart of the JAX package's
``kernels/ssd_scan/ops.py::ssd_scan``.  On a CUDA tensor it is one launch of
K3 (``csrc/ssd_scan.cu``), which computes the whole scan: the decays inside
each chunk, the intra-chunk dual form, the chunk states and the inter-chunk
recurrence.  On a CPU tensor it runs the plain version,
``ref.ssd_scan_ref``, which autograd differentiates.  On a CUDA tensor K3
launches or the call raises; there is no fallback.  K3 has no backward yet,
so on the card a call that would need a gradient raises.
``ssd_scan.launches`` counts K3's launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_scan_ref

# the widths K3 is instantiated for: head_dim P and d_state N; the chunk
# length is a multiple of TILE up to MAX_CHUNK
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
TILE, MAX_CHUNK = 64, 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])


def _check_layout(name: str, t: torch.Tensor) -> None:
    # K3 reads x, B and C with TMA: 16-byte aligned strides and base
    if (t.stride(-1) != 1
            or any(s * t.element_size() % 16 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"ssd_scan: {name} needs a contiguous last dim and "
                         "16-byte aligned strides and base, got strides "
                         f"{t.stride()}")


def _launch(x, dt, a, b_in, c_in, chunk, initial_state):
    tensors = [x, dt, a, b_in, c_in]
    if initial_state is not None:
        tensors.append(initial_state)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if chunk % TILE or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: K3 takes a chunk length that is a "
                         f"multiple of {TILE} up to {MAX_CHUNK}, got {chunk}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: K3 takes head_dim in {HEAD_DIMS} and "
                         f"d_state in {STATE_DIMS}, got {p} and {n}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in [dt, a, *tensors[5:]]):
        raise TypeError("ssd_scan: dt, a and the initial state must be "
                        "contiguous float32 on the card")
    for name, t in (("x", x), ("B", b_in), ("C", c_in)):
        _check_layout(name, t)
    y = torch.empty(bsz, s, h, p, dtype=x.dtype, device=x.device)
    final = torch.empty(bsz, h, p, n, dtype=torch.float32, device=x.device)
    fn = _build.function("repro_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(),
             None if initial_state is None else initial_state.data_ptr(),
             y.data_ptr(), final.data_ptr(), bsz, s, h, g, chunk, p, n,
             x.stride(0), x.stride(1), x.stride(2),
             b_in.stride(0), b_in.stride(1), b_in.stride(2),
             c_in.stride(0), c_in.stride(1), c_in.stride(2),
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_ssd_scan")
    ssd_scan.launches += 1     # the one place K3 launches
    return y, final


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None):
    """x: [B, S, H, P], dt: [B, S, H], a: [H], b_in/c_in: [B, S, G, N],
    initial_state: [B, H, P, N] or None.  x, B and C are read through their
    strides (the column slices of the conv output), each head's B and C
    from its group in place.

    Returns (y [B, S, H, P] in x.dtype, final_state [B, H, P, N] f32), as
    ``ref.ssd_ref`` does."""
    if x.dtype not in _DTYPE_CODES or b_in.dtype != x.dtype \
            or c_in.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C are {x.dtype}, {b_in.dtype}, "
                        f"{c_in.dtype}; one of float32 or bfloat16 for all")
    if x.dim() != 4 or b_in.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B "
                         f"{tuple(b_in.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or c_in.shape != b_in.shape
            or b_in.shape[:2] != (bsz, s) or h % g
            or (initial_state is not None
                and initial_state.shape != (bsz, h, p, n))):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(b_in.shape)}, C {tuple(c_in.shape)}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_scan: seq {s} not divisible by chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b_in, c_in, chunk, initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b_in, c_in, initial_state)):
        # K3's outputs would carry no gradient: refuse rather than train
        # the layers below it silently without one
        raise NotImplementedError(
            "ssd_scan: K3 has no backward kernel yet (ROADMAP, Queue 2: "
            "K3's backward is the next training slice, mamba2-370m); call "
            "it under torch.no_grad() or on inputs that need no gradient")
    return _launch(x, dt, a, b_in, c_in, chunk, initial_state)


ssd_scan.launches = 0
