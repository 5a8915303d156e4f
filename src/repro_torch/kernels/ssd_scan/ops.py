"""Mamba2 SSD scan (the chunked dual form) through the kernel K3, and its
backward through K3b.

:func:`ssd_scan` is the counterpart of the JAX package's
``kernels/ssd_scan/ops.py::ssd_scan``.  On a CUDA tensor it is one launch of
K3 (``csrc/ssd_scan.cu``), which computes the whole scan: the decays inside
each chunk, the intra-chunk dual form, the chunk states and the inter-chunk
recurrence.  It is a ``torch.autograd.Function`` over three opaque
operators: ``torch.ops.repro_torch.ssd_scan`` (no gradient wanted),
``ssd_scan_states`` (K3 also writes each chunk's inbound state, f32, for
the backward) and ``ssd_scan_bwd`` (K3b, ``csrc/ssd_scan_bwd.cu``, the
gradients of x, dt, a, B, C and the initial state).  On a CPU tensor each
runs its plain version (``ref.py``); on a CUDA tensor each launches its
kernel or the call raises; there is no fallback.  A trace on fake tensors
records one node per call and launches nothing.  ``ssd_scan.launches``
counts K3's launches and ``ssd_scan_bwd.launches`` K3b's (each of which
runs its kernels: three in bf16, four in f32), and nothing else: a call
captured into a CUDA graph records the kernels and is not counted.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...library import call, define
from .ref import ssd_scan_bwd_ref, ssd_scan_ref, ssd_scan_states_ref

# the widths K3 is instantiated for: head_dim P and d_state N; the chunk
# length is a multiple of TILE up to MAX_CHUNK
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
TILE, MAX_CHUNK = 64, 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])


def _check_layout(name: str, t: torch.Tensor) -> None:
    # K3 reads x, B and C with TMA: 16-byte aligned strides and base
    if (t.stride(-1) != 1
            or any(s * t.element_size() % 16 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"ssd_scan: {name} needs a contiguous last dim and "
                         "16-byte aligned strides and base, got strides "
                         f"{t.stride()}")


def _check(name, x, dt, a, b_in, c_in, chunk, initial_state):
    tensors = [x, dt, a, b_in, c_in]
    if initial_state is not None:
        tensors.append(initial_state)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if chunk % TILE or chunk > MAX_CHUNK:
        raise ValueError(f"{name}: K3 takes a chunk length that is a "
                         f"multiple of {TILE} up to {MAX_CHUNK}, got {chunk}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"{name}: K3 takes head_dim in {HEAD_DIMS} and "
                         f"d_state in {STATE_DIMS}, got {p} and {n}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in [dt, a, *tensors[5:]]):
        raise TypeError(f"{name}: dt, a and the initial state must be "
                        "contiguous float32 on the card")
    for arg, t in (("x", x), ("B", b_in), ("C", c_in)):
        _check_layout(arg, t)


def _strides(x, b_in, c_in):
    return (x.stride(0), x.stride(1), x.stride(2),
            b_in.stride(0), b_in.stride(1), b_in.stride(2),
            c_in.stride(0), c_in.stride(1), c_in.stride(2))


def _launch(x, dt, a, b_in, c_in, chunk, initial_state, with_states=False):
    """One launch of K3: (y, final_state, states or None)."""
    _check("ssd_scan", x, dt, a, b_in, c_in, chunk, initial_state)
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    y = torch.empty(bsz, s, h, p, dtype=x.dtype, device=x.device)
    final = torch.empty(bsz, h, p, n, dtype=torch.float32, device=x.device)
    states = (torch.empty(bsz, s // chunk, h, p, n, dtype=torch.float32,
                          device=x.device) if with_states else None)
    fn = _build.function("repro_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(),
             None if initial_state is None else initial_state.data_ptr(),
             y.data_ptr(), final.data_ptr(),
             None if states is None else states.data_ptr(),
             bsz, s, h, g, chunk, p, n, *_strides(x, b_in, c_in),
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_ssd_scan")
    _build.count_launch(ssd_scan)  # the one place K3 launches
    return y, final, states


def _launch_bwd(x, dt, a, b_in, c_in, chunk, initial_state, states, dy,
                dfinal):
    """One launch of K3b: (dx, ddt, da, dB, dC, dinitial)."""
    _check("ssd_scan_bwd", x, dt, a, b_in, c_in, chunk, initial_state)
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = s // chunk
    if (states.shape != (bsz, nc, h, p, n) or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device):
        raise ValueError("ssd_scan_bwd: states must be contiguous float32 "
                         f"[{bsz}, {nc}, {h}, {p}, {n}], got {states.dtype} "
                         f"{tuple(states.shape)}")
    dy = dy.to(x.dtype).contiguous()
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(bsz, s, h, p, dtype=x.dtype, device=x.device)
    ddt = torch.empty(bsz, s, h, **f32)
    da = torch.empty(h, **f32)
    db = torch.empty(bsz, s, g, n, dtype=x.dtype, device=x.device)
    dc = torch.empty(bsz, s, g, n, dtype=x.dtype, device=x.device)
    dinit = torch.empty(bsz, h, p, n, **f32)
    # scratch: the state gradient reaching each chunk's end [B, C, H, P, N],
    # each chunk's total decay [B, C, H], each head's partial dB and dC
    # [B, S, H, N] (summed over a group's heads by the last kernel, in
    # order) and each (batch, chunk, head)'s partial da [B, C, H]
    grad_states = torch.empty(bsz, nc, h, p, n, **f32)
    datot = torch.empty(bsz, nc, h, **f32)
    db_part = torch.empty(bsz, s, h, n, **f32)
    dc_part = torch.empty(bsz, s, h, n, **f32)
    da_part = torch.empty(bsz, nc, h, dtype=torch.float64, device=x.device)
    fn = _build.function("repro_ssd_scan_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(), states.data_ptr(), dy.data_ptr(),
             None if dfinal is None else dfinal.data_ptr(),
             dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
             dc.data_ptr(), dinit.data_ptr(), grad_states.data_ptr(),
             datot.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
             da_part.data_ptr(), bsz, s, h, g, chunk, p, n,
             *_strides(x, b_in, c_in),
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_ssd_scan_bwd")
    _build.count_launch(ssd_scan_bwd)  # the one place K3b launches
    return dx, ddt, da, db, dc, dinit


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
    return _SSDScan.apply(x, dt, a, b_in, c_in, int(chunk), initial_state)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, chunk, initial_state):
        args = (x, dt, a, b_in, c_in, chunk, initial_state)
        if not any(ctx.needs_input_grad):
            return call(_SCAN, *args)
        y, final, states = call(_SCAN_STATES, *args)
        ctx.save_for_backward(x, dt, a, b_in, c_in, initial_state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b_in, c_in, initial_state, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, da, db, dc, dinit = call(
            _BWD, x, dt, a, b_in, c_in, ctx.chunk, initial_state, states, dy,
            dfinal)
        return (dx, ddt.to(dt.dtype), da.to(a.dtype), db, dc, None,
                None if initial_state is None
                else dinit.to(initial_state.dtype))


def _kernel(*args):
    return _launch(*args)[:2]


def _kernel_states(*args):
    return _launch(*args, with_states=True)


def _fake(x, dt, a, b_in, c_in, chunk, initial_state):
    bsz, _, h, p = x.shape
    return (x.new_empty(x.shape),
            x.new_empty(bsz, h, p, b_in.shape[3], dtype=torch.float32))


def _fake_states(x, dt, a, b_in, c_in, chunk, initial_state):
    bsz, s, h, p = x.shape
    return (*_fake(x, dt, a, b_in, c_in, chunk, initial_state),
            x.new_empty(bsz, s // chunk, h, p, b_in.shape[3],
                        dtype=torch.float32))


def _fake_bwd(x, dt, a, b_in, c_in, chunk, initial_state, states, dy,
              dfinal):
    bsz, _, h, p = x.shape
    return (x.new_empty(x.shape), dt.new_empty(dt.shape, dtype=torch.float32),
            a.new_empty(a.shape, dtype=torch.float32),
            b_in.new_empty(b_in.shape), c_in.new_empty(c_in.shape),
            x.new_empty(bsz, h, p, b_in.shape[3], dtype=torch.float32))


def ssd_scan_bwd(x, dt, a, b_in, c_in, states, dy, *, chunk: int = 256,
                 initial_state=None, dfinal=None):
    """K3b: (dx, ddt, da, dB, dC, dinitial) of :func:`ssd_scan` from its
    inputs, the inbound states K3 wrote ([B, C, H, P, N] f32), dy and dfinal
    (None for 0); on CUDA tensors only.  dx, dB and dC are in x's dtype,
    the rest f32; dinitial is the initial state's gradient [B, H, P, N]."""
    return _launch_bwd(x, dt, a, b_in, c_in, chunk, initial_state, states, dy,
                       dfinal)


_ARGS = ("Tensor x, Tensor dt, Tensor a, Tensor b_in, Tensor c_in, "
         "int chunk, Tensor? initial_state")
_SCAN = define(f"ssd_scan({_ARGS}) -> (Tensor, Tensor)", ssd_scan_ref,
               _kernel, _fake)
_SCAN_STATES = define(f"ssd_scan_states({_ARGS}) -> (Tensor, Tensor, Tensor)",
                      ssd_scan_states_ref, _kernel_states, _fake_states)
_BWD = define(f"ssd_scan_bwd({_ARGS}, Tensor states, Tensor dy, "
              "Tensor? dfinal) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
              "Tensor)", ssd_scan_bwd_ref, _launch_bwd, _fake_bwd)
ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
