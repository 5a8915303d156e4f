"""Mamba2 SSD scan (the chunked dual form) with the intra-chunk kernel K3.

:func:`ssd_scan` is the counterpart of the JAX package's
``kernels/ssd_scan/ops.py::ssd_scan``.  It computes, in plain torch and f32,
the cumulative decays inside each chunk, each chunk's local state and the
inter-chunk recurrence (one [C+1, C+1] segment-sum product, not a loop over
chunks), and hands the matmul-heavy intra-chunk work to :func:`ssd_chunk`:
K3 (``csrc/ssd_scan.cu``) on a CUDA tensor, its plain version on a CPU
tensor.  On a CUDA tensor K3 launches or the call raises; there is no
fallback.  ``ssd_scan.launches`` counts K3's launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunk_ref

# the widths K3 is instantiated for: head_dim P and d_state N
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} x[..., k] for j <= i, else -inf;
    summed term by term, not as a difference of cumulative sums, which
    would lose a small decay next to the large sums of earlier chunks."""
    t = x.shape[-1]
    xx = x[..., :, None].expand(*x.shape, t)                   # [..., k, j]
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~causal, float("-inf"))


def chunk_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, chunk: int,
                 initial_state: torch.Tensor | None = None):
    """The plain part of the scan, in f32.  Returns ``dacs`` [B, S, H] (the
    cumulative sum of dt * a inside each chunk), the inbound state of each
    chunk [B, C, H, P, N] and the final state [B, H, P, N]."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = s // chunk
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    dacs = torch.cumsum(dtc * a.float(), dim=2)                # [B,C,L,H]
    datot = dacs[:, :, -1]                                     # [B,C,H]
    # local state of each chunk: sum_t exp(datot - dacs_t) dt_t x_t (x) B_t,
    # heads of a group against the group's B in place
    w = (torch.exp(datot[:, :, None] - dacs) * dtc).reshape(
        bsz, nc, chunk, g, h // g)
    xw = x.float().reshape(bsz, nc, chunk, g, h // g, p) * w[..., None]
    local = torch.einsum("bclgn,bclgkp->bcgkpn",
                         b_in.float().reshape(bsz, nc, chunk, g, n), xw)
    # inter-chunk recurrence S_{c+1} = exp(datot_c) S_c + local_c as one
    # product: z = [S_0, local_0 .. local_{C-1}] decayed by the segment sums
    # of [0, datot_0 .. datot_{C-1}] gives [S_0 .. S_C]
    init = (torch.zeros(bsz, h, p, n, device=x.device)
            if initial_state is None else initial_state.float())
    z = torch.cat([init[:, None], local.reshape(bsz, nc, h, p, n)], dim=1)
    e = torch.cat([torch.zeros_like(datot[:, :1]), datot], dim=1)
    decay = torch.exp(_segsum(e.transpose(1, 2)))              # [B,H,C+1,C+1]
    states = torch.einsum("bhzc,bchpn->bzhpn", decay, z)
    return dacs.reshape(bsz, s, h), states[:, :-1], states[:, -1]


def _check_layout(name: str, t: torch.Tensor) -> None:
    # K3 copies 16 bytes at a time along the contiguous last dim
    if (t.stride(-1) != 1
            or any(s * t.element_size() % 16 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"ssd_scan: {name} needs a contiguous last dim and "
                         "16-byte aligned strides and base, got strides "
                         f"{t.stride()}")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
              c_in: torch.Tensor, dacs: torch.Tensor,
              states: torch.Tensor) -> torch.Tensor:
    """K3's function (``ref.ssd_chunk_ref``, without the outbound states):
    y [B, S, H, P] in x.dtype from x [B, S, H, P], dt and dacs [B, S, H]
    f32, B and C [B, S, G, N] and the inbound states [B, C, H, P, N] f32.
    x, B and C are read through their strides (the column slices of the
    conv output), each head's B and C from its group in place."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, b_in, c_in, dacs, states)[0]
    tensors = (x, dt, b_in, c_in, dacs, states)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = states.shape[1]
    if (dt.shape != (bsz, s, h) or dacs.shape != dt.shape
            or b_in.shape != (bsz, s, g, n) or c_in.shape != b_in.shape
            or h % g or states.shape != (bsz, nc, h, p, n) or s % nc):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, dacs {tuple(dacs.shape)}, B "
                         f"{tuple(b_in.shape)}, C {tuple(c_in.shape)}, "
                         f"states {tuple(states.shape)}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: K3 takes head_dim in {HEAD_DIMS} and "
                         f"d_state in {STATE_DIMS}, got {p} and {n}")
    if (x.dtype not in _DTYPE_CODES or b_in.dtype != x.dtype
            or c_in.dtype != x.dtype or dt.dtype != torch.float32
            or dacs.dtype != torch.float32 or states.dtype != torch.float32):
        raise TypeError("ssd_scan: x, B and C must share float32 or "
                        "bfloat16; dt, dacs and states must be float32")
    for name, t in (("x", x), ("B", b_in), ("C", c_in)):
        _check_layout(name, t)
    dt, dacs, states = dt.contiguous(), dacs.contiguous(), states.contiguous()
    y = torch.empty(bsz, s, h, p, dtype=x.dtype, device=x.device)
    fn = _build.function("repro_ssd_chunk", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), dacs.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(), states.data_ptr(), y.data_ptr(),
             bsz, s, h, g, s // nc, p, n,
             x.stride(0), x.stride(1), x.stride(2),
             b_in.stride(0), b_in.stride(1), b_in.stride(2),
             c_in.stride(0), c_in.stride(1), c_in.stride(2),
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "repro_ssd_chunk")
    ssd_scan.launches += 1     # the one place K3 launches
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None):
    """x: [B, S, H, P], dt: [B, S, H], a: [H], b_in/c_in: [B, S, G, N].

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
    dacs, inbound, final = chunk_states(x, dt, a, b_in, chunk, initial_state)
    y = ssd_chunk(x, dt.float(), b_in, c_in, dacs, inbound)
    return y, final


ssd_scan.launches = 0
