"""Plain PyTorch versions of flash attention (K1) and of its backward (K1b):
the CPU path and the card's reference.  They materialise the [Sq, Skv]
scores; GQA by head grouping."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38

# How far the kernel may be from the plain version computed in f32 on the
# same inputs.  In bf16 the kernel rounds P to bf16 for the tensor cores,
# which moves an output by at most 2^-8 (P|V|)/l (bf16's unit roundoff is
# 2^-8), and rounds the output, which moves it by at most 2^-8 |o|: each
# element is held within RTOL times |o| + (P|V|)/l, a margin of 2 over that
# bound.  In f32 only exp and the order of summation differ.  Each row's
# error norm is held within ROW_RTOL of the row's norm: a dropped or
# mis-rescaled KV tile moves whole rows by far more than that.
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}
ROW_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -12}


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int,
            logit_cap: float, q_offset: int, dtype=torch.float32):
    """The scaled, capped scores [B, Hkv, G, Sq, Skv] in ``dtype``, the raw
    scaled ones (before the cap) and the [Sq, Skv] mask of visible keys."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.to(dtype).reshape(b, hkv, hq // hkv, sq, d)
    raw = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(dtype)) / math.sqrt(d)
    scores = logit_cap * torch.tanh(raw / logit_cap) if logit_cap > 0 else raw
    q_idx = torch.arange(sq, device=q.device) + q_offset
    k_idx = torch.arange(skv, device=q.device)
    diff = q_idx[:, None] - k_idx[None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return scores, raw, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D]."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset)[0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, logit_cap: float = 0.0,
                            q_offset: int = 0, dtype=torch.float32):
    """The forward and each row's log-sum-exp: (o [B, Hq, Sq, D] in q's
    dtype, lse [B, Hq, Sq] f32), computed in ``dtype``.  lse is the natural
    log of the sum of exp(s) over the row's visible keys of the scaled,
    capped scores s (K1's convention), -inf for a row with none."""
    b, hq, sq, _ = q.shape
    scores, _, mask = _scores(q, k, causal=causal, window=window,
                              logit_cap=logit_cap, q_offset=q_offset,
                              dtype=dtype)
    lse = torch.logsumexp(scores.masked_fill(~mask, -math.inf), dim=-1)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(dtype))
    return (out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype),
            lse.reshape(b, hq, sq).float())


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            logit_cap: float = 0.0, q_offset: int = 0):
    """The gradients (dq, dk, dv) of the forward from what it keeps (q, k,
    v, o and lse) and dO, written out as K1b computes them, in f32:

        P = exp(s - lse) (0 where masked),  delta = rowsum(dO o),
        dS = P (dO v^T - delta) cap'(x),    dV = P^T dO,
        dK = scale dS^T q,                  dQ = scale dS k,

    with dK and dV summed over each KV head's group of query heads.  Each
    comes back in its input's dtype."""
    dq, dk, dv, _ = _bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         logit_cap=logit_cap, q_offset=q_offset,
                         dtype=torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd(q, k, v, o, lse, do, *, causal=True, window=0, logit_cap=0.0,
         q_offset=0, dtype=torch.float32, terms=False):
    """(dq, dk, dv) in ``dtype`` and, with ``terms``, the sums of the
    magnitudes of each one's terms (``bwd_kernel_error``'s scale)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    scores, raw, mask = _scores(q, k, causal=causal, window=window,
                                logit_cap=logit_cap, q_offset=q_offset,
                                dtype=dtype)
    lse_g = lse.to(dtype).reshape(b, hkv, g, sq, 1)
    # a row with lse = -inf has no visible key: where() keeps exp(inf) out
    p = torch.where(mask, torch.exp(scores - torch.where(
        torch.isfinite(lse_g), lse_g, 0.0)), 0.0)
    dog = do.to(dtype).reshape(b, hkv, g, sq, -1)
    qg = q.to(dtype).reshape(b, hkv, g, sq, d)
    kd, vd = k.to(dtype), v.to(dtype)
    delta = (dog * o.to(dtype).reshape(b, hkv, g, sq, -1)).sum(-1,
                                                               keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vd)
    dcap = (1.0 - torch.tanh(raw / logit_cap) ** 2 if logit_cap > 0
            else torch.ones_like(raw))
    ds = p * (dp - delta) * dcap
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kd).reshape(b, hq, sq, d) * scale
    if not terms:
        return dq, dk, dv, None
    # dS's magnitude bound: P times the sums of the magnitudes of dP's and
    # delta's own terms (f32 rounds each of those sums by up to its length
    # times 2^-24 of that magnitude, and a cancelling dP - delta keeps it)
    dp_abs = torch.einsum("bhgqd,bhkd->bhgqk", dog.abs(), vd.abs())
    delta_abs = (dog.abs() * o.to(dtype).abs().reshape(b, hkv, g, sq, -1)
                 ).sum(-1, keepdim=True)
    ds_abs = p * (dp_abs + delta_abs) * dcap.abs()
    return dq, dk, dv, (
        torch.einsum("bhgqk,bhkd->bhgqd", ds_abs, kd.abs()
                     ).reshape(b, hq, sq, d) * scale,
        torch.einsum("bhgqk,bhgqd->bhkd", ds_abs, qg.abs()) * scale,
        torch.einsum("bhgqk,bhgqd->bhkd", p, dog.abs()))


def kernel_error(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, **kw) -> tuple[float, float, float]:
    """Hold a kernel's output against the plain version in f32 on the same
    inputs.  Returns the max abs error, the largest element error in units
    of its tolerance (RTOL) and the largest row error in units of ROW_RTOL:
    the kernel agrees when both ratios are at most 1."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    ref = flash_attention_ref(q32, k32, v32, **kw)
    scale = ref.abs() + flash_attention_ref(q32, k32, v32.abs(), **kw)
    err = out.float() - ref
    elem = err.abs() / (RTOL[q.dtype] * scale).clamp_min(1e-30)
    row = err.norm(dim=-1) / (ROW_RTOL[q.dtype]
                              * ref.norm(dim=-1)).clamp_min(1e-30)
    return err.abs().max().item(), elem.max().item(), row.max().item()


# How far K1's log-sum-exp may be from the plain version's, absolute: both
# take s in f32 from the same inputs, and the kernel's row sum of up to a few
# thousand exponentials (ex2.approx, f32 sums) is within 2^-13 of the plain
# one relatively, which moves lse by as much; a margin of 2.
LSE_ATOL = 2.0 ** -12

# How far K1b's gradients may be from the plain backward, computed in double
# on the same inputs (o and lse included).  Per element, each gradient is a
# sum over a row or a column of P or dS times dO, q or k.  In bf16 the
# kernel rounds P and dS to bf16 for the tensor cores (2^-8 of each term)
# and rounds the result (2^-8 of it): each element is held within BWD_RTOL
# times its magnitude plus the sum of its terms' magnitudes, a margin of 2
# over that bound.  dS's magnitude is taken as P (|dO| |v|^T + |dO| |o|)
# |cap'|, the magnitudes of the products that make dP and delta: dP and
# delta are f32 sums over d of bf16 products, and where they cancel (a
# query that sees one key has dP = delta) their rounding is all that is
# left of dS.  In f32 a sum of n
# terms in another order differs by up to n 2^-24 of the terms' magnitudes,
# 2^-11 for the 8192 terms of a dK at S=2048 and a group of 4, though its
# rounding errors add as a random walk and stay near 2^-17: 2^-12.  Each
# row's error norm (a query's dq, a key's dk or dv) is held within
# BWD_ROW_RTOL of the norm of the row's element scales (its magnitudes plus
# its terms'): independent roundings give about 2^-9 of it in bf16.  Not of
# the row's own norm: a query that sees one key has dS = P (dP - delta) = 0
# exactly, so its dq is 0 in exact arithmetic and f32's rounding of dP -
# delta is all that is left.
BWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -12}
BWD_ROW_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -12}


def lse_error(lse: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, **kw) -> tuple[float, float]:
    """K1's lse against the plain version's in f32 on the same inputs: the
    max abs error over finite rows and that error in units of LSE_ATOL
    (rows with no visible key must be -inf in both)."""
    _, ref = flash_attention_fwd_ref(q.float(), k.float(), v.float(), **kw)
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(lse)) or torch.isnan(lse).any():
        return math.inf, math.inf
    err = (lse[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
    return err, err / LSE_ATOL


def bwd_kernel_error(grads, q, k, v, o, lse, do, **kw):
    """Hold K1b's (dq, dk, dv) against the plain backward in double on the
    same inputs, one batch row at a time.  Returns, for each of dq, dk and
    dv, (max abs error, largest element error in units of BWD_RTOL, largest
    row error in units of BWD_ROW_RTOL): the kernel agrees when every ratio
    is at most 1."""
    rtol, row_rtol = BWD_RTOL[q.dtype], BWD_ROW_RTOL[q.dtype]
    out = [[0.0, 0.0, 0.0] for _ in range(3)]
    for i in range(q.shape[0]):
        s = slice(i, i + 1)
        *refs, scales = _bwd(q[s], k[s], v[s], o[s], lse[s], do[s],
                             dtype=torch.float64, terms=True, **kw)
        for j, (g, ref, sc) in enumerate(zip(grads, refs, scales)):
            err = g[s].double() - ref
            elem = err.abs() / (rtol * (ref.abs() + sc)).clamp_min(1e-300)
            row = err.norm(dim=-1) / (row_rtol * (ref.abs() + sc).norm(
                dim=-1)).clamp_min(1e-300)
            out[j] = [max(out[j][0], err.abs().max().item()),
                      max(out[j][1], elem.max().item()),
                      max(out[j][2], row.max().item())]
    return [tuple(x) for x in out]
