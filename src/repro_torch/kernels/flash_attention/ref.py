"""Plain PyTorch version of flash attention (K1): the CPU path and the card's
reference.  Materialises the [Sq, Skv] scores; GQA by head grouping."""
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    if logit_cap > 0:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    q_idx = torch.arange(sq, device=q.device) + q_offset
    k_idx = torch.arange(skv, device=q.device)
    diff = q_idx[:, None] - k_idx[None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


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
