"""GQA attention (sliding window, softcap, bias, padded heads).

Three implementations behind one interface, with the JAX package's layouts
([B, H, S, D] into attention):
  * dense   — materialised [Sq, Skv] scores (small shapes, oracle)
  * chunked — online-softmax loop over KV chunks in plain torch
  * kernel  — the hand-written flash-attention kernel K1
              (repro_torch.kernels.flash_attention), same math

Decode (Sq == 1 over the KV cache) stays plain torch, as the reference
computes it outside any kernel.  MLA waits for the other families.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import softcap
from .params import ParamSpec
from .rope import apply_rope

NEG_INF = -2.0e38


def attention_specs(cfg: ModelConfig, stacked: int = 0) -> dict:
    """GQA projection specs; ``stacked``>0 prepends a layer axis."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads + cfg.pad_heads,
                    cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.pad_heads and h % kv:
        raise ValueError(f"padded heads {h} not a multiple of kv heads {kv}")
    dt = cfg.dtype

    def p(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             dtype=dt, **kw)
        return ParamSpec(shape, axes, dtype=dt, **kw)

    specs = {
        "wq": p((d, h, hd), ("embed", "heads", "qk_dim"), init="scaled"),
        "wk": p((d, kv, hd), ("embed", "kv_heads", "qk_dim"), init="scaled"),
        "wv": p((d, kv, hd), ("embed", "kv_heads", "v_dim"), init="scaled"),
        "wo": p((h, hd, d), ("heads", "v_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = p((h, hd), ("heads", "qk_dim"), init="zeros")
        specs["bk"] = p((kv, hd), ("kv_heads", "qk_dim"), init="zeros")
        specs["bv"] = p((kv, hd), ("kv_heads", "v_dim"), init="zeros")
    return specs


# --------------------------------------------------------------------------
# masking
# --------------------------------------------------------------------------

def _apply_window(mask: torch.Tensor, diff: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Sliding-window constraint; ``window`` <= 0 means full attention."""
    if window <= 0:
        return mask
    return mask & (diff < window)


def _block_mask(q_idx: torch.Tensor, k_idx: torch.Tensor, *, causal: bool,
                window: int) -> torch.Tensor:
    """[Sq, Skv] boolean mask from absolute indices."""
    diff = q_idx[:, None] - k_idx[None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    return _apply_window(mask, diff, window)


# --------------------------------------------------------------------------
# core attention (dense / chunked / kernel)
# --------------------------------------------------------------------------

class AttnArgs(NamedTuple):
    causal: bool = True
    window: int = 0              # >0: sliding window
    logit_cap: float = 0.0
    q_offset: int = 0            # absolute position of q[0] (decode/prefill)


def _dense_attention(q, k, v, args: AttnArgs) -> torch.Tensor:
    """q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D]."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, sq, dh).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(dh)
    scores = softcap(scores, args.logit_cap)
    q_idx = torch.arange(sq, device=q.device) + args.q_offset
    k_idx = torch.arange(skv, device=q.device)
    mask = _block_mask(q_idx, k_idx, causal=args.causal, window=args.window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def _chunked_attention(q, k, v, args: AttnArgs, chunk: int) -> torch.Tensor:
    """Online-softmax loop over KV chunks — the flash-attention recurrence
    in plain torch."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, group, sq, dh).float() / math.sqrt(dh)
    q_idx = torch.arange(sq, device=q.device) + args.q_offset
    m = torch.full((b, hkv, group, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dv), device=q.device)
    for ci in range(n_chunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, :, ci * chunk:(ci + 1) * chunk].float()
        scores = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qg, kb),
                         args.logit_cap)
        k_idx = ci * chunk + torch.arange(chunk, device=q.device)
        diff = q_idx[:, None] - k_idx[None, :]
        mask = (k_idx < skv)[None, :].expand(diff.shape)
        if args.causal:
            mask = mask & (diff >= 0)
        mask = _apply_window(mask, diff, args.window)
        scores = scores.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def multihead_attention(q, k, v, args: AttnArgs, impl: str = "kernel",
                        chunk: int = 1024) -> torch.Tensor:
    if impl == "kernel":
        # no fallback: on the card this launches K1 or raises
        return flash_attention(q, k, v, causal=args.causal,
                               window=args.window, logit_cap=args.logit_cap,
                               q_offset=args.q_offset)
    if impl not in ("dense", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "dense" or q.shape[2] == 1:
        return _dense_attention(q, k, v, args)
    if q.shape[2] <= chunk and k.shape[2] <= chunk:
        return _dense_attention(q, k, v, args)
    return _chunked_attention(q, k, v, args, chunk)


# --------------------------------------------------------------------------
# GQA layer (projections + rope + attention)
# --------------------------------------------------------------------------

def _head_mask(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """Zero padded-head outputs (out: [..., H+pad, hd]) before W_o; the real
    heads of kv group g sit at [g*group_new, g*group_new + group_old)."""
    if not cfg.pad_heads:
        return out
    kv = cfg.num_kv_heads
    if cfg.pad_heads % kv:
        raise ValueError(f"pad_heads {cfg.pad_heads} not a multiple of {kv}")
    group_new = (cfg.num_heads + cfg.pad_heads) // kv
    group_old = cfg.num_heads // kv
    h_total = cfg.num_heads + cfg.pad_heads
    mask = ((torch.arange(h_total, device=out.device) % group_new)
            < group_old).to(out.dtype)
    return out * mask[:, None]


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: [B, S, d] -> q [B, S, H, hd], k and v [B, S, kv, hd]."""
    b, s, d = x.shape
    q = torch.matmul(x, p["wq"].reshape(d, -1)).view(b, s, *p["wq"].shape[1:])
    k = torch.matmul(x, p["wk"].reshape(d, -1)).view(b, s, *p["wk"].shape[1:])
    v = torch.matmul(x, p["wv"].reshape(d, -1)).view(b, s, *p["wv"].shape[1:])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet "
                                  "(ROADMAP, Queue 1 item 6)")
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor) -> torch.Tensor:
    """out: [B, S, H, hd] @ wo [H, hd, d] -> [B, S, d]."""
    b, s = out.shape[:2]
    return torch.matmul(out.reshape(b, s, -1),
                        p["wo"].reshape(-1, p["wo"].shape[-1]))


def gqa_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *,
                layer_window: int = 0) -> torch.Tensor:
    """Full-sequence GQA for train/prefill. x: [B, S, d]."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.causal or cfg.family == "audio":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    args = AttnArgs(causal=cfg.causal, window=layer_window,
                    logit_cap=cfg.attn_logit_softcap)
    out = multihead_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), args, impl=cfg.attn_impl,
                              chunk=cfg.attn_chunk)
    out = _head_mask(cfg, out.transpose(1, 2))           # [B, S, H, hd]
    return _out_proj(p, out)


def gqa_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cache_index: torch.Tensor, *, layer_window: int = 0):
    """One-token decode. x: [B, 1, d]; cache_k/v: [B, S_max, kv, hd];
    cache_index: 0-d int tensor (the position being written).

    Returns (attn_out [B,1,d], cache_k, cache_v).  The new key and value are
    written into ``cache_k``/``cache_v`` IN PLACE (the reference returns new
    arrays from ``dynamic_update_slice``); the index stays on the device, so
    a step never waits for the host.  With a static window no longer than
    the cache, the cache is a ring buffer of that size.
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    pos = cache_index.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ring = 0 < layer_window >= s_max
    slot = torch.remainder(cache_index, s_max) if ring else cache_index
    slot = slot.reshape(1).long()
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    # scores over the cache; mask invalid (future / unwritten) slots
    kt = cache_k.transpose(1, 2).float()                 # [B, kv, S, hd]
    vt = cache_v.transpose(1, 2).float()
    hq, hkv = q.shape[2], kt.shape[1]
    qg = q.transpose(1, 2).reshape(b, hkv, hq // hkv, 1, -1).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) / math.sqrt(q.shape[-1])
    scores = softcap(scores, cfg.attn_logit_softcap)
    slot_idx = torch.arange(s_max, device=x.device)
    if ring:
        valid = slot_idx < torch.clamp_max(cache_index + 1, s_max)
    else:
        valid = slot_idx <= cache_index
        if layer_window > 0:
            valid = valid & (cache_index - slot_idx < layer_window)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vt)
    out = out.reshape(b, hq, 1, -1).transpose(1, 2).to(x.dtype)
    out = _head_mask(cfg, out)
    return _out_proj(p, out), cache_k, cache_v
