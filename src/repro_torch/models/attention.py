"""Attention: GQA (sliding window, softcap, bias, padded heads) and MLA.

Three implementations behind one interface, with the JAX package's layouts
([B, H, S, D] into attention):
  * dense   — materialised [Sq, Skv] scores (small shapes, oracle)
  * chunked — online-softmax loop over KV chunks in plain torch
  * kernel  — the hand-written flash-attention kernel K1
              (repro_torch.kernels.flash_attention), same math

Decode (Sq == 1 over the KV cache) stays plain torch, as the reference
computes it outside any kernel: GQA over the K/V cache, MLA in the absorbed
form over the compressed cache.  On a ``model`` mesh axis the train/prefill
paths run the rank's heads (``distributed/tensor_parallel.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.tensor_parallel import current
from ..kernels.flash_attention.ops import flash_attention
from .common import dense, rms_norm, softcap
from .params import ParamSpec
from .rope import apply_mrope, apply_rope

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


def mla_specs(cfg: ModelConfig, stacked: int = 0) -> dict:
    """MLA projection specs (DeepSeek-V3): the query and the key/value
    latents' down projections, their norms and the heads' up projections."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = cfg.dtype
    qk = m.qk_nope_head_dim

    def p(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             dtype=dt, **kw)
        return ParamSpec(shape, axes, dtype=dt, **kw)

    return {
        "wdq": p((d, m.q_lora_rank), ("embed", "lora"), init="scaled"),
        "q_norm": p((m.q_lora_rank,), ("norm",), init="ones"),
        "wuq": p((m.q_lora_rank, h, qk + m.qk_rope_head_dim),
                 ("lora", "heads", "qk_dim"), init="scaled"),
        "wdkv": p((d, m.kv_lora_rank + m.qk_rope_head_dim),
                  ("embed", "lora"), init="scaled"),
        "kv_norm": p((m.kv_lora_rank,), ("norm",), init="ones"),
        "wuk": p((m.kv_lora_rank, h, qk), ("lora", "heads", "qk_dim"),
                 init="scaled"),
        "wuv": p((m.kv_lora_rank, h, m.v_head_dim),
                 ("lora", "heads", "v_dim"), init="scaled"),
        "wo": p((h, m.v_head_dim, d), ("heads", "v_dim", "embed"),
                init="scaled"),
    }


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
    heads of kv group g sit at [g*group_new, g*group_new + group_old).  On
    a model axis ``out`` holds the rank's heads, masked by their global
    index."""
    if not cfg.pad_heads:
        return out
    kv = cfg.num_kv_heads
    if cfg.pad_heads % kv:
        raise ValueError(f"pad_heads {cfg.pad_heads} not a multiple of {kv}")
    group_new = (cfg.num_heads + cfg.pad_heads) // kv
    group_old = cfg.num_heads // kv
    h_total = cfg.num_heads + cfg.pad_heads
    local = out.shape[-2]
    heads = (torch.arange(h_total, device=out.device) if local == h_total
             else current().global_heads(local, out))
    mask = ((heads % group_new) < group_old).to(out.dtype)
    return out * mask[:, None]


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: [B, S, d] -> q [B, S, H, hd], k and v [B, S, kv, hd].

    On a model axis (``wq`` holds the rank's heads) the projections are
    column-parallel: x enters the region through *f*.  Where ``kv_heads``
    stays whole, k and v are computed whole from x, enter the region
    through *f* themselves (so that ``wk`` and ``wv`` get their whole
    gradient on every rank) and are cut to the kv heads the rank's query
    heads read."""
    b, s, d = x.shape
    heads = cfg.num_heads + cfg.pad_heads
    local = p["wq"].shape[-2]
    tp = current() if local < heads else None
    xq = tp.copy(x) if tp is not None else x
    kv_split = tp is not None and p["wk"].shape[-2] < cfg.num_kv_heads
    xkv = xq if kv_split else x

    def proj(inp, w, bias):
        y = torch.matmul(inp, w.reshape(d, -1)).view(b, s, *w.shape[1:])
        return y + p[bias].to(y.dtype) if cfg.qkv_bias else y
    q = proj(xq, p["wq"], "bq")
    k = proj(xkv, p["wk"], "bk")
    v = proj(xkv, p["wv"], "bv")
    if tp is not None and not kv_split:
        k = tp.kv_heads(tp.copy(k), heads, local)
        v = tp.kv_heads(tp.copy(v), heads, local)
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor, heads: int = 0) -> torch.Tensor:
    """out: [B, S, H, hd] @ wo [H, hd, d] -> [B, S, d].  When ``wo`` holds
    fewer than ``heads`` heads (the rank's, on a model axis) the projection
    is row-parallel: its partial sums are added over the model ranks
    (*g*)."""
    b, s = out.shape[:2]
    y = torch.matmul(out.reshape(b, s, -1),
                     p["wo"].reshape(-1, p["wo"].shape[-1]))
    if p["wo"].shape[0] < heads:
        y = current().reduce(y)
    return y


def gqa_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, layer_window: int = 0,
                mrope_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence GQA for train/prefill. x: [B, S, d];
    ``mrope_positions`` [3, B, S]: M-RoPE's streams where the config has
    sections (plain RoPE at ``positions`` without them, as the
    reference)."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    elif cfg.causal or cfg.family == "audio":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    args = AttnArgs(causal=cfg.causal, window=layer_window,
                    logit_cap=cfg.attn_logit_softcap)
    out = multihead_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), args, impl=cfg.attn_impl,
                              chunk=cfg.attn_chunk)
    out = _head_mask(cfg, out.transpose(1, 2))           # [B, S, H, hd]
    return _out_proj(p, out, cfg.num_heads + cfg.pad_heads)


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
    if cfg.mrope_sections:
        # a decoded token's three streams all take its position
        pos3 = pos.expand(3, b, 1)
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
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


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------

def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, S, r] @ w: [r, H, k] -> [B, S, H, k]."""
    b, s = x.shape[:2]
    return torch.matmul(x, w.reshape(w.shape[0], -1)).view(b, s, *w.shape[1:])


def _mla_split(cfg: ModelConfig, p: dict):
    """The running :class:`TensorParallel` when the up projections hold the
    rank's heads (a model axis that divides them), else None."""
    return current() if p["wuk"].shape[-2] < cfg.num_heads else None


def _mla_query(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated).  On a
    model axis H is the rank's heads: the down projection and its norm run
    whole, and the latent enters the region of the heads' up projection
    through *f* (so ``wdq`` and ``q_norm`` get their whole gradient on every
    rank)."""
    m = cfg.mla
    cq = rms_norm(dense(x, p["wdq"]), p["q_norm"], cfg.rms_eps)
    tp = _mla_split(cfg, p)
    if tp is not None:
        cq = tp.copy(cq)
    q_nope, q_rope = _up(cq, p["wuq"]).split(
        [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    """(ckv [B, S, rank] normed, k_rope [B, S, 1, rope] rotated), whole on
    every model rank; on a model axis each enters the heads' region through
    *f*."""
    m = cfg.mla
    ckv, k_rope = dense(x, p["wdkv"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    # K2 takes contiguous rows: the first kv_lora_rank columns of each
    # [rank + rope] row are copied out before the norm
    ckv = rms_norm(ckv.contiguous(), p["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    tp = _mla_split(cfg, p)
    if tp is not None:
        ckv, k_rope = tp.copy(ckv), tp.copy(k_rope)
    return ckv, k_rope


def mla_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Materialised MLA for train/prefill: K1 at a query/key width of
    nope + rope (192) and a value width of v_head_dim (128).  On a model
    axis K1 runs over the rank's heads and ``wo`` is row-parallel."""
    m = cfg.mla
    b, s, _ = x.shape
    h = p["wuk"].shape[-2]
    q_nope, q_rope = _mla_query(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = _up(ckv, p["wuk"])
    v = _up(ckv, p["wuv"])
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    args = AttnArgs(causal=True, logit_cap=0.0)
    out = multihead_attention(qf.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), args, impl=cfg.attn_impl,
                              chunk=cfg.attn_chunk)
    return _out_proj(p, out.transpose(1, 2), cfg.num_heads)


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_index: torch.Tensor):
    """Absorbed-form MLA decode against the *compressed* KV cache.

    cache_ckv: [B, S_max, kv_lora_rank + qk_rope_head_dim]: W_uk is absorbed
    into the query and W_uv into the output, so a step's compute and cache
    stay in the compressed space.  The new entry is written into
    ``cache_ckv`` IN PLACE; returns (attn_out [B, 1, d], cache_ckv)."""
    m = cfg.mla
    b = x.shape[0]
    s_max = cache_ckv.shape[1]
    pos = cache_index.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _mla_query(cfg, p, x, pos)
    # absorb W_uk: q_c [B, 1, H, rank] = q_nope . W_uk^T
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
    ckv, k_rope = _mla_latent(cfg, p, x, pos)
    entry = torch.cat([ckv, k_rope[:, :, 0, :]], dim=-1)
    cache_ckv.index_copy_(1, cache_index.reshape(1).long(),
                          entry.to(cache_ckv.dtype))
    c_k = cache_ckv[:, :, :m.kv_lora_rank].float()
    r_k = cache_ckv[:, :, m.kv_lora_rank:].float()
    scores = (torch.einsum("bshr,btr->bhst", q_c.float(), c_k)
              + torch.einsum("bshk,btk->bhst", q_rope.float(), r_k))
    scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    valid = torch.arange(s_max, device=x.device) <= cache_index
    probs = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, c_k)       # compressed ctx
    out = torch.einsum("bshr,rhk->bshk", ctx.to(x.dtype), p["wuv"])
    return _out_proj(p, out), cache_ckv
