"""LM assembly: the training and serving paths of the dense Llama family,
and the serving path of the attention-free SSM family (Mamba2).

Public entry points are plain functions of (cfg, params, batch), with the
JAX package's names, signatures and layouts (layer-stacked weights [L, ...],
KV cache [L, B, S_max, kv, hd]; SSM cache ``ssm_state`` [L, B, H, P, N] f32
and ``conv_state`` [L, B, K-1, conv_ch]):

  model_specs(cfg)                       -> ParamSpec tree
  forward(cfg, params, batch)            -> (loss, logits)  [train / eval]
  prefill(cfg, params, batch)            -> last-token logits   [inference]
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  init_cache_specs(cfg, batch, max_len)  -> cache ParamSpec tree

:class:`TransformerLM` is the ``nn.Module`` that owns the parameters and
calls these functions.  The MoE, MLA and hybrid branches raise
``NotImplementedError`` until their families are ported.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import attention_specs, gqa_decode, gqa_forward
from .common import (embed_lookup, embedding_spec, norm_spec, rms_norm,
                     softcap)
from .mlp import mlp_forward, mlp_specs
from .params import DTYPES, ParamSpec, init_params
from .ssm import mamba2_forward, ssm_specs


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "hybrid" or cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (MoE/MLA/hybrid "
            "branches) is not ported yet (ROADMAP, Queue 1 item 6)")


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def _layer_specs(cfg: ModelConfig, stacked: int) -> dict:
    """One block's specs (attention + mlp + norms, or ssm + norm)."""
    _check_family(cfg)
    dt = cfg.dtype

    def n(shape, axes):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             init="ones", dtype=dt)
        return ParamSpec(shape, axes, init="ones", dtype=dt)

    if cfg.family == "ssm":
        return {"ssm": ssm_specs(cfg, stacked),
                "ln": n((cfg.d_model,), ("norm",))}
    return {"ln1": n((cfg.d_model,), ("norm",)),
            "ln2": n((cfg.d_model,), ("norm",)),
            "attn": attention_specs(cfg, stacked),
            "mlp": mlp_specs(cfg, stacked)}


def model_specs(cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    specs: dict = {
        "embed": embedding_spec(cfg.vocab_size, cfg.d_model, dt),
        "final_norm": norm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), init="scaled",
                                     dtype=dt)
    specs["layers"] = _layer_specs(cfg, stacked=cfg.num_layers)
    return specs


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """Per-layer sliding window (0 = full attention)."""
    if cfg.local_global_pattern > 0:
        # gemma2: even layers local (window), odd layers global
        is_local = layer_idx % cfg.local_global_pattern == 0
        return cfg.sliding_window if is_local else 0
    return cfg.sliding_window


def attn_block(cfg: ModelConfig, lp: dict, h: torch.Tensor,
               positions: torch.Tensor, layer_idx: int) -> torch.Tensor:
    x = rms_norm(h, lp["ln1"], cfg.rms_eps)
    h = h + gqa_forward(cfg, lp["attn"], x, positions,
                        layer_window=_layer_window(cfg, layer_idx))
    x = rms_norm(h, lp["ln2"], cfg.rms_eps)
    return h + mlp_forward(cfg, lp["mlp"], x)


def ssm_block(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    x = rms_norm(h, lp["ln"], cfg.rms_eps)
    y, _, _ = mamba2_forward(cfg, lp["ssm"], x)
    return h + y


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if cfg.frontend == "stub":
        return batch["embeds"].to(DTYPES[cfg.dtype])
    h = embed_lookup(batch["tokens"], params["embed"])
    if cfg.tie_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


def _logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Final norm and head; logits in f32 (the reference's
    ``preferred_element_type=float32``: bf16 products are exact in f32)."""
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    table = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"])
    logits = torch.matmul(h.float(), table.float())
    return softcap(logits, cfg.final_logit_softcap)


def _positions(batch: dict) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    lead = batch["tokens"] if "tokens" in batch else batch["embeds"]
    b, s = lead.shape[0], lead.shape[1]
    return torch.arange(s, dtype=torch.int32,
                        device=lead.device).expand(b, s)


# --------------------------------------------------------------------------
# forward (train / eval)
# --------------------------------------------------------------------------

def _unstack(tree, n: int) -> list[dict]:
    """A layer-stacked tree as ``n`` per-layer trees of views (no copy):
    one unbind a leaf, whose backward stacks the layers' gradients in one
    pass (a select a layer would build a zero-filled stacked gradient for
    each)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _scan_layers(cfg: ModelConfig, params: dict, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """The reference's layer scan as a Python loop over the stacked
    weights.  With ``remat == "full"`` each layer is recomputed in the
    backward (the reference's ``jax.checkpoint`` of the scan body), so its
    kernels' forwards run twice when a gradient is taken."""
    _check_family(cfg)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        if cfg.family == "ssm":
            def block(x, lp=lp):
                return ssm_block(cfg, lp, x)
        else:
            def block(x, lp=lp, i=i):
                return attn_block(cfg, lp, x, positions, i)
        if cfg.remat == "full" and torch.is_grad_enabled():
            h = checkpoint(block, h, use_reentrant=False)
        else:
            h = block(h)
    return h


def forward(cfg: ModelConfig, params: dict, batch: dict):
    """Returns (loss, logits). batch: tokens/embeds, targets, [positions].

    With ``loss_vocab_chunk`` > 0 the CE loss streams over vocab chunks and
    the full logits are never materialised (the logits returned are
    None)."""
    h = _embed(cfg, params, batch)
    h = _scan_layers(cfg, params, h, _positions(batch))
    if cfg.loss_vocab_chunk > 0:
        loss = chunked_cross_entropy(cfg, params, h, batch["targets"],
                                     cfg.loss_vocab_chunk)
        return loss, None
    logits = _logits(cfg, params, h)
    return cross_entropy(logits, batch["targets"]), logits


def chunked_cross_entropy(cfg: ModelConfig, params: dict, h: torch.Tensor,
                          targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Streaming softmax CE over vocab chunks, tracking the running
    max/sum-exp and the gold-token logit.  Peak memory drops from
    O(B*S*V) f32 to O(B*S*chunk); flops are unchanged.  The last chunk is
    the remainder of the vocab (the reference pads it with masked
    columns)."""
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    table = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    v = table.shape[1]
    b, s, _ = h.shape
    tgt = targets.long()
    hf = h.float()
    m = torch.full((b, s), -math.inf, device=h.device)
    l = torch.zeros((b, s), device=h.device)
    gold = torch.zeros((b, s), device=h.device)
    for base in range(0, v, chunk):
        tbl = table[:, base:base + chunk]
        width = tbl.shape[1]
        logits = softcap(torch.matmul(hf, tbl.float()),
                         cfg.final_logit_softcap)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(dim=-1)
        m = m_new
        in_chunk = (tgt >= base) & (tgt < base + width)
        idx = torch.clamp(tgt - base, 0, width - 1)
        g = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = torch.where(in_chunk, g, gold)
    lse = m + torch.log(l)
    return torch.mean(lse - gold)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable softmax CE, mean over tokens. logits: [B,S,V] f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()


# --------------------------------------------------------------------------
# inference: prefill + decode
# --------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch_size: int, max_len: int) -> dict:
    """KV or SSM cache description (shape, dtype, logical axes) for one
    batch."""
    _check_family(cfg)
    if cfg.family == "ssm":
        s = cfg.ssm
        nh, di = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model)
        conv_ch = di + 2 * s.n_groups * s.d_state
        return {
            "index": ((), "int32", ()),
            "ssm_state": ((cfg.num_layers, batch_size, nh, s.head_dim,
                           s.d_state), "float32",
                          ("layers", "batch", "ssm_heads", "qk_dim",
                           "ssm_state")),
            "conv_state": ((cfg.num_layers, batch_size, s.d_conv - 1,
                            conv_ch), cfg.dtype,
                           ("layers", "batch", "conv", "ssm_inner")),
        }
    hd = cfg.resolved_head_dim
    eff_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
               else max_len)
    kv_shape = (cfg.num_layers, batch_size, eff_len, cfg.num_kv_heads, hd)
    return {
        "index": ((), "int32", ()),
        "k": (kv_shape, cfg.dtype,
              ("layers", "batch", "cache_seq", "kv_heads", "qk_dim")),
        "v": (kv_shape, cfg.dtype,
              ("layers", "batch", "cache_seq", "kv_heads", "v_dim")),
    }


def init_cache_specs(cfg: ModelConfig, batch_size: int, max_len: int) -> dict:
    return {name: ParamSpec(shape, axes, init="zeros", dtype=dtype)
            for name, (shape, dtype, axes)
            in cache_shapes(cfg, batch_size, max_len).items()}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One autoregressive step. batch: tokens [B,1] (or embeds [B,1,d]).

    The cache index is carried in ``cache["index"]`` (a 0-d tensor).  The
    K/V tensors of ``cache`` (SSM family: ``ssm_state`` and ``conv_state``)
    are updated in place; the returned cache holds them and the advanced
    index.
    """
    _check_family(cfg)
    h = _embed(cfg, params, batch)
    index = cache["index"]
    layers = _unstack(params["layers"], cfg.num_layers)
    if cfg.family == "ssm":
        for i, lp in enumerate(layers):
            x = rms_norm(h, lp["ln"], cfg.rms_eps)
            y, new_s, new_c = mamba2_forward(
                cfg, lp["ssm"], x, ssm_state=cache["ssm_state"][i],
                conv_state=cache["conv_state"][i], decode=True)
            cache["ssm_state"][i].copy_(new_s)
            cache["conv_state"][i].copy_(new_c)
            h = h + y
        logits = _logits(cfg, params, h)
        return logits[:, -1], dict(cache, index=index + 1)
    for i, lp in enumerate(layers):
        x = rms_norm(h, lp["ln1"], cfg.rms_eps)
        y, _, _ = gqa_decode(cfg, lp["attn"], x, cache["k"][i],
                             cache["v"][i], index,
                             layer_window=_layer_window(cfg, i))
        h = h + y
        x = rms_norm(h, lp["ln2"], cfg.rms_eps)
        h = h + mlp_forward(cfg, lp["mlp"], x)
    logits = _logits(cfg, params, h)
    return logits[:, -1], dict(cache, index=index + 1)


def prefill(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Process a full prompt; returns last-token logits [B, V] (f32).  The
    head runs on the last position only: the same numbers, without the
    [B, S, V] logits."""
    h = _embed(cfg, params, batch)
    h = _scan_layers(cfg, params, h, _positions(batch))
    return _logits(cfg, params, h[:, -1:].contiguous())[:, -1]


# --------------------------------------------------------------------------
# module
# --------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A nested parameter dict as registered (frozen) parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def as_dict(self) -> dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out.update({k: m.as_dict() for k, m in self.named_children()})
        return out


class TransformerLM(nn.Module):
    """Owns a dense or SSM LM's parameters and serves it.

    ``params`` (e.g. from :func:`~repro_torch.models.params.params_from_jax`)
    is taken as is; without it the parameters are drawn from ``generator``
    on ``device`` (``None``: the card, which must exist)."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            device = resolve_device(device)
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(model_specs(cfg), generator, device)
        self.tree = _ParamTree(params)

    @property
    def params(self) -> dict:
        return self.tree.as_dict()

    def forward(self, batch: dict):
        return forward(self.cfg, self.params, batch)

    def prefill(self, batch: dict) -> torch.Tensor:
        return prefill(self.cfg, self.params, batch)

    def decode_step(self, cache: dict, batch: dict):
        return decode_step(self.cfg, self.params, cache, batch)

    def generate(self, prompt: torch.Tensor, max_new_tokens: int = 8,
                 max_len: int = 128):
        from ..serve.decode import greedy_decode
        return greedy_decode(self.cfg, self.params, prompt,
                             max_new_tokens=max_new_tokens, max_len=max_len)
