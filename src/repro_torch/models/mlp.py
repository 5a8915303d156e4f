"""MLPs: gated (SwiGLU/GeGLU) dense blocks and the sort-based sparse MoE.

The MoE dispatch is the reference's: tokens are ordered by expert with a
stable sort and moved with gathers and scatter-adds (no FLOPs), and each
expert runs a capacity-padded grouped GEMM, so an export's ``dot_general``
FLOPs track the active experts (top-k), not all of them.  The grouped GEMMs
stay ``torch.bmm`` with f32 accumulation: the JAX package computes them
outside any Pallas kernel.  The explicit expert-parallel dispatch
(``moe_forward_ep``) needs a ``model`` mesh axis, which is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import activation, dense
from .params import ParamSpec


def mlp_specs(cfg: ModelConfig, stacked: int = 0, d_ff: int | None = None,
              suffix: str = "") -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.dtype

    def p(shape, axes):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             init="scaled", dtype=dt)
        return ParamSpec(shape, axes, init="scaled", dtype=dt)

    return {
        f"w_gate{suffix}": p((d, f), ("embed", "mlp")),
        f"w_up{suffix}": p((d, f), ("embed", "mlp")),
        f"w_down{suffix}": p((f, d), ("mlp", "embed")),
    }


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                suffix: str = "") -> torch.Tensor:
    act = activation(cfg.act)
    g = act(dense(x, p[f"w_gate{suffix}"]))
    u = dense(x, p[f"w_up{suffix}"])
    return dense(g * u, p[f"w_down{suffix}"])


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig, stacked: int = 0) -> dict:
    mo = cfg.moe
    d, dt = cfg.d_model, cfg.dtype
    e, f = mo.num_experts, mo.d_ff_expert

    def p(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             dtype=dt, **kw)
        return ParamSpec(shape, axes, dtype=dt, **kw)

    specs = {
        "router": p((d, e), ("embed", "experts"), init="scaled"),
        "we_gate": p((e, d, f), ("experts", "embed", "mlp_expert"),
                     init="scaled"),
        "we_up": p((e, d, f), ("experts", "embed", "mlp_expert"),
                   init="scaled"),
        "we_down": p((e, f, d), ("experts", "mlp_expert", "embed"),
                     init="scaled"),
    }
    if mo.num_shared_experts:
        fs = mo.d_ff_shared or f
        specs.update(mlp_specs(
            cfg, stacked=stacked, d_ff=fs * mo.num_shared_experts,
            suffix="_shared"))
    return specs


def _capacity(tokens: int, mo) -> int:
    c = int(tokens * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(8, -(-c // 8) * 8)   # multiple of 8, >= 8


def moe_route(cfg: ModelConfig, p: dict,
              xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens xf [T, d]: (weights [T, k], experts [T, k]),
    the router in ``router_dtype`` (f32 by default).  Softmax gate; the
    DeepSeek-V3 ids take a sigmoid gate whose top-k weights are
    renormalised."""
    mo = cfg.moe
    router_dt = torch.float32 if mo.router_dtype == "float32" else xf.dtype
    logits = dense(xf.to(router_dt), p["router"].to(router_dt))   # [T, E]
    sigmoid_gate = cfg.name.startswith("deepseek-v3")
    scores = (torch.sigmoid(logits) if sigmoid_gate
              else torch.softmax(logits, dim=-1))
    top_w, top_e = torch.topk(scores, mo.top_k, dim=-1)
    if sigmoid_gate:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_w, top_e


def moe_dispatch(top_e: torch.Tensor, num_experts: int, cap: int):
    """The (token, k) assignment list sorted by expert: the order, each
    slot's token, whether it fits its expert's capacity and its row in the
    [E * C] buffer.  The sort is stable, so an expert over capacity drops
    its last tokens in token order, as the reference's does.  The counts
    are a scatter-add of ones, which is what JAX's ``bincount`` lowers to
    (``torch.bincount``'s output size depends on the data, so it cannot be
    traced)."""
    t, k = top_e.shape
    n = t * k
    dev = top_e.device
    flat_e = top_e.reshape(n)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(n)
    order = torch.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_tok[order]
    counts = torch.zeros(num_experts, dtype=se.dtype, device=dev
                         ).scatter_add(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts             # segment starts
    pos_in_e = torch.arange(n, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot = se * cap + torch.where(keep, pos_in_e, 0)
    return order, stok, keep, slot


def expert_ffn(cfg: ModelConfig, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The grouped expert GEMMs over the capacity buffer: [E, C, d] ->
    [E, C, d], each expert's rows through its own gated MLP (bf16 products
    accumulate in f32).  No expert's rows depend on another's."""
    act = activation(cfg.act)
    g = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    return torch.bmm(act(g) * u, p["we_down"])


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sort-based top-k MoE. x: [B, S, d] -> [B, S, d].

    1. route: logits -> top-k experts and weights per token;
    2. sort the (token, k) assignment list by expert (stable);
    3. scatter tokens into an [E * C, d] capacity buffer;
    4. grouped GEMMs over the expert axis;
    5. gather back and combine with the routing weights.

    Tokens beyond an expert's capacity are dropped (the residual path
    carries them).  The scatter-add into the buffer is exact in any order
    (a buffer row takes one token's row and zeros); each token's k rows
    come back by a gather and are summed by one reduction, so the output
    does not depend on the order of atomic adds."""
    if cfg.moe_ep_shardmap:
        raise NotImplementedError(
            f"{cfg.name}: moe_ep_shardmap (the expert-parallel dispatch) "
            "needs a model mesh axis, which is not ported yet (ROADMAP, "
            "Queue 1 item 10: tensor parallelism, the pod axis and sharded "
            "serving)")
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = mo.num_experts
    cap = _capacity(t, mo)
    xf = x.reshape(t, d)
    top_w, top_e = moe_route(cfg, p, xf)
    order, stok, keep, slot = moe_dispatch(top_e, e, cap)
    sw = top_w.reshape(-1)[order]

    # ---- scatter tokens into [E * C, d] ----
    buf = torch.zeros(e * cap, d, dtype=x.dtype, device=x.device).index_add_(
        0, slot, torch.where(keep[:, None], xf[stok], 0)).view(e, cap, d)
    y = expert_ffn(cfg, p, buf).view(e * cap, d)
    del buf   # at 16384 tokens of 256 experts: 2.3 GB in bf16

    # ---- gather back, weighted combine ----
    # each token's k rows gathered back in its top-k order (the sort undone
    # by a scatter of the slots and weights) and summed in one reduction:
    # atomic scatter-adds of bf16 rows would add a token's rows in an order
    # that varies from run to run (deepseek-v3's top-8 on an H100: prefill
    # logits 2e-3 apart)
    flat_slot = torch.empty_like(slot).scatter_(0, order, slot)
    flat_w = torch.empty_like(sw).scatter_(0, order, sw * keep)
    out = (y[flat_slot] * flat_w[:, None].to(x.dtype)).view(
        t, mo.top_k, d).sum(1)
    if mo.num_shared_experts:
        out = out + mlp_forward(cfg, p, xf, suffix="_shared")
    return out.view(b, s, d)


def moe_aux_loss(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    mo = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d).float()
    probs = torch.softmax(dense(xf, p["router"].float()), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, mo.num_experts).float().mean(0)
    frac_probs = probs.mean(0)
    return mo.num_experts * torch.sum(frac_tokens * frac_probs)
