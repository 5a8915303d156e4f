"""MLPs: gated (SwiGLU/GeGLU) dense blocks and the sort-based sparse MoE.

The MoE dispatch is the reference's: tokens are ordered by expert with a
stable sort and moved with gathers and scatter-adds (no FLOPs), and each
expert runs a capacity-padded grouped GEMM, so an export's ``dot_general``
FLOPs track the active experts (top-k), not all of them.  The grouped GEMMs
stay ``torch.bmm`` with f32 accumulation: the JAX package computes them
outside any Pallas kernel.  On a ``model`` mesh axis a rank runs the
reference's explicit expert-parallel dispatch (``moe_forward_ep``) whatever
``moe_ep_shardmap`` says: a per-rank program cannot sort the global batch's
assignments as XLA partitions the default path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.tensor_parallel import current
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


def _mlp_width(cfg: ModelConfig, suffix: str) -> int:
    """The whole width of the gated MLP named by ``suffix``: the dense
    block's ``d_ff``, or the MoE's shared experts side by side."""
    if not suffix:
        return cfg.d_ff
    mo = cfg.moe
    return (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared_experts


def _gated(cfg: ModelConfig, p: dict, x: torch.Tensor,
           suffix: str) -> torch.Tensor:
    g = activation(cfg.act)(dense(x, p[f"w_gate{suffix}"]))
    return dense(g * dense(x, p[f"w_up{suffix}"]), p[f"w_down{suffix}"])


def _mlp_split(cfg: ModelConfig, p: dict, suffix: str) -> bool:
    """Whether ``w_gate{suffix}`` holds the rank's block of its width (on a
    model axis that divides it)."""
    return p[f"w_gate{suffix}"].shape[-1] < _mlp_width(cfg, suffix)


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                suffix: str = "") -> torch.Tensor:
    """The gated MLP (``suffix`` ``"_shared"``: the MoE's shared experts).
    On a model axis (``w_gate`` holds the rank's block of the width) gate
    and up are column-parallel and down row-parallel: x enters through *f*,
    the output leaves through *g*."""
    if not _mlp_split(cfg, p, suffix):
        return _gated(cfg, p, x, suffix)
    tp = current()
    return tp.reduce(_gated(cfg, p, tp.copy(x), suffix))


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


def moe_dispatch(top_e: torch.Tensor, num_experts: int, cap: int,
                 discard: bool = False):
    """The (token, k) assignment list sorted by expert: the order, each
    slot's token, whether it fits its expert's capacity and its row in the
    [E * C] buffer.  The sort is stable, so an expert over capacity drops
    its last tokens in token order, as the reference's does.  With
    ``discard`` an expert id of ``num_experts`` is another rank's expert
    (the reference's discard bucket): sorted last, never kept.  The counts
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
    counts = torch.zeros(num_experts + discard, dtype=se.dtype, device=dev
                         ).scatter_add(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts             # segment starts
    pos_in_e = torch.arange(n, device=dev) - starts[se]
    keep = pos_in_e < cap
    if discard:
        mine = se < num_experts
        keep = keep & mine
        se = torch.where(mine, se, 0)
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


def _experts(cfg: ModelConfig, p: dict, xf: torch.Tensor, top_w, top_e,
             num_experts: int, discard: bool = False) -> torch.Tensor:
    """Steps 2 to 5 of :func:`moe_forward` for the tokens xf [T, d] routed
    to ``top_e`` [T, k] of the ``num_experts`` experts of ``p``'s ``we_*``
    (with ``discard`` an id of ``num_experts`` is none of them) -> [T, d].
    The capacity is reckoned from T and the config's expert count."""
    mo = cfg.moe
    t, d = xf.shape
    cap = _capacity(t, mo)
    order, stok, keep, slot = moe_dispatch(top_e, num_experts, cap, discard)
    sw = top_w.reshape(-1)[order]

    # ---- scatter tokens into [E * C, d] ----
    buf = torch.zeros(num_experts * cap, d, dtype=xf.dtype,
                      device=xf.device).index_add_(
        0, slot, torch.where(keep[:, None], xf[stok], 0)).view(
            num_experts, cap, d)
    y = expert_ffn(cfg, p, buf).view(num_experts * cap, d)
    del buf   # at 16384 tokens of 256 experts: 2.3 GB in bf16

    # ---- gather back, weighted combine ----
    # each token's k rows gathered back in its top-k order (the sort undone
    # by a scatter of the slots and weights) and summed in one reduction:
    # atomic scatter-adds of bf16 rows would add a token's rows in an order
    # that varies from run to run (deepseek-v3's top-8 on an H100: prefill
    # logits 2e-3 apart)
    flat_slot = torch.empty_like(slot).scatter_(0, order, slot)
    flat_w = torch.empty_like(sw).scatter_(0, order, sw * keep)
    return (y[flat_slot] * flat_w[:, None].to(xf.dtype)).view(
        t, mo.top_k, d).sum(1)


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
    does not depend on the order of atomic adds.

    On a model axis that divides the experts or ``d_ff_expert`` a rank runs
    :func:`moe_forward_ep`.  Elsewhere (one device, a data mesh, an axis
    that divides neither) the MoE is computed whole, ``moe_ep_shardmap`` or
    not, as the reference falls back to this function."""
    tp = current()
    if tp is not None and tp.moe_scheme(cfg.moe) is not None:
        return moe_forward_ep(cfg, p, x)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_w, top_e = moe_route(cfg, p, xf)
    out = _experts(cfg, p, xf, top_w, top_e, cfg.moe.num_experts)
    if cfg.moe.num_shared_experts:
        out = out + mlp_forward(cfg, p, xf, suffix="_shared")
    return out.view(b, s, d)


def moe_forward_ep(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """One model rank's MoE, the reference's ``moe_forward_ep``: the rank's
    tokens x [B, S, d] (its rows over ``(pod, data)``, whole over
    ``model``) -> [B, S, d].

    x enters the model-parallel region through *f*.  Routing takes every
    expert's score on the rank's tokens: scheme ``"expert"`` gathers the
    router's columns (their gradient summed over the model ranks), scheme
    ``"ffn"`` holds the router whole.  The capacity is reckoned from the
    rank's tokens (``moe_forward_ep``'s ``t_local``).  Scheme ``"expert"``:
    capacity buffers for the rank's E/M experts only, an assignment to
    another rank's expert going to the discard bucket.  Scheme ``"ffn"``:
    every expert on the rank's block of ``d_ff_expert``.  The partial token
    outputs (with a split shared expert's) are summed over the model ranks
    (*g*); a shared expert whole on the axis is added after."""
    tp = current()
    scheme = tp.moe_scheme(cfg.moe)
    mo = cfg.moe
    b, s, d = x.shape
    x0 = x.reshape(b * s, d)
    xf = tp.copy(x0)
    if scheme == "expert":
        router = tp.gather_columns(p["router"])
        local = p["we_gate"].shape[0]
        experts = p
    else:
        router = tp.copy(p["router"])
        local = mo.num_experts
        f = mo.d_ff_expert // tp.size
        experts = {"we_gate": tp.block(p["we_gate"], 2, f),
                   "we_up": tp.block(p["we_up"], 2, f),
                   "we_down": tp.block(p["we_down"], 1, f)}
    top_w, top_e = moe_route(cfg, {"router": router}, xf)
    if scheme == "expert":
        # the rank holds experts [m * local, (m + 1) * local)
        top_e = top_e - tp.index(top_e) * local
        top_e = torch.where((top_e >= 0) & (top_e < local), top_e, local)
    out = _experts(cfg, experts, xf, top_w, top_e, local,
                   discard=scheme == "expert")
    split = mo.num_shared_experts and _mlp_split(cfg, p, "_shared")
    if split:
        out = out + _gated(cfg, p, xf, "_shared")
    out = tp.reduce(out)
    if mo.num_shared_experts and not split:
        out = out + _gated(cfg, p, x0, "_shared")
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
