"""Optimizers as functions on nested dicts of tensors: AdamW and Adafactor
(factored second moments).

The counterpart of the JAX package's ``train/optimizer.py``, with its
arithmetic and dtypes: every update runs in f32, in the reference's order of
operations, and each result is cast back to its parameter's or moment's
dtype.  ``torch.optim`` is not used: its AdamW orders the arithmetic
differently.  The update takes one tensor at a time with fresh outputs, so
its temporaries stay within a few copies of the largest parameter.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.params import DTYPES, ParamSpec, is_spec


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    # adafactor
    min_dim_size_to_factor: int = 128


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts; ``rest`` has ``tree``'s
    structure (or ``tree`` as a prefix of it, as ``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _unzip(out, n: int):
    """A tree whose leaves are n-tuples -> n trees."""
    def pick(i):
        def go(t):
            if isinstance(t, tuple):
                return t[i]
            return {k: go(v) for k, v in t.items()}
        return go(out)
    return tuple(pick(i) for i in range(n))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                           1.0)
    return cfg.learning_rate * warm


def _global_norm(tree) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def opt_state_abstract(specs, opt_name: str, mesh=None, rules=None):
    """Meta tensors (no storage) for the optimizer state, from ParamSpecs:
    the zero-allocation twin of ``adamw_init``/``adafactor_init``.  On one
    card there is no sharding to carry (``mesh`` waits for ROADMAP, Queue 1
    item 5)."""
    if mesh is not None or rules is not None:
        raise NotImplementedError("opt_state_abstract: sharded state waits "
                                  "for the distribution slice (ROADMAP, "
                                  "Queue 1 item 5)")

    def like(spec: ParamSpec, dtype="float32"):
        return torch.empty(spec.shape, dtype=DTYPES[dtype], device="meta")

    def over(fn):
        def go(t):
            if is_spec(t):
                return fn(t)
            return {k: go(v) for k, v in t.items()}
        return go(specs)

    step = torch.empty((), dtype=torch.int32, device="meta")
    if opt_name == "adamw":
        return {"step": step, "m": over(like), "v": over(like)}

    def fac(spec: ParamSpec):
        if len(spec.shape) >= 2 and spec.shape[-1] >= 128 \
                and spec.shape[-2] >= 128:
            vr = ParamSpec(spec.shape[:-1], spec.axes[:-1], dtype="float32")
            vc = ParamSpec((*spec.shape[:-2], spec.shape[-1]),
                           (*spec.axes[:-2], spec.axes[-1]), dtype="float32")
            return {"vr": like(vr), "vc": like(vc)}
        return {"v": like(spec)}

    return {"step": step, "v": over(fac)}


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw_init(params, cfg: OptimizerConfig):
    dt = DTYPES[cfg.state_dtype]
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
    }


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mh = m_new / c1
        vh = v_new / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = _unzip(out, 3)
    return new_params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# Adafactor (factored second moment: O(n+m) state for an n x m matrix)
# --------------------------------------------------------------------------

def _factored(shape, min_size) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def adafactor_init(params, cfg: OptimizerConfig):
    dt = DTYPES[cfg.state_dtype]

    def one(p):
        if _factored(p.shape, cfg.min_dim_size_to_factor):
            return {"vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                    "vc": torch.zeros((*p.shape[:-2], p.shape[-1]), dtype=dt,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "v": tree_map(one, params)}


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptimizerConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    decay = 1.0 - step.to(torch.float32) ** -0.8

    def upd(p, g, v):
        gf = g.to(torch.float32)
        g2 = gf * gf + 1e-30
        if "vr" in v:
            vr = decay * v["vr"].to(torch.float32) + \
                (1 - decay) * g2.mean(dim=-1)
            vc = decay * v["vc"].to(torch.float32) + \
                (1 - decay) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(dim=-1, keepdim=True)
                                       [..., None], 1e-30))
            update = gf / torch.sqrt(denom + 1e-30)
            new_v = {"vr": vr.to(v["vr"].dtype), "vc": vc.to(v["vc"].dtype)}
        else:
            vv = decay * v["v"].to(torch.float32) + (1 - decay) * g2
            update = gf / torch.sqrt(vv + 1e-30)
            new_v = {"v": vv.to(v["v"].dtype)}
        # update clipping (RMS <= 1) as in the Adafactor paper
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        p_new = (p.to(torch.float32)
                 - lr * update - lr * cfg.weight_decay * p.to(torch.float32))
        return p_new.to(p.dtype), new_v

    out = tree_map(upd, params, grads, state["v"])
    new_params, new_v = _unzip(out, 2)
    return new_params, {"step": step, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, adamw_update
    if cfg.name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(cfg.name)
