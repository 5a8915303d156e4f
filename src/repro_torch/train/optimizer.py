"""Optimizers as functions on nested dicts of tensors: AdamW and Adafactor
(factored second moments).

The counterpart of the JAX package's ``train/optimizer.py``, with its
arithmetic and dtypes: every update runs in f32, in the reference's order of
operations, and each result is cast back to its parameter's or moment's
dtype.  ``torch.optim`` is not used: its AdamW orders the arithmetic
differently.  AdamW takes one tensor at a time; the global norm and
Adafactor take a leaf larger than ``SLICE_ELEMENTS`` a slice of its leading
(layer, expert) dims at a time, so that their f32 temporaries stay within a
few such slices (deepseek-v3-671b's stacked expert leaves are 3.76 G
elements, 15 GB in f32).  With ``donate`` the results are written into the
given tensors.
"""
from __future__ import annotations

import math
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
    """``fn`` over the leaves of nested dicts and lists; ``rest`` has
    ``tree``'s structure (or ``tree`` as a prefix of it, as
    ``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
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


# the elements of a leaf the global norm and Adafactor take at a time, past
# which a leaf is cut into slices of its leading dims: 2^28, 1 GiB in f32
SLICE_ELEMENTS = 1 << 28


def _per_slice(shape, inner: int):
    """How many of a leaf's [*inner dims] matrices one slice takes, or None
    when the leaf is taken whole (it has at most SLICE_ELEMENTS elements,
    or no dim before its last ``inner``)."""
    if math.prod(shape) <= SLICE_ELEMENTS or len(shape) <= inner:
        return None
    return max(1, SLICE_ELEMENTS // math.prod(shape[len(shape) - inner:]))


def _slices(t: torch.Tensor, inner: int, n) -> list:
    """``t`` whole (``n`` None), or as views of ``n`` of its [*last ``inner``
    dims] matrices at a time, its leading dims flattened."""
    if n is None:
        return [t]
    return list(t.flatten(0, t.dim() - inner - 1).split(n))


def _global_norm(tree) -> torch.Tensor:
    """The f32 norm of all leaves, each leaf's squares summed a slice at a
    time (rows of a 2-D leaf, matrices of a stacked one)."""
    total = None
    for x in tree_leaves(tree):
        inner = 1 if x.dim() == 2 else 2
        for part in _slices(x, inner, _per_slice(x.shape, inner)):
            sq = torch.sum(torch.square(part.to(torch.float32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, global_norm=_global_norm):
    """Gradients scaled to a global norm of at most ``max_norm``, and that
    norm.  ``global_norm`` computes it from the tree (a mesh's step passes
    :meth:`repro_torch.distributed.DataParallel.global_norm`, which sums
    each leaf's squares over the ranks that hold distinct pieces of it)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def opt_state_abstract(specs, opt_name: str, mesh=None, rules=None):
    """Meta tensors (no storage) for the optimizer state, from ParamSpecs:
    the zero-allocation twin of ``adamw_init``/``adafactor_init``.  With a
    mesh the moments are one rank's shards: they take their parameter's
    layout (a fully sharded optimizer), and Adafactor's factored moments
    drop the corresponding axes, as in the reference."""
    from ..distributed.sharding import param_sharding, shard_shape

    def like(spec: ParamSpec, dtype="float32"):
        shape = spec.shape if mesh is None else shard_shape(
            spec.shape, param_sharding(spec.axes, mesh, rules, spec.shape),
            mesh)
        return torch.empty(shape, dtype=DTYPES[dtype], device="meta")

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
def adamw_update(params, grads, state, cfg: OptimizerConfig,
                 global_norm=_global_norm, donate: bool = False):
    """One AdamW step: (new params, new state, metrics).  With ``donate``
    the new parameters and moments are written into the given tensors,
    which are returned (the reference jits its step with
    ``donate_argnums=(0, 1)``): the caller must not read the old values,
    and a step then needs no second copy of the parameters and moments."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, global_norm)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        del gf   # each f32 temporary as soon as it is spent
        delta = m_new / c1 / (torch.sqrt(v_new / c2) + cfg.eps) + \
            cfg.weight_decay * p.to(torch.float32)
        if donate:
            m.copy_(m_new)
            v.copy_(v_new)
            del m_new, v_new
            return p.copy_(p.to(torch.float32) - lr * delta), m, v
        p_new = p.to(torch.float32) - lr * delta
        return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = _unzip(out, 3)
    if donate:
        state["step"].copy_(step)
        step = state["step"]
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
def adafactor_update(params, grads, state, cfg: OptimizerConfig,
                     donate: bool = False):
    """One Adafactor step: (new params, new state, metrics), in the
    reference's arithmetic, a slice of a leaf's leading dims at a time.
    The row and column means of a factored leaf's moments are exact per
    slice; the update's RMS clip spans the whole leaf, so a leaf takes two
    passes: the first sums each slice's squared update, the second
    recomputes each slice's update from the old moments and the gradient,
    clips it by that RMS and writes the slice's moments and parameter.  The
    global clip's scale is applied to each gradient slice as it is read.
    With ``donate`` the results are written into the given tensors, which
    are returned (as ``adamw_update``); otherwise they are new tensors, the
    same bits."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    decay = 1.0 - step.to(torch.float32) ** -0.8

    def update_of(g, v):
        """A slice's update and new f32 moments from its gradient ``g``
        (clipped here, as clip_by_global_norm would) and old moments."""
        gf = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        g2 = gf * gf + 1e-30
        if "vr" in v:
            vr = decay * v["vr"].to(torch.float32) + \
                (1 - decay) * g2.mean(dim=-1)
            vc = decay * v["vc"].to(torch.float32) + \
                (1 - decay) * g2.mean(dim=-2)
            del g2
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(dim=-1, keepdim=True)
                                       [..., None], 1e-30))
            return gf / torch.sqrt(denom + 1e-30), {"vr": vr, "vc": vc}
        vv = decay * v["v"].to(torch.float32) + (1 - decay) * g2
        del g2
        return gf / torch.sqrt(vv + 1e-30), {"v": vv}

    def upd(p, g, v):
        n = _per_slice(p.shape, 2)
        inner = {"vr": 1, "vc": 1, "v": 2}
        parts = list(zip(_slices(p, 2, n), _slices(g, 2, n),
                         *(_slices(v[k], inner[k], n) for k in v)))
        total = None
        for _, gs, *vs in parts:
            update, _ = update_of(gs, dict(zip(v, vs)))
            sq = torch.sum(update * update)
            total = sq if total is None else total + sq
            del update
        # update clipping (RMS <= 1) as in the Adafactor paper
        rms = torch.sqrt(total / p.numel() + 1e-30)
        out = {"p": [], **{k: [] for k in v}}
        for ps, gs, *vs in parts:
            update, moments = update_of(gs, dict(zip(v, vs)))
            update = update / torch.clamp_min(rms, 1.0)
            p_new = (ps.to(torch.float32) - lr * update
                     - lr * cfg.weight_decay * ps.to(torch.float32))
            del update
            for k, dst, x in (("p", ps, p_new),
                              *((k, d, moments[k]) for k, d in zip(v, vs))):
                if donate:
                    dst.copy_(x)
                else:
                    out[k].append(x.to(dst.dtype))
            del p_new, moments
        if donate:
            return p, v
        whole = {k: xs[0] if len(xs) == 1 else torch.cat(xs).view(like.shape)
                 for (k, xs), like in zip(out.items(), (p, *v.values()))}
        return whole.pop("p"), whole

    out = tree_map(upd, params, grads, state["v"])
    new_params, new_v = _unzip(out, 2)
    if donate:
        state["step"].copy_(step)
        step = state["step"]
    return new_params, {"step": step, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, adamw_update
    if cfg.name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(cfg.name)
