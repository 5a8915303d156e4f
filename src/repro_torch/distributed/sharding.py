"""Logical-axis sharding rules (MaxText-style) -> per-dim mesh axes.

The port's copy of the JAX package's ``distributed/sharding.py``.  Every
parameter and activation carries a tuple of *logical* axis names; rule
tables map logical names to mesh axes, and :func:`logical_to_spec` resolves
them for a mesh into a partition spec: a tuple with one entry per leading
dim, ``None`` (replicated), a mesh axis name, or a tuple of names (trailing
``None`` entries trimmed), as ``jax.sharding.PartitionSpec`` holds it.

A mesh here is anything with ``mesh_dim_names`` and ``shape``, such as a
``torch.distributed.device_mesh.DeviceMesh`` (``launch/mesh.py``).  The
port runs a mesh as a per-rank program (``train/loop.py``): each rank holds
the shards these specs describe and the step's collectives move them, so
there is no sharding constraint to place inside a step (see
:func:`constrain`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# default logical-axis -> mesh-axis rules. None = replicated.
# "data" shards FSDP/batch; "model" shards TP/EP dims; "pod" is the
# multi-pod data-parallel outer axis.
PARAM_RULES: dict[str, object] = {
    "layers": None,          # scan dimension, never sharded
    "embed": "data",         # ZeRO-3: params sharded over the data axis
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qk_dim": None,
    "v_dim": None,
    "mlp": "model",
    "experts": "model",      # expert parallelism
    "mlp_expert": None,
    "conv": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "lora": None,
    "norm": None,
}

ACT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qk_dim": None,
    "v_dim": None,
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "cache_seq": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
}

# long-context decode with batch=1: batch cannot use the data axis, so the
# KV-cache length / SSD chunk dimension takes it (sequence parallelism).
ACT_RULES_SEQ_SHARDED = dict(ACT_RULES, **{
    "batch": "pod",
    "cache_seq": "data",
    "seq": "data",
})


@dataclass
class ShardingRules:
    param_rules: dict = field(default_factory=lambda: dict(PARAM_RULES))
    act_rules: dict = field(default_factory=lambda: dict(ACT_RULES))

    def with_overrides(self, *, params: dict | None = None,
                       acts: dict | None = None) -> "ShardingRules":
        pr = dict(self.param_rules)
        ar = dict(self.act_rules)
        pr.update(params or {})
        ar.update(acts or {})
        return ShardingRules(pr, ar)


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> its size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _resolve(axes: tuple[str, ...], rules: dict, mesh,
             shape: tuple[int, ...] | None = None) -> tuple:
    """Map logical axes to mesh axes, dropping any mapping whose mesh-axis
    product does not evenly divide the dimension (a shard must tile its
    dim exactly; non-dividing dims — 40 heads or kv=8 on a 16-way model
    axis, vocab 50280, batch 1 — stay replicated on that axis)."""
    sizes = axis_sizes(mesh)
    parts = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        rule = rules.get(name)
        if rule is None:
            parts.append(None)
            continue
        entries = rule if isinstance(rule, tuple) else (rule,)
        picked = [e for e in entries if e in sizes and e not in used]
        if shape is not None:
            dim = shape[i]
            while picked:
                if dim % math.prod(sizes[e] for e in picked) == 0:
                    break
                picked.pop()          # drop trailing mesh axes until it fits
        used.update(picked)
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    # trim trailing Nones, as PartitionSpec is printed
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def logical_to_spec(axes: tuple[str, ...], rules: dict, mesh,
                    shape: tuple[int, ...] | None = None) -> tuple:
    return _resolve(axes, rules, mesh, shape)


def param_sharding(axes: tuple[str, ...], mesh,
                   rules: ShardingRules | None = None,
                   shape: tuple[int, ...] | None = None) -> tuple:
    r = (rules or ShardingRules()).param_rules
    return _resolve(axes, r, mesh, shape)


def act_sharding(axes: tuple[str, ...], mesh,
                 rules: ShardingRules | None = None,
                 shape: tuple[int, ...] | None = None) -> tuple:
    r = (rules or ShardingRules()).act_rules
    return _resolve(axes, r, mesh, shape)


def spec_axes(spec: tuple, dim: int) -> tuple[str, ...]:
    """The mesh axes that dim ``dim`` of a partition spec shards over."""
    entry = spec[dim] if dim < len(spec) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """One rank's shard of a tensor of ``shape`` laid out by ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(d // math.prod(sizes[a] for a in spec_axes(spec, i))
                 for i, d in enumerate(shape))


def shard_index(spec: tuple, dim: int, mesh) -> int:
    """This rank's block along dim ``dim``: its coordinates on the dim's
    mesh axes in mixed radix, the first axis major (as JAX tiles a dim
    over a tuple of axes)."""
    sizes = axis_sizes(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in spec_axes(spec, dim):
        index = index * sizes[a] + coords[a]
    return index


def shard_range(shape: tuple[int, ...], spec: tuple, dim: int,
                mesh) -> tuple[int, int]:
    """This rank's ``[start, stop)`` along dim ``dim`` of a tensor of
    ``shape`` laid out by ``spec`` (e.g. its block of the vocab or of the
    heads on the ``model`` axis)."""
    width = shard_shape(shape, spec, mesh)[dim]
    start = shard_index(spec, dim, mesh) * width
    return start, start + width


def constrain(x, axes: tuple[str, ...], rules: ShardingRules | None = None):
    """The reference's ``with_sharding_constraint`` by logical axes.  A
    no-op here: the port runs a mesh as a per-rank program, whose values
    are each rank's own (the step places its collectives explicitly), so
    there is no global layout to constrain."""
    return x
