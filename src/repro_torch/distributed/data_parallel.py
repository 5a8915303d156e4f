"""The per-rank program of a data mesh: which dim of each leaf a rank holds,
and the collectives that move the leaves around the step.

The port's counterpart of what XLA's SPMD partitioner makes of the
reference's ``jax.jit`` over ``NamedSharding``s on a ``[N, 1]`` mesh.  Each
parameter leaf is sharded over the ``data`` axis along the dim its logical
axes map to (``embed`` -> ``data``: ZeRO-3), or replicated.  A train step
then (``train/loop.py::make_train_step``):

1. all-gathers each sharded leaf along its dim, a layer-stacked leaf one
   layer at a time (as XLA re-gathers each layer's weights in the layer
   loop), so the model gets a list of layers for it;
2. takes the loss and its gradient on the rank's rows of the batch;
3. all-reduces the loss as a mean over the ranks;
4. reduce-scatters each sharded leaf's gradient back to its shard as a
   mean (a layer at a time for a stacked leaf), and all-reduces each
   replicated leaf's gradient as a mean;
5. runs the optimizer on the shards, with the clip's global norm summed
   over the shards (:meth:`DataParallel.global_norm`).

The collectives are ``torch.ops._c10d_functional`` operators, each followed
by its ``wait_tensor``: a trace on fake tensors keeps them as graph nodes
(the export writes them as StableHLO collectives), and eagerly they run on
the mesh's process group (gloo, tested on the CPU; NCCL, untested; or the
``"fake"`` backend, which moves no data).  Means are sums scaled by 1/N in the step.
"""
from __future__ import annotations

import torch

from .sharding import ShardingRules, axis_sizes, param_sharding, spec_axes

_C10D = torch.ops._c10d_functional


def data_group(mesh):
    """The process group of the mesh's ``data`` axis.  Any other axis of
    size above 1 raises: only the data-parallel half of the reference's
    distribution layer is ported."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no 'data'")
    for axis, n in sizes.items():
        if axis != "data" and n > 1:
            raise NotImplementedError(
                f"a {axis!r} axis of size {n}: tensor parallelism and the "
                "pod axis are not ported yet (ROADMAP, Queue 1: tensor "
                "parallelism, the pod axis and sharded serving)")
    return mesh.get_group("data")


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim``, in rank order."""
    n = group.size()
    y = _C10D.wait_tensor(_C10D.all_gather_into_tensor(
        x.contiguous(), n, group.group_name))
    return torch.cat(torch.chunk(y, n, 0), dim) if dim else y


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's block of it along
    ``dim``."""
    n = group.size()
    if dim:
        x = torch.cat(torch.chunk(x, n, dim), 0)
    return _C10D.wait_tensor(_C10D.reduce_scatter_tensor(
        x.contiguous(), "sum", n, group.group_name))


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``x``."""
    return _C10D.wait_tensor(_C10D.all_reduce(x, "sum", group.group_name))


class DataParallel:
    """The data-parallel layout of a model's parameters on ``mesh``: for
    each leaf of the spec tree, the dim it is sharded along over ``data``
    (None: replicated) and whether its dim 0 stacks layers, and the
    collectives of the per-rank step."""

    def __init__(self, specs: dict, mesh, rules: ShardingRules | None = None):
        self.group = data_group(mesh)
        self.size = self.group.size()

        def dim_of(spec):
            layout = param_sharding(spec.axes, mesh, rules, spec.shape)
            dims = [i for i in range(len(spec.shape))
                    if "data" in spec_axes(layout, i)]
            return (dims[0] if dims else None,
                    spec.axes[:1] == ("layers",))

        def go(t):
            if isinstance(t, dict):
                return {k: go(v) for k, v in t.items()}
            return dim_of(t)
        self.dims = go(specs)

    def _map(self, fn, tree) -> dict:
        """``fn(leaf, (dim, stacked))`` over a tree with the parameters'
        structure."""
        def go(t, dims):
            if isinstance(t, dict):
                return {k: go(v, dims[k]) for k, v in t.items()}
            return fn(t, dims)
        return go(tree, self.dims)

    def gather(self, shards: dict) -> dict:
        """The whole parameters from the rank's shards; a sharded stacked
        leaf becomes the list of its layers."""
        def one(x, layout):
            dim, stacked = layout
            if dim is None:
                return x
            if stacked:
                return [all_gather(x[i], dim - 1, self.group)
                        for i in range(x.shape[0])]
            return all_gather(x, dim, self.group)
        return self._map(one, shards)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``x``."""
        return all_reduce(x, self.group) * (1.0 / self.size)

    def reduce_grads(self, grads: dict) -> dict:
        """Whole gradients (a list of layers for a sharded stacked leaf,
        as :meth:`gather` gives it) -> the mean over the ranks, as the
        rank's shard of each sharded leaf and whole for each replicated
        leaf."""
        def one(g, layout):
            dim, stacked = layout
            if dim is None:
                return all_reduce(g, self.group) * inv
            if stacked:
                return torch.stack([reduce_scatter(x, dim - 1, self.group)
                                    for x in g]) * inv
            return reduce_scatter(g, dim, self.group) * inv
        inv = 1.0 / self.size
        return self._map(one, grads)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the gradients from the rank's shards: the
        sharded leaves' sums of squares added over the ranks, each
        replicated leaf (whole on every rank) counted once."""
        sums = {True: None, False: None}

        def add(g, layout):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            key = layout[0] is not None
            sums[key] = sq if sums[key] is None else sums[key] + sq
        self._map(add, grads)
        total = sums[False]
        if sums[True] is not None:
            sharded = all_reduce(sums[True], self.group)
            total = sharded if total is None else sharded + total
        return torch.sqrt(total)
