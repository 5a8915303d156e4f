"""The per-rank program of a mesh: which dims of each leaf a rank holds,
and the collectives that move the leaves around the step.

The port's counterpart of what XLA's SPMD partitioner makes of the
reference's ``jax.jit`` over ``NamedSharding``s on a ``[data, model]`` or
``[pod, data, model]`` mesh.  Each parameter leaf is sharded over the
``data`` axis along the dim its logical axes map to (``embed`` -> ``data``:
ZeRO-3), over the ``model`` axis along its ``heads``, ``kv_heads``,
``mlp`` or ``vocab`` dim (``distributed/tensor_parallel.py`` runs the
layers on those shards), or replicated; no leaf is sharded over ``pod``.
A train step then (``train/loop.py::make_train_step``):

1. all-gathers each data-sharded leaf along its data dim, a layer-stacked
   leaf one layer at a time (as XLA re-gathers each layer's weights in the
   layer loop), so the model gets a list of layers for it; a dim sharded
   over ``model`` stays sharded;
2. takes the loss and its gradient with respect to the shards on the
   rank's rows of the batch (the batch's rows are split over ``(pod,
   data)``): the backward of each gather reduce-scatters the whole
   gradient it receives back to the shard as a sum over ``data``, so that
   a layer's whole gradient lives only while its backward runs;
3. all-reduces the loss as a mean over the pod and data ranks;
4. all-reduces each leaf's gradient that is whole on ``data`` as a sum
   over ``data``, then every gradient over ``pod``, and scales them to a
   mean over the pod and data ranks;
5. runs the optimizer on the shards, with the clip's global norm summed
   over the ranks that hold distinct pieces of each leaf
   (:meth:`DataParallel.global_norm`).

The collectives are ``torch.ops._c10d_functional`` operators, each followed
by its ``wait_tensor``: a trace on fake tensors keeps them as graph nodes
(the export writes them as StableHLO collectives), and eagerly they run on
the mesh's process groups (gloo, tested on the CPU; NCCL, untested; or the
``"fake"`` backend, which moves no data).  Means are sums scaled by 1/N in
the step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sharding import ShardingRules, axis_sizes, param_sharding, spec_axes

_C10D = torch.ops._c10d_functional


def data_group(mesh):
    """The process group of the mesh's ``data`` axis."""
    if "data" not in axis_sizes(mesh):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no 'data'")
    return mesh.get_group("data")


def axis_group(mesh, axis: str):
    """The process group of ``axis`` when the mesh has it above size 1,
    else None."""
    return mesh.get_group(axis) if axis_sizes(mesh).get(axis, 1) > 1 \
        else None


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


class _Gather(torch.autograd.Function):
    """:func:`all_gather` of a shard along ``dim``; backward the sum over
    the ranks of the whole gradient, the rank's block of it
    (:func:`reduce_scatter`)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Layout(NamedTuple):
    """Where a leaf is sharded: its dim over ``data`` (None: whole on that
    axis), whether its dim 0 stacks layers, and whether a dim of it is
    sharded over ``model``."""
    dim: int | None
    stacked: bool
    model: bool


class DataParallel:
    """The layout of a model's parameters on ``mesh``: for each leaf of
    the spec tree its :class:`_Layout`, and the collectives of the
    per-rank step over ``data`` and ``pod``."""

    def __init__(self, specs: dict, mesh, rules: ShardingRules | None = None):
        self.group = data_group(mesh)
        self.size = self.group.size()
        self.pod = axis_group(mesh, "pod")
        self.model = axis_group(mesh, "model")
        self.ranks = self.size * (self.pod.size() if self.pod else 1)
        # an axis of size 1 shards nothing and moves nothing
        split = {a for a, n in axis_sizes(mesh).items() if n > 1}

        def layout(spec):
            sharded = param_sharding(spec.axes, mesh, rules, spec.shape)
            axes = [set(spec_axes(sharded, i)) & split
                    for i in range(len(spec.shape))]
            dims = [i for i, a in enumerate(axes) if "data" in a]
            return _Layout(dims[0] if dims else None,
                           spec.axes[:1] == ("layers",),
                           any("model" in a for a in axes))

        def go(t):
            if isinstance(t, dict):
                return {k: go(v) for k, v in t.items()}
            return layout(t)
        self.dims = go(specs)

    def _map(self, fn, tree) -> dict:
        """``fn(leaf, layout)`` over a tree with the parameters'
        structure."""
        def go(t, dims):
            if isinstance(t, dict):
                return {k: go(v, dims[k]) for k, v in t.items()}
            return fn(t, dims)
        return go(tree, self.dims)

    def gather(self, shards: dict) -> dict:
        """The parameters whole along their data dims from the rank's
        shards; a data-sharded stacked leaf becomes the list of its
        layers.  Differentiable: the gradient that reaches a shard is the
        sum over the data ranks of its whole leaf's (or layer's)
        gradient, the rank's block of it."""
        def one(x, layout):
            dim, stacked = layout.dim, layout.stacked
            if dim is None:
                return x
            if stacked:
                # unbind: its backward stacks the layers' gradients in one
                # pass (a select a layer would build a zero-filled stacked
                # gradient for each)
                return [_Gather.apply(layer, dim - 1, self.group)
                        for layer in torch.unbind(x)]
            return _Gather.apply(x, dim, self.group)
        return self._map(one, shards)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the pod and data ranks of ``x``."""
        if self.size > 1:
            x = all_reduce(x, self.group)
        if self.pod is not None:
            x = all_reduce(x, self.pod)
        return x * (1.0 / self.ranks)

    def reduce_grads(self, grads: dict) -> dict:
        """The gradients with respect to the rank's shards, taken through
        :meth:`gather` (summed over ``data`` where a leaf is data-sharded)
        -> the mean over the pod and data ranks: a leaf whole on ``data``
        is all-reduced over it, then every leaf over ``pod``."""
        def one(g, layout):
            if layout.dim is None and self.size > 1:
                g = all_reduce(g, self.group)
            if self.pod is not None:
                g = all_reduce(g, self.pod)
            return g * inv
        inv = 1.0 / self.ranks
        return self._map(one, grads)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the gradients from the rank's shards: each
        leaf's sum of squares added over the ranks that hold distinct
        pieces of it (over ``data`` where its data dim is sharded, over
        ``model`` where a dim of it is), so that a leaf whole on an axis is
        counted once, not once a rank."""
        sums: dict = {}

        def add(g, layout):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            key = (layout.dim is not None, layout.model)
            sums[key] = sums[key] + sq if key in sums else sq
        self._map(add, grads)
        total = sums.get((False, False))
        if (True, False) in sums:
            total = _add(total, all_reduce(sums[True, False], self.group))
        over_model = sums.get((False, True))
        if (True, True) in sums:
            over_model = _add(over_model,
                              all_reduce(sums[True, True], self.group))
        if over_model is not None:
            total = _add(total, all_reduce(over_model, self.model))
        return torch.sqrt(total)


def _add(a, b):
    return b if a is None else a + b
