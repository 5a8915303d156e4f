"""The ``model`` axis of a mesh: Megatron-style tensor parallelism for the
dense and MLA attention, the dense MLP and the Mamba2 layer, and expert
parallelism for the sparse MoE.

The port's counterpart of what XLA's SPMD partitioner makes of the
reference's ``PARAM_RULES``/``ACT_RULES`` on a ``model`` axis: ``heads``,
``kv_heads``, ``mlp``, ``experts`` and ``vocab`` are sharded over it, the
residual stream, the norms and MLA's latent projections (``lora``) are
whole on every model rank.  A rank at model coordinate m runs:

* GQA attention column-parallel over its query heads (and over its kv
  heads where ``kv_heads`` divides; otherwise it computes every kv head
  and takes the ones its query heads read, :meth:`TensorParallel.kv_heads`),
  the output projection row-parallel;
* MLA's down projections and their norms whole, the latents entering the
  region of its heads' up projections, K1 over its heads, the output
  projection row-parallel;
* the MLP's gate and up column-parallel, its down projection
  row-parallel (the MoE's shared expert too);
* the MoE as the reference's ``moe_forward_ep`` does on a rank
  (:meth:`TensorParallel.moe_scheme`): routing on the rank's tokens with
  every expert's score, then either its E/M experts' capacity buffers from
  its tokens (``"expert"``) or every expert on its block of
  ``d_ff_expert`` (``"ffn"``), the partial token outputs summed over the
  model ranks;
* a Mamba2 layer over its SSM heads (``models/ssm.py``): the input
  projection over its block of the packed [z, x, B, C, dt] columns, the
  blocks gathered (:meth:`TensorParallel.gather_columns`) and the rank's
  z, x and dt with B and C whole taken from them, the conv over its x
  channels and B and C, K3 over its heads, the gated norm over its block of
  the row with each row's sums added over the model ranks
  (:meth:`TensorParallel.sum_rows`, the split-row K2 and K2b), the output
  projection row-parallel; where the axis does not divide the heads the
  layer runs whole on every model rank (:meth:`TensorParallel.whole`);
* the embedding over its vocab rows (:meth:`TensorParallel.embed`), the
  head's logits over its vocab columns and a vocab-parallel
  cross-entropy (:meth:`TensorParallel.cross_entropy`).

Two operators join the regions (Megatron's *f* and *g*):
:meth:`TensorParallel.copy` is the identity forward and an all-reduce of
the gradient backward; :meth:`TensorParallel.reduce` an all-reduce forward
and the identity backward.  The router's columns are gathered with a
summed backward (:meth:`TensorParallel.gather_columns`), and a leaf whole
on the axis is cut to the rank's block with a gathered backward
(:meth:`TensorParallel.block`).  A dim its axis does not divide stays whole
(the reference's ``_resolve``), and the model code then runs that part
unsharded: each model function compares a weight's local shape with the
config's to see what is sharded.

The collectives are ``torch.ops._c10d_functional`` operators (which have
no autograd of their own), so a trace keeps them as nodes.  What differs
from rank to rank (the vocab offset, the kv heads a rank reads, the global
index of a padded head, the rank's experts) is computed from
:meth:`TensorParallel.index`, the rank's model coordinate as a tensor:
eagerly the process's own, in an export ``stablehlo.partition_id``, so one
per-rank text serves every rank.

The model functions find the active instance with :func:`current`; the
per-rank step and forward (``train/loop.py``) set it with :func:`active`.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..library import define_rank_op
from .sharding import axis_sizes

_C10D = torch.ops._c10d_functional


def _axis_index(like: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    import torch.distributed as dist

    return torch.tensor((dist.get_rank() // stride) % size,
                        dtype=torch.int64, device=like.device)


#: ``axis_index(like, size, stride)``: the calling rank's coordinate on a
#: mesh axis of ``size`` whose neighbours' global ranks are ``stride``
#: apart, a 0-d int64 tensor on ``like``'s device
AXIS_INDEX = define_rank_op(
    "axis_index(Tensor like, int size, int stride) -> Tensor", _axis_index,
    lambda like, size, stride: torch.empty((), dtype=torch.int64,
                                           device=like.device))

def for_mesh(cfg, mesh) -> "TensorParallel | None":
    """The model axis of ``mesh`` for ``cfg``'s per-rank program (every
    family has one), or None when the mesh has no ``model`` axis above
    1."""
    if axis_sizes(mesh).get("model", 1) <= 1:
        return None
    return TensorParallel(mesh)


def _all_reduce(x: torch.Tensor, op: str, group: str) -> torch.Tensor:
    return _C10D.wait_tensor(_C10D.all_reduce(x.contiguous(), op, group))


class _Copy(torch.autograd.Function):
    """Megatron's *f*: identity forward, gradient all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' blocks of the last dim joined, in rank order; backward
    the sum over the ranks of the whole's gradient, the rank's block of it
    (a reduce-scatter): each rank's gradient of the whole is a partial."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = _C10D.wait_tensor(_C10D.all_gather_into_tensor(
            x.contiguous(), size, group))
        return torch.cat(torch.chunk(y, size, 0), -1)

    @staticmethod
    def backward(ctx, g):
        g = torch.cat(torch.chunk(g, ctx.size, -1), 0)
        return _C10D.wait_tensor(_C10D.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.size, ctx.group)), None, None


class _Whole(torch.autograd.Function):
    """The ranks' blocks along ``dim`` joined, in rank order (an
    all-gather); backward the rank's block of the gradient: every model
    rank computes the same from the whole, so each rank's gradient of it is
    already whole (Megatron's gather)."""

    @staticmethod
    def forward(ctx, x, index, dim, group, size):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        y = _C10D.wait_tensor(_C10D.all_gather_into_tensor(
            x.movedim(dim, 0).contiguous(), size, group))
        return y.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        rows = ctx.index * ctx.width + torch.arange(ctx.width,
                                                    device=g.device)
        return torch.index_select(g, ctx.dim, rows), None, None, None, None


class _Block(torch.autograd.Function):
    """The rank's block (``index``) along ``dim`` of a leaf whole on the
    model axis; backward the ranks' blocks of the gradient joined along
    ``dim`` (an all-gather): only rank m reads block m, so the whole leaf
    gets its whole gradient, equal on every rank."""

    @staticmethod
    def forward(ctx, x, index, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return torch.index_select(x, dim, index)

    @staticmethod
    def backward(ctx, g):
        y = _C10D.wait_tensor(_C10D.all_gather_into_tensor(
            g.movedim(ctx.dim, 0).contiguous(), ctx.size, ctx.group))
        return y.movedim(0, ctx.dim), None, None, None, None


class TensorParallel:
    """The ``model`` axis of ``mesh``: its process group, its size and the
    rank's coordinate on it, and the per-rank pieces of the layers."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        shape = tuple(mesh.shape)
        axis = names.index("model")
        self.size = shape[axis]
        self.stride = math.prod(shape[axis + 1:])
        self.group = mesh.get_group("model").group_name
        self._eager: dict = {}

    # -- the rank's coordinate ----------------------------------------------

    def index(self, like: torch.Tensor) -> torch.Tensor:
        """The rank's model coordinate, a 0-d int64 tensor on ``like``'s
        device: the operator inside a trace (so the text reads it from
        ``partition_id``), a cached tensor otherwise."""
        if torch._C._dispatch_tls_is_dispatch_key_included(
                torch._C.DispatchKey.Python):
            return AXIS_INDEX(like, self.size, self.stride)
        key = like.device
        if key not in self._eager:
            self._eager[key] = _axis_index(like, self.size, self.stride)
        return self._eager[key]

    # -- f, g and the max ---------------------------------------------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Enter a model-parallel region (*f*)."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Leave one: the sum over the model ranks (*g*)."""
        return _Reduce.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest over the model ranks, elementwise (no gradient)."""
        return _all_reduce(x.detach(), "max", self.group)

    # -- the MoE --------------------------------------------------------------

    def moe_scheme(self, moe) -> str | None:
        """How a rank runs the MoE of ``moe`` (a ``MoEConfig``), as the
        reference's ``moe_forward_ep`` chooses: ``"expert"`` where the axis
        divides the experts (the rank holds E/M of them, as the rules lay
        them out), ``"ffn"`` where it divides ``d_ff_expert`` instead
        (every expert whole on the rank, which runs its block of
        ``d_ff_expert``), None where it divides neither (the MoE whole on
        every model rank, no collective)."""
        if moe.num_experts % self.size == 0:
            return "expert"
        if moe.d_ff_expert % self.size == 0:
            return "ffn"
        return None

    def gather_columns(self, w: torch.Tensor) -> torch.Tensor:
        """The whole of ``w`` from the rank's block of its last dim (the
        router's experts).  Backward the ranks' gradients are summed: a
        rank's dispatch takes only its own experts, so its gradient with
        respect to the whole router is a partial (Megatron's gather, which
        keeps the rank's own slice, would drop the others' terms)."""
        return _GatherColumns.apply(w, self.group, self.size)

    def block(self, w: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        """The rank's block of ``width`` along ``dim`` of ``w``, a leaf
        whole on the model axis (scheme ``"ffn"``'s experts), whose
        gradient is then whole and equal on every rank."""
        index = self.index(w) * width + torch.arange(width, device=w.device)
        return _Block.apply(w, index, dim, self.group, self.size)

    def whole(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of ``w`` from the rank's block along ``dim``, for a
        part that every model rank computes alike (a Mamba2 layer whose
        heads the axis does not divide); backward the rank's block of the
        gradient."""
        return _Whole.apply(w, self.index(w), dim, self.group, self.size)

    # -- the split-row norm ---------------------------------------------------

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model ranks of a tensor of row sums (a norm's
        over a row split over them; no gradient)."""
        return _all_reduce(x.detach(), "sum", self.group)

    # -- attention ------------------------------------------------------------

    def global_heads(self, local: int, like: torch.Tensor) -> torch.Tensor:
        """The global indices of the rank's ``local`` query heads."""
        return self.index(like) * local + torch.arange(local,
                                                       device=like.device)

    def kv_heads(self, k: torch.Tensor, heads: int, local: int) -> torch.Tensor:
        """From every kv head of ``k`` [B, S, kv, D] (``kv_heads`` whole on
        the model axis), the ones the rank's ``local`` of ``heads`` query
        heads read, in GQA order: query head h reads kv head
        h // (heads / kv).  When the rank's heads do not make whole groups
        of one size, each query head gets its own kv head (a group of 1)."""
        kv = k.shape[2]
        group = heads // kv
        m = self.index(k)
        if local % group == 0:          # whole groups: local / group heads
            n = local // group
            idx = m * n + torch.arange(n, device=k.device)
        elif group % local == 0:        # inside one group: one kv head
            idx = (m * local // group).reshape(1)
        else:
            idx = self.global_heads(local, k) // group
        # the kv dim first: its gradient is then an index_put along dim 0
        return torch.index_select(k.movedim(2, 0), 0, idx).movedim(0, 2)

    # -- embedding, head and loss --------------------------------------------

    def _local(self, ids: torch.Tensor, width: int):
        """``ids`` relative to the rank's block of ``width`` vocab entries,
        clamped into it, and whether each lies in it."""
        local = ids.long() - self.index(ids) * width
        inside = (local >= 0) & (local < width)
        return torch.clamp(local, 0, width - 1), inside

    def embed(self, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The embedding from the rank's vocab rows of ``table``: each rank
        looks up the tokens in its range, zeros for the others, and the
        rows are summed over the model ranks."""
        local, inside = self._local(tokens, table.shape[0])
        rows = torch.where(inside[..., None], table[local],
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device))
        return self.reduce(rows)

    def cross_entropy(self, logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Softmax cross-entropy over vocab-sharded f32 logits [B, S, V/M],
        mean over tokens: the max, the sum of exponentials and the target's
        logit each reduced over the model ranks."""
        logits = logits.float()
        m = self.max(torch.amax(logits, dim=-1))
        total = self.reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
        local, inside = self._local(targets, logits.shape[-1])
        gold = torch.gather(logits, -1, local[..., None])[..., 0]
        gold = self.reduce(torch.where(inside, gold, 0.0))
        return (m + torch.log(total) - gold).mean()

    def combine_chunks(self, m: torch.Tensor, l: torch.Tensor,
                       gold: torch.Tensor) -> torch.Tensor:
        """A streaming cross-entropy's running max ``m``, sum of
        exponentials ``l`` (against ``m``) and target logit ``gold`` (0
        where the target is not in the rank's vocab block) over the rank's
        block -> the log-sum-exp minus the target logit over the whole
        vocab."""
        top = self.max(m)
        total = self.reduce(l * torch.exp(m - top))
        return top + torch.log(total) - self.reduce(gold)

    def target_in_block(self, targets: torch.Tensor,
                        width: int) -> torch.Tensor:
        """``targets`` relative to the rank's vocab block of ``width``
        entries (out of ``[0, width)`` where the target is another
        rank's)."""
        return targets.long() - self.index(targets) * width


_ACTIVE: list = [None]


@contextlib.contextmanager
def active(tp: TensorParallel | None):
    """Run the model functions inside the block as ``tp``'s model ranks
    (None: unsharded)."""
    before = _ACTIVE[0]
    _ACTIVE[0] = tp
    try:
        yield tp
    finally:
        _ACTIVE[0] = before


def current() -> TensorParallel | None:
    """The :class:`TensorParallel` of the running per-rank program, or
    None."""
    return _ACTIVE[0]
