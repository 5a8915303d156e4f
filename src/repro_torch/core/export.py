"""Trace a step into a functional ATen graph without device memory.

The counterpart of ``jax.jit(f).lower(*specs)``: :func:`trace` turns the
abstract arguments (meta tensors, e.g. from
:func:`repro_torch.train.loop.train_step_exports`) into fake tensors on the
export's device and traces ``fn`` twice with ``make_fx``:

1. as written, autograd included (a train step's ``torch.autograd.grad``
   is traced through the kernels' backward operators);
2. that graph again under ``functionalize``, with PyTorch's core-ATen
   decompositions: no in-place op and no view is left, so every node is a
   function of its operands' values.

The port's operators (``repro_torch.library``) stay one node per call: a
fake tensor runs only an operator's fake, so nothing launches, no pointer
is read and no launch counter moves.  For each distinct call (operator,
shapes, dtypes and scalar arguments) :func:`trace` also traces the
operator's plain version the same way; the emitter writes it as a private
function that each such call calls, so the text holds the math each kernel
computes in ops the estimators cost.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import torch
from torch._decomp import core_aten_decompositions
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from ..device import resolve_device
# the kernels' modules and the models' define their operators on import
from ..kernels.flash_attention import ops as _k1  # noqa: F401
from ..kernels.rmsnorm import ops as _k2  # noqa: F401
from ..kernels.ssd_scan import ops as _k3  # noqa: F401
from ..library import PLAIN
from ..models import common as _common  # noqa: F401

DECOMPOSITIONS = core_aten_decompositions()
BARRIER = torch.ops.repro_torch.barrier.default


@dataclass
class Traced:
    """A traced step: the functional graph (its inputs and outputs are the
    flattened argument and result trees), one plain-version graph per
    distinct operator call (``node.meta["plain"]`` names it), the count of
    each operator's nodes, and the seconds the trace took."""
    graph: torch.fx.GraphModule
    plain: dict[str, torch.fx.GraphModule]
    op_counts: dict[str, int]
    seconds: float


def _functional(fn, args) -> torch.fx.GraphModule:
    """``fn`` traced as written, then its graph traced again under
    ``functionalize`` with the core-ATen decompositions (functionalize
    cannot take autograd or Python's in-place operators directly)."""
    eager = make_fx(fn, tracing_mode="fake")(*args)
    return make_fx(
        torch.func.functionalize(eager, remove="mutations_and_views"),
        decomposition_table=DECOMPOSITIONS, tracing_mode="fake")(*args)


def _call_key(node: torch.fx.Node) -> str:
    """Calls that share this key share one plain-version function: the
    operator, its tensors' shapes and dtypes, and its other arguments."""
    return repr((node.target._schema.name,
                 [(tuple(a.meta["val"].shape), a.meta["val"].dtype)
                  if isinstance(a, torch.fx.Node) else a
                  for a in node.args]))


def _plain_graph(node: torch.fx.Node) -> torch.fx.GraphModule:
    """The plain version of an operator call, as a functional graph of the
    call's tensor arguments."""
    op, args = node.target, list(node.args)
    slots = [i for i, a in enumerate(args) if isinstance(a, torch.fx.Node)]

    def plain(*tensors):
        full = list(args)
        for i, t in zip(slots, tensors):
            full[i] = t
        return PLAIN[op](*full)

    return _functional(plain, [args[i].meta["val"] for i in slots])


def trace(fn, *abstract_args, device=None) -> Traced:
    """Trace ``fn(*abstract_args)`` on fake tensors on ``device`` (None:
    the card).  The abstract arguments are trees (dicts) of tensors whose
    shapes and dtypes are all that is read, e.g. meta tensors."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    with FakeTensorMode() as mode:
        fake = pytree.tree_map_only(
            torch.Tensor,
            lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
            abstract_args)
    leaves, in_spec = pytree.tree_flatten(fake)

    def flat(*xs):
        return pytree.tree_leaves(fn(*pytree.tree_unflatten(list(xs),
                                                           in_spec)))

    with mode:
        graph = _functional(flat, leaves)
        plain: dict[str, torch.fx.GraphModule] = {}
        counts: Counter = Counter()
        for node in graph.graph.nodes:
            if node.op == "call_function" and node.target in PLAIN:
                counts[node.target._schema.name.split("::")[1]] += 1
                if node.target is BARRIER:
                    continue
                key = node.meta["plain"] = _call_key(node)
                if key not in plain:
                    plain[key] = _plain_graph(node)
    return Traced(graph, plain, dict(counts), time.perf_counter() - t0)
