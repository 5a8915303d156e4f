"""Linear split (paper §III-B(b), first algorithm).

Partitions the program into alternating communication and compute regions
following dependency (textual/execution) order.  All consecutive compute
ops between communication primitives form a single region — large regions,
minimal analysis overhead, maximal compiler scope for profiling estimators.

While loops are descended into only when their bodies contain collectives
(otherwise the whole loop is one compute op inside the current region);
body segments carry the loop trip count as ``repeat``.
"""
from __future__ import annotations

import itertools

from ..ir.graph import OpNode, Program, ZERO_COST_OPS
from .regions import ComputeRegion, Segment, finalize_region

_group_counter = itertools.count(1)

#: calls to :func:`linear_split` in this process — plan reuse means this
#: grows once per (workload, fidelity) per campaign, not once per job;
#: tests and benchmarks assert on it
SPLIT_CALLS = 0


def _has_collective(op: OpNode) -> bool:
    return any(o.is_collective and not o.is_async_done for o in op.walk())


def linear_split(program: Program, min_region_ops: int = 1) -> list[Segment]:
    global SPLIT_CALLS
    SPLIT_CALLS += 1
    segments: list[Segment] = []

    def flush(pending: list[OpNode], repeat: int, group: int) -> None:
        real = [op for op in pending
                if op.op not in ZERO_COST_OPS and not op.is_async_done]
        if not real:
            pending.clear()
            return
        region = finalize_region(ComputeRegion(ops=list(pending)), program)
        segments.append(Segment("COMP", region=region, repeat=repeat, group=group))
        pending.clear()

    def visit(ops: list[OpNode], repeat: int, group: int) -> None:
        from ..ir.collectives import comm_spec
        world = program.meta.get("num_partitions", 1)
        pending: list[OpNode] = []
        for op in ops:
            if op.op == "optimization_barrier":
                # explicit compiler-scope boundary: split without a COMM node
                flush(pending, repeat, group)
            elif op.is_collective and not op.is_async_done:
                flush(pending, repeat, group)
                segments.append(Segment(
                    "COMM", comm=comm_spec(op, world), repeat=repeat, group=group))
            elif op.op == "while" and _has_collective(op):
                flush(pending, repeat, group)
                body = op.regions[-1] if op.regions else []
                inner_group = next(_group_counter)
                visit(body, repeat * max(op.trip_count, 1), inner_group)
            else:
                pending.append(op)
        flush(pending, repeat, group)

    visit(program.entry, 1, 0)
    return segments
