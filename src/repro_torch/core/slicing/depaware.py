"""Dependency-aware split (paper §III-B(b), second algorithm).

Operates at individual-operator granularity, capturing exact data
dependencies.  Produces smaller compute regions plus an explicit dependency
graph, which lets the network scheduler expose compute–communication
overlap that the linear split's total order hides.

Returns (segments, deps) where deps maps segment index -> set of segment
indices it depends on.  Loop bodies are unrolled; each iteration's entry
segments depend on the previous iteration's tail segments (loop-carried
values have no SSA producer, so name-based deps alone would be unsound).

Zero-cost ops (get_tuple_element, tuple, reshape-free metadata ops) never
become segments, but dependencies must still flow *through* them — they are
treated as aliases: their results inherit the producer set of their operands.
"""
from __future__ import annotations

from ..ir.collectives import comm_spec
from ..ir.graph import OpNode, Program, ZERO_COST_OPS
from .regions import ComputeRegion, Segment, finalize_region

#: calls to :func:`dependency_aware_split` in this process — plan reuse
#: means this grows once per (workload, fidelity) per campaign, not once
#: per job; tests and benchmarks assert on it
SPLIT_CALLS = 0


def _fuse_chains(ops: list[OpNode]) -> list[list[OpNode]]:
    """Group single-consumer chains of cheap ops with their consumer.

    Pure per-op granularity would flood the scheduler with sub-microsecond
    elementwise nodes; fusing producer chains whose only consumer is the next
    op preserves exact dependencies while keeping region count manageable.
    """
    defs: dict[str, int] = {}
    for op in ops:
        for r in op.results:
            defs[r] = op.uid
    n_consumers: dict[int, int] = {op.uid: 0 for op in ops}
    for op in ops:
        for o in set(op.operands):
            if o in defs:
                n_consumers[defs[o]] += 1
    groups: list[list[OpNode]] = []
    current: list[OpNode] = []
    for op in ops:
        current.append(op)
        chainable = (
            n_consumers[op.uid] == 1
            and op.op not in ("dot_general", "convolution", "while", "fusion")
            and not op.is_collective
        )
        if not chainable:
            groups.append(current)
            current = []
    if current:
        groups.append(current)
    return groups


def dependency_aware_split(
    program: Program,
) -> tuple[list[Segment], dict[int, set[int]]]:
    global SPLIT_CALLS
    SPLIT_CALLS += 1
    segments: list[Segment] = []
    deps: dict[int, set[int]] = {}
    producers: dict[str, set[int]] = {}   # SSA name -> producing segment set
    world = program.meta.get("num_partitions", 1)

    def dep_set(op_list: list[OpNode], extra: set[int]) -> set[int]:
        defined = {r for op in op_list for r in op.results}
        d: set[int] = set(extra)
        for op in op_list:
            for o in op.operands:
                if o not in defined:
                    d |= producers.get(o, set())
        return d

    def add_segment(seg: Segment, op_list: list[OpNode],
                    extra: set[int]) -> int:
        idx = len(segments)
        segments.append(seg)
        deps[idx] = {x for x in dep_set(op_list, extra) if x != idx}
        for op in op_list:
            for r in op.results:
                producers[r] = {idx}
        return idx

    def alias(op: OpNode) -> None:
        src: set[int] = set()
        for o in op.operands:
            src |= producers.get(o, set())
        for r in op.results:
            producers[r] = src

    def visit(ops: list[OpNode], chain_from: set[int]) -> set[int]:
        tail: set[int] = set(chain_from)
        first_pending = set(chain_from)
        start_idx = len(segments)

        def take_first() -> set[int]:
            nonlocal first_pending
            d, first_pending = first_pending, set()
            return d

        for group in _fuse_chains(ops):
            comp_ops: list[OpNode] = []
            for op in group:
                if op.op == "optimization_barrier":
                    alias(op)
                    if comp_ops:
                        region = finalize_region(
                            ComputeRegion(ops=comp_ops), program)
                        idx = add_segment(Segment("COMP", region=region),
                                          comp_ops, take_first())
                        tail = {idx}
                        comp_ops = []
                elif op.op in ZERO_COST_OPS or op.is_async_done:
                    alias(op)
                elif op.is_collective:
                    if comp_ops:
                        region = finalize_region(
                            ComputeRegion(ops=comp_ops), program)
                        idx = add_segment(Segment("COMP", region=region),
                                          comp_ops, take_first())
                        tail = {idx}
                        comp_ops = []
                    idx = add_segment(
                        Segment("COMM", comm=comm_spec(op, world)),
                        [op], take_first())
                    tail = {idx}
                elif op.op == "while" and any(
                        o.is_collective for o in op.walk()):
                    if comp_ops:
                        region = finalize_region(
                            ComputeRegion(ops=comp_ops), program)
                        idx = add_segment(Segment("COMP", region=region),
                                          comp_ops, take_first())
                        tail = {idx}
                        comp_ops = []
                    body = op.regions[-1] if op.regions else []
                    iter_tail = tail | take_first() | dep_set([op], set())
                    for _ in range(max(op.trip_count, 1)):
                        iter_tail = visit(body, iter_tail)
                    tail = iter_tail
                    for r in op.results:
                        producers[r] = set(iter_tail)
                else:
                    comp_ops.append(op)
            if comp_ops:
                region = finalize_region(ComputeRegion(ops=comp_ops), program)
                idx = add_segment(Segment("COMP", region=region),
                                  comp_ops, take_first())
                tail = {idx}
        # the iteration's tail must include every SINK segment (segments no
        # later segment of this visit depends on) — otherwise e.g. a
        # collective whose value only feeds the next iteration would not
        # serialize against its successor, and the scheduler could overlap
        # loop iterations unsoundly
        added = range(start_idx, len(segments))
        if start_idx < len(segments):
            consumed: set[int] = set()
            for i in added:
                consumed |= deps.get(i, set())
            sinks = {i for i in added if i not in consumed}
            if sinks:
                tail = sinks
        return tail

    visit(program.entry, set())
    return segments, deps
