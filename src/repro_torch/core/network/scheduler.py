"""Event-driven trace scheduler (the ASTRA-sim role, paper §III-B(d)).

Consumes a Chakra-style Trace and a Topology, schedules COMP nodes on the
device's compute stream and COMM nodes on the network stream, honoring data
dependencies.  Two scheduling modes:

  * ``overlap=False`` — collectives serialize with compute (paper's
    synchronous-collective configuration: async collective passes are
    disabled in its pipeline);
  * ``overlap=True``  — a COMM node may run concurrently with COMP nodes it
    does not depend on (what the dependency-aware slicer exposes).

Also models straggler injection (per-device slowdown factor; SPMD
collectives finish at the *slowest* participant — the classic straggler
amplification at scale) and gradient-compression payload scaling.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from ..trace.chakra import Trace
from .collective_models import collective_time
from .topology import Topology


@dataclass
class ScheduleResult:
    makespan_s: float
    compute_busy_s: float
    comm_busy_s: float
    exposed_comm_s: float          # comm time NOT hidden behind compute
    node_finish: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    @property
    def comm_fraction(self) -> float:
        return self.exposed_comm_s / self.makespan_s if self.makespan_s else 0.0


def simulate(trace: Trace, topo: Topology, *, overlap: bool = False,
             straggler_factor: float = 1.0, compression: float = 1.0,
             comm_type_breakdown: bool = True) -> ScheduleResult:
    """Schedule the trace; returns makespan and utilization breakdown.

    ``straggler_factor`` ≥ 1 stretches every collective (the slowest
    participant gates the group) — a single slow node's effect on an SPMD
    program.  Compute durations are per-device estimates and already
    reflect the modeled device.
    """
    nodes = trace.nodes
    n = len(nodes)
    indeg = [0] * n
    children: list[list[int]] = [[] for _ in range(n)]
    for node in nodes:
        for d in node.data_deps:
            indeg[node.id] += 1
            children[d].append(node.id)

    durations = [0.0] * n
    comm_busy = 0.0
    comp_busy = 0.0
    breakdown: dict[str, float] = {}
    for node in nodes:
        if node.node_type == "COMM_COLL_NODE":
            from ..ir.collectives import CommSpec
            spec = CommSpec(
                kind=node.comm_type.lower(), bytes_in=node.comm_size,
                bytes_out=node.comm_size, group_size=node.group_size,
                num_groups=node.num_groups)
            t = collective_time(spec, topo, compression) * straggler_factor
            durations[node.id] = t
            comm_busy += t
            if comm_type_breakdown:
                breakdown[node.comm_type] = breakdown.get(node.comm_type, 0.0) + t
        else:
            durations[node.id] = node.duration_us * 1e-6
            comp_busy += durations[node.id]
            if comm_type_breakdown:
                breakdown["COMP"] = breakdown.get("COMP", 0.0) + durations[node.id]

    # two resources: compute stream, network stream
    comp_free = 0.0
    net_free = 0.0
    finish = [0.0] * n
    ready: list[tuple[int, int]] = []  # (id, id) min-heap keeps trace order
    remaining = 0
    for node in nodes:
        if indeg[node.id] == 0:
            heapq.heappush(ready, (node.id, node.id))
        remaining += 1

    deps_finish = [0.0] * n
    processed = 0
    while ready:
        _, nid = heapq.heappop(ready)
        node = nodes[nid]
        start_after = deps_finish[nid]
        if node.node_type == "COMM_COLL_NODE":
            if overlap:
                start = max(start_after, net_free)
                net_free = start + durations[nid]
            else:
                start = max(start_after, comp_free, net_free)
                net_free = start + durations[nid]
                comp_free = net_free
        else:
            start = max(start_after, comp_free)
            comp_free = start + durations[nid]
        finish[nid] = start + durations[nid]
        processed += 1
        for ch in children[nid]:
            deps_finish[ch] = max(deps_finish[ch], finish[nid])
            indeg[ch] -= 1
            if indeg[ch] == 0:
                heapq.heappush(ready, (ch, ch))

    if processed != n:
        raise ValueError(
            f"trace has a dependency cycle: scheduled {processed}/{n}")

    makespan = max(finish) if finish else 0.0
    exposed = max(makespan - comp_busy, 0.0)
    return ScheduleResult(
        makespan_s=makespan, compute_busy_s=comp_busy,
        comm_busy_s=comm_busy, exposed_comm_s=exposed,
        node_finish={i: finish[i] for i in range(min(n, 0))},
        breakdown=breakdown)
