"""Analytical collective-communication cost models (ASTRA-sim-analytical
class backend, paper §IV-C4).

Standard algorithm costs on a ring of g participants with per-direction
bandwidth B, payload S per participant, per-hop latency α:

  all_reduce      : 2·(g-1)/g · S / B_eff + 2·(g-1)·α   (RS + AG)
  all_gather      : (g-1)/g · S_out / B_eff + (g-1)·α
  reduce_scatter  : (g-1)/g · S / B_eff + (g-1)·α
  all_to_all      : (g-1)/g · S / B_bisect + (g-1)·α
  collective_perm : S / B + α

B_eff doubles on bidirectional rings (both directions carry half the
payload); hierarchical topologies run one phase per level.
"""
from __future__ import annotations

from ..ir.collectives import CommSpec
from .topology import PathProfile, Topology


def _ring_time(size: float, g: int, p: PathProfile, passes: float) -> float:
    if g <= 1 or size <= 0:
        return 0.0
    bw = p.ring_bw * (2 if p.bidirectional else 1)
    steps = (g - 1) * passes
    return passes * (g - 1) / g * size / bw + steps * p.latency


def collective_time(spec: CommSpec, topo: Topology,
                    compression: float = 1.0) -> float:
    """Seconds for one collective.  ``compression`` scales payload (e.g.
    0.25 for int8-quantized gradient all-reduce)."""
    g = spec.group_size
    if g <= 1:
        return 0.0
    size = spec.algo_bytes * compression
    levels = getattr(topo, "hierarchical_levels", None)

    if spec.kind == "all_reduce":
        if levels:
            total = 0.0
            remaining = size
            lv = levels(g)
            # hierarchical: RS at each level inward, AG back out
            for i, (parts, prof) in enumerate(lv):
                total += _ring_time(remaining, parts, prof, passes=2.0)
                remaining = remaining / parts
            return total
        return _ring_time(size, g, topo.ring(g), passes=2.0)

    if spec.kind in ("all_gather", "reduce_scatter"):
        if levels:
            total, remaining = 0.0, size
            for parts, prof in levels(g):
                total += _ring_time(remaining, parts, prof, passes=1.0)
            return total
        return _ring_time(size, g, topo.ring(g), passes=1.0)

    if spec.kind in ("all_to_all", "ragged_all_to_all"):
        p = topo.ring(g)
        bw = p.ring_bw * (2 if p.bidirectional else 1)
        return (g - 1) / g * size / bw + p.latency * 2

    if spec.kind in ("collective_permute", "send", "recv",
                     "collective_broadcast"):
        p = topo.ring(min(g, 2))
        return size / p.ring_bw + p.latency

    # unknown collective: conservative ring all-reduce cost
    return _ring_time(size, g, topo.ring(g), passes=2.0)
