"""Compute/communication segments produced by the slicing stage."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..ir.collectives import CommSpec
from ..ir.graph import OpNode, build_def_use
from ..ir.opcost import Cost, op_cost


@dataclass
class ComputeRegion:
    ops: list[OpNode]
    label: str = ""
    cost: Cost = field(default_factory=Cost)
    boundary_in_bytes: float = 0.0
    boundary_out_bytes: float = 0.0
    fingerprint: str = ""

    @property
    def num_ops(self) -> int:
        return len(self.ops)


@dataclass
class Segment:
    """One slice of the program: either compute or communication.

    ``repeat`` carries loop multiplicity (a segment inside a scan body with
    trip count L appears once with repeat=L; the trace builder unrolls it).
    """
    kind: str                        # "COMP" | "COMM"
    region: ComputeRegion | None = None
    comm: CommSpec | None = None
    repeat: int = 1
    group: int = 0                   # loop-nest id: segments sharing a group
    #                                  repeat together, in order


def region_fingerprint(ops: list[OpNode]) -> str:
    """Structural hash: op mnemonics + shapes + key attrs.

    This is the R of the paper's (H × C × R) cache key: two regions with
    identical op sequences and shapes hit the same cache entry (e.g. the 48
    identical transformer blocks of a stacked model).
    """
    h = hashlib.sha256()
    for op in ops:
        h.update(op.op.encode())
        for t in op.operand_types:
            h.update(str(t).encode())
        for t in op.result_types:
            h.update(str(t).encode())
        for key in ("lhs_contract", "rhs_contract", "lhs_batch", "rhs_batch",
                    "feature_group_count", "dim_labels"):
            if key in op.attrs:
                h.update(f"{key}={op.attrs[key]}".encode())
        if op.trip_count > 1:
            h.update(f"trip={op.trip_count}".encode())
        for region in op.regions:
            h.update(region_fingerprint(region).encode())
    return h.hexdigest()[:16]


def finalize_region(region: ComputeRegion, program=None) -> ComputeRegion:
    """Compute aggregate cost, boundary traffic, and fingerprint."""
    cost = Cost()
    for op in region.ops:
        cost += op_cost(op, program)
    region.cost = cost
    defs = build_def_use(region.ops)
    produced = set(defs.keys())
    # inputs: operands whose producer is outside the region
    in_bytes = 0.0
    seen: set[str] = set()
    for op in region.ops:
        for name, t in zip(op.operands, op.operand_types):
            if name not in produced and name not in seen:
                seen.add(name)
                in_bytes += t.nbytes
    # outputs: conservatively, results of ops not consumed inside the region
    consumed = {o for op in region.ops for o in op.operands}
    out_bytes = 0.0
    for op in region.ops:
        for name, t in zip(op.results, op.result_types):
            if name not in consumed:
                out_bytes += t.nbytes
    region.boundary_in_bytes = in_bytes
    region.boundary_out_bytes = out_bytes
    region.fingerprint = region_fingerprint(region.ops)
    if not region.label and region.ops:
        region.label = region.ops[0].attrs.get("op_name", region.ops[0].op)
    return region
