"""Communication-operator extraction (paper §III-B(b), slicing stage).

Communication sizes are inferred from tensor types and communication
semantics from the StableHLO/HLO collective operator — exactly the mapping
the paper uses to build Chakra COMM nodes.
"""
from __future__ import annotations

from dataclasses import dataclass

from .graph import OpNode, Program


@dataclass(frozen=True)
class CommSpec:
    kind: str            # all_reduce | all_gather | reduce_scatter | all_to_all | collective_permute
    bytes_in: float      # per-participant input payload bytes
    bytes_out: float     # per-participant output payload bytes
    group_size: int      # participants per replica group
    num_groups: int      # concurrent disjoint groups
    op_uid: int = -1
    label: str = ""

    @property
    def algo_bytes(self) -> float:
        """Payload size the collective algorithm moves, per participant.

        all_reduce: input size (reduce-scatter + all-gather over it)
        all_gather: output size (each rank ends with the full tensor)
        reduce_scatter: input size
        all_to_all: input size (full resharding)
        collective_permute: input size (point-to-point)
        """
        if self.kind == "all_gather":
            return max(self.bytes_out, self.bytes_in)
        return max(self.bytes_in, self.bytes_out / max(self.group_size, 1))


def comm_spec(op: OpNode, default_world: int = 1) -> CommSpec:
    bytes_in = sum(t.nbytes for t in op.operand_types)
    bytes_out = sum(t.nbytes for t in op.result_types)
    if bytes_in == 0 and bytes_out > 0:
        # HLO parser resolves operand types from defs; fall back to result
        if op.op == "all_gather":
            bytes_in = bytes_out  # conservative
        else:
            bytes_in = bytes_out
    rg = op.attrs.get("replica_groups")
    if rg:
        num_groups, group_size = rg
    else:
        num_groups, group_size = 1, default_world
    label = op.attrs.get("op_name", "") or op.op
    return CommSpec(
        kind=op.op, bytes_in=bytes_in, bytes_out=bytes_out,
        group_size=max(group_size, 1), num_groups=max(num_groups, 1),
        op_uid=op.uid, label=label,
    )


def collect_collectives(program: Program) -> list[tuple[CommSpec, int]]:
    """All collectives in the program with their loop multiplicity.

    Returns (spec, multiplicity) where multiplicity is the product of
    enclosing while trip counts (a collective inside a scan-over-layers body
    executes L times per step).
    """
    world = program.meta.get("num_partitions", 1)
    out: list[tuple[CommSpec, int]] = []

    def visit(ops: list[OpNode], mult: int) -> None:
        for op in ops:
            if op.is_collective and not op.is_async_done:
                out.append((comm_spec(op, world), mult))
            if op.op == "while":
                body = op.regions[-1] if op.regions else []
                visit(body, mult * max(op.trip_count, 1))
            else:
                for region in op.regions:
                    visit(region, mult)

    visit(program.entry, 1)
    return out


def total_collective_bytes(program: Program) -> dict[str, float]:
    """Per-kind algorithm bytes (per participant), summed over the program."""
    totals: dict[str, float] = {}
    for spec, mult in collect_collectives(program):
        totals[spec.kind] = totals.get(spec.kind, 0.0) + spec.algo_bytes * mult
    return totals
