"""Dialect-neutral op graph — the unified workload representation.

Both front ends (StableHLO-MLIR text, post-SPMD HLO text) produce this
graph; everything downstream (slicing, estimation, network simulation)
consumes only this form. This realizes the paper's "single source of
truth" property: one representation drives every fidelity level.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

from .types import TensorType

# normalized collective mnemonics (StableHLO underscores; HLO hyphens map here)
COLLECTIVE_OPS = {
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "collective_permute", "collective_broadcast", "send", "recv",
    "ragged_all_to_all",
}
# ops that carry no work (metadata / flow only)
ZERO_COST_OPS = {
    "parameter", "constant", "iota", "get_tuple_element", "tuple", "return",
    "after_all", "optimization_barrier", "partition_id", "replica_id",
    "get_dimension_size", "sharding_constraint", "custom_call_sharding",
}


@dataclass
class OpNode:
    uid: int                       # unique within program, topological order
    results: tuple[str, ...]       # SSA names defined
    op: str                        # normalized mnemonic, e.g. "dot_general"
    operands: tuple[str, ...]      # SSA names consumed
    operand_types: tuple[TensorType, ...]
    result_types: tuple[TensorType, ...]
    attrs: dict = field(default_factory=dict)
    regions: list[list["OpNode"]] = field(default_factory=list)
    trip_count: int = 1            # >1 for while/scan bodies
    raw: str = ""                  # original text (single- or multi-line)
    called: tuple[str, ...] = ()   # names of called computations (fusion/call)

    @property
    def is_collective(self) -> bool:
        return self.op in COLLECTIVE_OPS

    @property
    def is_async_start(self) -> bool:
        return bool(self.attrs.get("async_start"))

    @property
    def is_async_done(self) -> bool:
        return bool(self.attrs.get("async_done"))

    def walk(self) -> Iterator["OpNode"]:
        """Yield self and all region ops recursively."""
        yield self
        for region in self.regions:
            for op in region:
                yield from op.walk()


@dataclass
class Program:
    """A parsed module: entry computation + callee computations."""
    entry: list[OpNode]
    functions: dict[str, list[OpNode]]
    dialect: str                             # "stablehlo" | "hlo"
    meta: dict = field(default_factory=dict)  # num_partitions, mesh, ...

    def walk(self) -> Iterator[OpNode]:
        for op in self.entry:
            yield from op.walk()

    def resolve(self, name: str) -> list[OpNode] | None:
        """Look up a callee computation by (possibly %-prefixed) name."""
        name = name.lstrip("%@")
        if name in self.functions:
            return self.functions[name]
        # HLO names often carry numeric suffixes already; try fuzzy match
        for k in self.functions:
            if k == name or k.split(".")[0] == name:
                return self.functions[k]
        return None

    def collectives(self) -> list[OpNode]:
        return [op for op in self.walk() if op.is_collective and not op.is_async_done]

    @property
    def num_ops(self) -> int:
        return sum(1 for _ in self.walk())


def build_def_use(ops: list[OpNode]) -> dict[str, int]:
    """Map SSA name -> uid of defining op (entry level only)."""
    defs: dict[str, int] = {}
    for op in ops:
        for r in op.results:
            defs[r] = op.uid
    return defs


def dependency_edges(ops: list[OpNode]) -> dict[int, set[int]]:
    """uid -> set of uids it depends on (within the given op list)."""
    defs = build_def_use(ops)
    deps: dict[int, set[int]] = {}
    for op in ops:
        deps[op.uid] = {defs[o] for o in op.operands if o in defs}
    return deps
