"""Chakra-style execution trace (paper §III-B(d)).

The performance-annotated sliced program is mapped to a version-controlled
trace-graph format: vertices are COMP or COMM nodes, edges are data
dependencies.  We mirror the MLCommons Chakra ET node vocabulary
(COMP_NODE / COMM_COLL_NODE, comm_type, comm_size, ctrl/data deps) in JSON,
one trace per (workload × system); the network scheduler consumes this.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

COMM_TYPE = {
    "all_reduce": "ALL_REDUCE", "all_gather": "ALL_GATHER",
    "reduce_scatter": "REDUCE_SCATTER", "all_to_all": "ALL_TO_ALL",
    "collective_permute": "COLLECTIVE_PERMUTE", "send": "SEND", "recv": "RECV",
    "collective_broadcast": "BROADCAST", "ragged_all_to_all": "ALL_TO_ALL",
}


@dataclass
class TraceNode:
    id: int
    node_type: str                  # "COMP_NODE" | "COMM_COLL_NODE"
    name: str
    duration_us: float = 0.0        # COMP: filled by the compute estimator
    comm_type: str = ""             # COMM only
    comm_size: float = 0.0          # COMM only: per-participant payload bytes
    group_size: int = 1
    num_groups: int = 1
    data_deps: list[int] = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class Trace:
    nodes: list[TraceNode] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def add_comp(self, name: str, duration_us: float,
                 deps: list[int] | None = None, **attrs) -> int:
        nid = len(self.nodes)
        self.nodes.append(TraceNode(
            id=nid, node_type="COMP_NODE", name=name,
            duration_us=duration_us, data_deps=sorted(deps or []),
            attrs=attrs))
        return nid

    def add_comm(self, kind: str, size_bytes: float, group_size: int,
                 num_groups: int = 1, deps: list[int] | None = None,
                 name: str = "", **attrs) -> int:
        nid = len(self.nodes)
        self.nodes.append(TraceNode(
            id=nid, node_type="COMM_COLL_NODE", name=name or kind,
            comm_type=COMM_TYPE.get(kind, kind.upper()),
            comm_size=size_bytes, group_size=group_size,
            num_groups=num_groups, data_deps=sorted(deps or []),
            attrs=attrs))
        return nid

    # ---------------- (de)serialization ----------------
    def to_json(self) -> str:
        return json.dumps(
            {"schema": "repro-chakra-et/1", "meta": self.meta,
             "nodes": [asdict(n) for n in self.nodes]}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        d = json.loads(text)
        t = cls(meta=d.get("meta", {}))
        for n in d["nodes"]:
            t.nodes.append(TraceNode(**n))
        return t

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())

    # ---------------- stats ----------------
    @property
    def total_comp_us(self) -> float:
        return sum(n.duration_us for n in self.nodes
                   if n.node_type == "COMP_NODE")

    @property
    def total_comm_bytes(self) -> float:
        return sum(n.comm_size for n in self.nodes
                   if n.node_type == "COMM_COLL_NODE")

    def validate(self) -> None:
        ids = {n.id for n in self.nodes}
        for n in self.nodes:
            for d in n.data_deps:
                if d not in ids:
                    raise ValueError(f"node {n.id} depends on missing {d}")
                if d >= n.id:
                    raise ValueError(f"node {n.id} has forward dep {d}")
