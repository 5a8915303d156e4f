"""Structural Program comparison for the differential parser harness.

:func:`program_diff` compares two parsed :class:`Program`\\ s node for
node — every OpNode field *except* ``uid`` (the streaming front end
numbers uids clean-sequentially, while the legacy MLIR parser burns uids
on a discarded pre-parse of ``while`` interiors; nothing downstream
depends on the absolute values, only on definition order and identity).
Instead of raw uid equality it checks the *uid correspondence* is a
consistent bijection across the whole program, which also catches a
front end that copies a shared HLO computation where the other attaches
it by reference.
"""
from __future__ import annotations

from .graph import OpNode, Program

_FIELDS = ("results", "op", "operands", "operand_types", "result_types",
           "attrs", "trip_count", "raw", "called")


class _Differ:
    def __init__(self, limit: int):
        self.out: list[str] = []
        self.limit = limit
        self.seen: set[tuple[int, int]] = set()
        self.a2b: dict[int, int] = {}
        self.b2a: dict[int, int] = {}

    def full(self) -> bool:
        return len(self.out) >= self.limit

    def note(self, msg: str) -> None:
        if not self.full():
            self.out.append(msg)

    def ops(self, a: list[OpNode], b: list[OpNode], path: str) -> None:
        if self.full():
            return
        if len(a) != len(b):
            self.note(f"{path}: {len(a)} ops != {len(b)} ops")
        for i, (x, y) in enumerate(zip(a, b)):
            self.node(x, y, f"{path}[{i}]")

    def node(self, a: OpNode, b: OpNode, path: str) -> None:
        if self.full():
            return
        pa, pb = self.a2b.get(id(a)), self.b2a.get(id(b))
        if pa is not None and pa != id(b):
            self.note(f"{path}: node appears twice on the left but maps to "
                      "two distinct right nodes (sharing mismatch)")
        if pb is not None and pb != id(a):
            self.note(f"{path}: node appears twice on the right but maps to "
                      "two distinct left nodes (sharing mismatch)")
        self.a2b[id(a)] = id(b)
        self.b2a[id(b)] = id(a)
        if (id(a), id(b)) in self.seen:
            return
        self.seen.add((id(a), id(b)))
        for f in _FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            if va != vb:
                self.note(f"{path}.{f}: {va!r} != {vb!r}")
        if len(a.regions) != len(b.regions):
            self.note(f"{path}.regions: {len(a.regions)} != {len(b.regions)}")
            return
        for ri, (ra, rb) in enumerate(zip(a.regions, b.regions)):
            self.ops(ra, rb, f"{path}.regions[{ri}]")


def program_diff(a: Program, b: Program, limit: int = 50) -> list[str]:
    """All structural differences between two parses, as readable strings.

    Empty list == node-for-node identical Programs (modulo uid values,
    whose correspondence must still be a consistent bijection)."""
    d = _Differ(limit)
    if a.dialect != b.dialect:
        d.note(f"dialect: {a.dialect!r} != {b.dialect!r}")
    if a.meta != b.meta:
        ka, kb = set(a.meta), set(b.meta)
        if ka != kb:
            d.note(f"meta keys: {sorted(ka)} != {sorted(kb)}")
        for k in sorted(ka & kb):
            if a.meta[k] != b.meta[k]:
                d.note(f"meta[{k}]: differs")
    if list(a.functions) != list(b.functions):
        d.note(f"functions: {list(a.functions)} != {list(b.functions)}")
    for name in a.functions:
        if name in b.functions:
            d.ops(a.functions[name], b.functions[name], f"fn {name}")
    d.ops(a.entry, b.entry, "entry")
    return d.out


def assert_programs_equal(a: Program, b: Program) -> None:
    """Raise AssertionError with every difference if the parses diverge."""
    diffs = program_diff(a, b)
    if diffs:
        raise AssertionError(
            "programs differ:\n  " + "\n  ".join(diffs))
