"""Workload export (paper stage a): the port's copy of the reference's
``core/pipeline.Workload`` and ``export_workload``, for raw text only.

A torch export has the raw StableHLO text and no optimized (compiled,
SPMD-partitioned) text, so :meth:`Workload.program` raises for the
"optimized" fidelity instead of falling back to the raw text as the
reference does: a prediction that asks for the optimized text must not get
the raw one without being told.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .export import trace
from .ir.graph import Program
from .ir.parser import parse
from .stablehlo import emit

FIDELITIES = ("raw", "optimized")


@dataclass
class Workload:
    """An exported workload: raw StableHLO and, once the distribution
    slice emits it, optimized text."""
    name: str
    stablehlo_text: str | None = None
    hlo_text: str | None = None
    meta: dict = field(default_factory=dict)

    def program(self, fidelity: str = "optimized") -> Program:
        if fidelity not in FIDELITIES:
            raise ValueError(f"fidelity {fidelity!r} is not one of "
                             f"{FIDELITIES}")
        text = self.hlo_text if fidelity == "optimized" else \
            self.stablehlo_text
        if text is None:
            raise ValueError(f"workload {self.name}: no {fidelity} text (a "
                             "torch export has raw StableHLO only)")
        return parse(text)


def export_workload(fn, *specs, name: str = "workload",
                    device=None) -> Workload:
    """Trace ``fn(*specs)`` on fake tensors on ``device`` (None: the card)
    and emit its StableHLO text; no device memory is allocated and no
    kernel launches.  ``meta`` holds the trace's and the emit's seconds,
    the text's size in bytes and the count of each operator of the port's
    library in the graph (``kernel_ops``)."""
    traced = trace(fn, *specs, device=device)
    t0 = time.perf_counter()
    text = emit(traced, name)
    return Workload(name=name, stablehlo_text=text, meta={
        "trace_s": traced.seconds, "emit_s": time.perf_counter() - t0,
        "text_bytes": len(text.encode()), "kernel_ops": traced.op_counts})
