"""Analytical roofline estimator (paper §IV-C1).

Per-operator roofline using peak FLOP/s and peak memory bandwidth, selecting
the dominant bottleneck.  Fused regions are modeled as a single compute
region: memory traffic is accounted only at the region boundaries while the
full compute cost of all constituent operators is preserved — this lets
*optimized* StableHLO inputs be consumed directly and is what makes the
analytical path consistently optimistic relative to hardware.
"""
from __future__ import annotations

import numpy as np

from ..ir.arrays import RegionArrays
from ..ir.opcost import op_cost
from ..registry import register_estimator
from ..slicing.regions import ComputeRegion
from ..systems import System
from .base import ComputeEstimator


@register_estimator("roofline")
class RooflineEstimator(ComputeEstimator):
    toolchain = "roofline"

    def __init__(self, system: System, mode: str = "region",
                 include_overheads: bool = False):
        """mode: 'region' (boundary-bytes; optimistic, for optimized IR) or
        'per-op' (per-operator max(compute, memory) summed; for raw IR)."""
        super().__init__(system)
        assert mode in ("region", "per-op")
        self.mode = mode
        self.include_overheads = include_overheads

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "RooflineEstimator":
        return cls(system, mode=options.get("mode", "region"),
                   include_overheads=bool(
                       options.get("include_overheads", False)))

    @property
    def cache_config_key(self) -> str:
        return self.mode + ("+ovh" if self.include_overheads else "")

    def _dtype_of(self, region: ComputeRegion) -> str:
        # dominant dtype by output bytes across matmul-ish ops, else first op
        best, best_bytes = "bf16", -1.0
        for op in region.ops:
            for t in op.result_types:
                if t.nbytes > best_bytes:
                    best, best_bytes = t.dtype, t.nbytes
        return best

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        sysm = self.system
        if self.mode == "region":
            dtype = self._dtype_of(region)
            compute_t = region.cost.flops / sysm.flops_for(dtype)
            mem_bytes = region.boundary_in_bytes + region.boundary_out_bytes
            memory_t = mem_bytes / sysm.mem_bw
            t = max(compute_t, memory_t)
            if self.include_overheads:
                t += sysm.kernel_overhead_s
            return t
        total = 0.0
        for op in region.ops:
            c = op_cost(op)
            dtype = (op.result_types[0].dtype if op.result_types else "bf16")
            t = max(c.flops / sysm.flops_for(dtype), c.bytes / sysm.mem_bw)
            if self.include_overheads and (c.flops > 0 or c.bytes > 0):
                t += sysm.kernel_overhead_s
            total += t
        return total

    def evaluate_batch(self, arrays: RegionArrays) -> list[float]:
        """All regions of a plan in a handful of vectorized expressions.

        Bit-identical to calling :meth:`get_run_time_estimate` per region:
        every value is the same float64 operation sequence — numpy's
        elementwise divide/maximum are IEEE double ops, the overhead add
        happens after the max exactly as the scalar path orders it, and
        per-op mode sums each region's op latencies left-to-right in
        Python (``sum`` over a numpy slice would not preserve the scalar
        loop's associativity).  In per-op mode the overhead lands only on
        active ops via the precomputed 0/1 mask (``t + 0.0 == t`` for the
        non-negative latencies involved)."""
        sysm = self.system
        peak = np.array([sysm.flops_for(dt) for dt in arrays.dtype_table],
                        dtype=np.float64)
        if self.mode == "region":
            t = np.maximum(arrays.flops / peak[arrays.dtype_idx],
                           arrays.boundary_bytes / sysm.mem_bw)
            if self.include_overheads:
                t = t + sysm.kernel_overhead_s
            return t.tolist()
        op_t = np.maximum(arrays.op_flops / peak[arrays.op_dtype_idx],
                          arrays.op_bytes / sysm.mem_bw)
        if self.include_overheads:
            op_t = op_t + arrays.op_active * sysm.kernel_overhead_s
        vals = op_t.tolist()
        offs = arrays.op_offsets.tolist()
        out = []
        for r in range(arrays.num_regions):
            total = 0.0
            for v in vals[offs[r]:offs[r + 1]]:
                total += v
            out.append(total)
        return out
