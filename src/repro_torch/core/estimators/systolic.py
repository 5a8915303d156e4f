"""Simulation-based estimator: cycle-approximate systolic-array model.

TPU-native adaptation of the paper's §IV-C3 estimator class (ONNXim,
COCOSSim, SCALE-Sim, ZigZag).  The model walks the HBM→VMEM→MXU hierarchy:

  * the GEMM is tiled into (mxu_rows × mxu_cols) output tiles with the
    contraction streamed through the array (weight-stationary);
  * each output tile costs K + fill cycles, where fill = rows + cols - 2
    is the systolic fill/drain latency;
  * tiles pipeline across ``n_mxu`` arrays; double buffering overlaps the
    HBM→VMEM stream of the next tile with compute unless disabled;
  * the final latency is max(compute pipeline, memory stream) + overhead.

Four presets reproduce the fidelity spread of the paper's Fig 10:
  onnxim    — double-buffered, high utilization (closest to TPU trends)
  cocossim  — double-buffered, per-tile re-fill charged (slightly slower)
  scalesim  — no double buffering, serial tile loads (pessimistic)
  zigzag    — pure compute cycles, no fill/memory modeling (optimistic)

Supports only matrix-multiplication regions natively (``supports``); pair
with a roofline fallback through MixedEstimator, as the paper pairs
COCOSSim with an analytical TPU estimator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ir.arrays import RegionArrays, gemm_dims as _gemm_dims
from ..ir.graph import OpNode
from ..ir.types import DTYPE_BYTES
from ..registry import register_estimator
from ..slicing.regions import ComputeRegion
from ..systems import System
from .base import ComputeEstimator


@dataclass(frozen=True)
class SystolicPreset:
    name: str
    double_buffer: bool = True
    charge_fill_per_tile: bool = True
    model_memory: bool = True
    utilization: float = 1.0       # sustained/peak derate


PRESETS = {
    "onnxim": SystolicPreset("onnxim", True, False, True, 0.95),
    "cocossim": SystolicPreset("cocossim", True, True, True, 0.90),
    "scalesim": SystolicPreset("scalesim", False, True, True, 0.85),
    "zigzag": SystolicPreset("zigzag", True, False, False, 1.0),
}


@register_estimator("systolic")
class SystolicEstimator(ComputeEstimator):
    """Cycle-approximate MXU model behind the Compute API."""

    def __init__(self, system: System, preset: str = "cocossim"):
        super().__init__(system)
        self.preset = PRESETS[preset]
        self.toolchain = f"systolic-{preset}"

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "SystolicEstimator":
        return cls(system, options.get("preset", "cocossim"))

    def supports(self, region: ComputeRegion) -> bool:
        """Native support: regions whose cost is ≥90% matmul flops."""
        mat = sum(op_flops for op in region.ops
                  for op_flops in [self._matmul_flops(op)])
        total = region.cost.flops
        return total > 0 and mat / total >= 0.9

    @staticmethod
    def _matmul_flops(op: OpNode) -> float:
        dims = _gemm_dims(op)
        if dims is None:
            total = 0.0
            for r in op.regions:
                for sub in r:
                    total += SystolicEstimator._matmul_flops(sub)
            return total * max(op.trip_count, 1)
        b, m, n, k = dims
        return 2.0 * b * m * n * k

    def gemm_latency(self, m: int, n: int, k: int, batch: int = 1,
                     dtype: str = "bf16") -> float:
        p = self.preset
        s = self.system
        rows, cols = s.mxu_rows, s.mxu_cols
        tiles_m = math.ceil(m / rows)
        tiles_n = math.ceil(n / cols)
        fill = rows + cols - 2
        if p.charge_fill_per_tile:
            cycles_per_tile = k + fill
        else:
            # fill amortized across the tile stream (pipelined drain)
            cycles_per_tile = k
        tiles = tiles_m * tiles_n * batch
        compute_cycles = tiles * cycles_per_tile / s.n_mxu + fill
        compute_t = compute_cycles / (s.clock_hz * p.utilization)

        if not p.model_memory:
            return compute_t + s.kernel_overhead_s
        eb = DTYPE_BYTES.get(dtype, 2)
        bytes_moved = batch * (m * k + k * n + m * n) * eb
        mem_t = bytes_moved / s.mem_bw
        if p.double_buffer:
            t = max(compute_t, mem_t)
        else:
            t = compute_t + mem_t
        return t + s.kernel_overhead_s

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        total = 0.0
        for op in region.ops:
            total += self._op_latency(op)
        return total

    def _op_latency(self, op: OpNode) -> float:
        dims = _gemm_dims(op)
        if dims is not None:
            b, m, n, k = dims
            dtype = op.operand_types[0].dtype if op.operand_types else "bf16"
            return self.gemm_latency(m, n, k, batch=b, dtype=dtype)
        total = 0.0
        for r in op.regions:
            for sub in r:
                total += self._op_latency(sub)
        return total * max(op.trip_count, 1)

    def evaluate_batch(self, arrays: RegionArrays) -> list[float] | None:
        """All regions of a plan as vectorized GEMM-dimension math.

        Bit-identical to :meth:`get_run_time_estimate` per region: each
        float64 expression mirrors :meth:`gemm_latency` operation for
        operation and in the same order (Python's exact-int intermediate
        products all stay below 2**53 for any realizable GEMM, where
        float64 products are exact, so the numpy pipeline lands on the
        same doubles), ``np.maximum`` is IEEE ``max``, and each region's
        tile latencies are summed left-to-right in Python — non-GEMM ops
        contribute an exact ``+0.0`` in the scalar walk, so skipping
        them preserves the sum.  Returns None (declining the batch back
        to the scalar loop) when the plan hides a ``dot_general`` inside
        nested control flow, where the scalar path's sum-then-multiply
        trip-count fold has no exact flat-array replay."""
        if not arrays.gemm_exact:
            return None
        p = self.preset
        s = self.system
        rows, cols = s.mxu_rows, s.mxu_cols
        b, m = arrays.gemm_batch, arrays.gemm_m
        n, k = arrays.gemm_n, arrays.gemm_k
        tiles_m = np.ceil(m / rows)
        tiles_n = np.ceil(n / cols)
        fill = rows + cols - 2
        if p.charge_fill_per_tile:
            cycles_per_tile = k + fill
        else:
            cycles_per_tile = k
        tiles = tiles_m * tiles_n * b
        compute_cycles = tiles * cycles_per_tile / s.n_mxu + fill
        compute_t = compute_cycles / (s.clock_hz * p.utilization)

        if not p.model_memory:
            t = compute_t + s.kernel_overhead_s
        else:
            eb = np.array([float(DTYPE_BYTES.get(dt, 2))
                           for dt in arrays.dtype_table], dtype=np.float64)
            bytes_moved = b * (m * k + k * n + m * n) \
                * eb[arrays.gemm_dtype_idx]
            mem_t = bytes_moved / s.mem_bw
            if p.double_buffer:
                t = np.maximum(compute_t, mem_t)
            else:
                t = compute_t + mem_t
            t = t + s.kernel_overhead_s
        vals = t.tolist()
        offs = arrays.gemm_offsets.tolist()
        out = []
        for r in range(arrays.num_regions):
            total = 0.0
            for v in vals[offs[r]:offs[r + 1]]:
                total += v
            out.append(total)
        return out
