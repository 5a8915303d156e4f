"""Array-of-structs views of parsed programs and sliced regions.

Two representations, both plain numpy + interned tables, both picklable
(they ride inside :class:`~repro_torch.core.pipeline.PredictionPlan` to process
workers):

* :class:`ProgramArrays` — the whole op graph flattened to parallel
  arrays (op codes into an interned mnemonic table, CSR operand/result
  indices, interned shape/dtype tables).  This is the structure-of-arrays
  twin of the per-node :class:`OpNode` objects: cheap to scan, cheap to
  ship, and the natural substrate for future whole-graph analyses.

* :class:`RegionArrays` — the *evaluation-ready* per-region arrays the
  estimators consume: region flops / boundary bytes / dominant dtype for
  roofline region mode, CSR per-op flops/bytes/dtype for per-op mode, and
  the region fingerprints (so (H,C,R) cache keys for a whole plan are one
  string-concat per region, memoized per key prefix).  Built once at plan
  time; :meth:`RooflineEstimator.evaluate_batch` turns a plan evaluation
  into a handful of vectorized numpy expressions that are bit-identical
  to the scalar per-region path (same float64 operations in the same
  order — sums are performed left-to-right in Python over the numpy
  results precisely to preserve IEEE associativity with the legacy loop).

:class:`RegionArrays` also carries a per-region CSR of GEMM dimensions
(batch, M, N, K, operand dtype) for every ``dot_general`` directly in a
region's op list — the substrate for
:meth:`SystolicEstimator.evaluate_batch`.  The systolic scalar path
recurses into nested control-flow regions and multiplies by trip count
*after* summing each level, a fold that a flat weighted array cannot
replay bit-identically when a loop body holds several GEMMs; regions
hiding a ``dot_general`` below the top level therefore clear
``gemm_exact`` and the estimator declines the whole batch back to the
scalar loop rather than return approximately-right values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .graph import OpNode, Program
from .opcost import op_cost

#: dtype assumed when an op has no result types (mirrors the estimators)
_DEFAULT_DTYPE = "bf16"


class _Interner:
    """Value -> dense index table (insertion-ordered)."""

    def __init__(self):
        self.index: dict = {}
        self.values: list = []

    def __call__(self, value) -> int:
        idx = self.index.get(value)
        if idx is None:
            idx = len(self.values)
            self.index[value] = idx
            self.values.append(value)
        return idx


@dataclass
class ProgramArrays:
    """Flattened op graph in walk order (entry + nested regions)."""
    op_table: list[str]                 # interned mnemonics
    dtype_table: list[str]              # interned dtypes
    shape_table: list[tuple[int, ...]]  # interned shape tuples
    opcodes: np.ndarray                 # int32[N] -> op_table
    trip_counts: np.ndarray             # int64[N]
    operand_offsets: np.ndarray         # int64[N+1] CSR
    operand_defs: np.ndarray            # int32[nnz] defining op row, -1 = external
    result_offsets: np.ndarray          # int64[N+1] CSR
    result_shapes: np.ndarray           # int32[nnz] -> shape_table
    result_dtypes: np.ndarray           # int32[nnz] -> dtype_table

    @property
    def num_ops(self) -> int:
        return len(self.opcodes)


def build_program_arrays(program: Program) -> ProgramArrays:
    """Flatten ``program.walk()`` order into a :class:`ProgramArrays`.

    Operand references resolve to the row of the op that defined the SSA
    name earlier in walk order (-1 when defined outside the walked entry,
    e.g. a function argument)."""
    ops: list[OpNode] = list(program.walk())
    op_i = _Interner()
    dt_i = _Interner()
    sh_i = _Interner()
    defs: dict[str, int] = {}
    opcodes = np.empty(len(ops), dtype=np.int32)
    trips = np.empty(len(ops), dtype=np.int64)
    operand_offsets = np.zeros(len(ops) + 1, dtype=np.int64)
    result_offsets = np.zeros(len(ops) + 1, dtype=np.int64)
    operand_defs: list[int] = []
    result_shapes: list[int] = []
    result_dtypes: list[int] = []
    for row, op in enumerate(ops):
        opcodes[row] = op_i(op.op)
        trips[row] = op.trip_count
        for name in op.operands:
            operand_defs.append(defs.get(name, -1))
        operand_offsets[row + 1] = len(operand_defs)
        for name in op.results:
            defs[name] = row
        for t in op.result_types:
            result_shapes.append(sh_i(t.shape))
            result_dtypes.append(dt_i(t.dtype))
        result_offsets[row + 1] = len(result_shapes)
    return ProgramArrays(
        op_table=op_i.values, dtype_table=dt_i.values, shape_table=sh_i.values,
        opcodes=opcodes, trip_counts=trips,
        operand_offsets=operand_offsets,
        operand_defs=np.asarray(operand_defs, dtype=np.int32),
        result_offsets=result_offsets,
        result_shapes=np.asarray(result_shapes, dtype=np.int32),
        result_dtypes=np.asarray(result_dtypes, dtype=np.int32),
    )


def gemm_dims(op: OpNode) -> tuple[int, int, int, int] | None:
    """(batch, M, N, K) of a ``dot_general``, or None.

    Single source of the GEMM-shape parse shared by the systolic
    estimator's scalar path and the vectorized arrays built here — the
    two must agree op-for-op or the batch path stops being a replay of
    the scalar one."""
    if op.op != "dot_general" or len(op.operand_types) < 2:
        return None
    lhs, rhs = op.operand_types[0], op.operand_types[1]
    lb = op.attrs.get("lhs_batch", ())
    lc = op.attrs.get("lhs_contract", ())
    rb = op.attrs.get("rhs_batch", ())
    rc = op.attrs.get("rhs_contract", ())
    batch = math.prod(lhs.shape[d] for d in lb) if lb else 1
    k = math.prod(lhs.shape[d] for d in lc) if lc else 1
    m = math.prod(d for i, d in enumerate(lhs.shape)
                  if i not in lb and i not in lc)
    n = math.prod(d for i, d in enumerate(rhs.shape)
                  if i not in rb and i not in rc)
    return batch, m, n, k


def _hides_gemm(op: OpNode) -> bool:
    """A ``dot_general`` somewhere below ``op``'s own regions."""
    for region in op.regions:
        for sub in region:
            if gemm_dims(sub) is not None or _hides_gemm(sub):
                return True
    return False


@dataclass
class RegionArrays:
    """Per-compute-region evaluation arrays, in plan segment order."""
    fingerprints: list[str]             # region fingerprint per region
    dtype_table: list[str]              # interned dtypes
    flops: np.ndarray                   # float64[R] region.cost.flops
    boundary_bytes: np.ndarray          # float64[R] in+out boundary traffic
    dtype_idx: np.ndarray               # int32[R] dominant dtype per region
    op_offsets: np.ndarray              # int64[R+1] CSR into per-op arrays
    op_flops: np.ndarray                # float64[nnz] op_cost(op).flops
    op_bytes: np.ndarray                # float64[nnz] op_cost(op).bytes
    op_dtype_idx: np.ndarray            # int32[nnz]
    op_active: np.ndarray               # float64[nnz] 1.0 iff flops or bytes
    gemm_offsets: np.ndarray            # int64[R+1] CSR into gemm arrays
    gemm_batch: np.ndarray              # float64[G] dot_general batch
    gemm_m: np.ndarray                  # float64[G]
    gemm_n: np.ndarray                  # float64[G]
    gemm_k: np.ndarray                  # float64[G]
    gemm_dtype_idx: np.ndarray          # int32[G] operand dtype
    gemm_exact: bool = True             # no GEMMs hidden below top level
    _key_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_regions(self) -> int:
        return len(self.fingerprints)

    def keys_for(self, prefix: str) -> list[str]:
        """(H,C,config,R) cache keys for every region: ``prefix`` is the
        estimator's ``hw|toolchain|config|`` part; memoized per prefix so
        a warm grid re-evaluation does zero string work."""
        keys = self._key_cache.get(prefix)
        if keys is None:
            keys = [prefix + f for f in self.fingerprints]
            self._key_cache[prefix] = keys
        return keys


def _dominant_dtype(region) -> str:
    """Dominant dtype by result bytes — must mirror
    ``RooflineEstimator._dtype_of`` exactly (strictly-greater compare,
    bf16 default) so precomputed indices reproduce the scalar path."""
    best, best_bytes = _DEFAULT_DTYPE, -1.0
    for op in region.ops:
        for t in op.result_types:
            if t.nbytes > best_bytes:
                best, best_bytes = t.dtype, t.nbytes
    return best


def build_region_arrays(regions: list) -> RegionArrays:
    """Build :class:`RegionArrays` from finalized compute regions."""
    dt_i = _Interner()
    nr = len(regions)
    flops = np.empty(nr, dtype=np.float64)
    boundary = np.empty(nr, dtype=np.float64)
    dtype_idx = np.empty(nr, dtype=np.int32)
    op_offsets = np.zeros(nr + 1, dtype=np.int64)
    op_flops: list[float] = []
    op_bytes: list[float] = []
    op_dtype: list[int] = []
    op_active: list[float] = []
    fingerprints: list[str] = []
    gemm_offsets = np.zeros(nr + 1, dtype=np.int64)
    gemm_b: list[float] = []
    gemm_m: list[float] = []
    gemm_n: list[float] = []
    gemm_k: list[float] = []
    gemm_dtype: list[int] = []
    gemm_exact = True
    for r, region in enumerate(regions):
        fingerprints.append(region.fingerprint)
        flops[r] = region.cost.flops
        boundary[r] = region.boundary_in_bytes + region.boundary_out_bytes
        dtype_idx[r] = dt_i(_dominant_dtype(region))
        for op in region.ops:
            c = op_cost(op)
            op_flops.append(c.flops)
            op_bytes.append(c.bytes)
            op_dtype.append(dt_i(op.result_types[0].dtype if op.result_types
                                 else _DEFAULT_DTYPE))
            op_active.append(1.0 if (c.flops > 0 or c.bytes > 0) else 0.0)
            dims = gemm_dims(op)
            if dims is not None:
                b, m, n, k = dims
                gemm_b.append(float(b))
                gemm_m.append(float(m))
                gemm_n.append(float(n))
                gemm_k.append(float(k))
                gemm_dtype.append(dt_i(op.operand_types[0].dtype))
            elif _hides_gemm(op):
                gemm_exact = False
        op_offsets[r + 1] = len(op_flops)
        gemm_offsets[r + 1] = len(gemm_b)
    return RegionArrays(
        fingerprints=fingerprints, dtype_table=dt_i.values,
        flops=flops, boundary_bytes=boundary, dtype_idx=dtype_idx,
        op_offsets=op_offsets,
        op_flops=np.asarray(op_flops, dtype=np.float64),
        op_bytes=np.asarray(op_bytes, dtype=np.float64),
        op_dtype_idx=np.asarray(op_dtype, dtype=np.int32),
        op_active=np.asarray(op_active, dtype=np.float64),
        gemm_offsets=gemm_offsets,
        gemm_batch=np.asarray(gemm_b, dtype=np.float64),
        gemm_m=np.asarray(gemm_m, dtype=np.float64),
        gemm_n=np.asarray(gemm_n, dtype=np.float64),
        gemm_k=np.asarray(gemm_k, dtype=np.float64),
        gemm_dtype_idx=np.asarray(gemm_dtype, dtype=np.int32),
        gemm_exact=gemm_exact,
    )
