"""The port's copy of the reference's IR front ends and cost model
(``repro.core.ir``): StableHLO-MLIR and HLO text -> one op graph, both
parsers (legacy and streaming), the per-op FLOP and byte accounting, the
collectives' communication specs, the estimators' array view of regions,
and the structural comparison of two parses."""
from .collectives import CommSpec, collect_collectives, comm_spec, total_collective_bytes
from .graph import COLLECTIVE_OPS, OpNode, Program, dependency_edges
from .opcost import Cost, op_cost, program_cost
from .arrays import ProgramArrays, RegionArrays, build_program_arrays, build_region_arrays
from .diff import assert_programs_equal, program_diff
from .parser import parse, parse_hlo, parse_stablehlo
from .streaming import parse_hlo_streaming, parse_stablehlo_streaming
from .types import DTYPE_BYTES, TensorType

__all__ = [
    "CommSpec", "collect_collectives", "comm_spec", "total_collective_bytes",
    "COLLECTIVE_OPS", "OpNode", "Program", "dependency_edges",
    "Cost", "op_cost", "program_cost",
    "parse", "parse_hlo", "parse_stablehlo",
    "parse_hlo_streaming", "parse_stablehlo_streaming",
    "program_diff", "assert_programs_equal",
    "ProgramArrays", "RegionArrays",
    "build_program_arrays", "build_region_arrays",
    "DTYPE_BYTES", "TensorType",
]
