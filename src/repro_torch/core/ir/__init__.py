"""The port's copy of the reference's IR front ends and cost model
(``repro.core.ir``): StableHLO-MLIR and HLO text -> one op graph, both
parsers (legacy and streaming), the per-op FLOP and byte accounting, and
the structural comparison of two parses."""
from .diff import assert_programs_equal, program_diff
from .graph import OpNode, Program
from .opcost import Cost, op_cost, program_cost
from .parser import parse, parse_hlo, parse_stablehlo
from .streaming import parse_hlo_streaming, parse_stablehlo_streaming
from .types import DTYPE_BYTES, TensorType

__all__ = [
    "OpNode", "Program", "Cost", "op_cost", "program_cost",
    "parse", "parse_hlo", "parse_stablehlo",
    "parse_hlo_streaming", "parse_stablehlo_streaming",
    "program_diff", "assert_programs_equal", "DTYPE_BYTES", "TensorType",
]
