"""Tensor types shared by the StableHLO-MLIR and HLO-text front ends."""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

# bytes per element for every dtype our models emit
DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "s4": 0.5,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "u4": 0.5,
    "i64": 8, "i32": 4, "i16": 2, "i8": 1, "i1": 0.125,
    "pred": 0.125, "c64": 8, "c128": 16, "token": 0,
}

_MLIR_TENSOR_RE = re.compile(r"tensor<([^<>]*)>")
# HLO text: bf16[256,512]{1,0} or f32[] or s32[4]
_HLO_TYPE_RE = re.compile(r"\b([a-z]+\d+[a-z0-9]*|pred|token)\[([0-9,]*)\](?:\{[^}]*\})?")


@dataclass(frozen=True)
class TensorType:
    shape: tuple[int, ...]
    dtype: str

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def nbytes(self) -> float:
        return self.num_elements * DTYPE_BYTES.get(self.dtype, 4)

    def __str__(self) -> str:  # normalized, layout-free
        dims = "x".join(str(d) for d in self.shape)
        return f"{dims}x{self.dtype}" if dims else self.dtype


def parse_mlir_tensor(body: str) -> TensorType | None:
    """Parse the inside of ``tensor<...>``: e.g. ``4x6xf32`` or ``f32`` or ``1xi1``."""
    body = body.strip()
    if not body:
        return None
    parts = body.split("x")
    dims: list[int] = []
    for i, p in enumerate(parts):
        if p and (p[0].isdigit() or p == "?"):
            dims.append(-1 if p == "?" else int(p))
        else:
            dtype = "x".join(parts[i:])
            return TensorType(tuple(dims), dtype.strip())
    return TensorType(tuple(dims), parts[-1])


def mlir_types_in(text: str) -> list[TensorType]:
    out = []
    for m in _MLIR_TENSOR_RE.finditer(text):
        t = parse_mlir_tensor(m.group(1))
        if t is not None:
            out.append(t)
    return out


def hlo_types_in(text: str) -> list[TensorType]:
    out = []
    for m in _HLO_TYPE_RE.finditer(text):
        dtype, dims = m.group(1), m.group(2)
        shape = tuple(int(d) for d in dims.split(",")) if dims else ()
        out.append(TensorType(shape, dtype))
    return out
