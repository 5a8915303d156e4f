"""Single-pass streaming tokenizer for the MLIR/HLO text front ends.

The legacy parser (:mod:`repro_torch.core.ir.parser`) re-scans text repeatedly:
every line is brace-balanced with a per-character Python loop, nested
region lines are regex-matched once per nesting level, and every
``tensor<...>`` / ``f32[...]`` type is re-parsed at each occurrence.  This
module makes one pass over the text and records, per line, everything the
parser needs later:

* the line text itself (round-trip property: joining the token texts with
  ``"\\n"`` reproduces the comment-stripped input),
* the brace/paren balance (``str.count`` fast path when the line carries
  no string literal; the legacy character loop otherwise — the two are
  equivalent exactly when no ``"`` is present),
* the pre-computed op-header regex match.

It also owns the *interned tables*: repeated type/signature substrings
(``tensor<4096x4096xbf16>``, ``f32[64,64]{1,0}``, whole `` : (...) ->
...`` signatures) resolve to shared :class:`TensorType` instances through
bounded memo dictionaries, so an L-layer model pays the type-parsing cost
once per distinct shape instead of once per occurrence.

``TOKENIZER_PASSES`` counts full-text tokenization passes; the benchmark
suite asserts exactly one pass per parse (the legacy front end would
count one per nesting level if it were instrumented the same way).
"""
from __future__ import annotations

from .parser import _HLO_OP_RE, _MLIR_OP_RE, _balance, _strip_comments
from .types import TensorType, mlir_types_in, parse_mlir_tensor

#: full-text tokenization passes in this process; benchmarks and CI assert
#: exactly 1 per parse (single-pass property of the streaming front end)
TOKENIZER_PASSES = 0

#: interned-table size bound; tables reset (not LRU-evict) past this, so a
#: pathological stream of unique shapes cannot grow memory without bound
_TABLE_LIMIT = 1 << 16

_TENSOR_TABLE: dict[str, TensorType | None] = {}
_MLIR_SIG_TABLE: dict[str, tuple[tuple[TensorType, ...], tuple[TensorType, ...]]] = {}
_HLO_TYPES_TABLE: dict[str, tuple[TensorType, ...]] = {}


def _bounded(table: dict) -> dict:
    if len(table) >= _TABLE_LIMIT:
        table.clear()
    return table


def intern_tensor(body: str) -> TensorType | None:
    """Interned :func:`repro_torch.core.ir.types.parse_mlir_tensor`.

    Equal bodies yield the *same* (frozen, hashable) TensorType object —
    the shape/string table of the streaming front end."""
    try:
        return _TENSOR_TABLE[body]
    except KeyError:
        t = parse_mlir_tensor(body)
        _bounded(_TENSOR_TABLE)[body] = t
        return t


def mlir_types_interned(text: str) -> list[TensorType]:
    """:func:`types.mlir_types_in` over interned tensor bodies."""
    from .types import _MLIR_TENSOR_RE
    out = []
    for m in _MLIR_TENSOR_RE.finditer(text):
        t = intern_tensor(m.group(1))
        if t is not None:
            out.append(t)
    return out


def mlir_signature_types(
        sig: str) -> tuple[tuple[TensorType, ...], tuple[TensorType, ...]]:
    """Interned MLIR trailing-signature split: ``sig`` is everything after
    the last `` : `` of an op header.  Returns (operand_types,
    result_types) exactly as the legacy ``_signature_types`` computes them
    for the same header, memoized on the signature substring (layer-stacked
    models repeat whole signatures verbatim)."""
    try:
        return _MLIR_SIG_TABLE[sig]
    except KeyError:
        if "->" in sig:
            lhs, rhs = sig.split("->", 1)
            pair = (tuple(mlir_types_interned(lhs)),
                    tuple(mlir_types_interned(rhs)))
        else:
            ts = tuple(mlir_types_interned(sig))
            pair = (ts, ts)
        _bounded(_MLIR_SIG_TABLE)[sig] = pair
        return pair


def hlo_types_interned(text: str) -> tuple[TensorType, ...]:
    """Interned :func:`types.hlo_types_in` (HLO result-type column)."""
    try:
        return _HLO_TYPES_TABLE[text]
    except KeyError:
        from .types import _HLO_TYPE_RE
        out = []
        for m in _HLO_TYPE_RE.finditer(text):
            dtype, dims = m.group(1), m.group(2)
            shape = tuple(int(d) for d in dims.split(",")) if dims else ()
            out.append(TensorType(shape, dtype))
        tup = tuple(out)
        _bounded(_HLO_TYPES_TABLE)[text] = tup
        return tup


def fast_balance(line: str) -> int:
    """Brace/paren balance of ``line``, equal to the legacy per-character
    ``parser._balance`` on every input.

    Fast paths: a line with no ``"`` cannot toggle the in-string state, so
    the balance is a plain count difference (C-speed ``str.count``); a line
    with quotes but no escaped quote (``\\"``) splits on ``"`` — the
    even-indexed segments are exactly the out-of-string spans the legacy
    loop counts (an unterminated quote leaves the tail in-string, which the
    split reproduces: the tail lands in an odd segment).  Only lines
    carrying an escaped quote fall back to the per-character loop."""
    if '"' not in line:
        return (line.count("{") + line.count("(")
                - line.count("}") - line.count(")"))
    if '\\"' in line:
        return _balance(line)
    bal = 0
    for seg in line.split('"')[::2]:
        bal += (seg.count("{") + seg.count("(")
                - seg.count("}") - seg.count(")"))
    return bal


def strip_comments(text: str) -> str:
    """Comment stripping with a containment gate (most exports carry no
    ``/* ... */`` at all); identical output to ``parser._strip_comments``."""
    if "/*" in text:
        return _strip_comments(text)
    return text


class MlirTokens:
    """One tokenization pass over StableHLO-MLIR text.

    ``lines[i]`` / ``bals[i]`` / ``oms[i]`` are the text, brace balance,
    and op-header match of line *i*.  Region handling in the streaming
    parser works on index ranges into these parallel lists, so nested
    regions never re-scan text."""

    __slots__ = ("lines", "bals", "oms")

    def __init__(self, stripped_text: str):
        global TOKENIZER_PASSES
        TOKENIZER_PASSES += 1
        self.lines = stripped_text.splitlines()
        # fast_balance, with its common no-quote path inlined: a Python
        # call per line costs more than the four C-level str.counts
        self.bals = [
            fast_balance(ln) if '"' in ln else
            ln.count("{") + ln.count("(") - ln.count("}") - ln.count(")")
            for ln in self.lines]
        match = _MLIR_OP_RE.match
        self.oms = [match(ln) for ln in self.lines]


class HloTokens:
    """One tokenization pass over (post-SPMD) HLO text.

    Only op-definition lines (containing ``=``) are regex-matched; the
    computation-header match is left to the parser's top-level loop, which
    touches a handful of lines per module."""

    __slots__ = ("lines", "oms")

    def __init__(self, stripped_text: str):
        global TOKENIZER_PASSES
        TOKENIZER_PASSES += 1
        self.lines = stripped_text.splitlines()
        match = _HLO_OP_RE.match
        self.oms = [match(ln) if "=" in ln else None for ln in self.lines]


def reset_tables() -> None:
    """Drop every interned table (tests use this for isolation)."""
    _TENSOR_TABLE.clear()
    _MLIR_SIG_TABLE.clear()
    _HLO_TYPES_TABLE.clear()
