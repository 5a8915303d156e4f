"""Re-emit a sliced compute region as a standalone StableHLO module: the
port's copy of the reference's ``core/slicing/emit.py``, text only.

This is what makes the profiling estimator real: each region becomes an
independently executable program (the paper runs these through
``hlo_runner_main``; the port runs them with its own executor,
``core/executor.py``, on the card).  A region that calls a private
function (an operator of the port's library, written as its plain
version's ops) carries that function's text along, under the same name, so
the export's ``call`` table (``Workload.meta["calls"]``) still names its
operator.

Only the ``stablehlo`` dialect supports emission — the paper, likewise,
profiles from the StableHLO export, not from post-compilation HLO.
"""
from __future__ import annotations

import re

from ..ir.graph import OpNode, Program
from ..ir.types import TensorType

_SSA_TOKEN = re.compile(r"(%[\w.\-#]+)")
# definitions: op results at line start, loop/iter binders, block arguments
_DEF_PATTERNS = (
    re.compile(r"(?m)^\s*(%[\w.\-#]+)(?::\d+)?\s*(?:,\s*%[\w.\-#]+\s*)*="),
    re.compile(r"(?m)^\s*%[\w.\-#]+(?::\d+)?\s*(?:,\s*(%[\w.\-#]+)\s*)+="),
    re.compile(r"[(,]\s*(%[\w.\-#]+)\s*="),          # (%iterArg = %init
)
# block-argument lines: ^bb0(%x: tensor<..>, %y: tensor<..>):
_BLOCK_ARG_LINE = re.compile(r"(?m)^\s*\^bb[\w]*\((.*)$")
_BLOCK_ARG_TOKEN = re.compile(r"(%[\w.\-#]+)\s*:")
_CONST_LIKE = {"constant", "iota"}


def _internal_defs(raw_text: str) -> set[str]:
    defs: set[str] = set()
    for pat in _DEF_PATTERNS:
        defs.update(m for m in pat.findall(raw_text))
    for line in _BLOCK_ARG_LINE.findall(raw_text):
        defs.update(_BLOCK_ARG_TOKEN.findall(line))
    return defs


class RegionEmitError(RuntimeError):
    pass


# sharding identities nested in region bodies (while/cond) — resolved at
# the text level, since nested ops are raw lines, not OpNodes
_SDY_IDENTITY = re.compile(
    r"^\s*(%[\w.\-#]+)\s*=\s*\"?(?:sdy\.sharding_constraint"
    r"|stablehlo\.custom_call @Sharding)\"?\s*\(?\s*(%[\w.\-#]+)")


def _strip_sharding_lines(lines: list[str]) -> list[str]:
    """Drop sharding-identity ops and re-route their uses to the operand."""
    alias: dict[str, str] = {}
    kept: list[str] = []
    for line in lines:
        m = _SDY_IDENTITY.match(line)
        if m:
            src = m.group(2)
            alias[m.group(1)] = alias.get(src, src)
        else:
            kept.append(line)
    if not alias:
        return lines
    return [_SSA_TOKEN.sub(lambda m: alias.get(m.group(1), m.group(1)), l)
            for l in kept]


def _mlir_type(t: TensorType) -> str:
    dims = "x".join(str(d) for d in t.shape)
    return f"tensor<{dims}{'x' if dims else ''}{t.dtype}>"


_ARG_SENTINEL = OpNode(uid=-1, results=(), op="parameter", operands=(),
                       operand_types=(), result_types=())


def _global_defs(program: Program) -> dict[str, tuple[OpNode, TensorType | None]]:
    defs: dict[str, tuple[OpNode, TensorType | None]] = {}
    # function arguments (typed from the signature) act as external defs
    for args in program.meta.get("func_args", {}).values():
        for name, t in args:
            defs.setdefault(name, (_ARG_SENTINEL, t))
    for body in program.functions.values():
        for op in body:
            for o in op.walk():
                types = list(o.result_types) or [None]
                for i, r in enumerate(o.results):
                    defs.setdefault(r, (o, types[min(i, len(types) - 1)]))
    return defs


def _referenced_functions(raw_text: str, program: Program,
                          seen: set[str]) -> list[str]:
    out: list[str] = []
    for name in re.findall(r"@([\w.\-]+)", raw_text):
        if name in seen or name == "main" or name not in program.functions:
            continue
        seen.add(name)
        callee_raw = program.meta.get("func_raw", {}).get(name, "")
        out.extend(_referenced_functions(callee_raw, program, seen))
        out.append(name)
    return out


def region_to_module(ops: list[OpNode], program: Program,
                     name: str = "region") -> tuple[str, list[TensorType]]:
    """Build a standalone module for a region.

    Returns (module_text, input_types).  External SSA values become function
    arguments (types resolved from their global defining op); constants and
    iotas referenced from outside are inlined so regions stay self-contained;
    every region-defined value not consumed inside is returned, so XLA cannot
    dead-code-eliminate interior work — mirroring the paper's per-region
    compilation scope (and its loss of cross-region optimization).
    """
    if program.dialect != "stablehlo":
        raise RegionEmitError("region emission requires the stablehlo dialect")

    # sharding annotations reference the module-level sdy.mesh symbol, which a
    # standalone region module does not carry; sharding ops are identities for
    # compute purposes -> alias their results to their operands and drop them.
    alias_map: dict[str, str] = {}
    kept_ops: list[OpNode] = []
    for op in ops:
        is_shard_op = (
            op.op in ("sharding_constraint", "sharding_group", "propagation_barrier")
            or (op.op == "custom_call" and "@Sharding" in op.raw)
        )
        if is_shard_op and op.results and op.operands:
            src = op.operands[0]
            alias_map[op.results[0]] = alias_map.get(src, src)
        else:
            kept_ops.append(op)
    ops = kept_ops
    if not ops:
        raise RegionEmitError("region contains only sharding ops")

    raw_text = "\n".join(op.raw for op in ops)
    if alias_map:
        raw_text = _SSA_TOKEN.sub(
            lambda m: alias_map.get(m.group(1), m.group(1)), raw_text)
    internal = _internal_defs(raw_text)
    gdefs = _global_defs(program)

    inline_lines: list[str] = []
    inputs: list[tuple[str, TensorType]] = []
    seen: set[str] = set()
    for tok in _SSA_TOKEN.findall(raw_text):
        base = tok.split("#")[0]
        if tok in internal or base in internal or tok in seen:
            continue
        seen.add(tok)
        entry = gdefs.get(tok) or gdefs.get(base)
        if entry is None:
            raise RegionEmitError(f"unresolvable external value {tok}")
        def_op, t = entry
        if def_op.op in _CONST_LIKE and "\n" not in def_op.raw:
            inline_lines.append(def_op.raw.strip())
            internal.add(tok)
            internal.add(base)
        else:
            if t is None:
                raise RegionEmitError(f"untyped external value {tok}")
            inputs.append((tok, t))

    # a value is "consumed internally" if referenced anywhere other than its
    # own definition; count occurrences to decide
    occurrence: dict[str, int] = {}
    for tok in _SSA_TOKEN.findall(raw_text):
        occurrence[tok] = occurrence.get(tok, 0) + 1

    outputs: list[tuple[str, TensorType]] = []
    for op in ops:
        types = list(op.result_types) or [None]
        for i, r in enumerate(op.results):
            if "#" in r:
                continue
            t = types[min(i, len(types) - 1)]
            if t is None:
                continue
            multi = any(x.startswith(r + "#") for x in occurrence)
            if occurrence.get(r, 0) <= 1 and not multi:
                outputs.append((r, t))
    if not outputs:
        last = ops[-1]
        outputs = [(r, t) for r, t in zip(last.results, last.result_types)
                   if t is not None and "#" not in r]
    if not outputs:
        raise RegionEmitError("region has no emittable outputs")

    rename = {old: f"%rin{i}" for i, (old, _) in enumerate(inputs)}

    def rewrite(text: str) -> str:
        def sub(m: re.Match) -> str:
            tok = alias_map.get(m.group(1), m.group(1))
            return rename.get(tok, tok)
        return _SSA_TOKEN.sub(sub, text)

    body_lines = [l for op in ops for l in rewrite(op.raw).splitlines()]
    body_lines = _strip_sharding_lines(body_lines)
    inline_block = [rewrite(l) for l in inline_lines]
    args = ", ".join(f"%rin{i}: {_mlir_type(t)}"
                     for i, (_, t) in enumerate(inputs))
    ret_names = ", ".join(r for r, _ in outputs)
    ret_types = ", ".join(_mlir_type(t) for _, t in outputs)

    callee_raws = []
    for fn in _referenced_functions(raw_text, program, set()):
        raw = program.meta.get("func_raw", {}).get(fn)
        if raw is None:
            raise RegionEmitError(f"missing raw text for callee @{fn}")
        callee_raws.append(
            "\n".join(_strip_sharding_lines(raw.splitlines())))

    module = (
        f"module @{name} {{\n"
        + "\n".join(callee_raws)
        + ("\n" if callee_raws else "")
        + f"  func.func public @main({args}) -> ({ret_types}) {{\n"
        + "\n".join("    " + l for l in inline_block + body_lines)
        + f"\n    return {ret_names} : {ret_types}\n"
        + "  }\n}"
    )
    return module, [t for _, t in inputs]
