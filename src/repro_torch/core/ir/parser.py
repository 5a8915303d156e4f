"""Front ends: StableHLO-MLIR text and post-SPMD HLO text -> Program.

Two textual dialects flow through the methodology (paper §III-B):

* the *raw export*  — ``jax.jit(f).lower(...).as_text()`` — StableHLO MLIR with
  ``sdy`` sharding annotations, global shapes, collectives only if the program
  used shard_map / explicit collectives;
* the *optimized representation* — ``lowered.compile().as_text()`` — XLA's
  SPMD-partitioned, fused, optimized HLO with per-device shapes and explicit
  ``all-reduce``/``all-gather``/... ops.  This plays the role of the paper's
  hlo-opt pipeline output ("compiler effects visible to the model").

Both are parsed into the same :class:`repro_torch.core.ir.graph.Program`.
"""
from __future__ import annotations

import json
import re

from .graph import OpNode, Program
from .types import TensorType, hlo_types_in, mlir_types_in, parse_mlir_tensor

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

# DOTALL: block comments may span lines (jax metadata dumps do); without it
# a multi-line /* ... */ survives stripping and corrupts the next op line
_COMMENT_RE = re.compile(r"/\*.*?\*/", re.DOTALL)
_SSA_RE = re.compile(r"%[\w.\-#]+")

# HLO opcode -> normalized mnemonic
_HLO_NORMALIZE = {
    "dot": "dot_general",
    "all-reduce": "all_reduce", "all-gather": "all_gather",
    "reduce-scatter": "reduce_scatter", "all-to-all": "all_to_all",
    "collective-permute": "collective_permute",
    "collective-broadcast": "collective_broadcast",
    "all-reduce-start": "all_reduce", "all-gather-start": "all_gather",
    "collective-permute-start": "collective_permute",
    "all-reduce-done": "async_done", "all-gather-done": "async_done",
    "collective-permute-done": "async_done", "async-done": "async_done",
    "get-tuple-element": "get_tuple_element",
    "dynamic-slice": "dynamic_slice", "dynamic-update-slice": "dynamic_update_slice",
    "broadcast": "broadcast_in_dim", "rng-bit-generator": "rng_bit_generator",
    "select-and-scatter": "select_and_scatter", "reduce-window": "reduce_window",
    "batch-norm-training": "batch_norm_training", "batch-norm-grad": "batch_norm_grad",
    "custom-call": "custom_call",
}


def _strip_comments(text: str) -> str:
    return _COMMENT_RE.sub("", text)


def _parse_replica_groups(text: str) -> tuple[int, int] | None:
    """Return ``(num_groups, group_size)`` from any textual form.

    Accepted grammar (all three forms the XLA/StableHLO printers emit),
    tried in this order — first match wins:

    1. HLO iota form — no whitespace tolerated (matches the printer)::

           replica_groups=[G,S]<=[N]            ->  (G, S)

    2. HLO explicit form — groups are ``{...}`` lists of device ids;
       whitespace is tolerated *between* groups but not around the
       ``replica_groups=`` key; the group size is taken from the first
       group (XLA emits uniform groups), empty first group counts as 1::

           replica_groups={{0,1,2,3},{4,5,6,7}} ->  (2, 4)

    3. MLIR dense form — whitespace tolerated around ``=`` and ``:``;
       the shape is read from the ``tensor<GxSxi64>`` type, not the
       elements; a ``tensor<0x0xi64>`` (empty groups) yields None::

           replica_groups = dense<[[0, 1], [2, 3]]> : tensor<2x2xi64>
                                                 ->  (2, 2)

    Text with none of these (or a malformed variant) yields None — the
    op is then modeled without a group split.  Comments never reach this
    function: both front ends strip ``/* ... */`` before line handling.
    """
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[\d+\]", text)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.search(r"replica_groups=\{(\{[^}]*\}(?:,\s*\{[^}]*\})*)\}", text)
    if m:
        groups = re.findall(r"\{([^}]*)\}", m.group(1))
        if groups:
            size = len([x for x in groups[0].split(",") if x.strip() != ""])
            return len(groups), max(size, 1)
    m = re.search(r"replica_groups\s*=\s*dense<[^>]*>\s*:\s*tensor<(\d+)x(\d+)xi64>", text)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.search(r"replica_groups\s*=\s*dense<[^>]*>\s*:\s*tensor<0x0xi64>", text)
    if m:
        return None
    return None


def _parse_dims_pair(text: str, key: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Parse MLIR ``key = [a, b] x [c, d]`` -> ((a,b),(c,d))."""
    m = re.search(key + r"\s*=\s*\[([\d, ]*)\]\s*x\s*\[([\d, ]*)\]", text)
    if not m:
        return (), ()
    l = tuple(int(x) for x in m.group(1).split(",") if x.strip())
    r = tuple(int(x) for x in m.group(2).split(",") if x.strip())
    return l, r


def _parse_hlo_dims(text: str, key: str) -> tuple[int, ...]:
    m = re.search(key + r"=\{([\d,]*)\}", text)
    if not m:
        return ()
    return tuple(int(x) for x in m.group(1).split(",") if x.strip())


# ---------------------------------------------------------------------------
# StableHLO MLIR text parser
# ---------------------------------------------------------------------------

_MLIR_OP_RE = re.compile(
    r"^\s*(?:(%[\w.\-#]+(?::\d+)?(?:\s*,\s*%[\w.\-#]+)*)\s*=\s*)?"  # results
    r'("?)([\w]+\.[\w]+|call|return)\2'                              # mnemonic
)
_MLIR_FUNC_RE = re.compile(r"^\s*func\.func\s+(?:public\s+|private\s+)?@([\w.\-]+)\((.*)$")


def _balance(line: str) -> int:
    bal = 0
    in_str = False
    prev = ""
    for ch in line:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        elif not in_str:
            if ch in "{(":
                bal += 1
            elif ch in "})":
                bal -= 1
        prev = ch
    return bal


class _MlirParser:
    def __init__(self, text: str):
        self.lines = _strip_comments(text).splitlines()
        self.uid = 0

    def parse(self) -> Program:
        functions: dict[str, list[OpNode]] = {}
        meta: dict = {}
        m = re.search(r"mhlo.num_partitions = (\d+)", self.lines[0] if self.lines else "")
        if m:
            meta["num_partitions"] = int(m.group(1))
        mesh_m = re.search(r"sdy.mesh @\w+ = <\[(.*?)\]>", "\n".join(self.lines[:8]))
        if mesh_m:
            axes = re.findall(r'"(\w+)"=(\d+)', mesh_m.group(1))
            meta["mesh"] = {name: int(size) for name, size in axes}
        i = 0
        entry_name = None
        func_raw: dict[str, str] = {}
        meta["func_raw"] = func_raw
        while i < len(self.lines):
            fm = _MLIR_FUNC_RE.match(self.lines[i])
            if fm:
                name = fm.group(1)
                start = i
                args = [(a, parse_mlir_tensor(t))
                        for a, t in re.findall(
                            r"(%[\w.\-]+):\s*tensor<([^>]*)>", self.lines[i])]
                body, i = self._collect_region_lines(i)
                functions[name] = self._parse_ops(body)
                func_raw[name] = "\n".join(self.lines[start:i])
                meta.setdefault("func_args", {})[name] = args
                if entry_name is None or name == "main":
                    entry_name = name if entry_name is None or name == "main" else entry_name
            else:
                i += 1
        entry = functions.get("main") or (functions[entry_name] if entry_name else [])
        return Program(entry=entry, functions=functions, dialect="stablehlo", meta=meta)

    def _collect_region_lines(self, start: int) -> tuple[list[str], int]:
        """Collect lines of a brace-balanced block starting at ``start``.

        Returns the interior lines (everything after the opening line, up to
        but excluding the closing line at balance zero) and the next index.
        """
        bal = _balance(self.lines[start])
        i = start + 1
        body: list[str] = []
        while i < len(self.lines) and bal > 0:
            bal += _balance(self.lines[i])
            if bal > 0:
                body.append(self.lines[i])
            i += 1
        return body, i

    def _parse_ops(self, lines: list[str]) -> list[OpNode]:
        ops: list[OpNode] = []
        i = 0
        while i < len(lines):
            line = lines[i]
            om = _MLIR_OP_RE.match(line)
            if not om:
                i += 1
                continue
            # collect full (possibly multi-line, region-carrying) op text
            bal = _balance(line)
            block = [line]
            j = i + 1
            while bal > 0 and j < len(lines):
                bal += _balance(lines[j])
                block.append(lines[j])
                j += 1
            # pretty-printed `while` has a balanced header; its regions start
            # on the following ` cond {` line — pull them into the block
            if "while" in line and j < len(lines) and re.match(r"^\s*cond\s*\{", lines[j]):
                rbal = _balance(lines[j])
                block.append(lines[j])
                j += 1
                while rbal > 0 and j < len(lines):
                    rbal += _balance(lines[j])
                    block.append(lines[j])
                    j += 1
            op = self._make_op(om, block)
            if op is not None:
                ops.append(op)
            i = j if j > i + 1 else i + 1
        return ops

    def _make_op(self, om: re.Match, block: list[str]) -> OpNode | None:
        header = block[0]
        raw = "\n".join(block)
        results_txt = om.group(1) or ""
        mnem = om.group(3)
        if mnem.startswith(("stablehlo.", "mhlo.", "chlo.", "sdy.", "arith.", "func.", "tf.")):
            op_name = mnem.split(".", 1)[1]
        else:
            op_name = mnem
        if op_name in ("return",):
            return None
        # results: "%3:2" form or "%a, %b" form
        results: list[str] = []
        for tok in results_txt.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if ":" in tok:
                base, n = tok.split(":")
                results.extend(f"{base}#{k}" for k in range(int(n)))
                results.append(base)
            else:
                results.append(tok)
        # operand names: SSA ids on the header after '=' and before signature
        after = header.split("=", 1)[1] if "=" in header and results_txt else header
        sig_idx = after.rfind(" : ")
        operand_zone = after[:sig_idx] if sig_idx != -1 else after
        operands = tuple(t for t in _SSA_RE.findall(operand_zone) if t not in results)
        # types
        operand_types, result_types = self._signature_types(header)
        # uniform-typed ops (`%c = stablehlo.add %a, %b : tensor<..>`) list the
        # shared type once; replicate it per operand for byte accounting
        if len(operand_types) == 1 and len(operands) > 1 and " -> " not in header:
            operand_types = operand_types * len(operands)
        attrs: dict = {"header": header}
        if op_name == "dot_general":
            lb, rb = _parse_dims_pair(header, "batching_dims")
            lc, rc = _parse_dims_pair(header, "contracting_dims")
            attrs.update(lhs_batch=lb, rhs_batch=rb, lhs_contract=lc, rhs_contract=rc)
        if op_name == "convolution":
            fg = re.search(r"feature_group_count\s*=\s*(\d+)", raw)
            attrs["feature_group_count"] = int(fg.group(1)) if fg else 1
            dn = re.search(r"dim_numbers\s*=\s*(\[[^\]]*\]x\[[^\]]*\]->\[[^\]]*\])", header)
            if dn:
                attrs["dim_labels"] = dn.group(1)
        rg = _parse_replica_groups(raw)
        if rg:
            attrs["replica_groups"] = rg
        if "channel_handle" in raw or "channel_id" in raw:
            attrs["channel"] = True
        # gather/scatter/reduce dims, all_gather dim
        gd = re.search(r"all_gather_dim\s*=\s*(\d+)", raw)
        if gd:
            attrs["gather_dim"] = int(gd.group(1))
        node = OpNode(
            uid=self._next_uid(), results=tuple(results), op=op_name,
            operands=operands, operand_types=tuple(operand_types),
            result_types=tuple(result_types), attrs=attrs, raw=raw,
        )
        if op_name == "call" or mnem == "func.call":
            callee = re.search(r"@([\w.\-]+)", header)
            if callee:
                node.called = (callee.group(1),)
        # nested regions (while / reduce / all_reduce bodies ...)
        if len(block) > 1:
            interior = block[1:]
            # drop the final closing line(s)
            region_ops = self._parse_ops(interior)
            if region_ops:
                if op_name == "while":
                    cond_ops, body_ops = self._split_while(interior)
                    node.regions = [cond_ops, body_ops]
                    node.trip_count = self._trip_count(block)
                else:
                    node.regions = [region_ops]
        return node

    def _split_while(self, interior: list[str]) -> tuple[list[OpNode], list[OpNode]]:
        """Split pretty-printed while into cond/body regions on '} do {'."""
        depth = 0
        split = None
        for idx, line in enumerate(interior):
            if depth == 1 and re.match(r"^\s*\}\s*do\s*\{", line):
                split = idx
                break
            depth += _balance(line)
        if split is None:
            return [], self._parse_ops(interior)
        return self._parse_ops(interior[:split]), self._parse_ops(interior[split + 1:])

    def _trip_count(self, block: list[str]) -> int:
        """Heuristic: largest small-integer constant in the cond region."""
        text = "\n".join(block)
        best = 1
        for m in re.finditer(r"dense<(\d+)>\s*:\s*tensor<i(?:32|64)>", text):
            v = int(m.group(1))
            if 1 < v <= 1_000_000:
                best = max(best, v)
        return best

    def _signature_types(self, header: str) -> tuple[list[TensorType], list[TensorType]]:
        sig_idx = header.rfind(" : ")
        if sig_idx == -1:
            return [], mlir_types_in(header)
        sig = header[sig_idx + 3:]
        if "->" in sig:
            lhs, rhs = sig.split("->", 1)
            return mlir_types_in(lhs), mlir_types_in(rhs)
        ts = mlir_types_in(sig)
        return ts, ts

    def _next_uid(self) -> int:
        self.uid += 1
        return self.uid


# ---------------------------------------------------------------------------
# HLO text parser (post-SPMD, optimized)
# ---------------------------------------------------------------------------

_HLO_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)(?:\.v\d+)?\s*\(.*\)\s*->\s*.*\{\s*$")
_HLO_OP_RE = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(.*?\)|[a-z]\w*\[[\d,]*\](?:\{[^}]*\})?|[a-z]\w*\[\])\s*"
    r"([\w\-]+)\((.*?)\)(.*)$"
)


class _HloParser:
    def __init__(self, text: str):
        self.text = _strip_comments(text)
        self.uid = 0

    def parse(self) -> Program:
        meta: dict = {}
        m = re.search(r"num_partitions=(\d+)", self.text)
        if m:
            meta["num_partitions"] = int(m.group(1))
        computations: dict[str, list[OpNode]] = {}
        entry_name = None
        lines = self.text.splitlines()
        i = 0
        while i < len(lines):
            cm = _HLO_COMP_RE.match(lines[i])
            if cm:
                is_entry, name = bool(cm.group(1)), cm.group(2)
                body: list[str] = []
                i += 1
                while i < len(lines) and not lines[i].startswith("}"):
                    body.append(lines[i])
                    i += 1
                computations[name] = self._parse_ops(body)
                if is_entry:
                    entry_name = name
            i += 1
        entry = computations.get(entry_name, [])
        prog = Program(entry=entry, functions=computations, dialect="hlo", meta=meta)
        self._attach_called_regions(prog)
        return prog

    def _parse_ops(self, lines: list[str]) -> list[OpNode]:
        ops = []
        for line in lines:
            om = _HLO_OP_RE.match(line)
            if not om:
                continue
            _, name, type_txt, opcode, operand_txt, attr_txt = om.groups()
            op_name = _HLO_NORMALIZE.get(opcode, opcode.replace("-", "_"))
            result_types = tuple(hlo_types_in(type_txt))
            operands = tuple(_SSA_RE.findall(operand_txt)) or tuple(
                t for t in re.findall(r"[\w.\-]+", operand_txt)
                if not re.fullmatch(r"[a-z]\w*\[[\d,]*\]", t)
            )
            attrs: dict = {}
            if op_name == "dot_general":
                attrs["lhs_contract"] = _parse_hlo_dims(attr_txt, "lhs_contracting_dims")
                attrs["rhs_contract"] = _parse_hlo_dims(attr_txt, "rhs_contracting_dims")
                attrs["lhs_batch"] = _parse_hlo_dims(attr_txt, "lhs_batch_dims")
                attrs["rhs_batch"] = _parse_hlo_dims(attr_txt, "rhs_batch_dims")
            if op_name == "convolution":
                fg = re.search(r"feature_group_count=(\d+)", attr_txt)
                attrs["feature_group_count"] = int(fg.group(1)) if fg else 1
                dl = re.search(r"dim_labels=([\w>\-_]+)", attr_txt)
                if dl:
                    attrs["dim_labels"] = dl.group(1)
            rg = _parse_replica_groups(attr_txt)
            if rg:
                attrs["replica_groups"] = rg
            if opcode.endswith("-start"):
                attrs["async_start"] = True
            if op_name == "async_done":
                attrs["async_done"] = True
            md = re.search(r'op_name="([^"]*)"', attr_txt)
            if md:
                attrs["op_name"] = md.group(1)
            called = tuple(re.findall(r"(?:calls|to_apply|condition|body)=%?([\w.\-]+)", attr_txt))
            node = OpNode(
                uid=self._next_uid(), results=(f"%{name}",), op=op_name,
                operands=operands, operand_types=(), result_types=result_types,
                attrs=attrs, raw=line, called=called,
            )
            if op_name == "while":
                tc = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', attr_txt)
                if tc:
                    node.trip_count = int(tc.group(1))
                else:
                    node.trip_count = 0  # resolve later from condition comp
            ops.append(node)
        # operand types resolvable from defs within the computation
        defs = {r: op for op in ops for r in op.results}
        for op in ops:
            otypes = []
            for o in op.operands:
                d = defs.get(o)
                otypes.append(d.result_types[0] if d and d.result_types else None)
            op.operand_types = tuple(t for t in otypes if t is not None)
        return ops

    def _attach_called_regions(self, prog: Program) -> None:
        """Attach fusion/while called computations as regions; fix trip counts.

        Iterates every computation (not just the entry walk) so fusions inside
        while bodies get their called bodies attached too.  Computations form a
        DAG in HLO, so attachment cannot cycle.
        """
        all_ops = [op for comp in prog.functions.values() for op in comp]
        for op in all_ops:
            if not op.called:
                continue
            if op.op == "while":
                cond = prog.resolve(op.called[0]) if len(op.called) > 0 else None
                body = prog.resolve(op.called[1]) if len(op.called) > 1 else None
                # 'condition=' regex ordering: condition first, then body
                op.regions = [r for r in (cond, body) if r is not None]
                if op.trip_count == 0:
                    op.trip_count = self._cond_trip_count(cond) if cond else 1
            elif op.op in ("fusion", "call", "map", "reduce", "reduce_window",
                           "scatter", "select_and_scatter", "sort", "all_reduce",
                           "reduce_scatter", "custom_call", "conditional"):
                regions = [prog.resolve(c) for c in op.called]
                op.regions = [r for r in regions if r]

    @staticmethod
    def _cond_trip_count(cond: list[OpNode]) -> int:
        best = 1
        for op in cond:
            m = re.search(r"constant\((\d+)\)", op.raw)
            if m:
                v = int(m.group(1))
                if 1 < v <= 1_000_000:
                    best = max(best, v)
        return best

    def _next_uid(self) -> int:
        self.uid += 1
        return self.uid


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

#: which front end :func:`parse`/:func:`parse_stablehlo`/:func:`parse_hlo`
#: use when no explicit ``frontend=`` is given.  ``"streaming"`` is the
#: single-pass tokenizer front end (:mod:`repro_torch.core.ir.streaming`);
#: ``"legacy"`` is the multi-pass regex parser in this module, kept as the
#: independent reference implementation for the differential test harness
#: (tests/test_parser_diff.py asserts node-for-node Program equality).
DEFAULT_FRONTEND = "streaming"


def _resolve_frontend(frontend: str | None) -> str:
    fe = frontend or DEFAULT_FRONTEND
    if fe not in ("streaming", "legacy"):
        raise ValueError(f"unknown parser frontend {fe!r} "
                         "(expected 'streaming' or 'legacy')")
    return fe


def parse_stablehlo(text: str, frontend: str | None = None) -> Program:
    """Parse StableHLO-MLIR text (``lowered.as_text()``)."""
    if _resolve_frontend(frontend) == "streaming":
        from .streaming import parse_stablehlo_streaming
        return parse_stablehlo_streaming(text)
    return _MlirParser(text).parse()


def parse_hlo(text: str, frontend: str | None = None) -> Program:
    """Parse (optimized, possibly SPMD-partitioned) HLO text."""
    if _resolve_frontend(frontend) == "streaming":
        from .streaming import parse_hlo_streaming
        return parse_hlo_streaming(text)
    return _HloParser(text).parse()


#: calls to :func:`parse` in this process — parsing multi-MB HLO text is
#: the single most expensive per-workload cost, so the campaign engine's
#: plan store memoizes it per (workload, fidelity); tests and benchmarks
#: assert on this counter
PARSE_CALLS = 0


def parse(text: str, frontend: str | None = None) -> Program:
    """Auto-detect dialect."""
    global PARSE_CALLS
    PARSE_CALLS += 1
    head = text[:4096]
    if "HloModule" in head:
        return parse_hlo(text, frontend=frontend)
    return parse_stablehlo(text, frontend=frontend)
