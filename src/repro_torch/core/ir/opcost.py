"""Per-operator FLOP / byte accounting over the unified op graph.

This is the "operator-level metrics" layer the paper's analytical estimator
aggregates (§III-B(c)(i)).  FLOPs for contractions come from parsed dimension
numbers; elementwise ops count one (or a few) flops per output element;
pure data-movement ops cost bytes only.

Unlike XLA's ``cost_analysis`` (which counts ``while`` bodies ONCE — verified
empirically: a scan of length 4 and length 8 report identical flops), this
accounting multiplies region costs by the loop trip count, so scan-over-layers
models report full-step numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .graph import OpNode, Program, ZERO_COST_OPS

# transcendental-ish ops: weight >1 flop/element
_EXPENSIVE_ELEMENTWISE = {
    "exponential": 4, "exp": 4, "log": 4, "logistic": 6, "tanh": 6,
    "rsqrt": 2, "sqrt": 2, "power": 4, "sine": 4, "cosine": 4,
    "erf": 8, "exponential_minus_one": 4, "log_plus_one": 4, "cbrt": 4,
    "atan2": 8, "divide": 1,
}
# simple elementwise / cheap ops: 1 flop/element
_SIMPLE_ELEMENTWISE = {
    "add", "subtract", "multiply", "maximum", "minimum", "negate", "abs",
    "and", "or", "xor", "not", "compare", "select", "clamp", "floor",
    "ceil", "round_nearest_afz", "round_nearest_even", "sign",
    "shift_left", "shift_right_logical", "shift_right_arithmetic",
    "remainder", "is_finite", "popcnt", "clz", "reduce_precision",
    "stochastic_convert",
}
# data movement: 0 flops, bytes = in+out
_MOVEMENT = {
    "reshape", "transpose", "broadcast_in_dim", "convert", "bitcast",
    "bitcast_convert", "copy", "slice", "dynamic_slice",
    "dynamic_update_slice", "concatenate", "pad", "reverse", "gather",
    "scatter", "real", "imag", "copy_start", "copy_done", "domain",
}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0          # HBM traffic estimate (operands + results)
    transcendentals: float = 0.0
    by_op: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        self.transcendentals += other.transcendentals
        for k, v in other.by_op.items():
            self.by_op[k] = self.by_op.get(k, 0.0) + v
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] = self.bytes_by_op.get(k, 0.0) + v
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, self.transcendentals * k,
                    {n: v * k for n, v in self.by_op.items()},
                    {n: v * k for n, v in self.bytes_by_op.items()})


def _dot_flops(op: OpNode) -> float:
    if not op.operand_types or len(op.operand_types) < 2:
        # fall back: 2 * out_elems * sqrt-ish — better to use result only
        out = sum(t.num_elements for t in op.result_types)
        return 2.0 * out
    lhs, rhs = op.operand_types[0], op.operand_types[1]
    lc = op.attrs.get("lhs_contract", ())
    lb = op.attrs.get("lhs_batch", ())
    if any(d >= len(lhs.shape) for d in (*lc, *lb)) or any(
            d >= len(rhs.shape)
            for d in (*op.attrs.get("rhs_contract", ()),
                      *op.attrs.get("rhs_batch", ()))):
        # malformed/mismatched operand types: fall back to output-based bound
        return 2.0 * sum(t.num_elements for t in op.result_types)
    batch = math.prod(lhs.shape[d] for d in lb) if lb else 1
    contract = math.prod(lhs.shape[d] for d in lc) if lc else 1
    m = math.prod(d for i, d in enumerate(lhs.shape) if i not in lc and i not in lb)
    rb = op.attrs.get("rhs_batch", ())
    rc = op.attrs.get("rhs_contract", ())
    n = math.prod(d for i, d in enumerate(rhs.shape) if i not in rc and i not in rb)
    return 2.0 * batch * m * n * contract


def _conv_flops(op: OpNode) -> float:
    if len(op.operand_types) < 2 or not op.result_types:
        return 0.0
    lhs, rhs, out = op.operand_types[0], op.operand_types[1], op.result_types[0]
    groups = op.attrs.get("feature_group_count", 1) or 1
    # kernel: spatial dims are everything except input/output-feature dims.
    # With dim_labels like [0, 1, i, o] / 01io, the i/o positions vary; the
    # product of ALL kernel dims = prod(spatial) * Cin/g * Cout, so
    # flops = 2 * out_spatial*batch * prod(kernel)/Cout * Cout / g ... simplify:
    kernel_elems = rhs.num_elements            # spatial * (Cin/g) * Cout
    out_elems = out.num_elements               # batch * out_spatial * Cout
    cout = _conv_out_features(op, rhs, out)
    per_out = kernel_elems / max(cout, 1)      # spatial * Cin/g
    return 2.0 * out_elems * per_out / 1.0     # groups already folded in Cin/g


def _conv_out_features(op: OpNode, rhs, out) -> int:
    labels = op.attrs.get("dim_labels", "")
    # HLO form: b01f_01io->b01f ; MLIR form: [b, 0, 1, f]x[0, 1, i, o]->[b, 0, 1, f]
    try:
        if "x" in labels and "[" in labels:
            kernel_part = labels.split("x")[1].split("->")[0]
            toks = [t.strip() for t in kernel_part.strip("[]").split(",")]
            o_pos = toks.index("o")
            return rhs.shape[o_pos]
        if "_" in labels:
            kernel_part = labels.split("_")[1].split("->")[0]
            o_pos = kernel_part.index("o")
            return rhs.shape[o_pos]
    except (ValueError, IndexError):
        pass
    return rhs.shape[-1] if rhs.shape else 1


_SLICE_LIKE = {"dynamic_slice", "slice", "gather", "get_tuple_element",
               "bitcast", "reshape"}


def _fusion_input_bytes(body_ops: list[OpNode]) -> float:
    """HBM read bytes at a fusion's boundary, slice-aware.

    For each fusion ``parameter``, if every direct consumer in the body is a
    slice-like op, charge the consumers' OUTPUT sizes (only those elements
    are read); otherwise charge the parameter's full size."""
    total = 0.0
    consumers: dict[str, list[OpNode]] = {}
    for sub in body_ops:
        for o in sub.operands:
            consumers.setdefault(o, []).append(sub)
    for sub in body_ops:
        if sub.op != "parameter":
            continue
        psize = sum(t.nbytes for t in sub.result_types)
        users = [u for r in sub.results for u in consumers.get(r, [])]
        if users and all(u.op in _SLICE_LIKE for u in users):
            read = sum(t.nbytes for u in users for t in u.result_types)
            total += min(psize, read)
        elif users and all(u.op == "dynamic_update_slice"
                           and u.operands and u.operands[0] in sub.results
                           for u in users):
            # in-place buffer update: only the update window moves
            upd = sum(u.operand_types[1].nbytes for u in users
                      if len(u.operand_types) > 1)
            total += min(psize, upd)
        else:
            total += psize
    return total


def op_cost(op: OpNode, program: Program | None = None) -> Cost:
    """Cost of a single op, including its regions (× trip count for loops)."""
    c = Cost()
    name = op.op
    out_elems = sum(t.num_elements for t in op.result_types)
    in_bytes = sum(t.nbytes for t in op.operand_types)
    out_bytes = sum(t.nbytes for t in op.result_types)

    if name in ZERO_COST_OPS or op.is_async_done:
        return c
    if op.is_collective:
        # collectives cost no device flops; bytes handled by the network model
        return c
    if name == "while":
        body = op.regions[-1] if op.regions else []
        inner = Cost()
        for sub in body:
            inner += op_cost(sub, program)
        return inner.scaled(max(op.trip_count, 1))
    if name in ("fusion", "call", "map", "conditional", "sort", "composite"):
        inner = Cost()
        body_ops: list[OpNode] = []
        for region in op.regions:
            body_ops.extend(region)
            for sub in region:
                inner += op_cost(sub, program)
        if program is not None and not op.regions and op.called:
            for callee in op.called:
                body = program.resolve(callee)
                if body:
                    body_ops.extend(body)
                    for sub in body:
                        inner += op_cost(sub, program)
        # fused region: memory traffic only at boundaries (paper §IV-C1).
        # Boundary operands consumed exclusively through slice-like body ops
        # are charged at the SLICE size, not the full operand: a fusion that
        # dynamic-slices layer i's weights out of a scan-stacked [L, ...]
        # parameter reads only that layer from HBM (naive accounting charged
        # the full stack per loop iteration — 236 TB/chip on deepseek-v3).
        in_eff = _fusion_input_bytes(body_ops) if body_ops else in_bytes
        inner.bytes = in_eff + out_bytes
        inner.bytes_by_op = {name: inner.bytes}
        if name == "sort":
            inner.flops += out_elems * math.log2(max(out_elems, 2))
        return inner

    if name == "dot_general":
        c.flops = _dot_flops(op)
        c.bytes = in_bytes + out_bytes
    elif name == "convolution":
        c.flops = _conv_flops(op)
        c.bytes = in_bytes + out_bytes
    elif name in ("reduce", "reduce_window"):
        c.flops = sum(t.num_elements for t in op.operand_types) or out_elems
        c.bytes = in_bytes + out_bytes
    elif name in _EXPENSIVE_ELEMENTWISE:
        w = _EXPENSIVE_ELEMENTWISE[name]
        c.flops = out_elems * w
        c.transcendentals = out_elems
        c.bytes = in_bytes + out_bytes
    elif name in _SIMPLE_ELEMENTWISE:
        c.flops = out_elems
        c.bytes = in_bytes + out_bytes
    elif name in _MOVEMENT:
        if name in ("dynamic_slice", "slice", "gather"):
            c.bytes = 2 * out_bytes          # read the window, write it
        elif name == "dynamic_update_slice" and len(op.operand_types) > 1:
            c.bytes = 2 * op.operand_types[1].nbytes
        else:
            c.bytes = in_bytes + out_bytes
    elif name in ("custom_call", "batch_norm_training", "batch_norm_grad",
                  "cholesky", "triangular_solve", "fft"):
        c.flops = out_elems * 2
        c.bytes = in_bytes + out_bytes
    else:
        # unknown op: treat as elementwise so nothing silently disappears
        c.flops = out_elems
        c.bytes = in_bytes + out_bytes
    c.by_op[name] = c.flops
    c.bytes_by_op[name] = c.bytes
    return c


def program_cost(program: Program) -> Cost:
    total = Cost()
    for op in program.entry:
        total += op_cost(op, program)
    return total
