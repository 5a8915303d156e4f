"""Run a StableHLO module with torch: the port's counterpart of compiling
a module with XLA and executing it.

:class:`Executor` parses a module with the port's front end (``core/ir``;
each :class:`~repro_torch.core.ir.graph.OpNode` keeps its raw line, from
which the attributes are read) and runs ``@main`` op by op on an explicit
device, the card unless the caller asks for the CPU.  It covers every op
that ``core/stablehlo.py`` writes into a compute region:

* ``dot_general`` (batch and contracting dims; a result type other than
  the operands', JAX's ``preferred_element_type``, converts the operands
  first), the elementwise unary, binary and ``compare`` ops, ``convert``,
  ``select``, ``constant``, ``iota``;
* ``broadcast_in_dim``, ``reshape``, ``transpose``, ``slice``,
  ``concatenate``, ``pad``, ``reverse``, the one-line ``reduce`` (add,
  maximum, minimum);
* ``gather``, ``scatter`` (an add, or a replacement) and
  ``dynamic_update_slice`` in the emitter's forms (an embedding lookup and
  its gradient, ``torch.index_select``, ``torch.gather``, ``scatter_add``
  and ``scatter`` along one dim, constant start indices); a gather clamps
  its indices and a scatter drops updates out of range, as XLA's do;
* ``convolution`` in JAX's three forms (explicit ``dim_numbers``, padding,
  lhs and rhs dilation, ``reverse``), ``reduce_window`` (a max pool, or a
  cumulative sum) and ``select_and_scatter`` (the pool's gradient),
  ``optimization_barrier``;
* ``sort`` (a stable sort by the first operand, the emitter's
  ``argsort``) and ``chlo.top_k`` (the MoE's routing);
* ``call``.  A function in the text's ``call`` table
  (:meth:`repro_torch.core.pipeline.Workload.calls`) runs through its
  operator, ``torch.ops.repro_torch.*`` (on the card the kernel, on the CPU
  the plain version), with the arguments the table records; a
  ``call @repro_torch.*`` missing from the table raises, since running its
  body op by op would time the plain version in place of the kernel.  Any
  other function runs its body.

Any other op raises ``NotImplementedError`` naming it, when the module is
compiled, before anything runs.  Each value is dropped after its last use,
so a region holds only what is live (an optimizer region over a model's
parameters would otherwise keep every pass).  The executor reads no
device value back to the host, so a run can be captured in a CUDA graph.
"""
from __future__ import annotations

import math
import re
import struct
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..library import call as call_operator
from .ir.graph import OpNode, Program
from .ir.parser import parse
from .ir.types import TensorType, mlir_types_in

#: the element types the emitter writes
DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
          "f64": torch.float64, "i32": torch.int32, "i1": torch.bool}


def torch_dtype(dt: str) -> torch.dtype:
    try:
        return DTYPES[dt]
    except KeyError:
        raise NotImplementedError(f"no torch dtype for element type {dt!r}")


def _ints(text: str) -> list[int]:
    return [int(x) for x in re.findall(r"-?\d+", text)]


def _field(raw: str, name: str, pattern: str = r"\[([^\]]*)\]") -> str | None:
    m = re.search(rf"\b{name}\s*=\s*{pattern}", raw)
    return m.group(1) if m else None


def _array(raw: str, name: str) -> list[int] | None:
    """``name = [1, 2]`` or ``name = array<i64: 1, 2>``."""
    v = _field(raw, name)
    if v is None:
        v = _field(raw, name, r"array<i64(?::([^>]*))?>")
    return None if v is None else _ints(v)


def signature(op: OpNode) -> tuple[list[TensorType], list[TensorType]]:
    """An op's (operand types, result types) from its own signature, which
    ends its last line.  The front end types an op printed over several
    lines from its attributes' tensors (a ``reduce_window``'s
    ``tensor<4x2xi64>`` padding), a collective printed on one line with its
    reduction region not at all, and a ``select`` with its predicate's type
    first."""
    lines = op.raw.strip().splitlines()
    n = len(_results(op))
    if len(lines) == 1 and len(op.result_types) == n:
        return list(op.operand_types), list(op.result_types)
    head, arrow, outs = lines[-1].rpartition("->")
    if arrow:
        return mlir_types_in(head.rpartition(" : ")[-1]), mlir_types_in(outs)
    types = mlir_types_in(lines[-1].rpartition(" : ")[-1])
    return types, types[-n:]


def _result_types(op: OpNode) -> list[TensorType]:
    return signature(op)[1]


def _operand_types(op: OpNode) -> list[TensorType]:
    return signature(op)[0]


def _results(op: OpNode) -> list[str]:
    return [r for r in op.results if "#" in r] or list(op.results[:1])


def _literal(text: str, dt: str):
    """A scalar literal as MLIR prints it: a float in decimal or as its
    bits in hex (a non-finite one), an integer, or a boolean."""
    text = text.strip()
    if text in ("true", "false"):
        return text == "true"
    if text.startswith("0x"):
        bits = int(text, 16)
        if dt == "f16":
            return struct.unpack("<e", struct.pack("<H", bits))[0]
        if dt == "f64":
            return struct.unpack("<d", struct.pack("<Q", bits))[0]
        if dt == "bf16":
            bits <<= 16
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if text.startswith("["):
        raise NotImplementedError("a constant other than a scalar")
    return float(text) if dt[0] in "fb" else int(text)


def _region_ops(op: OpNode) -> list[str]:
    """The op names inside the reduction or selection regions of a
    multi-line op, in order (``compare`` with its direction)."""
    out = []
    for line in op.raw.splitlines()[1:]:
        m = re.search(r"stablehlo\.(compare\s+\w+|\w+)", line)
        if m and not m.group(1).startswith("return"):
            out.append(" ".join(m.group(1).split()))
    return out


@dataclass
class _Step:
    fn: Callable
    operands: tuple[str, ...]
    results: tuple[str, ...]
    drop: tuple[str, ...] = ()


class _Function:
    """One compiled ``func.func``: its steps, with each value's last use,
    and the types of its results as its body computes them."""

    def __init__(self, executor: "Executor", name: str):
        program = executor.program
        self.name = name
        self.params = [a for a, _ in program.meta["func_args"].get(name, [])]
        self.param_types = [t for _, t in
                            program.meta["func_args"].get(name, [])]
        raw = program.meta["func_raw"][name]
        ret = re.findall(r"^\s*(?:func\.)?return\s+([^:]*?)\s*(?::|$)", raw,
                         re.M)
        self.returns = re.findall(r"%[\w.\-#]+", ret[-1]) if ret else []
        self.consts: dict[str, object] = {}
        self.steps: list[_Step] = []
        types: dict[str, TensorType] = {}
        for op in program.functions[name]:
            if op.op == "return":
                continue
            compile_op = _OPS.get(op.op)
            if compile_op is None:
                raise NotImplementedError(
                    f"the executor has no case for stablehlo op {op.op!r}: "
                    f"{op.raw.strip().splitlines()[0][:200]}")
            fn = compile_op(executor, self, op)
            self.steps.append(_Step(fn, tuple(op.operands),
                                    tuple(_results(op))))
            types.update(zip(_results(op), _result_types(op)))
        # a multi-result op's bare name is its first result, as in MLIR
        # (the reference's region_to_module returns one when none of the
        # op's results is used inside the region)
        first = {r.split("#")[0]: r for s in self.steps for r in s.results
                 if r.endswith("#0")}
        for step in self.steps:
            step.operands = tuple(first.get(n, n) for n in step.operands)
        self.returns = [first.get(n, n) for n in self.returns]
        self.return_types = [types.get(n) for n in self.returns]
        last: dict[str, int] = {}
        for i, step in enumerate(self.steps):
            for n in step.operands + step.results:
                last[n] = i
        for n in self.returns:
            last.pop(n, None)
        drops: dict[int, list[str]] = {}
        for n, i in last.items():
            drops.setdefault(i, []).append(n)
        for i, step in enumerate(self.steps):
            step.drop = tuple(drops.get(i, ()))

    def __call__(self, inputs, record: dict | None = None) -> list:
        if len(inputs) != len(self.params):
            raise ValueError(f"@{self.name} takes {len(self.params)} "
                             f"arguments, got {len(inputs)}")
        env = dict(zip(self.params, inputs))
        for step in self.steps:
            out = step.fn([env[n] for n in step.operands])
            if len(step.results) == 1:
                env[step.results[0]] = out
            else:
                env.update(zip(step.results, out))
            if record is not None:
                record.update((n, env[n]) for n in step.results)
            else:
                for n in step.drop:
                    env.pop(n, None)
        return [env[n] for n in self.returns]


class Executor:
    """A module (text or parsed :class:`Program`) compiled for ``device``
    (None: the card); ``calls`` is the text's ``call`` table."""

    def __init__(self, module: str | Program, *, calls: dict | None = None,
                 device=None):
        self.program = parse(module) if isinstance(module, str) else module
        if self.program.dialect != "stablehlo":
            raise NotImplementedError("the executor runs StableHLO text")
        self.device = resolve_device(device)
        self.calls = dict(calls or {})
        self._functions: dict[str, _Function] = {}
        self.main = self.function("main")

    def function(self, name: str) -> _Function:
        fn = self._functions.get(name)
        if fn is None:
            if name not in self.program.functions:
                raise ValueError(f"no function @{name} in the module")
            fn = self._functions[name] = _Function(self, name)
        return fn

    @property
    def input_types(self) -> list[TensorType]:
        return list(self.main.param_types)

    @property
    def output_types(self) -> list[TensorType]:
        """``@main``'s result types as its body computes them (the
        reference's region_to_module may declare others: a multi-line
        op's result typed from its attributes, a bare multi-result name
        typed as its last result)."""
        return list(self.main.return_types)

    def run(self, inputs, record: dict | None = None) -> list:
        """``@main`` on ``inputs`` (tensors on the executor's device);
        with ``record`` every value is kept there by name instead of being
        dropped after its last use."""
        return self.main(list(inputs), record)

    def run_function(self, name: str, inputs) -> list:
        """Function ``name``'s body, op by op, whether or not the ``call``
        table names it (a reference for the operator that stands for it)."""
        return self.function(name)(list(inputs))


# ---------------------------------------------------------------------------
# op compilers: (executor, function, op) -> fn(operand tensors) -> result(s)
# ---------------------------------------------------------------------------

_OPS: dict[str, Callable] = {}


def _compiles(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _out(op: OpNode) -> TensorType:
    return _result_types(op)[0]


@_compiles("constant")
def _constant(ex, fn, op):
    m = re.search(r"dense<(.*)>\s*:\s*tensor<", op.raw)
    if m is None:
        raise NotImplementedError(f"constant {op.raw.strip()[:120]}")
    t = _out(op)
    v = fn.consts[_results(op)[0]] = _literal(m.group(1), t.dtype)
    value = torch.tensor(v, dtype=torch_dtype(t.dtype),
                         device=ex.device).expand(t.shape)
    return lambda xs: value


@_compiles("iota")
def _iota(ex, fn, op):
    t = _out(op)
    dim = int(_field(op.raw, "dim", r"(\d+)"))
    view = [1] * len(t.shape)
    view[dim] = t.shape[dim]
    value = torch.arange(t.shape[dim], device=ex.device).to(
        torch_dtype(t.dtype)).reshape(view).expand(t.shape).contiguous()
    return lambda xs: value


def _logical(logical, bitwise):
    return lambda a, *b: (logical if a.dtype == torch.bool else bitwise)(a,
                                                                         *b)


def _divide(a, b):
    if a.is_floating_point():
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="trunc")


UNARY = {"negate": torch.neg, "abs": torch.abs, "exponential": torch.exp,
         "log": torch.log, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
         "sine": torch.sin, "cosine": torch.cos, "tanh": torch.tanh,
         "logistic": torch.sigmoid, "log_plus_one": torch.log1p,
         "not": _logical(torch.logical_not, torch.bitwise_not)}
BINARY = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
          "divide": _divide, "maximum": torch.maximum,
          "minimum": torch.minimum, "power": torch.pow,
          "and": _logical(torch.logical_and, torch.bitwise_and),
          "or": _logical(torch.logical_or, torch.bitwise_or),
          # the remainder takes the dividend's sign, as C's fmod
          "remainder": torch.fmod}
COMPARE = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt, "LE": torch.le,
           "GT": torch.gt, "GE": torch.ge}


@_compiles(*UNARY)
def _unary(ex, fn, op):
    f = UNARY[op.op]
    return lambda xs: f(xs[0])


@_compiles(*BINARY)
def _binary(ex, fn, op):
    f = BINARY[op.op]
    return lambda xs: f(xs[0], xs[1])


@_compiles("compare")
def _compare(ex, fn, op):
    m = re.search(r"compare\s+(\w+)\s*,", op.raw)
    f = COMPARE[m.group(1)]
    return lambda xs: f(xs[0], xs[1])


@_compiles("convert")
def _convert(ex, fn, op):
    dt = torch_dtype(_out(op).dtype)
    return lambda xs: xs[0].to(dt)


@_compiles("partition_id")
def _partition_id(ex, fn, op):
    """The partition this run stands for: 0, the rank a per-rank text was
    traced as (``launch/mesh.py::fake_world``), held as an int32 (the
    text's ``ui32`` is read only through a ``convert``)."""
    value = torch.zeros((), dtype=torch.int32, device=ex.device)
    return lambda xs: value


@_compiles("select")
def _select(ex, fn, op):
    return lambda xs: torch.where(xs[0], xs[1], xs[2])


@_compiles("optimization_barrier")
def _barrier(ex, fn, op):
    if len(_results(op)) == 1:
        return lambda xs: xs[0]
    return lambda xs: list(xs)


@_compiles("broadcast_in_dim")
def _broadcast(ex, fn, op):
    shape = _out(op).shape
    dims = _ints(_field(op.raw, "dims"))
    # the operand's dims in the order of the result dims they map to
    order = sorted(range(len(dims)), key=dims.__getitem__)
    view = [1] * len(shape)
    for i in order:
        view[dims[i]] = _operand_types(op)[0].shape[i]
    if order == sorted(order):
        return lambda xs: xs[0].reshape(view).expand(shape)
    return lambda xs: xs[0].permute(order).reshape(view).expand(shape)


@_compiles("reshape")
def _reshape(ex, fn, op):
    shape = _out(op).shape
    return lambda xs: xs[0].reshape(shape)


@_compiles("transpose")
def _transpose(ex, fn, op):
    perm = _ints(_field(op.raw, "dims"))
    return lambda xs: xs[0].permute(perm)


@_compiles("reverse")
def _reverse(ex, fn, op):
    dims = _ints(_field(op.raw, "dims"))
    return lambda xs: torch.flip(xs[0], dims)


@_compiles("slice")
def _slice(ex, fn, op):
    m = re.search(r"stablehlo\.slice\s+%[\w.\-#]+\s*\[([^\]]*)\]", op.raw)
    if m is None:
        raise NotImplementedError(f"slice {op.raw.strip()[:120]}")
    index = []
    for part in m.group(1).split(","):
        s, l, *st = (int(v) for v in part.split(":"))
        index.append(slice(s, l, st[0] if st else 1))
    index = tuple(index)
    return lambda xs: xs[0][index]


@_compiles("concatenate")
def _concatenate(ex, fn, op):
    dim = int(_field(op.raw, "dim", r"(\d+)"))
    return lambda xs: torch.cat(xs, dim)


def _const(fn, op, i: int, what: str):
    """The compile-time value of operand ``i`` (a scalar ``constant``)."""
    name = op.operands[i]
    if name not in fn.consts:
        raise NotImplementedError(f"{op.op} whose {what} is not a constant "
                                  f"of the module")
    return fn.consts[name]


@_compiles("pad")
def _pad(ex, fn, op):
    low, high = _ints(_field(op.raw, "low")), _ints(_field(op.raw, "high"))
    if any(_ints(_field(op.raw, "interior"))):
        raise NotImplementedError("pad with interior padding")
    value = _const(fn, op, 1, "padding value")
    shape = _out(op).shape
    # a negative edge crops the input, a positive one pads it
    src = tuple(slice(max(-lo, 0), None if hi >= 0 else hi)
                for lo, hi in zip(low, high))
    dst = tuple(slice(max(lo, 0), n - max(hi, 0))
                for n, lo, hi in zip(shape, low, high))

    def run(xs):
        out = xs[0].new_full(shape, value)
        out[dst] = xs[0][src]
        return out
    return run


@_compiles("reduce")
def _reduce(ex, fn, op):
    m = re.search(r"applies\s+stablehlo\.(\w+)\s+across\s+dimensions\s*=\s*"
                  r"\[([^\]]*)\]", op.raw)
    if m is None:
        raise NotImplementedError("reduce with a region body (only the "
                                  "one-line form is run)")
    kind, dims = m.group(1), _ints(m.group(2))
    if kind == "add":
        def reduce(x):
            return torch.sum(x, dims, dtype=x.dtype) if dims else x
    elif kind in ("maximum", "minimum"):
        f = torch.amax if kind == "maximum" else torch.amin

        def reduce(x):
            return f(x, dims) if dims else x
    else:
        raise NotImplementedError(f"reduce with stablehlo.{kind}")
    # an initial value that changes nothing is not combined in
    dt = _operand_types(op)[0].dtype
    if fn.consts.get(op.operands[1]) == _NEUTRAL[kind][
            dt if dt in ("i32", "i1") else "float"]:
        return lambda xs: reduce(xs[0])
    combine = BINARY[kind]
    return lambda xs: combine(reduce(xs[0]), xs[1])


#: the initial values of a reduction that change nothing, as the emitter
#: writes them for each element type
_NEUTRAL = {"add": {"float": 0.0, "i32": 0, "i1": False},
            "maximum": {"float": -math.inf, "i32": -2 ** 31, "i1": False},
            "minimum": {"float": math.inf, "i32": 2 ** 31 - 1, "i1": True}}


@_compiles("dot_general")
def _dot_general(ex, fn, op):
    batch = re.search(r"batching_dims\s*=\s*\[([^\]]*)\]\s*x\s*\[([^\]]*)\]",
                      op.raw)
    contract = re.search(r"contracting_dims\s*=\s*\[([^\]]*)\]\s*x\s*"
                         r"\[([^\]]*)\]", op.raw)
    lb, rb = (_ints(batch.group(1)), _ints(batch.group(2))) if batch else \
        ([], [])
    lc, rc = _ints(contract.group(1)), _ints(contract.group(2))
    a_t, b_t = _operand_types(op)[:2]
    out = _out(op)
    dt = torch_dtype(out.dtype)
    lf = [d for d in range(len(a_t.shape)) if d not in lb and d not in lc]
    rf = [d for d in range(len(b_t.shape)) if d not in rb and d not in rc]
    bsz = math.prod(a_t.shape[d] for d in lb)
    m = math.prod(a_t.shape[d] for d in lf)
    k = math.prod(a_t.shape[d] for d in lc)
    n = math.prod(b_t.shape[d] for d in rf)
    a_perm, b_perm = lb + lf + lc, rb + rc + rf

    def run(xs):
        a, b = xs
        if a.dtype != dt:
            a = a.to(dt)
        if b.dtype != dt:
            b = b.to(dt)
        a, b = a.permute(a_perm), b.permute(b_perm)
        if bsz == 1:
            r = torch.mm(a.reshape(m, k), b.reshape(k, n))
        else:
            r = torch.bmm(a.reshape(bsz, m, k), b.reshape(bsz, k, n))
        return r.reshape(out.shape)
    return run


def _dnums(raw: str, kind: str) -> dict[str, list[int]]:
    m = re.search(rf"#stablehlo\.{kind}<([^>]*)>", raw)
    out = {}
    for name, v in re.findall(r"(\w+)\s*=\s*(\[[^\]]*\]|\d+)", m.group(1)):
        out[name] = _ints(v)
    return out


def _check_index(op: OpNode, indices: TensorType, ivd: int) -> None:
    if ivd != len(indices.shape) - 1 or indices.shape[-1] != 1:
        raise NotImplementedError(f"{op.op} with an index vector other than "
                                  "its indices' last dim, of size 1")


@_compiles("gather")
def _gather(ex, fn, op):
    d = _dnums(op.raw, "gather")
    x_t, i_t = _operand_types(op)[:2]
    sizes = _array(op.raw, "slice_sizes")
    rank = len(x_t.shape)
    ivd = d["index_vector_dim"][0]
    start = d.get("start_index_map", [])
    batch = d.get("operand_batching_dims", [])
    if len(start) != 1:
        raise NotImplementedError(f"gather over {len(start)} index dims")
    _check_index(op, i_t, ivd)
    dim = start[0]
    n = x_t.shape[dim]
    if (not batch and dim == 0 and d.get("collapsed_slice_dims") == [0]
            and sizes == [1, *x_t.shape[1:]]
            and d.get("offset_dims") == list(range(len(i_t.shape) - 1,
                                                   len(i_t.shape) + rank - 2))):
        out = _out(op).shape      # an embedding lookup: x[idx]

        def run(xs):
            i = xs[1][..., 0].clamp(0, n - 1)
            return torch.index_select(xs[0], 0, i.reshape(-1)).reshape(out)
        return run
    if (batch == [a for a in range(rank) if a != dim]
            and d.get("start_indices_batching_dims") == batch
            and d.get("collapsed_slice_dims") == [dim] and sizes == [1] * rank):
        def run(xs):               # torch.gather along dim
            i = xs[1][..., 0].clamp(0, n - 1).long()
            return torch.gather(xs[0], dim, i)
        return run
    if (not batch and len(i_t.shape) == 2 and ivd == 1
            and d.get("collapsed_slice_dims") == [dim]
            and sizes == [1 if a == dim else s for a, s in
                          enumerate(x_t.shape)]
            and d.get("offset_dims") == [a for a in range(rank) if a != dim]):
        def run(xs):               # torch.index_select along dim
            i = xs[1][:, 0].clamp(0, n - 1)
            return torch.index_select(xs[0], dim, i)
        return run
    raise NotImplementedError(f"gather with dimension numbers {d} and slice "
                              f"sizes {sizes} (the emitter's three forms run)")


def _replaces(op: OpNode) -> bool:
    """Whether a scatter's update region returns its second argument (the
    update replaces the operand's element, JAX's ``.at[].set``)."""
    args = re.search(r"\^bb0\(\s*%[\w.]+\s*:[^,]*,\s*(%[\w.]+)\s*:", op.raw)
    ret = re.search(r"stablehlo\.return\s+(%[\w.]+)", op.raw)
    return (not _region_ops(op) and args is not None and ret is not None
            and args.group(1) == ret.group(1))


@_compiles("scatter")
def _scatter(ex, fn, op):
    replace = _replaces(op)
    if not replace and _region_ops(op) != ["add"]:
        raise NotImplementedError(f"scatter whose update computation is "
                                  f"{_region_ops(op)}, neither an add nor "
                                  "a replacement")
    d = _dnums(op.raw, "scatter")
    x_t = _result_types(op)[0]
    rank = len(x_t.shape)
    ivd = d["index_vector_dim"][0]
    to_operand = d.get("scatter_dims_to_operand_dims", [])
    batch = d.get("input_batching_dims", [])
    if len(to_operand) != 1 or d.get("inserted_window_dims") != to_operand:
        raise NotImplementedError(f"scatter with dimension numbers {d}")
    _check_index(op, _operand_types(op)[1], ivd)
    dim = to_operand[0]
    n = x_t.shape[dim]

    def valid(xs):
        # XLA drops an update whose index is out of range
        i = xs[1][..., 0]
        ok = (i >= 0) & (i < n)
        return i.clamp(0, n - 1), ok

    upd_rank = len(_operand_types(op)[2].shape)
    if replace:
        if batch != [a for a in range(rank) if a != dim] or d.get(
                "scatter_indices_batching_dims") != batch:
            raise NotImplementedError(f"a replacing scatter with dimension "
                                      f"numbers {d}")

        pad = [0, 0] * (rank - 1 - dim) + [0, 1]

        def run(xs):               # torch.scatter along dim
            # an update out of range goes to a spare slot, cut off after
            i = xs[1][..., 0].long()
            i = torch.where((i >= 0) & (i < n), i, n)
            return torch.scatter(F.pad(xs[0], pad), dim, i,
                                 xs[2]).narrow(dim, 0, n)
        return run
    if (not batch and dim == 0 and d.get("update_window_dims")
            == list(range(upd_rank - rank + 1, upd_rank))):
        def run(xs):               # x[idx] += updates (an embedding's grad)
            i, ok = valid(xs)
            upd = xs[2].reshape(-1, *x_t.shape[1:])
            ok = ok.reshape(-1, *([1] * (rank - 1)))
            return torch.index_add(xs[0], 0, i.reshape(-1),
                                   torch.where(ok, upd, 0))
        return run
    if (batch == [a for a in range(rank) if a != dim]
            and d.get("scatter_indices_batching_dims") == batch):
        def run(xs):               # torch.scatter_add along dim
            i, ok = valid(xs)
            return torch.scatter_add(xs[0], dim, i.long(),
                                     torch.where(ok, xs[2], 0))
        return run
    raise NotImplementedError(f"scatter with dimension numbers {d}")


@_compiles("dynamic_update_slice")
def _dynamic_update_slice(ex, fn, op):
    x_t, upd_t = _operand_types(op)[:2]
    starts = [_const(fn, op, i, "start index")
              for i in range(2, len(op.operands))]
    # XLA clamps each start so that the update fits
    index = tuple(slice(b, b + u) for b, u in zip(
        (min(max(s, 0), n - u) for s, n, u in
         zip(starts, x_t.shape, upd_t.shape)), upd_t.shape))

    def run(xs):
        out = xs[0].clone(memory_format=torch.contiguous_format)
        out[index] = xs[1]
        return out
    return run


_CONV_LABELS = ("b", "f", "0", "1")


def _conv_attrs(raw: str) -> dict:
    m = re.search(r"dim_numbers\s*=\s*\[([^\]]*)\]x\[([^\]]*)\]->\[([^\]]*)\]",
                  raw)
    lhs, rhs, out = ([s.strip() for s in g.split(",")] for g in m.groups())
    window = re.search(r"window\s*=\s*\{([^}]*)\}", raw)
    w = window.group(1) if window else ""

    def arr(name, default):
        v = re.search(rf"{name}\s*=\s*\[((?:[^\[\]]|\[[^\]]*\])*)\]", w)
        return v.group(1) if v else default

    pads = [_ints(p) for p in re.findall(r"\[([^\[\]]*)\]",
                                          arr("pad", "[0, 0], [0, 0]"))]
    return {
        "lhs": lhs, "rhs": rhs, "out": out,
        "stride": _ints(arr("stride", "1, 1")),
        "pad": pads,
        "lhs_dilate": _ints(arr("lhs_dilate", "1, 1")),
        "rhs_dilate": _ints(arr("rhs_dilate", "1, 1")),
        "reverse": [v.strip() == "true" for v in
                    arr("reverse", "false, false").split(",")],
        "feature_groups": int(_field(raw, "feature_group_count", r"(\d+)")
                              or 1),
        "batch_groups": int(_field(raw, "batch_group_count", r"(\d+)") or 1),
    }


@_compiles("convolution")
def _convolution(ex, fn, op):
    a = _conv_attrs(op.raw)
    if sorted(a["lhs"]) != sorted(["b", "f", "0", "1"]) or \
            sorted(a["rhs"]) != sorted(["o", "i", "0", "1"]):
        raise NotImplementedError(f"convolution with dim_numbers "
                                  f"{a['lhs']}x{a['rhs']} (two spatial dims "
                                  "run)")
    if a["batch_groups"] != 1:
        raise NotImplementedError("convolution with batch_group_count "
                                  f"{a['batch_groups']}")
    lhs_perm = [a["lhs"].index(c) for c in _CONV_LABELS]
    rhs_perm = [a["rhs"].index(c) for c in ("o", "i", "0", "1")]
    out_perm = [_CONV_LABELS.index(c) for c in a["out"]]
    stride, dil, lhs_dil = a["stride"], a["rhs_dilate"], a["lhs_dilate"]
    (lo0, hi0), (lo1, hi1) = a["pad"]
    groups = a["feature_groups"]
    flip = [2 + i for i, r in enumerate(a["reverse"]) if r]
    k = [_operand_types(op)[1].shape[a["rhs"].index(c)] for c in ("0", "1")]
    # JAX's data gradient of a strided convolution (the lhs dilated, stride
    # 1) is a transposed convolution, and its weight gradient (the images
    # contracted: lhs dim 0 is not the batch) the gradient of the weight:
    # each runs as cuDNN's own backward path
    tp = [kk - 1 - lo for kk, lo in zip(k, (lo0, lo1))]
    op_pad = [hi0 - lo0, hi1 - lo1]
    transposed = (any(d > 1 for d in lhs_dil) and stride == [1, 1]
                  and dil == [1, 1] and groups == 1
                  and all(p >= 0 for p in tp)
                  and all(0 <= o < s for o, s in zip(op_pad, lhs_dil)))
    weight_grad = (a["lhs"][0] != "b" and lhs_dil == [1, 1]
                   and stride == [1, 1] and groups == 1)

    def run(xs):
        x, w = xs[0].permute(lhs_perm), xs[1].permute(rhs_perm)
        if flip:
            w = torch.flip(w, flip)
        if transposed:
            y = F.conv_transpose2d(x, torch.flip(w, [2, 3]).transpose(0, 1),
                                   stride=lhs_dil, padding=tp,
                                   output_padding=op_pad)
            return y.permute(out_perm)
        if weight_grad:
            if (lo0, hi0, lo1, hi1) != (0, 0, 0, 0):
                x = F.pad(x, (lo1, hi1, lo0, hi0))
            size = (w.shape[0], x.shape[0],
                    *(n - (kk - 1) * d for n, kk, d in
                      zip(x.shape[2:], w.shape[2:], dil)))
            y = torch.nn.grad.conv2d_weight(x.transpose(0, 1), size,
                                            w.transpose(0, 1), stride=dil)
            return y.transpose(0, 1).permute(out_perm)
        if any(d > 1 for d in lhs_dil):
            n, c, h, wd = x.shape
            z = x.new_zeros(n, c, (h - 1) * lhs_dil[0] + 1,
                            (wd - 1) * lhs_dil[1] + 1)
            z[:, :, ::lhs_dil[0], ::lhs_dil[1]] = x
            x = z
        if (lo0, hi0, lo1, hi1) != (0, 0, 0, 0):
            x = F.pad(x, (lo1, hi1, lo0, hi0))
        return F.conv2d(x, w, stride=stride, dilation=dil,
                        groups=groups).permute(out_perm)
    return run


def _window_attrs(raw: str, rank: int) -> tuple[list, list, list]:
    """A window's (dimensions, strides, padding) over every dim; dilations
    other than 1 raise."""
    window = _array(raw, "window_dimensions")
    strides = _array(raw, "window_strides") or [1] * rank
    p = re.search(r"padding\s*=\s*dense<([^>]*)>", raw)
    if p is None or p.group(1).strip() == "0":
        pads = [[0, 0]] * rank
    else:
        pads = [_ints(g) for g in re.findall(r"\[([^\[\]]*)\]", p.group(1))]
    for name in ("base_dilations", "window_dilations"):
        v = _array(raw, name)
        if v is not None and any(x != 1 for x in v):
            raise NotImplementedError(f"a window with {name} {v}")
    return window, strides, pads


def _window(raw: str, rank: int) -> tuple[list, list, list]:
    """A pool's window over NCHW's spatial dims."""
    window, strides, pads = _window_attrs(raw, rank)
    if rank != 4 or window[:2] != [1, 1] or strides[:2] != [1, 1] or \
            pads[0] != [0, 0] or pads[1] != [0, 0]:
        raise NotImplementedError(f"a window {window} with strides "
                                  f"{strides} over other than NCHW's spatial "
                                  "dims")
    return window[2:], strides[2:], pads[2:]


def _prefix_sum(ex, fn, op):
    """A ``reduce_window`` of ``add`` whose window spans one dim, padded by
    its length less one in front: a cumulative sum (JAX's ``cumsum``)."""
    shape = _operand_types(op)[0].shape
    window, strides, pads = _window_attrs(op.raw, len(shape))
    spans = [d for d, (w, n, p) in enumerate(zip(window, shape, pads))
             if w == n and p == [n - 1, 0] and n > 1]
    if len(spans) != 1 or any(
            (w, s, p) != (1, 1, [0, 0])
            for d, (w, s, p) in enumerate(zip(window, strides, pads))
            if d != spans[0]) or strides[spans[0]] != 1:
        raise NotImplementedError(f"reduce_window of add with window "
                                  f"{window}, strides {strides}, padding "
                                  f"{pads} (only a cumulative sum is run)")
    dim = spans[0]
    init = _const(fn, op, 1, "initial value")

    def run(xs):
        y = torch.cumsum(xs[0], dim, dtype=xs[0].dtype)
        return y if init == 0 else y + xs[1]
    return run


@_compiles("reduce_window")
def _reduce_window(ex, fn, op):
    kinds = _region_ops(op)
    if kinds == ["add"]:
        return _prefix_sum(ex, fn, op)
    if kinds != ["maximum"]:
        raise NotImplementedError(f"reduce_window of {kinds}")
    kernel, stride, pads = _window(op.raw,
                                   len(_operand_types(op)[0].shape))
    init = _const(fn, op, 1, "initial value")
    # a padded element is the initial value
    flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])

    def run(xs):
        x = F.pad(xs[0], flat, value=init) if any(flat) else xs[0]
        y = F.max_pool2d(x, kernel, stride)
        return y if init == -math.inf else torch.maximum(y, xs[1])
    return run


@_compiles("select_and_scatter")
def _select_and_scatter(ex, fn, op):
    kinds = _region_ops(op)
    if kinds != ["compare GE", "add"]:
        raise NotImplementedError(f"select_and_scatter of {kinds}")
    kernel, stride, pads = _window(op.raw, len(_operand_types(op)[0].shape))
    if any(map(any, pads)):
        raise NotImplementedError("select_and_scatter with padding")
    init = _const(fn, op, 2, "initial value")

    def run(xs):
        x, src = xs[0], xs[1]
        # each window's first maximum takes its source value, summed where
        # windows overlap: PyTorch's max-pool backward
        _, idx = F.max_pool2d(x, kernel, stride, return_indices=True)
        y = torch.ops.aten.max_pool2d_with_indices_backward(
            src, x, kernel, stride, [0, 0], [1, 1], False, idx)
        return y if init == 0 else y + xs[2]
    return run


@_compiles("sort")
def _sort(ex, fn, op):
    """A stable sort of every operand by the first, whose comparator is
    ``LT`` or ``GT`` of the first pair of block arguments (the emitter's
    ``argsort``)."""
    dim = int(_field(op.raw, "dimension", r"(-?\d+)"))
    kinds = _region_ops(op)
    block = re.search(r"\^bb0\(([^)]*)\)", op.raw)
    args = re.findall(r"(%[\w.\-]+)\s*:", block.group(1)) if block else []
    cmp = re.search(r"compare\s+\w+,\s*(%[\w.\-]+),\s*(%[\w.\-]+)", op.raw)
    if (kinds not in (["compare LT"], ["compare GT"]) or cmp is None
            or list(cmp.groups()) != args[:2]):
        raise NotImplementedError(f"sort with the comparator {kinds} (only "
                                  "LT or GT of the first operand is run)")
    descending = kinds == ["compare GT"]

    def run(xs):
        _, idx = torch.sort(xs[0], dim=dim, stable=True,
                            descending=descending)
        return [torch.gather(x, dim, idx) for x in xs]
    return run


@_compiles("top_k")
def _top_k(ex, fn, op):
    """``chlo.top_k``: the k largest along the last dim, descending, and
    their indices."""
    k = int(_field(op.raw, "k", r"(\d+)"))

    def run(xs):
        values, indices = torch.topk(xs[0], k, dim=-1)
        return [values, indices.to(torch.int32)]
    return run


@_compiles("call")
def _call(ex, fn, op):
    name = op.called[0] if op.called else \
        re.search(r"call\s+@([\w.\-]+)", op.raw).group(1)
    entry = ex.calls.get(name)
    if entry is not None:
        overload = entry.overload
        multi = len(_results(op)) > 1

        def run(xs):
            out = call_operator(overload,
                                *entry.bind([x.contiguous() for x in xs]))
            return list(out) if multi else out
        return run
    if name.startswith("repro_torch."):
        raise ValueError(
            f"call @{name}: an operator of the port's library that the "
            "module's call table does not name; its body is the plain "
            "version, and running it would time that in place of the "
            "kernel (pass the export's Workload.calls)")
    body = ex.function(name)
    multi = len(_results(op)) > 1
    return lambda xs: body(xs) if multi else body(xs)[0]
