"""Emit StableHLO MLIR text from a traced step (fx graph -> text).

Each ATen op of a :class:`repro_torch.core.export.Traced` graph is written
as the StableHLO ops that ``jax.jit(f).lower(...).as_text()`` prints for the
same function, in the same textual form, so that the reference's two
parsers read it and its cost model counts it as it counts a JAX export:
``dot_general`` for ``mm``/``bmm``, a one-line ``reduce`` for a sum or a
max, ``broadcast_in_dim`` for implicit broadcasting, ``gather``/``scatter``
for indexing, and so on.  An operator of the port's library becomes a
``call`` of a private function holding its plain version's ops (one
function per distinct call), and the layer barrier an
``optimization_barrier``.  The operator's other arguments (a flag, a
window, an epsilon) are in no line of the text: :func:`emit` records them
beside it, in a table from each such function's name to the
:class:`OperatorCall` it stands for, so that an executor of the text runs
the operator itself (``core/executor.py``).  A per-rank step's collectives
(``_c10d_functional``) become ``all_gather``, ``reduce_scatter`` and
``all_reduce`` over their group's ranks, each with a channel of its own and
each printed on one line, reduction region included (the reference's front
ends type a collective printed over several lines by its attributes, ROADMAP
Queue 3); the module then carries the mesh's size as
``mhlo.num_partitions``.  An op with no lowering raises
``NotImplementedError`` naming it: nothing is skipped.

A convolution is written in JAX's forms, on PyTorch's NCHW activations and
OIHW weights (``dim_numbers`` name each dim, so the cost model reads them
as it reads JAX's NHWC/HWIO ones): the forward ``convolution``; the data
gradient as a ``reverse`` of the kernel and an lhs-dilated convolution;
the weight gradient as a convolution of the input with the rhs-dilated
output gradient.  A zero pad that feeds a convolution is folded into its
window, and the crop that undoes it in the backward into the data
gradient, so an asymmetric ``"SAME"`` window (which ``F.conv2d`` cannot
pad) costs what JAX's does.  A max pool is a ``reduce_window`` (its -inf
pad folded in the same way) and its backward, as JAX writes it, a
``select_and_scatter`` over the -inf-padded input and a ``slice``.

Element types are ``bf16``, ``f16``, ``f32``, ``i32`` and ``i1``; PyTorch's
int64 indices are written as ``i32``, as JAX writes them without x64.
"""
from __future__ import annotations

import itertools
import math
import operator
import re
import struct
from dataclasses import dataclass

import torch

from ..library import PLAIN
from .export import BARRIER, Traced

aten = torch.ops.aten

_ELEMENT = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16", torch.int32: "i32", torch.int64: "i32",
            torch.bool: "i1"}
_FLOATS = ("f32", "bf16", "f16")
_TORCH_FLOAT = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}


def _element(dtype: torch.dtype) -> str:
    try:
        return _ELEMENT[dtype]
    except KeyError:
        raise NotImplementedError(f"no StableHLO element type for {dtype}")


@dataclass(frozen=True)
class Operand:
    """A tensor argument of an operator call: the ``index``-th operand of
    its ``call`` line."""
    index: int


@dataclass(frozen=True)
class OperatorCall:
    """What a private function of the text stands for: the operator
    ``op`` (its qualified name, e.g. ``"repro_torch::rmsnorm"``, so that
    the table pickles) called with ``args`` in its schema's order, each
    tensor an :class:`Operand` of the ``call``."""
    op: str
    args: tuple

    @property
    def overload(self) -> torch._ops.OpOverload:
        ns, name = self.op.split("::")
        return getattr(getattr(torch.ops, ns), name).default

    def bind(self, tensors) -> list:
        """The operator's arguments for a call on ``tensors``."""
        return [tensors[a.index] if isinstance(a, Operand) else a
                for a in self.args]


@dataclass(frozen=True)
class Value:
    name: str
    shape: tuple[int, ...]
    dt: str

    @property
    def ty(self) -> str:
        return _tensor_type(self.shape, self.dt)


def _tensor_type(shape, dt: str) -> str:
    dims = "x".join(str(d) for d in shape)
    return f"tensor<{dims}x{dt}>" if dims else f"tensor<{dt}>"


def _float_literal(x: float, dt: str) -> str:
    """A float as MLIR prints it: the value rounded to ``dt``, in decimal
    with a point, or as bits when it is not finite."""
    if math.isnan(x) or math.isinf(x):
        if dt == "f16":
            return f"0x{struct.unpack('<H', struct.pack('<e', x))[0]:04X}"
        bits = struct.unpack("<I", struct.pack("<f", x))[0]
        return f"0x{bits:08X}" if dt == "f32" else f"0x{bits >> 16:04X}"
    rounded = torch.tensor(x, dtype=_TORCH_FLOAT[dt]).item()
    mant, _, exp = repr(rounded).partition("e")
    if "." not in mant:
        mant += ".0"
    return f"{mant}e{exp}" if exp else mant


def _literal(v, dt: str) -> str:
    if dt == "i1":
        return "true" if v else "false"
    if dt in _FLOATS:
        return _float_literal(float(v), dt)
    return str(int(v))


def _dims(xs) -> str:
    return "[" + ", ".join(str(x) for x in xs) + "]"


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _meta(node):
    return node.meta["val"]


_UNARY = {
    aten.neg.default: "negate", aten.abs.default: "abs",
    aten.exp.default: "exponential", aten.log.default: "log",
    aten.sqrt.default: "sqrt", aten.rsqrt.default: "rsqrt",
    aten.sin.default: "sine", aten.cos.default: "cosine",
    aten.tanh.default: "tanh", aten.sigmoid.default: "logistic",
    aten.bitwise_not.default: "not",
}
_BINARY = {
    aten.add.Tensor: "add", aten.sub.Tensor: "subtract",
    aten.mul.Tensor: "multiply", aten.mul.Scalar: "multiply",
    aten.div.Tensor: "divide",
    aten.div.Scalar: "divide", aten.maximum.default: "maximum",
    aten.minimum.default: "minimum", aten.pow.Scalar: "power",
    aten.bitwise_and.Tensor: "and", aten.bitwise_or.Tensor: "or",
}
_COMPARE = {}
for _name, _dir in (("eq", "EQ"), ("ne", "NE"), ("lt", "LT"), ("le", "LE"),
                    ("gt", "GT"), ("ge", "GE")):
    _COMPARE[getattr(aten, _name).Tensor] = _dir
    _COMPARE[getattr(aten, _name).Scalar] = _dir
# ops whose output is their input's value (functional copies, detaches)
_IDENTITY = {aten.clone.default, aten.detach_copy.default}
# ops whose output is their input's values in another shape
_RESHAPE = {aten.view.default, aten.view_copy.default, aten._unsafe_view.default,
            aten.squeeze.dims, aten.squeeze_copy.dims, aten.unsqueeze.default,
            aten.unsqueeze_copy.default}
_FILL = {  # factory op -> its fill value, from the node's args
    aten.full.default: lambda a: a[1], aten.full_like.default: lambda a: a[1],
    aten.scalar_tensor.default: lambda a: a[0],
    # uninitialised memory (a buffer that a copy or a scatter then fills):
    # its value is undefined, and the text writes zeros
    aten.empty.memory_format: lambda a: 0,
    aten.empty_permuted.default: lambda a: 0,
}


class _Deferred:
    """A value whose ops are written only when a consumer takes it as a
    tensor (:meth:`_Function.value`): until then a convolution or a pool
    may fold it into its window instead."""

    def materialize(self, f: "_Function") -> Value:
        raise NotImplementedError


@dataclass
class _Pad(_Deferred):
    """``src`` padded with ``fill`` (``low``/``high`` per dim, >= 0)."""
    src: Value
    low: list[int]
    high: list[int]
    fill: float

    def materialize(self, f):
        return f.pad(self.src, self.low, self.high, self.fill)


@dataclass
class _PaddedGrad(_Deferred):
    """The data gradient of a convolution whose input is a folded
    :class:`_Pad`, taken by the crop that undoes the pad: with respect to
    the unpadded input (``inner``), which is JAX's form."""
    inner: object
    low: list[int]
    high: list[int]

    def materialize(self, f):
        raise NotImplementedError(
            "the data gradient of a convolution with respect to its padded "
            "input, used other than by the crop that undoes the pad")


class _Function:
    """The body of one ``func.func``: SSA names and lines."""

    def __init__(self, module: "_Module"):
        self.module = module
        self.lines: list[str] = []
        self.count = 0
        self.env: dict[torch.fx.Node, object] = {}

    # -- primitives -------------------------------------------------------

    def _emit(self, text: str, shape, dt: str) -> Value:
        name = f"%{self.count}"
        self.count += 1
        self.lines.append(f"    {name} = {text}")
        return Value(name, tuple(shape), dt)

    def constant(self, v, dt: str) -> Value:
        return self._emit(f"stablehlo.constant dense<{_literal(v, dt)}> : "
                          f"{_tensor_type((), dt)}", (), dt)

    def full(self, v, shape, dt: str) -> Value:
        return self.broadcast(self.constant(v, dt), shape)

    def convert(self, x: Value, dt: str) -> Value:
        if x.dt == dt:
            return x
        return self._emit(f"stablehlo.convert {x.name} : ({x.ty}) -> "
                          f"{_tensor_type(x.shape, dt)}", x.shape, dt)

    def broadcast(self, x: Value, shape) -> Value:
        """numpy-style broadcasting of x to ``shape``."""
        shape = tuple(shape)
        if x.shape == shape:
            return x
        lead = len(shape) - len(x.shape)
        if lead < 0 or any(s not in (1, shape[lead + i])
                           for i, s in enumerate(x.shape)):
            raise ValueError(f"cannot broadcast {x.shape} to {shape}")
        dims = list(range(lead, len(shape)))
        return self._emit(f"stablehlo.broadcast_in_dim {x.name}, dims = "
                          f"{_dims(dims)} : ({x.ty}) -> "
                          f"{_tensor_type(shape, x.dt)}", shape, x.dt)

    def reshape(self, x: Value, shape) -> Value:
        shape = tuple(shape)
        if x.shape == shape:
            return x
        return self._emit(f"stablehlo.reshape {x.name} : ({x.ty}) -> "
                          f"{_tensor_type(shape, x.dt)}", shape, x.dt)

    def transpose(self, x: Value, perm) -> Value:
        perm = [_norm_dim(p, len(x.shape)) for p in perm]
        if perm == sorted(perm):
            return x
        shape = tuple(x.shape[p] for p in perm)
        return self._emit(f"stablehlo.transpose {x.name}, dims = "
                          f"{_dims(perm)} : ({x.ty}) -> "
                          f"{_tensor_type(shape, x.dt)}", shape, x.dt)

    def unary(self, op: str, x: Value) -> Value:
        return self._emit(f"stablehlo.{op} {x.name} : {x.ty}", x.shape, x.dt)

    def binary(self, op: str, a: Value, b: Value) -> Value:
        return self._emit(f"stablehlo.{op} {a.name}, {b.name} : {a.ty}",
                          a.shape, a.dt)

    def compare(self, direction: str, a: Value, b: Value) -> Value:
        kind = ("FLOAT" if a.dt in _FLOATS
                else "UNSIGNED" if a.dt == "i1" else "SIGNED")
        return self._emit(
            f"stablehlo.compare  {direction}, {a.name}, {b.name},  {kind} : "
            f"({a.ty}, {b.ty}) -> {_tensor_type(a.shape, 'i1')}",
            a.shape, "i1")

    def select(self, c: Value, a: Value, b: Value) -> Value:
        return self._emit(f"stablehlo.select {c.name}, {a.name}, {b.name} : "
                          f"{c.ty}, {a.ty}", a.shape, a.dt)

    def reduce(self, x: Value, dims, op: str) -> Value:
        """Reduce x over ``dims`` with ``add``, ``maximum`` or
        ``minimum``."""
        dims = sorted({_norm_dim(d, len(x.shape)) for d in dims})
        if not dims:
            return x
        if op == "add":
            init = 0
        elif x.dt in _FLOATS:
            init = -math.inf if op == "maximum" else math.inf
        elif x.dt == "i1":
            init = op == "minimum"
        else:
            init = -2 ** 31 if op == "maximum" else 2 ** 31 - 1
        i = self.constant(init, x.dt)
        shape = tuple(s for d, s in enumerate(x.shape) if d not in dims)
        return self._emit(
            f"stablehlo.reduce({x.name} init: {i.name}) applies "
            f"stablehlo.{op} across dimensions = {_dims(dims)} : "
            f"({x.ty}, {i.ty}) -> {_tensor_type(shape, x.dt)}", shape, x.dt)

    def dot(self, a: Value, b: Value, batch, contract, shape) -> Value:
        batching = (f"batching_dims = {_dims(batch[0])} x {_dims(batch[1])}, "
                    if batch[0] else "")
        return self._emit(
            f"stablehlo.dot_general {a.name}, {b.name}, {batching}"
            f"contracting_dims = {_dims(contract[0])} x "
            f"{_dims(contract[1])}, precision = [DEFAULT, DEFAULT] : "
            f"({a.ty}, {b.ty}) -> {_tensor_type(shape, a.dt)}", shape, a.dt)

    def slice(self, x: Value, starts, limits, strides) -> Value:
        spec = ", ".join(f"{s}:{l}" if st == 1 else f"{s}:{l}:{st}"
                         for s, l, st in zip(starts, limits, strides))
        shape = tuple(max(0, -(-(l - s) // st))
                      for s, l, st in zip(starts, limits, strides))
        return self._emit(f"stablehlo.slice {x.name} [{spec}] : ({x.ty}) -> "
                          f"{_tensor_type(shape, x.dt)}", shape, x.dt)

    def pad(self, x: Value, low, high, fill) -> Value:
        v = self.constant(fill, x.dt)
        shape = tuple(n + lo + hi for n, lo, hi in zip(x.shape, low, high))
        return self._emit(
            f"stablehlo.pad {x.name}, {v.name}, low = {_dims(low)}, high = "
            f"{_dims(high)}, interior = {_dims([0] * len(low))} : ({x.ty}, "
            f"{v.ty}) -> {_tensor_type(shape, x.dt)}", shape, x.dt)

    def region_op(self, head: str, operands, attrs: str, regions, shape,
                  dt: str) -> Value:
        """``"stablehlo.<head>"(operands) <{attrs}> ({region}, ...)`` over
        several lines, as JAX prints a reduce_window or a
        select_and_scatter: each region takes two scalars of
        ``operands[0]``'s type and returns ``op`` of them (``"GE"``, a
        comparison, or an elementwise op)."""
        name = f"%{self.count}"
        self.count += 1
        e = _tensor_type((), operands[0].dt)
        blocks = []
        for i, op in enumerate(regions):
            lhs, rhs, res = (f"%{k}{name[1:]}_{i}" for k in ("lhs", "rhs",
                                                            "red"))
            if op == "GE":
                body, rty = (f"stablehlo.compare  {op}, {lhs}, {rhs},  FLOAT "
                             f": ({e}, {e}) -> tensor<i1>"), "tensor<i1>"
            else:
                body, rty = f"stablehlo.{op} {lhs}, {rhs} : {e}", e
            blocks.append(f"    ^bb0({lhs}: {e}, {rhs}: {e}):\n"
                          f"      {res} = {body}\n"
                          f"      stablehlo.return {res} : {rty}")
        self.lines.append(
            f'    {name} = "stablehlo.{head}"('
            f"{', '.join(v.name for v in operands)}) <{{{attrs}}}> ({{\n"
            + "\n    }, {\n".join(blocks)
            + f"\n    }}) : ({', '.join(v.ty for v in operands)}) -> "
            f"{_tensor_type(shape, dt)}")
        return Value(name, tuple(shape), dt)

    def slice_dim(self, x: Value, dim: int, start, end, step=1) -> Value:
        size = x.shape[dim]
        start = 0 if start is None else start
        end = size if end is None else end
        start = min(max(start + size if start < 0 else start, 0), size)
        end = min(max(end + size if end < 0 else end, start), size)
        starts = [0] * len(x.shape)
        limits = list(x.shape)
        strides = [1] * len(x.shape)
        starts[dim], limits[dim], strides[dim] = start, end, step
        return self.slice(x, starts, limits, strides)

    # -- operands ---------------------------------------------------------

    def value(self, arg) -> Value:
        v = self.env[arg]
        if isinstance(v, _Deferred):
            v = self.env[arg] = v.materialize(self)
        if not isinstance(v, Value):
            raise NotImplementedError(f"{arg} is not a single tensor")
        return v

    def operand(self, arg, dt: str, shape) -> Value:
        """An argument (a node or a Python number) as a ``dt`` tensor of
        ``shape``."""
        if isinstance(arg, torch.fx.Node):
            return self.broadcast(self.convert(self.value(arg), dt), shape)
        if isinstance(arg, (bool, int, float)):
            return self.full(arg, shape, dt)
        raise NotImplementedError(f"operand {arg!r}")

    # -- nodes ------------------------------------------------------------

    def lower(self, node: torch.fx.Node):
        op = node.target
        if op is BARRIER:
            x = self.value(node.args[0])
            return self._emit(f"stablehlo.optimization_barrier {x.name} : "
                              f"{x.ty}", x.shape, x.dt)
        if op in PLAIN:
            return self.call(node)
        if op is operator.getitem:
            return self.env[node.args[0]][node.args[1]]
        lowering = _LOWERINGS.get(op)
        if lowering is None:
            raise NotImplementedError(
                f"no StableHLO lowering for {op} (node {node.name})")
        return lowering(self, node, *node.args, **node.kwargs)

    def call(self, node: torch.fx.Node):
        outs = _meta(node)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        types = [_tensor_type(o.shape, _element(o.dtype)) for o in outs]
        name = self.module.function_for(node, types)
        args = [self.value(a) for a in node.args
                if isinstance(a, torch.fx.Node)]
        res = f"%{self.count}"
        self.count += 1
        arity = f":{len(outs)}" if len(outs) > 1 else ""
        sig = (f"({', '.join(a.ty for a in args)}) -> "
               + (types[0] if len(outs) == 1 else f"({', '.join(types)})"))
        self.lines.append(f"    {res}{arity} = call @{name}("
                          f"{', '.join(a.name for a in args)}) : {sig}")
        vals = [Value(f"{res}#{i}" if len(outs) > 1 else res, tuple(o.shape),
                      _element(o.dtype)) for i, o in enumerate(outs)]
        return vals if isinstance(_meta(node), (tuple, list)) else vals[0]

    def body(self, graph: torch.fx.Graph) -> tuple[list[Value], list[Value]]:
        """Lower every node; returns the arguments and the results."""
        params: list[Value] = []
        results: list[Value] = []
        for node in graph.nodes:
            if node.op == "placeholder":
                m = _meta(node)
                v = Value(f"%arg{len(params)}", tuple(m.shape),
                          _element(m.dtype))
                params.append(v)
                self.env[node] = v
            elif node.op == "call_function":
                self.env[node] = self.lower(node)
            elif node.op == "output":
                results = [self.value(out)
                           for out in _flat_outputs(node.args[0])]
            else:
                raise NotImplementedError(f"fx node {node.op} {node.target}")
        return params, results

    def text(self, name: str, visibility: str, graph: torch.fx.Graph) -> str:
        params, results = self.body(graph)
        rtypes = self.result_types = [r.ty for r in results]
        ret = rtypes[0] if len(rtypes) == 1 else f"({', '.join(rtypes)})"
        head = (f"  func.func {visibility} @{name}("
                + ", ".join(f"{p.name}: {p.ty}" for p in params)
                + f") -> {ret} {{")
        tail = (f"    return {', '.join(r.name for r in results)} : "
                f"{', '.join(rtypes)}")
        return "\n".join([head, *self.lines, tail, "  }"])


def _flat_outputs(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat_outputs(o)]
    return [out]


class _Module:
    def __init__(self, traced: Traced, calls: dict | None = None):
        self.traced = traced
        self.calls = {} if calls is None else calls
        self.names: dict[str, str] = {}
        self.functions: list[str] = []
        self.channels = 0

    def channel(self) -> int:
        """A channel handle no other collective of the module has."""
        self.channels += 1
        return self.channels

    def function_for(self, node: torch.fx.Node, types: list[str]) -> str:
        """The private function of the plain version of an operator call,
        written the first time a call needs it; its results must have the
        types of the operator's fake."""
        key = node.meta["plain"]
        if key not in self.names:
            op = node.target._schema.name.replace("::", ".")
            name = self.names[key] = f"{op}_{len(self.names)}"
            fn = _Function(self)
            self.functions.append(fn.text(name, "private",
                                          self.traced.plain[key].graph))
            if fn.result_types != types:
                raise ValueError(f"{op}: the plain version returns "
                                 f"{fn.result_types}, the fake {types}")
            tensors = itertools.count()
            self.calls[name] = OperatorCall(
                node.target._schema.name, tuple(
                    Operand(next(tensors)) if isinstance(a, torch.fx.Node)
                    else a for a in node.args))
        return self.names[key]


def emit(traced: Traced, name: str = "workload",
         calls: dict | None = None) -> str:
    """The StableHLO module of a traced step: ``@main`` takes the flattened
    arguments in order and returns the flattened outputs.  ``calls``, when
    given, is filled with the text's ``call`` table: each private function
    of an operator's plain version by name -> its :class:`OperatorCall`."""
    module = _Module(traced, calls)
    main = _Function(module).text("main", "public", traced.graph.graph)
    sym = re.sub(r"[^A-Za-z0-9_]", "_", name)
    return (f"module @jit_{sym} attributes {{mhlo.num_partitions = "
            f"{traced.num_partitions} : i32, mhlo.num_replicas = 1 : i32}} "
            "{\n"
            + "\n".join([main, *module.functions]) + "\n}\n")


# ---------------------------------------------------------------------------
# lowerings: (function, node, *node.args, **node.kwargs) -> Value or list
# ---------------------------------------------------------------------------

_LOWERINGS: dict = {}


def _lowers(*ops):
    def deco(fn):
        for op in ops:
            _LOWERINGS[op] = fn
        return fn
    return deco


def _out(node) -> tuple[tuple[int, ...], str]:
    m = _meta(node)
    return tuple(m.shape), _element(m.dtype)


def _unary(f, node, x):
    shape, dt = _out(node)
    return f.unary(_UNARY[node.target], f.operand(x, dt, shape))


for _op in _UNARY:
    _LOWERINGS[_op] = _unary


def _binary(f, node, a, b, alpha=1, rounding_mode=None):
    if alpha != 1 or rounding_mode is not None:
        raise NotImplementedError(f"{node.target} with alpha {alpha}, "
                                  f"rounding_mode {rounding_mode}")
    shape, dt = _out(node)
    return f.binary(_BINARY[node.target], f.operand(a, dt, shape),
                    f.operand(b, dt, shape))


for _op in _BINARY:
    _LOWERINGS[_op] = _binary


def _promoted(a, b) -> torch.dtype:
    va = _meta(a) if isinstance(a, torch.fx.Node) else a
    vb = _meta(b) if isinstance(b, torch.fx.Node) else b
    return torch.result_type(va, vb)


@_lowers(*_COMPARE)
def _compare(f, node, a, b):
    shape, _ = _out(node)
    dt = _element(_promoted(a, b))
    return f.compare(_COMPARE[node.target], f.operand(a, dt, shape),
                     f.operand(b, dt, shape))


@_lowers(aten.pow.Tensor_Scalar)
def _pow(f, node, x, e):
    shape, dt = _out(node)
    x = f.operand(x, dt, shape)
    if e == 2:
        return f.binary("multiply", x, x)
    return f.binary("power", x, f.full(e, shape, dt))


@_lowers(aten.reciprocal.default)
def _reciprocal(f, node, x):
    shape, dt = _out(node)
    return f.binary("divide", f.full(1, shape, dt), f.operand(x, dt, shape))


@_lowers(aten.clamp.default)
def _clamp(f, node, x, lo=None, hi=None):
    shape, dt = _out(node)
    v = f.operand(x, dt, shape)
    if lo is not None:
        v = f.binary("maximum", v, f.operand(lo, dt, shape))
    if hi is not None:
        v = f.binary("minimum", v, f.operand(hi, dt, shape))
    return v


@_lowers(aten.where.self)
def _where(f, node, c, a, b):
    shape, dt = _out(node)
    return f.select(f.operand(c, "i1", shape), f.operand(a, dt, shape),
                    f.operand(b, dt, shape))


@_lowers(*_IDENTITY)
def _identity(f, node, x, **kw):
    return f.value(x)


@_lowers(aten.copy.default)
def _copy(f, node, x, src, non_blocking=False):
    """``x`` overwritten by ``src``: src in x's dtype and shape."""
    shape, dt = _out(node)
    return f.operand(src, dt, shape)


@_lowers(aten._to_copy.default)
def _to_copy(f, node, x, **kw):
    return f.convert(f.value(x), _out(node)[1])


@_lowers(*_RESHAPE)
def _reshape(f, node, x, *rest):
    return f.reshape(f.value(x), _out(node)[0])


@_lowers(aten.permute.default, aten.permute_copy.default)
def _permute(f, node, x, perm):
    return f.transpose(f.value(x), perm)


@_lowers(aten.expand.default)
def _expand(f, node, x, *rest, **kw):
    return f.broadcast(f.value(x), _out(node)[0])


@_lowers(aten.slice_copy.Tensor)
def _slice(f, node, x, dim=0, start=None, end=None, step=1):
    v = f.value(x)
    return f.slice_dim(v, _norm_dim(dim, len(v.shape)), start, end, step)


@_lowers(aten.select_copy.int)
def _select(f, node, x, dim, index):
    v = f.value(x)
    dim = _norm_dim(dim, len(v.shape))
    index = index + v.shape[dim] if index < 0 else index
    return f.reshape(f.slice_dim(v, dim, index, index + 1), _out(node)[0])


@_lowers(aten.split_copy.Tensor, aten.unbind_copy.int)
def _split(f, node, x, size=0, dim=0):
    v = f.value(x)
    unbind = node.target is aten.unbind_copy.int
    dim = _norm_dim(size if unbind else dim, len(v.shape))
    parts, start = [], 0
    for o in _meta(node):
        width = 1 if unbind else o.shape[dim]
        parts.append(f.reshape(f.slice_dim(v, dim, start, start + width),
                               tuple(o.shape)))
        start += width
    return parts


@_lowers(aten.cat.default)
def _cat(f, node, xs, dim=0):
    shape, dt = _out(node)
    vals = [f.convert(f.value(x), dt) for x in xs]
    dim = _norm_dim(dim, len(shape))
    if len(vals) == 1:
        return vals[0]
    return f._emit(f"stablehlo.concatenate {', '.join(v.name for v in vals)}"
                   f", dim = {dim} : ({', '.join(v.ty for v in vals)}) -> "
                   f"{_tensor_type(shape, dt)}", shape, dt)


@_lowers(*_FILL)
def _fill(f, node, *args, **kw):
    shape, dt = _out(node)
    return f.full(_FILL[node.target](args), shape, dt)


@_lowers(aten.arange.start_step)
def _arange(f, node, start, end, step=1, **kw):
    # torch 2.13's decompositions leave start 0 and step 1 in these graphs;
    # another torch may not
    shape, dt = _out(node)
    v = f._emit(f"stablehlo.iota dim = 0 : {_tensor_type(shape, dt)}",
                shape, dt)
    if step != 1:
        v = f.binary("multiply", v, f.full(step, shape, dt))
    if start != 0:
        v = f.binary("add", v, f.full(start, shape, dt))
    return v


def _reduce_dims(v: Value, dims) -> list[int]:
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(len(v.shape)))
    return [dims] if isinstance(dims, int) else list(dims)


@_lowers(aten.sum.dim_IntList)
def _sum(f, node, x, dims=None, keepdim=False, **kw):
    shape, dt = _out(node)
    v = f.convert(f.value(x), dt)
    return f.reshape(f.reduce(v, _reduce_dims(v, dims), "add"), shape)


@_lowers(aten.mean.dim, aten.mean.default)
def _mean(f, node, x, dims=None, keepdim=False, **kw):
    shape, dt = _out(node)
    v = f.convert(f.value(x), dt)
    dims = _reduce_dims(v, dims)
    n = math.prod(v.shape[_norm_dim(d, len(v.shape))] for d in dims)
    s = f.reshape(f.reduce(v, dims, "add"), shape)
    return f.binary("divide", s, f.full(n, shape, dt))


@_lowers(aten.amax.default)
def _amax(f, node, x, dims=(), keepdim=False):
    v = f.value(x)
    return f.reshape(f.reduce(v, _reduce_dims(v, dims), "maximum"),
                     _out(node)[0])


@_lowers(aten._softmax.default)
def _softmax(f, node, x, dim, half_to_float):
    shape, dt = _out(node)
    # in f32, as PyTorch computes a bf16 softmax, rounded once at the end
    v = f.convert(f.value(x), "f32")
    dim = _norm_dim(dim, len(shape))
    m = f.broadcast(f.reshape(f.reduce(v, [dim], "maximum"),
                              shape[:dim] + (1,) + shape[dim + 1:]), shape)
    z = f.binary("subtract", v, m)
    e = f.unary("exponential", z)
    s = f.broadcast(f.reshape(f.reduce(e, [dim], "add"),
                              shape[:dim] + (1,) + shape[dim + 1:]), shape)
    return f.convert(f.binary("divide", e, s), dt)


@_lowers(aten.mm.default)
def _mm(f, node, a, b):
    shape, dt = _out(node)
    return f.dot(f.convert(f.value(a), dt), f.convert(f.value(b), dt),
                 ((), ()), ([1], [0]), shape)


@_lowers(aten.bmm.default)
def _bmm(f, node, a, b):
    shape, dt = _out(node)
    return f.dot(f.convert(f.value(a), dt), f.convert(f.value(b), dt),
                 ([0], [0]), ([2], [1]), shape)


def _indices(f, idx: Value, shape) -> Value:
    """Integer indices with a trailing index-vector dim of 1."""
    return f.reshape(f.convert(idx, "i32"), (*shape, 1))


@_lowers(aten.index.Tensor)
def _index(f, node, x, indices):
    """x[idx] along dim 0 (an embedding lookup)."""
    if len(indices) != 1 or indices[0] is None:
        raise NotImplementedError(f"aten.index.Tensor with indices "
                                  f"{indices} (only x[idx] is lowered)")
    shape, dt = _out(node)
    v, idx = f.value(x), f.value(indices[0])
    r = len(idx.shape)
    ind = _indices(f, idx, idx.shape)
    offset = list(range(r, r + len(v.shape) - 1))
    sizes = ", ".join(["1", *map(str, v.shape[1:])])
    return f._emit(
        f'"stablehlo.gather"({v.name}, {ind.name}) <{{dimension_numbers = '
        f"#stablehlo.gather<offset_dims = {_dims(offset)}, "
        f"collapsed_slice_dims = [0], start_index_map = [0], "
        f"index_vector_dim = {r}>, indices_are_sorted = false, "
        f"slice_sizes = array<i64: {sizes}>}}> : ({v.ty}, {ind.ty}) -> "
        f"{_tensor_type(shape, dt)}", shape, dt)


@_lowers(aten.gather.default)
def _gather(f, node, x, dim, index, sparse_grad=False):
    """torch.gather with the index's other dims equal to x's."""
    shape, dt = _out(node)
    v, idx = f.value(x), f.value(index)
    r = len(v.shape)
    dim = _norm_dim(dim, r)
    batch = [d for d in range(r) if d != dim]
    if any(idx.shape[d] != v.shape[d] for d in batch):
        raise NotImplementedError("aten.gather.default with an index "
                                  "narrower than its input")
    ind = _indices(f, idx, idx.shape)
    return f._emit(
        f'"stablehlo.gather"({v.name}, {ind.name}) <{{dimension_numbers = '
        f"#stablehlo.gather<collapsed_slice_dims = [{dim}], "
        f"operand_batching_dims = {_dims(batch)}, "
        f"start_indices_batching_dims = {_dims(batch)}, "
        f"start_index_map = [{dim}], index_vector_dim = {r}>, "
        f"indices_are_sorted = false, slice_sizes = array<i64: "
        f"{', '.join('1' * r)}>}}> : ({v.ty}, {ind.ty}) -> "
        f"{_tensor_type(shape, dt)}", shape, dt)


def _scatter_add(f, v: Value, ind: Value, upd: Value, dnums: str) -> Value:
    name = f"%{f.count}"
    f.count += 1
    e = _tensor_type((), v.dt)
    f.lines += [
        f'    {name} = "stablehlo.scatter"({v.name}, {ind.name}, {upd.name}) '
        f"<{{indices_are_sorted = false, scatter_dimension_numbers = "
        f"#stablehlo.scatter<{dnums}>, unique_indices = false}}> ({{",
        f"    ^bb0(%lhs{name[1:]}: {e}, %rhs{name[1:]}: {e}):",
        f"      %sum{name[1:]} = stablehlo.add %lhs{name[1:]}, "
        f"%rhs{name[1:]} : {e}",
        f"      stablehlo.return %sum{name[1:]} : {e}",
        f"    }}) : ({v.ty}, {ind.ty}, {upd.ty}) -> {v.ty}"]
    return Value(name, v.shape, v.dt)


@_lowers(aten.index_put.default)
def _index_put(f, node, x, indices, values, accumulate=False):
    """x[idx] += values along dim 0 (an embedding's gradient)."""
    if len(indices) != 1 or indices[0] is None or not accumulate:
        raise NotImplementedError("aten.index_put.default is lowered only "
                                  "as x[idx] += values")
    shape, dt = _out(node)
    v, idx = f.convert(f.value(x), dt), f.value(indices[0])
    r = len(idx.shape)
    upd = f.operand(values, dt, (*idx.shape, *v.shape[1:]))
    window = list(range(r, r + len(v.shape) - 1))
    return _scatter_add(f, v, _indices(f, idx, idx.shape), upd,
                        f"update_window_dims = {_dims(window)}, "
                        "inserted_window_dims = [0], "
                        f"scatter_dims_to_operand_dims = [0], "
                        f"index_vector_dim = {r}")


@_lowers(aten.scatter_add.default)
def _scatter_add_op(f, node, x, dim, index, src):
    """torch.scatter_add with the index's other dims equal to x's."""
    shape, dt = _out(node)
    v, idx = f.convert(f.value(x), dt), f.value(index)
    r = len(v.shape)
    dim = _norm_dim(dim, r)
    batch = [d for d in range(r) if d != dim]
    if any(idx.shape[d] != v.shape[d] for d in batch):
        raise NotImplementedError("aten.scatter_add.default with an index "
                                  "narrower than its input")
    upd = f.operand(src, dt, idx.shape)
    return _scatter_add(f, v, _indices(f, idx, idx.shape), upd,
                        f"inserted_window_dims = [{dim}], "
                        f"input_batching_dims = {_dims(batch)}, "
                        f"scatter_indices_batching_dims = {_dims(batch)}, "
                        f"scatter_dims_to_operand_dims = [{dim}], "
                        f"index_vector_dim = {r}")


def _update(f, x: Value, upd: Value, starts) -> Value:
    idx = [f.constant(s, "i32") for s in starts]
    return f._emit(
        f"stablehlo.dynamic_update_slice {x.name}, {upd.name}, "
        f"{', '.join(i.name for i in idx)} : ({x.ty}, {upd.ty}, "
        f"{', '.join(i.ty for i in idx)}) -> {x.ty}", x.shape, x.dt)


@_lowers(aten.slice_scatter.default)
def _slice_scatter(f, node, x, src, dim=0, start=None, end=None, step=1):
    """x with x[start:end] along dim replaced by src."""
    if step != 1:
        raise NotImplementedError(f"aten.slice_scatter.default with step "
                                  f"{step}")
    shape, dt = _out(node)
    dim = _norm_dim(dim, len(shape))
    start = 0 if start is None else start
    start = min(max(start + shape[dim] if start < 0 else start, 0),
                shape[dim])
    starts = [0] * len(shape)
    starts[dim] = start
    return _update(f, f.operand(x, dt, shape),
                   f.convert(f.value(src), dt), starts)


@_lowers(aten.relu.default)
def _relu(f, node, x):
    shape, dt = _out(node)
    return f.binary("maximum", f.value(x), f.full(0, shape, dt))


@_lowers(aten.constant_pad_nd.default)
def _constant_pad(f, node, x, pad, value=0):
    """A pad (``pad`` in PyTorch's order: the last dim's low and high
    first) is deferred, so that a convolution or a pool can fold it into
    its window; a crop (every entry <= 0) is a ``slice``, or, when it undoes
    the pad of a convolution's input, that convolution's data gradient
    with respect to the unpadded input."""
    raw = f.env[x]
    rank = len(_out(node)[0])
    low, high = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        low[rank - 1 - i], high[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if all(p >= 0 for p in low + high):
        return _Pad(f.value(x), low, high, value)
    if all(p <= 0 for p in low + high):
        if isinstance(raw, _PaddedGrad) and raw.low == [-p for p in low] \
                and raw.high == [-p for p in high]:
            return raw.inner(f)
        v = f.value(x)
        return f.slice(v, [-p for p in low],
                       [n + p for n, p in zip(v.shape, high)], [1] * rank)
    return f.pad(f.value(x), low, high, value)


def _window_input(f, x, padding, fill) -> tuple[Value, list, list]:
    """The input of a convolution or a pool over NCHW's spatial dims, with
    a deferred pad of ``fill`` folded into the window: ``(x, lows, highs)``
    of the two spatial dims."""
    raw = f.env[x]
    low, high = [padding[0], padding[1]], [padding[0], padding[1]]
    if isinstance(raw, _Pad) and raw.fill == fill \
            and raw.low[:2] == [0, 0] and raw.high[:2] == [0, 0]:
        return (raw.src, [a + b for a, b in zip(low, raw.low[2:])],
                [a + b for a, b in zip(high, raw.high[2:])])
    return f.value(x), low, high


def _window_ok(node, dilation=(1, 1), groups=1, transposed=False,
               ceil_mode=False) -> None:
    if list(dilation) != [1, 1] or groups != 1 or transposed or ceil_mode:
        raise NotImplementedError(
            f"{node.target} with dilation {dilation}, groups {groups}, "
            f"transposed {transposed}, ceil_mode {ceil_mode}")


def _convolution(f, lhs: Value, rhs: Value, dims: str, stride, low, high,
                 lhs_dilate, rhs_dilate, shape, dt: str) -> Value:
    pad = ", ".join(_dims(p) for p in zip(low, high))
    return f._emit(
        f"stablehlo.convolution({lhs.name}, {rhs.name}) dim_numbers = {dims}"
        f", window = {{stride = {_dims(stride)}, pad = [{pad}], lhs_dilate = "
        f"{_dims(lhs_dilate)}, rhs_dilate = {_dims(rhs_dilate)}, reverse = "
        f"[false, false]}} {{batch_group_count = 1 : i64, "
        f"feature_group_count = 1 : i64, precision_config = "
        f"[#stablehlo<precision DEFAULT>, #stablehlo<precision DEFAULT>]}} : "
        f"({lhs.ty}, {rhs.ty}) -> {_tensor_type(shape, dt)}", shape, dt)


# NCHW activations and OIHW weights: the forward, the data gradient (the
# kernel's O is the transposed convolution's input feature) and the weight
# gradient (the images are its contracted "input feature", Cin its batch)
_CONV_FWD = "[b, f, 0, 1]x[o, i, 0, 1]->[b, f, 0, 1]"
_CONV_DATA = "[b, f, 0, 1]x[i, o, 0, 1]->[b, f, 0, 1]"
_CONV_WEIGHT = "[f, b, 0, 1]x[i, o, 0, 1]->[f, b, 0, 1]"


@_lowers(aten.convolution.default)
def _conv(f, node, x, w, bias, stride, padding, dilation, transposed,
          output_padding, groups):
    _window_ok(node, dilation, groups, transposed)
    if bias is not None:
        raise NotImplementedError(f"{node.target} with a bias")
    shape, dt = _out(node)
    v, low, high = _window_input(f, x, padding, 0)
    return _convolution(f, v, f.value(w), _CONV_FWD, stride, low, high,
                        [1, 1], [1, 1], shape, dt)


@_lowers(aten.convolution_backward.default)
def _conv_backward(f, node, dy, x, w, bias_sizes, stride, padding, dilation,
                   transposed, output_padding, groups, output_mask):
    """JAX's two forms: the data gradient is a convolution of the
    lhs-dilated output gradient with the reversed kernel, the weight
    gradient one of the input with the rhs-dilated output gradient."""
    _window_ok(node, dilation, groups, transposed)
    if output_mask[2]:
        raise NotImplementedError(f"{node.target} with a bias")
    g, k = f.value(dy), f.value(w)
    v, low, high = _window_input(f, x, padding, 0)
    metas = _meta(node)
    out = g.shape[2:]
    ks = k.shape[2:]

    def data_grad(size, lo, hi, dt):
        rev = f._emit(f"stablehlo.reverse {k.name}, dims = [2, 3] : {k.ty}",
                      k.shape, k.dt)
        before = [kk - a - 1 for kk, a in zip(ks, lo)]
        after = [n + kk - 1 - ((o - 1) * s + 1) - b for n, kk, o, s, b in
                 zip(size, ks, out, stride, before)]
        return _convolution(f, g, rev, _CONV_DATA, [1, 1], before, after,
                            stride, [1, 1], (g.shape[0], k.shape[1], *size),
                            dt)

    res: list = [None, None, None]
    if output_mask[1]:
        after = [(o - 1) * s + 1 - n + kk - a - 1 for o, s, n, kk, a in
                 zip(out, stride, v.shape[2:], ks, low)]
        res[1] = _convolution(f, v, g, _CONV_WEIGHT, [1, 1], low, after,
                              [1, 1], stride, k.shape,
                              _element(metas[1].dtype))
    if output_mask[0]:
        shape, dt = tuple(metas[0].shape), _element(metas[0].dtype)
        if shape == v.shape:
            res[0] = data_grad(v.shape[2:], low, high, dt)
        else:      # x is a folded pad of v: v's gradient, for the crop
            pad_lo = [0, 0] + [a - p for a, p in zip(low, padding)]
            pad_hi = [0, 0] + [a - p for a, p in zip(high, padding)]
            res[0] = _PaddedGrad(
                lambda f: data_grad(v.shape[2:], low, high, dt),
                pad_lo, pad_hi)
    return res


def _pair(x) -> list[int]:
    return list(x) * (2 // len(x))


def _pool_attrs(kernel, stride, low, high) -> tuple[list, list, str]:
    window = [1, 1, *_pair(kernel)]
    strides = [1, 1, *_pair(stride or kernel)]
    pads = [[0, 0], [0, 0], *([a, b] for a, b in zip(low, high))]
    dense = ("0" if not any(map(any, pads)) else
             "[" + ", ".join(_dims(p) for p in pads) + "]")
    return window, strides, (f"padding = dense<{dense}> : "
                             "tensor<4x2xi64>")


@_lowers(aten.max_pool2d_with_indices.default)
def _max_pool(f, node, x, kernel, stride=(), padding=(0, 0),
              dilation=(1, 1), ceil_mode=False):
    """A ``reduce_window`` of ``maximum`` from -inf (a deferred -inf pad
    folded into its padding).  The indices are not computed: the backward
    selects each window's maximum again, as JAX's does, and any other use
    of them raises."""
    _window_ok(node, dilation, ceil_mode=ceil_mode)
    m = _meta(node)[0]
    shape, dt = tuple(m.shape), _element(m.dtype)
    v, low, high = _window_input(f, x, _pair(padding), -math.inf)
    window, strides, pads = _pool_attrs(kernel, stride, low, high)
    out = f.region_op(
        "reduce_window", [v, f.constant(-math.inf, v.dt)],
        f"base_dilations = array<i64: 1, 1, 1, 1>, {pads}, "
        f"window_dilations = array<i64: 1, 1, 1, 1>, window_dimensions = "
        f"array<i64: {', '.join(map(str, window))}>, window_strides = "
        f"array<i64: {', '.join(map(str, strides))}>", ["maximum"], shape, dt)
    return [out, None]


@_lowers(aten.max_pool2d_with_indices_backward.default)
def _max_pool_backward(f, node, dy, x, kernel, stride, padding, dilation,
                       ceil_mode, indices):
    """JAX's ``select_and_scatter``: each window's first maximum (``GE``)
    takes the window's output gradient, the others 0, summed where windows
    overlap.  A folded pad is written out here, and the crop that undoes it
    is a ``slice``: JAX's text has the same ``pad`` and ``slice``."""
    _window_ok(node, dilation, ceil_mode=ceil_mode)
    shape, dt = _out(node)
    window, strides, pads = _pool_attrs(kernel, stride, _pair(padding),
                                        _pair(padding))
    return f.region_op(
        "select_and_scatter", [f.value(x), f.value(dy), f.constant(0, dt)],
        f"{pads}, window_dimensions = array<i64: "
        f"{', '.join(map(str, window))}>, window_strides = array<i64: "
        f"{', '.join(map(str, strides))}>", ["GE", "add"], shape, dt)


# ---------------------------------------------------------------------------
# collectives of a per-rank step
# ---------------------------------------------------------------------------

_C10D = torch.ops._c10d_functional


def _collective(f, node, kind: str, x: Value, group: str, first: str = "",
                last: str = "", reduce_op: str | None = None) -> Value:
    """One collective on one line: ``"stablehlo.<kind>"(x) <{...}>`` with
    the attributes in JAX's order (``first``, the channel, the replica
    groups, ``last``), then its reduction region when it has one, then its
    signature."""
    ranks = f.module.traced.groups[group]
    shape, dt = _out(node)
    name = f"%{f.count}"
    f.count += 1
    region = ""
    if reduce_op is not None:
        # the step sums and scales means itself (data_parallel.py)
        if reduce_op != "sum":
            raise NotImplementedError(f"{node.target} with reduce_op "
                                      f"{reduce_op!r}")
        e, n = _tensor_type((), x.dt), name[1:]
        region = (f" ({{^bb0(%lhs{n}: {e}, %rhs{n}: {e}): %red{n} = "
                  f"stablehlo.add %lhs{n}, %rhs{n} : {e} stablehlo.return "
                  f"%red{n} : {e}}})")
    f.lines.append(
        f'    {name} = "stablehlo.{kind}"({x.name}) <{{{first}channel_handle '
        f"= #stablehlo.channel_handle<handle = {f.module.channel()}, type = "
        f"1>, replica_groups = dense<[[{', '.join(map(str, ranks))}]]> : "
        f"tensor<1x{len(ranks)}xi64>, {last}use_global_device_ids}}>{region} : "
        f"({x.ty}) -> {_tensor_type(shape, x.dt)}")
    return Value(name, shape, x.dt)


@_lowers(_C10D.all_gather_into_tensor.default)
def _all_gather(f, node, x, group_size, group):
    return _collective(f, node, "all_gather", f.value(x), group,
                       first="all_gather_dim = 0 : i64, ")


@_lowers(_C10D.reduce_scatter_tensor.default)
def _reduce_scatter(f, node, x, reduce_op, group_size, group):
    return _collective(f, node, "reduce_scatter", f.value(x), group,
                       last="scatter_dimension = 0 : i64, ",
                       reduce_op=reduce_op)


@_lowers(_C10D.all_reduce.default)
def _all_reduce(f, node, x, reduce_op, group):
    return _collective(f, node, "all_reduce", f.value(x), group,
                       reduce_op=reduce_op)


@_lowers(_C10D.wait_tensor.default)
def _wait(f, node, x):
    return f.value(x)
