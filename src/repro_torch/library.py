"""The port's opaque operators, in the ``repro_torch`` operator library.

Each kernel entry point (and the layer barrier) is an operator of its own,
``torch.ops.repro_torch.<name>``: its CPU implementation is the plain
version, its CUDA implementation the kernel, and its fake only allocates
the outputs, so a trace on fake tensors records one node per call, launches
nothing and reads no pointer.  :func:`call` goes through the operator only
inside a trace: outside one it runs the implementation for the tensors'
device itself, since the dispatcher's round trip through Python costs the
host several µs a call, which the host-bound decode step pays on each of
its kernel calls (``tools/ab_dispatch.py``).  For the same reason the
operators are defined with ``torch.library.Library`` rather than
``torch.library.custom_op``, which adds Python checks to every call.
"""
from __future__ import annotations

from typing import Callable

import torch

_LIB = torch.library.Library("repro_torch", "DEF")
#: each operator and the plain version it stands for (the export writes an
#: operator as its plain version's math)
PLAIN: dict[torch._ops.OpOverload, Callable] = {}
_KERNEL: dict[torch._ops.OpOverload, Callable] = {}


def define(schema: str, plain: Callable, kernel: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define the operator ``schema`` (``"name(args) -> outputs"``) with
    ``plain`` on the CPU, ``kernel`` on the card and ``fake`` for the
    outputs' shapes, dtypes and device, each called with the operator's
    arguments in order.  Returns the operator."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, kernel, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    op = getattr(torch.ops.repro_torch, name).default
    PLAIN[op], _KERNEL[op] = plain, kernel
    return op


def call(op: torch._ops.OpOverload, *args):
    """``op(*args)``.  Inside a trace (a Python dispatch mode is active, as
    under ``make_fx`` or ``FakeTensorMode``) the call goes through the
    dispatcher, which records the operator and runs its fake; outside one
    the plain version (CPU tensors) or the kernel (any other) runs
    directly."""
    if torch._C._dispatch_tls_is_dispatch_key_included(
            torch._C.DispatchKey.Python):
        return op(*args)
    impl = PLAIN[op] if args[0].device.type == "cpu" else _KERNEL[op]
    return impl(*args)


def define_rank_op(schema: str, impl: Callable,
                   fake: Callable) -> torch._ops.OpOverload:
    """Define the operator ``schema`` whose value depends on which rank of
    a process group runs it (a mesh coordinate): ``impl`` on the CPU and
    the card alike, ``fake`` in a trace.  It has no plain version, so the
    export lowers it itself (``core/stablehlo.py``, from
    ``stablehlo.partition_id``) instead of writing a ``call``."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CPU")
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default
