"""Profiling estimator (paper §IV-C2): the port's counterpart of the
reference's ``core/estimators/profiling.py``.

Each compute region is re-emitted as a standalone StableHLO module
(``slicing/emit.py``), run by the port's executor (``core/executor.py``) on
synthetic inputs, and its median time is the region's latency.  Where the
reference compiles the module with XLA and executes the executable, the
port runs it op by op with torch on the measured device, the card unless
the caller asks for the CPU, and each ``call`` of an operator of the
port's library (K1, K1b, K2, K2b) through the operator: the kernel on the
card.  This keeps the method's bias: the scope is truncated at region
boundaries, so nothing is fused or optimized across regions, and the
text is not fused within one either — the profiling path is
systematically pessimistic (paper §V-A).

On the card a region is captured once into a CUDA graph after one eager
run, replayed once to warm, and ``runs`` replays are timed with CUDA
events: the counterpart of executing XLA's compiled executable, which has
no per-op host work, where an eager run would time the executor's own
dispatch.  On the CPU the eager runs are timed with ``perf_counter``, as
the reference times its runs.

Only a region the emitter cannot re-emit (``RegionEmitError``) or that
holds an op the executor has no case for (``NotImplementedError``, raised
before anything runs) falls back to per-op roofline, as the reference's
emit failures do, and is counted in ``emit_failures``.  Anything else — a
CUDA error, a kernel that does not build or launch, a failed graph
capture — propagates: it is never replaced by roofline or by eager timing.

When the profiled platform differs from the target system, latencies are
rescaled by the roofline ratio of the two systems for the region's dominant
resource (a pragmatic cross-platform projection; flagged in results as
``projected=True``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from ...device import resolve_device
from ..executor import Executor, signature, torch_dtype
from ..ir.graph import OpNode, Program
from ..registry import register_estimator
from ..slicing.emit import RegionEmitError, region_to_module
from ..slicing.regions import ComputeRegion
from ..systems import MEASURE, System, host_system
from .analytical import RooflineEstimator
from .base import ComputeEstimator


def synthetic(types, device, seed: int = 0) -> list[torch.Tensor]:
    """The reference's synthetic inputs: normal floats (a bf16 drawn in
    f32 and rounded) and zero integers and booleans, drawn in order from
    one generator seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for t in types:
        dt = torch_dtype(t.dtype)
        if dt.is_floating_point:
            out.append(torch.randn(t.shape, generator=gen, device=device,
                                   dtype=torch.float32).to(dt))
        else:
            out.append(torch.zeros(t.shape, dtype=dt, device=device))
    return out


def typed_program(program: Program) -> Program:
    """``program`` with each op's result types read from its own
    signature (:func:`~repro_torch.core.executor.signature`) where the
    front end reads other types or none: the types ``region_to_module``
    declares a region's inputs with.  Without it a region that takes a
    max pool's output would declare it ``tensor<4x2xi64>``, one that takes
    a ``select``'s would declare its predicate's type, and one that takes
    a reduce-scatter's would not re-emit ("untyped external value")."""
    def typed(op: OpNode) -> OpNode:
        regions = [[typed(o) for o in r] for r in op.regions]
        outs = tuple(signature(op)[1])
        if outs == op.result_types and all(
                a is b for r, s in zip(regions, op.regions)
                for a, b in zip(r, s)):
            return op
        return dataclasses.replace(op, result_types=outs, regions=regions)
    functions = {name: [typed(op) for op in body]
                 for name, body in program.functions.items()}
    entry = functions.get("main") or [typed(op) for op in program.entry]
    return Program(entry=entry, functions=functions,
                   dialect=program.dialect, meta=program.meta)


@register_estimator("profiling")
class ProfilingEstimator(ComputeEstimator):

    def __init__(self, system: System | None = None,
                 program: Program | None = None, runs: int = 5,
                 target_system: System | None = None, *, device=None,
                 calls: dict | None = None):
        """``system``: the platform actually profiled (default: the
        calibrated host on ``device``, None meaning the card).
        ``target_system``: if set, results are roofline-projected onto it.
        ``program``: the source program (needed for region re-emission),
        and ``calls`` its text's ``call`` table."""
        self.device = resolve_device(device)
        super().__init__(system or host_system(self.device))
        self.program = program
        self._typed = None
        self.calls = dict(calls or {})
        self.runs = runs
        self.target_system = target_system
        self.toolchain = ("torch-cuda-graph" if self.device.type == "cuda"
                          else "torch-eager")
        self.fallback = RooflineEstimator(self.system, mode="per-op",
                                          include_overheads=True)
        self.emit_failures = 0

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "ProfilingEstimator":
        """Spec form: profile on the host (the card, or ``context.device``),
        roofline-projecting onto the grid system — unless the grid system
        *is* the host (ground-truth mode, no projection)."""
        target = None if context.system_name == "host" else system
        return cls(program=context.program,
                   runs=int(options.get("runs", 3)),
                   target_system=target,
                   device=getattr(context, "device", None),
                   calls=getattr(context, "calls", None))

    # Compute API
    def get_compile_args(self) -> dict:
        return {"backend": self.device.type, "num_partitions": 1}

    def get_exec_args(self) -> dict:
        return {"runs": self.runs, "reduction": "median"}

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        if self.program is None:
            return self.fallback.get_run_time_estimate(region)
        # one region at a time in a process (MEASURE): a thread campaign's
        # jobs would otherwise time each other's work, or touch the card
        # while a graph is being captured
        with MEASURE:
            try:
                if self._typed is None:
                    self._typed = typed_program(self.program)
                module_text, _ = region_to_module(
                    region.ops, self._typed, name="profiled_region")
                executor = Executor(module_text, calls=self.calls,
                                    device=self.device)
                inputs = synthetic(executor.input_types, self.device)
            except (RegionEmitError, NotImplementedError):
                self.emit_failures += 1
                return self.fallback.get_run_time_estimate(region)
            if self.device.type == "cuda":
                measured = self._time_graph(executor, inputs)
            else:
                measured = self._time_eager(executor, inputs)
            del executor, inputs
        return self._project(region, measured)

    def _time_eager(self, executor: Executor, inputs) -> float:
        executor.run(inputs)  # warmup
        times = []
        for _ in range(self.runs):
            t0 = time.perf_counter()
            executor.run(inputs)
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def _time_graph(self, executor: Executor, inputs) -> float:
        # one eager run on a side stream (it builds the kernels' library
        # and warms the libraries' handles), then one capture
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            executor.run(inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = executor.run(inputs)
        graph.replay()  # warmup
        times = []
        for _ in range(self.runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        del outputs, graph
        return statistics.median(times)

    def _project(self, region: ComputeRegion, host_seconds: float) -> float:
        """Project a host-measured latency onto the target system."""
        if self.target_system is None:
            return host_seconds
        src, dst = self.system, self.target_system
        dtype = "f32"
        for op in region.ops:
            if op.result_types:
                dtype = op.result_types[0].dtype
                break
        compute_ratio = src.flops_for(dtype) / dst.flops_for(dtype)
        memory_ratio = src.mem_bw / dst.mem_bw
        # dominant resource on the *target* decides the scaling
        c_t = region.cost.flops / dst.flops_for(dtype)
        m_t = (region.boundary_in_bytes + region.boundary_out_bytes) / dst.mem_bw
        ratio = compute_ratio if c_t >= m_t else memory_ratio
        return host_seconds * ratio

    @property
    def cache_hw_key(self) -> str:
        tgt = self.target_system.name if self.target_system else "native"
        return f"{self.system.name}->{tgt}"

    @property
    def cache_config_key(self) -> str:
        return f"runs{self.runs}"
