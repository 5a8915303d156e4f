"""End-to-end evaluation pipeline (paper Fig 2): the port's copy of the
reference's ``core/pipeline.py``.

    workload export -> slicing -> compute estimation
                    -> trace construction -> network simulation

One :class:`Workload` (the StableHLO text a torch step exports) can be
driven through any combination of slicer × estimator × topology — the
cross-fidelity, cross-architecture axis of the paper.

A torch export's raw text is the global step as written.  Its optimized
text, for a workload with a mesh, is the per-rank program of the data mesh
with its collectives (``train/loop.py``, ``distributed/data_parallel.py``):
the port's counterpart of the reference's compiled, SPMD-partitioned text.
Without it :meth:`Workload.program` raises for the "optimized" fidelity
instead of falling back to the raw text as the reference does: a prediction
that asks for the optimized text must not get the raw one without being
told.

Execution is split into two phases, as in the reference:

* **plan** — parse + slice, producing a :class:`PredictionPlan`.  A plan
  depends only on ``(workload, fidelity, slicer)``, so one plan serves
  every grid point that shares those axes (the campaign engine builds
  each plan exactly once and fans it out);
* **evaluate** — estimator + trace + network simulation against a plan.
  All region latencies are fetched through the estimator's *batched*
  API, so a shared cache store pays one lock round-trip per plan
  evaluation instead of one per region.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .estimators.base import ComputeEstimator
from .estimators.cache import CachedEstimator, CacheStats
from .export import trace
from .ir.arrays import RegionArrays, build_region_arrays
from .ir.graph import Program
from .ir.parser import parse
from .network.scheduler import ScheduleResult, simulate
from .network.topology import Topology
from .slicing.depaware import dependency_aware_split
from .slicing.linear import linear_split
from .slicing.regions import Segment
from .stablehlo import emit
from .trace.chakra import Trace

#: evaluate phase default: feed plans' precomputed RegionArrays to the
#: estimator batch API (vectorized where the estimator supports it; the
#: values are bit-identical either way)
DEFAULT_VECTORIZE = True

FIDELITIES = ("raw", "optimized")


@dataclass
class Workload:
    """An exported workload: raw StableHLO and, for a workload with a
    mesh, the per-rank (optimized) text."""
    name: str
    stablehlo_text: str | None = None
    hlo_text: str | None = None
    meta: dict = field(default_factory=dict)

    def program(self, fidelity: str = "optimized") -> Program:
        if fidelity not in FIDELITIES:
            raise ValueError(f"fidelity {fidelity!r} is not one of "
                             f"{FIDELITIES}")
        text = self.hlo_text if fidelity == "optimized" else \
            self.stablehlo_text
        if text is None:
            raise ValueError(missing_text(self.name, fidelity))
        return parse(text)

    def calls(self, fidelity: str = "optimized") -> dict:
        """The ``call`` table of the text of ``fidelity``: each private
        function that stands for an operator of the port's library, by
        name -> its :class:`~repro_torch.core.stablehlo.OperatorCall` (empty
        for a text the port did not export)."""
        meta = self.meta.get("optimized", {}) if fidelity == "optimized" \
            else self.meta
        return dict(meta.get("calls", {}))


def missing_text(name: str, fidelity: str) -> str:
    """Why workload ``name`` cannot be costed at ``fidelity``."""
    why = ("a torch export has optimized (per-device) text only when it is "
           "exported with a mesh, as the per-rank program of a data mesh; "
           "this one has none" if fidelity == "optimized" else
           "the workload carries no raw StableHLO text")
    return f"workload {name!r}: no {fidelity} text: {why}"


def export_workload(fn, *specs, name: str = "workload", device=None,
                    per_rank=None) -> Workload:
    """Trace ``fn(*specs)`` on fake tensors on ``device`` (None: the card)
    and emit its StableHLO text; no device memory is allocated and no
    kernel launches.  ``meta`` holds the trace's and the emit's seconds,
    the text's size in bytes and the count of each operator of the port's
    library in the graph (``kernel_ops``).

    ``per_rank`` is ``(rank_fn, rank_specs, mesh)``: the per-rank program
    of the same step on a mesh and its arguments, e.g. from
    ``train_step_exports(cfg, seq, batch, mesh)``, called while the mesh's
    process group is up (``launch/mesh.py::traced_mesh``).  Its text is the
    workload's optimized text (``hlo_text``) and its figures are
    ``meta["optimized"]``."""
    w = Workload(name=name)
    w.stablehlo_text, w.meta = _export(fn, specs, name, device)
    if per_rank is not None:
        rank_fn, rank_specs, mesh = per_rank
        w.hlo_text, w.meta["optimized"] = _export(rank_fn, rank_specs, name,
                                                  device, mesh)
        w.meta["optimized"]["num_partitions"] = mesh.size()
    return w


def _export(fn, specs, name: str, device, mesh=None) -> tuple[str, dict]:
    traced = trace(fn, *specs, device=device, mesh=mesh)
    t0 = time.perf_counter()
    calls: dict = {}
    text = emit(traced, name, calls)
    return text, {"trace_s": traced.seconds,
                  "emit_s": time.perf_counter() - t0,
                  "text_bytes": len(text.encode()),
                  "kernel_ops": traced.op_counts, "calls": calls}


@dataclass
class PredictionPlan:
    """The reusable product of the pipeline's *plan* phase.

    Everything that depends only on ``(workload, fidelity, slicer)`` —
    the parsed :class:`Program`, the slicer's segments (with region
    fingerprints already computed by ``finalize_region``), and the
    dependency map for the dependency-aware slicer.  Plans are plain
    picklable data: the campaign engine builds each one once, shares it
    across every grid point with the same key, and ships it to process
    workers instead of raw IR text.
    """
    name: str
    fidelity: str
    slicer: str
    program: Program
    segments: list[Segment]
    dep_map: dict[int, set[int]] | None = None
    #: evaluation-ready array-of-structs view of the COMP regions, in
    #: segment order (built once at plan time; numpy + interned tables,
    #: picklable like the rest of the plan)
    arrays: RegionArrays | None = None
    #: the text's ``call`` table (:meth:`Workload.calls`): what the
    #: profiling estimator's executor runs each operator's ``call`` with
    calls: dict = field(default_factory=dict)

    @property
    def key(self) -> tuple[str, str, str]:
        """The identity under which this plan is shared."""
        return (self.name, self.fidelity, self.slicer)

    @property
    def compute_regions(self) -> list:
        """The COMP regions, in segment order (the estimator batch)."""
        return [s.region for s in self.segments if s.kind == "COMP"]

    @property
    def fingerprints(self) -> set[str]:
        """Distinct region fingerprints — the plan's cache-key surface."""
        return {s.region.fingerprint for s in self.segments
                if s.kind == "COMP"}


def build_plan(program: Program, *, slicer: str = "linear",
               name: str = "workload", fidelity: str = "raw",
               calls: dict | None = None) -> PredictionPlan:
    """Run the plan phase: slice ``program`` once into a reusable plan
    (segments plus the evaluation-ready :class:`RegionArrays`); ``calls``
    is the text's ``call`` table, carried along."""
    if slicer == "linear":
        segments, dep_map = linear_split(program), None
    elif slicer in ("dep", "dependency-aware"):
        segments, dep_map = dependency_aware_split(program)
    else:
        raise ValueError(f"unknown slicer {slicer!r}")
    arrays = build_region_arrays(
        [s.region for s in segments if s.kind == "COMP"])
    return PredictionPlan(name=name, fidelity=fidelity, slicer=slicer,
                          program=program, segments=segments,
                          dep_map=dep_map, arrays=arrays,
                          calls=dict(calls or {}))


@dataclass
class Prediction:
    workload: str
    system: str
    estimator: str
    slicer: str
    step_time_s: float
    compute_s: float
    comm_s: float
    exposed_comm_s: float
    num_segments: int
    num_comm: int
    simulation_wall_s: float
    cache_stats: CacheStats | None = None
    schedule: ScheduleResult | None = None
    breakdown: dict = field(default_factory=dict)
    #: estimator-reported per-prediction quality fields (a learned-tier
    #: estimator's uncertainty interval + extrapolation flags); merged
    #: verbatim into the result row
    quality: dict | None = None

    def to_row(self) -> dict:
        """Flat, JSON/CSV-serializable view (drops the schedule object)."""
        row = {
            "workload": self.workload,
            "system": self.system,
            "estimator": self.estimator,
            "slicer": self.slicer,
            "step_time_s": self.step_time_s,
            "compute_s": self.compute_s,
            "comm_s": self.comm_s,
            "exposed_comm_s": self.exposed_comm_s,
            "num_segments": self.num_segments,
            "num_comm": self.num_comm,
            "simulation_wall_s": self.simulation_wall_s,
        }
        if self.quality:
            row.update(self.quality)
        if self.cache_stats is not None:
            row["cache_hits"] = self.cache_stats.hits
            row["cache_misses"] = self.cache_stats.misses
            row["cache_hit_rate"] = self.cache_stats.hit_rate
            row["cache_saved_s"] = self.cache_stats.saved_seconds
            row["cache_miss_cost_s"] = self.cache_stats.miss_cost_seconds
        return row


def _trace_from_linear(segments: list[Segment], durations: list[float],
                       name: str) -> Trace:
    """Sequential trace; loop groups are unrolled preserving group order."""
    trace = Trace(meta={"workload": name, "slicer": "linear"})
    prev: int | None = None

    def emit(seg: Segment, dur: float) -> None:
        nonlocal prev
        deps = [prev] if prev is not None else []
        if seg.kind == "COMM":
            nid = trace.add_comm(
                seg.comm.kind, seg.comm.algo_bytes, seg.comm.group_size,
                seg.comm.num_groups, deps=deps, name=seg.comm.label)
        else:
            nid = trace.add_comp(
                seg.region.label or "region", dur * 1e6, deps=deps,
                flops=seg.region.cost.flops)
        prev = nid

    i = 0
    while i < len(segments):
        seg = segments[i]
        if seg.repeat <= 1:
            emit(seg, durations[i])
            i += 1
            continue
        # contiguous run with the same group repeats together, in order
        j = i
        while (j < len(segments) and segments[j].group == seg.group
               and segments[j].repeat == seg.repeat):
            j += 1
        for _ in range(seg.repeat):
            for k in range(i, j):
                emit(segments[k], durations[k])
        i = j
    return trace


def _trace_from_dep(segments: list[Segment], deps: dict[int, set[int]],
                    durations: list[float], name: str) -> Trace:
    trace = Trace(meta={"workload": name, "slicer": "dependency-aware"})
    for idx, seg in enumerate(segments):
        d = sorted(deps.get(idx, set()))
        if seg.kind == "COMM":
            trace.add_comm(seg.comm.kind, seg.comm.algo_bytes,
                           seg.comm.group_size, seg.comm.num_groups,
                           deps=d, name=seg.comm.label)
        else:
            trace.add_comp(seg.region.label or "region",
                           durations[idx] * 1e6, deps=d,
                           flops=seg.region.cost.flops)
    return trace


@dataclass
class PredictionJob:
    """One (plan × estimator × topology × knobs) prediction, reified.

    This is the unit the campaign engine schedules: constructing the job
    is cheap and side-effect free; :meth:`run` executes stages (b)-(d) of
    the methodology as two phases — :meth:`build_plan` (parse/slice,
    skipped entirely when a prebuilt ``plan`` is supplied) and
    :meth:`evaluate` (estimator + network simulation).  ``cache_store``
    lets many jobs (and many estimators — the (H, C, config, R) key
    disambiguates, including estimator configuration) share one latency
    store, in-process or persistent; ``cached`` exposes the wrapper after
    the run so callers can collect ``new_entries`` for cross-process
    merging.  ``batch_cache=False`` forces one store round-trip per
    region (the pre-plan behavior; kept for parity testing and
    benchmarking against the batched default).
    """
    program: Program | None = None
    estimator: ComputeEstimator = None
    topology: Topology = None
    slicer: str = "linear"
    overlap: bool = False
    straggler_factor: float = 1.0
    compression: float = 1.0
    name: str = "workload"
    use_cache: bool = True
    system_name: str | None = None
    cache_store: object | None = None   # MutableMapping | PersistentCache
    plan: PredictionPlan | None = None  # prebuilt plan (skips parse/slice)
    batch_cache: bool = True
    #: None = module default (DEFAULT_VECTORIZE); False forces the scalar
    #: per-region estimator path (parity testing / benchmarking)
    vectorize: bool | None = None
    cached: CachedEstimator | None = field(default=None, init=False)

    def build_plan(self) -> PredictionPlan:
        """The plan phase for this job's (program, slicer)."""
        if self.program is None:
            raise ValueError(f"job {self.name!r}: no program and no plan")
        return build_plan(self.program, slicer=self.slicer, name=self.name)

    def evaluate(self, plan: PredictionPlan) -> Prediction:
        """The evaluate phase: cost ``plan``'s regions (one batched cache
        operation), build the trace, and simulate the network."""
        if self.estimator is None or self.topology is None:
            raise ValueError(
                f"job {self.name!r}: estimator and topology are required")
        t0 = time.perf_counter()
        self.cached = (CachedEstimator(self.estimator, store=self.cache_store)
                       if self.use_cache else None)
        est = self.cached or self.estimator

        vectorize = (DEFAULT_VECTORIZE if self.vectorize is None
                     else self.vectorize)
        arrays = plan.arrays if vectorize else None
        segments = plan.segments
        if self.batch_cache:
            costed = iter(est.get_run_time_estimates(plan.compute_regions,
                                                     arrays=arrays))
            durations = [next(costed) if s.kind == "COMP" else 0.0
                         for s in segments]
        else:
            durations = [est.get_run_time_estimate(s.region)
                         if s.kind == "COMP" else 0.0 for s in segments]
        if plan.slicer == "linear":
            trace = _trace_from_linear(segments, durations, self.name)
        else:
            trace = _trace_from_dep(segments, plan.dep_map, durations,
                                    self.name)

        trace.validate()
        sched = simulate(trace, self.topology, overlap=self.overlap,
                         straggler_factor=self.straggler_factor,
                         compression=self.compression)
        # optional estimator hook: per-prediction quality fields (the
        # learned tier's uncertainty interval + extrapolation flags) ride
        # into the result row.  Queried on the bare estimator — cache
        # hits don't change what the model knows about its confidence.
        quality_fn = getattr(self.estimator, "prediction_quality", None)
        quality = (dict(quality_fn(plan.compute_regions))
                   if quality_fn is not None else None)
        wall = time.perf_counter() - t0
        return Prediction(
            workload=self.name,
            system=self.system_name or self.estimator.system.name,
            estimator=self.estimator.toolchain,
            slicer=self.slicer,
            step_time_s=sched.makespan_s,
            compute_s=sched.compute_busy_s,
            comm_s=sched.comm_busy_s,
            exposed_comm_s=sched.exposed_comm_s,
            num_segments=len(segments),
            num_comm=sum(1 for s in segments if s.kind == "COMM"),
            simulation_wall_s=wall,
            cache_stats=self.cached.stats if self.cached else None,
            schedule=sched,
            breakdown=sched.breakdown,
            quality=quality)

    def run(self) -> Prediction:
        return self.evaluate(self.plan or self.build_plan())


def predict(program: Program, estimator: ComputeEstimator, topology: Topology,
            *, slicer: str = "linear", overlap: bool = False,
            straggler_factor: float = 1.0, compression: float = 1.0,
            name: str = "workload", use_cache: bool = True,
            system_name: str | None = None,
            cache_store: object | None = None) -> Prediction:
    """Run stages (b)-(d) of the methodology on a parsed program.

    Thin wrapper over :class:`PredictionJob` for the single-point case."""
    return PredictionJob(
        program=program, estimator=estimator, topology=topology,
        slicer=slicer, overlap=overlap, straggler_factor=straggler_factor,
        compression=compression, name=name, use_cache=use_cache,
        system_name=system_name, cache_store=cache_store).run()
