"""Campaign execution: expand the grid, plan once per workload, run jobs
in parallel, stream results, share one persistent (H, C, R) cache.

Execution is **plan-based**: every ``(workload, fidelity, slicer)`` is
parsed and sliced exactly once (a :class:`~repro_torch.core.pipeline.PredictionPlan`
built by the :class:`~repro_torch.campaign.plans.PlanStore`), and each grid
point only runs the cheap evaluate phase against its shared plan — with
all region latencies fetched in one batched cache operation.

Executors:

  * ``serial``  — in-process, deterministic schedule order;
  * ``thread``  — ThreadPoolExecutor; jobs share one live cache store, so a
    fingerprint evaluated by one job is a hit for every later job;
  * ``process`` — ProcessPoolExecutor.  Workers receive pickled *plan
    files* (never raw workload text) and unpickle only the plans their
    jobs reference.  With a ``cache_path``, every worker opens the same
    file-locked append-log store: misses are written through immediately
    and lookups tail the log, so workers observe each other's fresh
    entries *mid-campaign*.  Without a path, each worker falls back to a
    startup snapshot, ships its fresh entries back for the parent to
    merge, and chain siblings are warmed with their leader's entries.

Schedules (``schedule=``):

  * ``locality`` (default) — jobs are grouped into *cache chains*
    (identical (H, C, R) keysets: same plan + system + estimator); each
    chain's leader runs before its siblings are released, so parallel
    executors never duplicate a cold miss, and chains are ordered
    fingerprint-heavy-first so expensive workloads warm the shared cache
    before cheap ones;
  * ``grid``  — pure grid order, all jobs released at once (the legacy
    behavior).

Results stream to ``results.jsonl`` as jobs finish (crash-safe: a killed
campaign keeps everything completed so far), then consolidate into
``results.csv`` and ``summary.json``.

The port's copy of the reference's ``campaign/runner.py``.  Its
differences: workloads that need an export are traced on fake tensors on
``run_campaign``'s ``device`` (None: the card), and a job whose fidelity
the workload has no text for is a ``plan`` error row (the reference
costs the raw text instead; see ``campaign/plans.py``).  ``session`` is
a :class:`repro_torch.api.Session`, or any object with the same
``estimators``/``topologies``/``systems`` registries.
"""
from __future__ import annotations

import csv
import json
import os
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, Executor, Future,
                                ProcessPoolExecutor, ThreadPoolExecutor,
                                wait)
from dataclasses import dataclass, field

from ..core.catalog import SystemRegistry, default_registry
from ..core.estimators.cache import PersistentCache
from ..core.pipeline import PredictionJob, PredictionPlan, Workload
from ..core.registry import ESTIMATORS, TOPOLOGIES, BuildContext
from ..serve import faults
from .builders import (build_estimator, build_system, build_topology,
                       build_workload)
from .plans import PlanStore
from .spec import CampaignSpec, JobSpec
from .summary import summarize

EXECUTORS = ("serial", "thread", "process")
SCHEDULES = ("locality", "grid")

# -------------------------- single-job execution --------------------------


@dataclass
class _Registries:
    """The registry set one campaign's jobs build against — a session's
    scoped registries (plugin kinds, user catalogs) or the globals —
    plus the spec file's base dir for backend-relative paths."""
    estimators: object = None           # core.registry.Registry
    topologies: object = None
    systems: SystemRegistry | None = None
    base_dir: str | None = None

    @classmethod
    def for_session(cls, session, spec: CampaignSpec) -> "_Registries":
        return cls(
            estimators=getattr(session, "estimators", None),
            topologies=getattr(session, "topologies", None),
            systems=spec.system_registry(getattr(session, "systems", None)),
            base_dir=spec.base_dir)

    def local_entries(self) -> tuple[dict, dict, dict, str | None]:
        """The non-global registrations, as picklable maps — what ships
        to process-pool workers so they can rebuild the same scope.
        (Classes pickle by reference: a plugin class must be importable
        from the worker, i.e. defined at module level — checked here, at
        the ship point, so the failure is one actionable error instead
        of a pickling traceback from inside the pool.)"""
        problems: list[str] = []
        for reg in (self.estimators, self.topologies):
            if reg is not None and hasattr(reg, "portability_errors"):
                problems.extend(reg.portability_errors())
        if problems:
            raise ValueError(
                "session-scoped backend classes cannot cross the "
                "worker-process boundary:\n  - " + "\n  - ".join(problems))
        est = self.estimators.local_entries() if self.estimators else {}
        topo = self.topologies.local_entries() if self.topologies else {}
        sysd: dict = {}
        chain = []
        reg = self.systems
        while reg is not None and reg is not default_registry():
            chain.append(reg)
            reg = reg.parent
        for r in reversed(chain):       # outermost scope wins
            sysd.update(r.local_systems())
        return est, topo, sysd, self.base_dir

    @classmethod
    def from_local_entries(cls, est: dict, topo: dict, sysd: dict,
                           base_dir: str | None = None) -> "_Registries":
        """Rebuild a worker-side scope from shipped maps."""
        regs = cls(estimators=ESTIMATORS.scope(),
                   topologies=TOPOLOGIES.scope(),
                   systems=default_registry().scope(),
                   base_dir=base_dir)
        for kind, c in est.items():
            regs.estimators.register(kind, c, replace=True)
        for kind, c in topo.items():
            regs.topologies.register(kind, c, replace=True)
        for sid, s in sysd.items():
            regs.systems.register(sid, s, source="<session>", replace=True)
        return regs

    def context(self, *, system_name: str = "",
                program=None) -> "BuildContext":
        return BuildContext(
            system_name=system_name, program=program,
            estimators=self.estimators, topologies=self.topologies,
            systems=self.systems, base_dir=self.base_dir)


#: stable error-row classification (satellite: error taxonomy).
#: ``plan``      — the workload's plan phase failed (parse/slice/build);
#: ``evaluate``  — the job's evaluate phase raised;
#: ``transport`` — the executor plumbing failed (a dead worker process),
#:                 not the job itself.
ERROR_TYPES = ("plan", "evaluate", "transport")


def _error_row(job: JobSpec, exc, error_type: str) -> dict:
    """An error result row: the grid point's axes plus a stable
    ``error_type`` (one of :data:`ERROR_TYPES`) and the exception class
    prefixed message."""
    row = dict(job.to_row())
    row["error"] = (exc if isinstance(exc, str)
                    else f"{type(exc).__name__}: {exc}")
    row["error_type"] = error_type
    return row


def _execute(job: JobSpec, plan: PredictionPlan, store,
             regs: _Registries | None = None) -> tuple[dict, dict]:
    """Evaluate one grid point against its shared plan; returns
    (result_row, freshly_computed_entries)."""
    t0 = time.perf_counter()
    if faults.active():
        faults.trip("evaluate", workload=job.workload, system=job.system,
                    estimator=job.estimator.kind)
    regs = regs or _Registries()
    system = build_system(job.system, registry=regs.systems)
    ctx = regs.context(system_name=job.system, program=plan.program)
    estimator = build_estimator(job.estimator, system,
                                registry=regs.estimators, context=ctx)
    topology = build_topology(job.topology, system,
                              registry=regs.topologies, context=ctx)
    pjob = PredictionJob(
        estimator=estimator, topology=topology,
        slicer=job.slicer, overlap=job.overlap,
        straggler_factor=job.straggler_factor, compression=job.compression,
        name=job.workload, system_name=system.name, cache_store=store,
        plan=plan)
    p = pjob.run()
    row = dict(job.to_row())
    row["fidelity"] = plan.fidelity  # the fidelity actually costed
    pred = p.to_row()
    row["toolchain"] = pred.pop("estimator")
    for k in ("workload", "system", "slicer"):
        pred.pop(k, None)
    row.update(pred)
    row.update(cost_columns(p.step_time_s, system, topology.num_devices))
    row["job_wall_s"] = time.perf_counter() - t0
    return row, dict(pjob.cached.new_entries)


def cost_columns(step_time_s: float, system, num_devices: int) -> dict:
    """TCO columns for one grid point, from the catalog's per-device
    cost/power ratings (absent fields -> absent columns, so unpriced
    systems produce exactly the pre-cost-model row shape).

    ``perf_per_usd`` is steps per dollar — the "how much work does a
    dollar buy" axis of the TCO survey, higher is better."""
    out: dict = {}
    if step_time_s <= 0:
        return out
    if system.cost_per_hour is not None:
        usd = step_time_s * num_devices * system.cost_per_hour / 3600.0
        out["usd_per_step"] = usd
        out["perf_per_usd"] = 1.0 / usd
    if system.tdp_watts is not None:
        out["joules_per_step"] = step_time_s * num_devices * system.tdp_watts
    return out


# process-pool worker state (plans + store, one set per worker process)
_WORKER: dict = {}


def _worker_init(plan_paths: dict, cache_entries: dict,
                 cache_path: str | None = None,
                 local_regs: tuple | None = None) -> None:
    """Per-worker setup.  ``plan_paths`` maps plan key -> pickled plan
    file; a worker unpickles a plan the first time one of its jobs
    references it (and never re-parses IR text).  With a ``cache_path``
    the worker opens the shared file-locked store — live view,
    write-through appends; without one it degrades to a private snapshot
    of the parent's entries.  ``local_regs`` carries a session's scoped
    registrations (plugin classes by reference, systems by value) so the
    worker resolves the same open vocabularies as the parent."""
    _WORKER["plan_paths"] = dict(plan_paths)
    _WORKER["plans"] = {}
    _WORKER["regs"] = (_Registries.from_local_entries(*local_regs)
                       if local_regs else _Registries())
    if cache_path:
        _WORKER["store"] = PersistentCache(cache_path)
    else:
        _WORKER["store"] = dict(cache_entries)


def _worker_plan(key: tuple) -> PredictionPlan:
    plan = _WORKER["plans"].get(key)
    if plan is None:
        plan = PlanStore.load_file(_WORKER["plan_paths"][key])
        _WORKER["plans"][key] = plan
    return plan


def _worker_run(job: JobSpec, plan_key: tuple,
                warm_entries: dict | None = None) -> tuple[dict, dict]:
    """Execute one job against this worker's plan + store; returns the
    result row plus the ``key -> (value, cost)`` entries it computed
    itself.  ``warm_entries`` carries a chain leader's fresh entries into
    snapshot-mode stores (path-backed stores see them via the log)."""
    store = _WORKER["store"]
    if warm_entries:
        if isinstance(store, PersistentCache):
            store.merge(warm_entries)
        else:
            store.update({k: v[0] if isinstance(v, (tuple, list)) else v
                          for k, v in warm_entries.items()})
    return _execute(job, _worker_plan(tuple(plan_key)), store,
                    _WORKER["regs"])


# ------------------------------ the campaign ------------------------------


@dataclass
class CampaignResult:
    """Everything a finished campaign produced: job_id-ordered result
    rows (error rows included), the summary dict, paths of any streamed
    artifacts, wall time, and the cache/plan reports."""
    name: str
    rows: list[dict]                 # job_id-ordered; error rows included
    summary: dict
    jsonl_path: str | None = None
    csv_path: str | None = None
    summary_path: str | None = None
    wall_s: float = 0.0
    cache: dict = field(default_factory=dict)
    plans: dict = field(default_factory=dict)
    resumed_rows: int = 0            # prior rows replayed, not re-run
    retried_rows: int = 0            # jobs that needed >= 1 retry

    @property
    def ok_rows(self) -> list[dict]:
        return [r for r in self.rows if "error" not in r]


#: row fields a resumed row must match against the expanded grid before
#: it is trusted (``fidelity`` is excluded, as in the reference, whose
#: rows record a fallback fidelity where the port's raise).
RESUME_MATCH_KEYS = ("workload", "system", "estimator", "slicer",
                     "topology", "overlap", "straggler_factor",
                     "compression")


def _match_resume_rows(jobs: list[JobSpec], resume_rows: list[dict]
                       ) -> tuple[dict[int, dict], dict]:
    """Partition a partial run's rows into trusted (replayed as-is) and
    everything that must re-run.

    A prior row is trusted only when its ``job_id`` exists in the
    expanded grid, it carries no ``error``, and its grid axes match the
    job exactly (a changed spec silently invalidates stale rows instead
    of smuggling them into the new grid).  Returns ``(job_id -> row,
    report)`` where the report counts resumed/stale rows and the error
    rows being retried, by ``error_type``."""
    expected = {j.job_id: j.to_row() for j in jobs}
    trusted: dict[int, dict] = {}
    report = {"resumed": 0, "rerun_errors": 0, "stale": 0, "missing": 0,
              "rerun_errors_by_type": {}}
    for r in resume_rows:
        jid = r.get("job_id")
        exp = expected.get(jid)
        if exp is None:
            report["stale"] += 1
            continue
        if "error" in r:
            et = r.get("error_type", "unknown")
            report["rerun_errors"] += 1
            report["rerun_errors_by_type"][et] = (
                report["rerun_errors_by_type"].get(et, 0) + 1)
            continue
        if any(r.get(k) != exp[k] for k in RESUME_MATCH_KEYS):
            report["stale"] += 1
            continue
        trusted[jid] = dict(r)
        trusted[jid]["resumed"] = True
    report["resumed"] = len(trusted)
    report["missing"] = (len(jobs) - len(trusted)
                         - report["rerun_errors"])
    return trusted, report


def _workload_texts(spec: CampaignSpec,
                    workloads: dict[str, Workload] | None,
                    only: set[str] | None = None, device=None) -> dict:
    """name -> {"raw": stablehlo, "optimized": hlo} for every grid workload.

    In-memory ``workloads`` take precedence; anything else is materialized
    from its spec (file read, synthesis, or the port's export on fake
    tensors on ``device``).  ``only`` restricts to the named workloads (a
    resumed campaign skips materializing — possibly re-exporting —
    workloads whose every row was replayed)."""
    provided = dict(workloads or {})
    texts: dict[str, dict] = {}
    for wspec in spec.workloads:
        if only is not None and wspec.name not in only:
            continue
        w = provided.get(wspec.name)
        if w is None:
            w = build_workload(wspec, device=device)
        texts[wspec.name] = {"raw": w.stablehlo_text,
                             "optimized": w.hlo_text}
    return texts


def _build_plans(jobs: list[JobSpec],
                 plans: PlanStore) -> tuple[dict, dict]:
    """The campaign's plan phase: build every referenced plan exactly
    once.  Returns (job_id -> plan key, plan key -> error string); jobs
    whose plan failed to build become error rows instead of running."""
    plan_keys: dict[int, tuple] = {}
    plan_errors: dict[tuple, str] = {}
    for job in jobs:
        key = plans.key_for(job)
        plan_keys[job.job_id] = key
        if key in plan_errors:
            continue
        try:
            plans.get(*key)
        except Exception as e:  # noqa: BLE001 — keep the campaign going
            plan_errors[key] = f"{type(e).__name__}: {e}"
    return plan_keys, plan_errors


def _schedule_chains(jobs: list[JobSpec], plan_keys: dict,
                     plans: PlanStore, schedule: str) -> list[list[JobSpec]]:
    """Order jobs into cache-affinity chains.

    ``locality``: one chain per cache group (see
    :meth:`JobSpec.cache_group` — jobs with identical (H, C, R) cache
    keysets).  The leader (first job) runs before its siblings are
    released, so a parallel executor cannot duplicate its cold misses;
    chains are ordered fingerprint-heavy-first (ties broken by job_id) so
    expensive plans warm the shared store before cheap ones.

    ``grid``: singleton chains in grid order — every job released at
    once, the pre-plan behavior.
    """
    if schedule == "grid":
        return [[j] for j in jobs]
    groups: dict[tuple, list[JobSpec]] = {}
    for job in jobs:
        # group by the exact cache keyset (fingerprint set, not plan
        # key): the linear and dep plans of a single-region workload
        # produce identical keys and must share a chain too
        groups.setdefault(
            job.cache_group(plans.fingerprint_set(plan_keys[job.job_id])),
            []).append(job)
    return sorted(
        groups.values(),
        key=lambda js: (-plans.weight(plan_keys[js[0].job_id]),
                        js[0].job_id))


def run_campaign(spec: CampaignSpec, *,
                 workloads: dict[str, Workload] | None = None,
                 out_dir: str | None = None,
                 executor: str = "serial",
                 max_workers: int | None = None,
                 cache_path: str | None = None,
                 cache: PersistentCache | None = None,
                 plan_store: PlanStore | None = None,
                 schedule: str = "locality",
                 progress: bool = False,
                 on_row=None,
                 session=None,
                 resume_rows: list[dict] | None = None,
                 retries: int = 0, device=None) -> CampaignResult:
    """Expand ``spec`` into jobs, plan, run them, and collect/stream
    results.

    ``workloads`` supplies in-memory :class:`Workload` objects by name
    (anything else is materialized from its spec — file read, synthesis,
    or the port's export traced on fake tensors on ``device``, None for
    the card).  Every ``(workload, fidelity, slicer)``
    is parsed + sliced once into a shared plan; ``schedule`` orders the
    jobs over those plans (``locality`` default, ``grid`` legacy).
    ``cache_path`` points every job — and, under the process executor,
    every live worker — at one shared append-log (H, C, R) store; the
    log is compacted once on completion and the returned ``cache``
    report includes the across-run ``time_saving_fraction`` from
    persisted per-key costs.  ``session`` (a
    :class:`repro_torch.api.Session`, or an object with the same scoped
    ``estimators``/``topologies``/``systems`` registries) supplies scoped
    registries — plugin estimator/topology kinds and
    user system catalogs — that jobs build against; without one the
    global registries and the spec's own ``system_catalog`` apply.

    Long-lived callers (a warm server, a multi-campaign session) pass
    ``cache`` — an already-open :class:`PersistentCache`, in place of a
    fresh one built from ``cache_path`` — and ``plan_store`` — a warm
    :class:`PlanStore` whose parsed programs and plans carry over, so a
    repeated campaign re-parses nothing.  The returned cache/plan
    reports count only *this* run's activity (deltas against the warm
    store's counters); ``on_row(row)`` observes each result row as it
    completes (a server streams these to its clients).

    Robustness knobs: ``resume_rows`` replays a partial prior run —
    trusted rows (see :func:`_match_resume_rows`) land in the output
    tagged ``"resumed": true`` without re-running (and without firing
    ``on_row``: stream consumers have seen them already), while error,
    stale, and missing rows re-run; the summary gains a ``resume``
    report saying exactly what was replayed vs retried.  ``retries``
    re-runs a job whose *evaluate* phase raised, up to N extra attempts
    (plan failures are deterministic and transport failures mean the
    executor itself died, so neither is retried)."""
    if executor not in EXECUTORS:
        raise ValueError(f"executor {executor!r} not in {EXECUTORS}")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    t0 = time.perf_counter()
    spec.validate(provided=set(workloads or {}), session=session)
    regs = _Registries.for_session(session, spec)
    jobs = spec.expand()
    resumed: dict[int, dict] = {}
    resume_report: dict | None = None
    if resume_rows is not None:
        resumed, resume_report = _match_resume_rows(jobs, resume_rows)
        todo = [j for j in jobs if j.job_id not in resumed]
    else:
        todo = jobs
    texts = _workload_texts(
        spec, workloads,
        only={j.workload for j in todo} if resumed else None, device=device)

    if cache is None:
        cache = (PersistentCache(cache_path) if cache_path
                 else PersistentCache())
        loaded = cache.loaded_entries
    else:
        # a warm store: entries present now were "loaded" for this run
        cache_path = cache_path or cache.path
        loaded = len(cache)
    lock0 = cache.lock_roundtrips

    if plan_store is None:
        plans = PlanStore(texts)
    else:
        plans = plan_store
        plans.add_texts(texts)
    parse0, built0 = plans.parse_count, plans.plans_built
    plan_keys, plan_errors = _build_plans(todo, plans)

    jsonl_path = None
    jsonl_file = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        jsonl_path = os.path.join(out_dir, "results.jsonl")
        jsonl_file = open(jsonl_path, "w")
    jsonl_lock = threading.Lock()

    def emit_row(row: dict) -> None:
        if jsonl_file:
            with jsonl_lock:
                jsonl_file.write(json.dumps(row) + "\n")
                jsonl_file.flush()
        if on_row is not None:
            on_row(row)
        if faults.active():
            # fires *after* the row is flushed/streamed: a kill here
            # loses only rows not yet emitted, which is the guarantee
            # the chaos tests pin down
            faults.trip("campaign_row", job_id=row.get("job_id"),
                        workload=row.get("workload"))
        if progress:
            tag = (f"{row['step_time_s'] * 1e3:9.3f} ms"
                   if "step_time_s" in row else f"ERROR {row.get('error')}")
            print(f"  [{row['job_id']:4d}/{len(jobs)}] "
                  f"{row['workload']} × {row['system']} × "
                  f"{row['estimator']} × {row['slicer']}: {tag}",
                  flush=True)

    rows: list[dict] = []
    new_entry_count = 0
    retried_rows = 0
    try:
        # resumed rows replay straight into the artifacts (jsonl but not
        # on_row: a resuming stream consumer already holds them)
        for jid in sorted(resumed):
            rows.append(resumed[jid])
            if jsonl_file:
                with jsonl_lock:
                    jsonl_file.write(json.dumps(resumed[jid]) + "\n")
                    jsonl_file.flush()
        # jobs whose plan could not be built fail up front, as rows
        for job in todo:
            err = plan_errors.get(plan_keys[job.job_id])
            if err is not None:
                row = _error_row(job, err, "plan")
                rows.append(row)
                emit_row(row)
        runnable = [j for j in todo
                    if plan_keys[j.job_id] not in plan_errors]
        chains = _schedule_chains(runnable, plan_keys, plans, schedule)
        if executor == "process":
            prows, new_entry_count, retried_rows = _run_process_pool(
                chains, plan_keys, plans, cache, max_workers, emit_row,
                out_dir, regs, retries)
        else:
            prows, new_entry_count, retried_rows = _run_in_process(
                chains, plan_keys, plans, cache, emit_row,
                max_workers if executor == "thread" else 0, regs, retries)
        rows.extend(prows)
    finally:
        if jsonl_file:
            jsonl_file.close()

    rows.sort(key=lambda r: r["job_id"])
    if cache_path:
        cache.save(cache_path)

    # cache accounting covers this run's work only: a resumed row's
    # hit/miss counters describe the *previous* run's store traffic
    fresh = [r for r in rows if not r.get("resumed")]
    total_hits = sum(r.get("cache_hits", 0) for r in fresh)
    total_misses = sum(r.get("cache_misses", 0) for r in fresh)
    saved = sum(r.get("cache_saved_s", 0.0) for r in fresh)
    miss_cost = sum(r.get("cache_miss_cost_s", 0.0) for r in fresh)
    wall = time.perf_counter() - t0
    cache_report = {
        "path": cache_path,
        "loaded_entries": loaded,
        "total_entries": len(cache),
        "new_entries": new_entry_count,
        "hits": total_hits,
        "misses": total_misses,
        "hit_rate": total_hits / (total_hits + total_misses)
        if total_hits + total_misses else 0.0,
        # the paper's §III-B(c) metric, across-run thanks to persisted
        # per-key evaluation costs: fraction of estimator wall time that
        # hits avoided (hits on entries from previous runs count too)
        "saved_seconds": saved,
        "miss_cost_seconds": miss_cost,
        "time_saving_fraction": saved / (saved + miss_cost)
        if (saved + miss_cost) > 0 else 0.0,
        # parent-side flock acquisitions (load/refresh/append/compact)
        # during *this* run (a warm store keeps its lifetime counter)
        "lock_roundtrips": cache.lock_roundtrips - lock0,
    }
    plan_report = {
        "schedule": schedule,
        "jobs": len(jobs),
        "plan_keys": len({plan_keys[j.job_id] for j in todo}),
        # this run's parse/slice work only: zero on a warm plan store
        # that already holds every referenced plan
        "parse_calls": plans.parse_count - parse0,
        "plans_built": plans.plans_built - built0,
        "plan_errors": len(plan_errors),
    }
    summary = summarize(spec.name, rows)
    summary["wall_s"] = wall
    summary["cache"] = cache_report
    summary["plans"] = plan_report
    if resume_report is not None:
        summary["resume"] = resume_report
    if retries or retried_rows:
        summary["retries"] = {"configured": retries,
                              "rows_retried": retried_rows}
    # full spec provenance: a streamed results dir is self-describing,
    # so `report --results` (and humans) can recover the grid later
    summary["spec"] = spec.to_dict()

    csv_path = summary_path = None
    if out_dir:
        csv_path = os.path.join(out_dir, "results.csv")
        _write_csv(rows, csv_path)
        summary_path = os.path.join(out_dir, "summary.json")
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=2)

    return CampaignResult(
        name=spec.name, rows=rows, summary=summary, jsonl_path=jsonl_path,
        csv_path=csv_path, summary_path=summary_path, wall_s=wall,
        cache=cache_report, plans=plan_report,
        resumed_rows=len(resumed), retried_rows=retried_rows)


def _run_in_process(chains: list[list[JobSpec]], plan_keys: dict,
                    plans: PlanStore, cache: PersistentCache,
                    emit_row, thread_workers: int,
                    regs: _Registries | None = None,
                    retries: int = 0) -> tuple[list[dict], int, int]:
    """Serial or thread-pool execution over one shared live cache store.

    Thread mode submits each chain's leader first and releases the
    siblings only when it completes — by then every (H, C, R) key the
    siblings need is in the shared store, so they are pure hits."""
    new_keys: set[str] = set()
    rows: list[dict] = []
    rows_lock = threading.Lock()
    retried = [0]

    def run_one(job: JobSpec) -> None:
        for attempt in range(retries + 1):
            try:
                plan = plans.get(*plan_keys[job.job_id])
                row, new = _execute(job, plan, cache, regs)
                with rows_lock:
                    new_keys.update(new)
                break
            except Exception as e:  # noqa: BLE001 — keep the campaign going
                row = _error_row(job, e, "evaluate")
                if attempt == 0 and retries:
                    with rows_lock:
                        retried[0] += 1
        with rows_lock:
            rows.append(row)
        emit_row(row)

    if thread_workers == 0:
        for chain in chains:
            for job in chain:
                run_one(job)
    else:
        with ThreadPoolExecutor(max_workers=thread_workers) as pool:
            _drain_chains(pool, chains,
                          submit=lambda job, lead: pool.submit(run_one, job))
    return rows, len(new_keys), retried[0]


def _drain_chains(pool: Executor, chains: list[list[JobSpec]],
                  submit, on_done=None) -> None:
    """Leader-first chain draining: submit every chain's leader, release
    its siblings (concurrently, as singleton chains) when it completes.
    ``submit(job, leader_result)`` returns a future; ``on_done(chain,
    future)`` observes each completion and returns the value handed to
    the chain's siblings as ``leader_result``."""
    pending = {}
    for chain in chains:
        pending[submit(chain[0], None)] = chain
    while pending:
        done, _ = wait(pending, return_when=FIRST_COMPLETED)
        for fut in done:
            chain = pending.pop(fut)
            lead_result = on_done(chain, fut) if on_done else fut.result()
            for sib in chain[1:]:
                pending[submit(sib, lead_result)] = [sib]


def _run_process_pool(chains: list[list[JobSpec]], plan_keys: dict,
                      plans: PlanStore, cache: PersistentCache,
                      max_workers: int | None, emit_row,
                      out_dir: str | None,
                      regs: _Registries | None = None,
                      retries: int = 0) -> tuple[list[dict], int, int]:
    """Process-pool execution over pickled plan files.

    Workers never see workload text: the parent dumps each built plan to
    a file and ships only the (tiny) key -> path map at pool startup;
    every job submission carries its plan key.  With a path-backed cache
    the workers share the live append-log store (see
    :func:`_worker_init`); fresh entries are additionally merged into the
    parent for accounting.  Pathless caches fall back to snapshot-out /
    merge-in, with chain siblings warmed by their leader's fresh entries
    so they cannot duplicate its cold misses."""
    import multiprocessing
    import shutil
    import sys
    import tempfile
    from concurrent.futures.process import BrokenProcessPool

    # prefer spawn: the parent may hold live torch threads and fork of a
    # threaded process risks deadlock.  spawn re-imports __main__, which
    # only works when __main__ is a real file (CLI, pytest, scripts) —
    # fall back to fork for stdin/interactive parents.
    main_mod = sys.modules.get("__main__")
    method = ("spawn" if getattr(main_mod, "__file__", None)
              and os.path.exists(getattr(main_mod, "__file__"))
              else "fork")
    rows: list[dict] = []
    new_total = 0
    retried = 0
    # path-backed workers open the shared store themselves — don't ship
    # them a (potentially large) snapshot they would never read
    snapshot = {} if cache.path else dict(cache.entries)
    plan_dir = (os.path.join(out_dir, "plans") if out_dir
                else tempfile.mkdtemp(prefix="repro-plans-"))
    try:
        # ship only the plans this campaign references — a warm store
        # may hold plans from earlier campaigns these workers never run
        plan_paths = plans.dump(
            plan_dir, keys={plan_keys[j.job_id]
                            for chain in chains for j in chain})
        local_regs = (regs or _Registries()).local_entries()
        if not any(local_regs):
            local_regs = None     # nothing scoped: workers use globals
        with ProcessPoolExecutor(
                max_workers=max_workers, initializer=_worker_init,
                initargs=(plan_paths, snapshot, cache.path, local_regs),
                mp_context=multiprocessing.get_context(method)) as pool:

            def submit(job: JobSpec, lead_entries):
                # warm only snapshot-mode siblings: path-backed workers
                # already observe the leader's entries via the log
                warm = lead_entries if not cache.path else None
                try:
                    return pool.submit(_worker_run, job,
                                       plan_keys[job.job_id], warm)
                except BrokenProcessPool as e:
                    # dead pool: hand back a pre-failed future so the
                    # drain keeps going and every remaining job gets a
                    # transport error row instead of aborting the run
                    f = Future()
                    f.set_exception(e)
                    return f

            def on_done(chain, fut):
                nonlocal new_total, retried
                job = chain[0]
                new = {}
                for attempt in range(retries + 1):
                    try:
                        row, new = (fut.result() if attempt == 0
                                    else submit(job, None).result())
                        new_total += cache.merge(new)
                        break
                    except BrokenProcessPool as e:
                        # the pool itself died (a worker was SIGKILLed
                        # or crashed hard): every pending future fails
                        # the same way, and resubmitting can't help —
                        # record a transport row and let the campaign
                        # drain, leaving a resumable results.jsonl
                        row = _error_row(job, e, "transport")
                        break
                    except Exception as e:  # noqa: BLE001
                        # raised *inside* the worker and pickled back:
                        # an evaluate failure, retryable
                        row = _error_row(job, e, "evaluate")
                        if attempt == 0 and retries:
                            retried += 1
                rows.append(row)
                emit_row(row)
                return new

            _drain_chains(pool, chains, submit=submit, on_done=on_done)
    finally:
        if not out_dir:
            shutil.rmtree(plan_dir, ignore_errors=True)
    return rows, new_total, retried


def _write_csv(rows: list[dict], path: str) -> None:
    """Consolidate result rows into one CSV (union of all columns)."""
    fields: list[str] = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def load_jsonl(path: str) -> list[dict]:
    """Read back a streamed results file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
