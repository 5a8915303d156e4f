"""Plan store: build each (workload, fidelity, slicer) plan exactly once.

Parsing a multi-MB HLO text and slicing it are per-*workload* costs, not
per-*job* costs — every grid point that shares ``(workload, fidelity,
slicer)`` consumes the identical :class:`~repro_torch.core.pipeline.PredictionPlan`.
The store memoizes both stages separately (two slicers share one parsed
``Program``) and can pickle plans to files so process-pool workers load
exactly the plans they execute instead of re-parsing shipped IR text.

The port's copy of the reference's ``campaign/plans.py``, with one
difference: a fidelity whose text the workload lacks is never replaced by
another.  The reference costs the raw text when a job asks for optimized
text that is absent; here the plan raises, naming what is missing (a
torch export has optimized text only when its workload has a mesh), and
the runner records a ``plan`` error row.
"""
from __future__ import annotations

import os
import pickle
import re
import threading

from ..core.ir.graph import Program
from ..core.pipeline import PredictionPlan, build_plan, missing_text

PLAN_FILE_SUFFIX = ".plan.pkl"

#: (workload name, effective fidelity, slicer) — the sharing identity
PlanKey = tuple


class PlanStore:
    """Memoizing plan builder for one campaign's workload texts.

    ``texts`` maps workload name -> ``{"raw": ..., "optimized": ...}``,
    and optionally ``"calls": {"raw": ..., "optimized": ...}``, each text's
    ``call`` table (:meth:`~repro_torch.core.pipeline.Workload.calls`),
    which its plans carry.
    ``get`` parses at most once per (workload, fidelity) and slices at
    most once per full key, under a lock so concurrent first jobs of a
    thread campaign cannot duplicate the work.  ``parse_count`` /
    ``plans_built`` expose exactly how often each stage ran (benchmarks
    and tests assert on them).
    """

    def __init__(self, texts: dict[str, dict] | None = None):
        self.texts = dict(texts or {})
        self._programs: dict[tuple[str, str], Program] = {}
        self._plans: dict[PlanKey, PredictionPlan] = {}
        self._fingerprints: dict[PlanKey, frozenset] = {}
        self._lock = threading.Lock()
        self.parse_count = 0    # programs parsed: one per (workload, fidelity)
        self.plans_built = 0    # slicer runs: one per (workload, fid, slicer)

    def add_texts(self, texts: dict[str, dict]) -> None:
        """Fold more workload texts into the store (long-lived stores —
        a warm server, a multi-campaign session — grow one store instead
        of rebuilding it per campaign).

        Re-registering a name with *identical* texts keeps its parsed
        programs and plans hot; binding a name to *different* text drops
        everything cached under that name first, so a reused workload
        name can never serve a stale plan."""
        with self._lock:
            for name, t in texts.items():
                old = self.texts.get(name)
                if old == t:
                    continue
                if old is not None:
                    for memo in (self._programs, self._plans,
                                 self._fingerprints):
                        for key in [k for k in memo if k[0] == name]:
                            del memo[key]
                self.texts[name] = t

    def key_for(self, job) -> PlanKey:
        """The plan key a :class:`~repro_torch.campaign.spec.JobSpec`
        resolves to (its own fidelity: there is no fallback)."""
        return (job.workload, job.fidelity, job.slicer)

    def get(self, workload: str, fidelity: str,
            slicer: str) -> PredictionPlan:
        """The plan for the key — parse + slice run at most once; raises
        ``ValueError`` when the workload has no text of ``fidelity``."""
        key = (workload, fidelity, slicer)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = build_plan(
                    self._program_locked(workload, fidelity), slicer=slicer,
                    name=workload, fidelity=fidelity,
                    calls=self.texts[workload].get("calls", {}).get(fidelity))
                self.plans_built += 1
                self._plans[key] = plan
        return plan

    def _program_locked(self, workload: str, fidelity: str) -> Program:
        from ..core.ir.parser import parse

        pkey = (workload, fidelity)
        prog = self._programs.get(pkey)
        if prog is None:
            text = self.texts[workload].get(fidelity)
            if text is None:
                raise ValueError(missing_text(workload, fidelity))
            prog = parse(text)
            self.parse_count += 1
            self._programs[pkey] = prog
        return prog

    @property
    def plans(self) -> dict:
        """The built plans, keyed by plan key (read-only view)."""
        return dict(self._plans)

    def fingerprint_set(self, key: PlanKey) -> frozenset:
        """The plan's distinct region fingerprints as a hashable set —
        the R surface of its cache keys (empty for unbuilt keys).  Two
        plans with equal sets (e.g. the linear and dep slicings of a
        single-region workload) produce identical cache keysets, so the
        scheduler chains their jobs together."""
        memo = self._fingerprints
        fs = memo.get(key)
        if fs is None:
            plan = self._plans.get(tuple(key))
            fs = (frozenset(plan.fingerprints) if plan is not None
                  else frozenset())
            memo[key] = fs
        return fs

    def weight(self, key: PlanKey) -> int:
        """Distinct region fingerprints of the plan — the scheduler's
        'fingerprint-heavy first' ordering weight (0 for unbuilt keys)."""
        return len(self.fingerprint_set(key))

    # --------------------------- plan files ---------------------------

    def dump(self, dir_path: str,
             keys: set | None = None) -> dict[PlanKey, str]:
        """Pickle built plans into ``dir_path``; returns key -> path.

        This is how plans cross the process-pool boundary: workers
        receive the (tiny) path map and unpickle only the plans their
        jobs reference — no workload text ever ships to a worker.
        ``keys`` restricts the dump to the plans one campaign actually
        references (a warm store may hold many more)."""
        os.makedirs(dir_path, exist_ok=True)
        items = sorted(k_p for k_p in self._plans.items()
                       if keys is None or k_p[0] in keys)
        paths: dict[PlanKey, str] = {}
        for i, (key, plan) in enumerate(items):
            slug = re.sub(r"[^\w.-]+", "_", "-".join(key))
            path = os.path.join(dir_path, f"{i:03d}-{slug}{PLAN_FILE_SUFFIX}")
            with open(path, "wb") as f:
                pickle.dump(plan, f, protocol=pickle.HIGHEST_PROTOCOL)
            paths[key] = path
        return paths

    @staticmethod
    def load_file(path: str) -> PredictionPlan:
        """Unpickle one dumped plan (the worker side of :meth:`dump`)."""
        with open(path, "rb") as f:
            return pickle.load(f)
