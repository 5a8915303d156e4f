"""Stable public facade over the port's prediction pipeline: the
counterpart of the reference's ``repro.api``.

Exporting workloads, building plans, single predictions, campaigns, and
extending the three open vocabularies (estimator kinds, topology kinds,
system catalog) behind one entry point::

    from repro_torch import api
    from repro_torch.models.resnet import ResNetConfig, resnet_train_exports

    session = api.Session(cache_path=".cache/hcr.jsonl")
    step, args = resnet_train_exports(ResNetConfig(depth=18), 64, 224)
    w = session.export(step, *args, name="resnet18")   # on the card
    p = session.predict(w, system="h100", estimator="roofline")
    result = session.campaign("specs/fig7_resnet.json", executor="thread")

A :class:`Session` owns *scoped* registries (they overlay the global ones
without mutating them) plus the shared (H, C, R) cache store and a warm
plan store.  Third-party backends register globally
(:func:`register_estimator`, :func:`register_topology`) or per session
(``session.register_estimator("my-sim")(MySim)``,
``session.register_system("my-chip", {...})``); campaign specs then use
the new kinds and ids like any builtin.

Where the port differs from the reference's facade:

* :meth:`Session.export` traces a torch step on fake tensors through
  :func:`repro_torch.core.pipeline.export_workload`; ``device=None`` means
  the card (the CPU only when asked), and ``per_rank`` gives a data mesh's
  per-rank step as the optimized text;
* :meth:`Session.search` raises ``NotImplementedError``: the what-if search
  is not ported yet;
* the catalog id ``host`` (:func:`host_system`) is the calibrated card
  that the ``profiling`` estimator measures on, not the host CPU; the
  verbs that measure (:meth:`Session.predict`, :meth:`Session.campaign`,
  :meth:`Session.get_system` for ``host``) take a ``device``, the CPU only
  when asked.

This module imports only the registries and the catalog at load time;
numpy and torch are pulled in by the methods that need them.
"""
from __future__ import annotations

import os

from .core.catalog import SystemRegistry, default_registry
from .core.registry import (ESTIMATORS, TOPOLOGIES, BuildContext, Registry,
                            register_estimator, register_topology)
from .core.systems import Interconnect, System, host_system

__all__ = [
    "Session", "System", "Interconnect", "SystemRegistry", "Registry",
    "register_estimator", "register_topology", "host_system", "load_spec",
]

#: why :meth:`Session.search` raises
SEARCH_PENDING = (
    "the what-if search (search/: spec, engine, pareto, report) is not "
    "ported to repro_torch yet (ROADMAP, Queue 1 item 8: search)")


class Session:
    """Registries + cache store + the pipeline verbs that use them.

    ``systems`` seeds extra catalog paths (files or directories of system
    JSON records); ``cache_path`` backs every prediction and campaign run
    with one persistent (H, C, R) store.
    """

    def __init__(self, *, systems: list[str] | tuple = (),
                 cache_path: str | None = None):
        self.estimators = ESTIMATORS.scope()
        self.topologies = TOPOLOGIES.scope()
        self.systems = default_registry().scope()
        for p in systems:
            self.systems.load_path(p)
        self.cache_path = cache_path
        self._store = None
        self._plan_store = None

    # ------------------------- extension surface -------------------------

    def register_estimator(self, kind: str, cls: type | None = None, *,
                           replace: bool = False):
        """Session-scoped :func:`register_estimator`."""
        return self.estimators.register(kind, cls, replace=replace)

    def register_topology(self, kind: str, cls: type | None = None, *,
                          replace: bool = False):
        """Session-scoped :func:`register_topology`."""
        return self.topologies.register(kind, cls, replace=replace)

    def register_system(self, sid: str, system: System | dict, *,
                        replace: bool = False) -> System:
        """Add a system (object or catalog-record dict) under id ``sid``."""
        return self.systems.register(sid, system, replace=replace)

    def load_systems(self, path: str) -> list[str]:
        """Load a catalog file or directory; returns the new ids."""
        return self.systems.load_path(path)

    def get_system(self, name: str, device=None) -> System:
        """A catalog system, or for ``host`` the calibrated host on
        ``device`` (None: the card)."""
        return self.systems.get(name, device)

    # --------------------------- cache store ---------------------------

    @property
    def cache_store(self):
        """The session's shared (H, C, R) store, created on first use (a
        :class:`~repro_torch.core.estimators.cache.PersistentCache`, in
        memory only when the session has no ``cache_path``).  Every
        predict and campaign run through this session shares it."""
        if self._store is None:
            from .core.estimators.cache import PersistentCache
            self._store = PersistentCache(self.cache_path)
        return self._store

    @property
    def plan_store(self):
        """The session's warm plan store: parsed programs and sliced
        plans shared by every campaign run through this session."""
        if self._plan_store is None:
            from .campaign.plans import PlanStore
            self._plan_store = PlanStore()
        return self._plan_store

    def flush_cache(self) -> None:
        """Compact the persistent store (no-op without a ``cache_path``)."""
        from .core.estimators.cache import PersistentCache
        if isinstance(self._store, PersistentCache) and self.cache_path:
            self._store.save(self.cache_path)

    # ------------------------- pipeline verbs -------------------------

    def export(self, step, *meta_args, name: str = "workload", device=None,
               per_rank=None):
        """Trace a torch step on fake tensors and emit its StableHLO text
        (paper stage a) on ``device`` (None: the card); ``per_rank`` is
        ``(rank_step, rank_args, mesh)``, the per-rank program of a data
        mesh, whose text is the optimized one.  See
        :func:`repro_torch.core.pipeline.export_workload`."""
        from .core.pipeline import export_workload
        return export_workload(step, *meta_args, name=name, device=device,
                               per_rank=per_rank)

    def workload(self, *, name: str, stablehlo: str | None = None,
                 hlo: str | None = None,
                 stablehlo_path: str | None = None,
                 hlo_path: str | None = None):
        """Wrap IR text (or text files) as a Workload, without a trace."""
        from .core.pipeline import Workload
        if stablehlo_path:
            with open(stablehlo_path) as f:
                stablehlo = f.read()
        if hlo_path:
            with open(hlo_path) as f:
                hlo = f.read()
        return Workload(name=name, stablehlo_text=stablehlo, hlo_text=hlo)

    def plan(self, workload, *, slicer: str = "linear",
             fidelity: str | None = None):
        """Parse and slice once into a reusable PredictionPlan (see
        :func:`repro_torch.core.pipeline.build_plan`)."""
        from .core.pipeline import build_plan
        fidelity = fidelity or (
            "optimized" if workload.hlo_text else "raw")
        return build_plan(workload.program(fidelity), slicer=slicer,
                          name=workload.name, fidelity=fidelity,
                          calls=workload.calls(fidelity))

    def predict(self, workload, *, system="a100", estimator="roofline",
                options: dict | None = None, fidelity: str | None = None,
                slicer: str = "linear", topology="auto",
                topology_params: dict | None = None, overlap: bool = False,
                straggler_factor: float = 1.0, compression: float = 1.0,
                use_cache: bool = True, device=None):
        """One grid point: cost ``workload`` (a Workload or a prebuilt
        PredictionPlan) on ``system`` with ``estimator`` over
        ``topology``, all resolved through the session's registries;
        ``device`` is where a ``profiling`` estimator runs and what
        ``host`` is (None: the card).

        ``system`` is a catalog id or a :class:`System`; ``estimator`` a
        registered kind name (with ``options``), an EstimatorSpec, or a
        live ComputeEstimator; ``topology`` a registered kind name (with
        ``topology_params``), a TopologySpec, or a live Topology."""
        from .campaign.builders import build_estimator, build_topology
        from .campaign.spec import EstimatorSpec, TopologySpec
        from .core.estimators.base import ComputeEstimator
        from .core.network import Topology
        from .core.pipeline import PredictionJob, PredictionPlan

        if isinstance(system, System):
            sysm, system_name = system, system.name
        else:
            sysm, system_name = self.get_system(system, device), system

        if isinstance(workload, PredictionPlan):
            plan = workload
        else:
            plan = self.plan(workload, slicer=slicer, fidelity=fidelity)

        context = BuildContext(
            system_name=system_name, program=plan.program, calls=plan.calls,
            device=device, estimators=self.estimators,
            topologies=self.topologies, systems=self.systems)
        if isinstance(estimator, str):
            estimator = EstimatorSpec(
                kind=estimator,
                options=tuple(sorted((options or {}).items())))
        if isinstance(estimator, EstimatorSpec):
            est = build_estimator(estimator, sysm,
                                  registry=self.estimators, context=context)
        elif isinstance(estimator, ComputeEstimator):
            est = estimator
        else:
            raise TypeError(f"estimator: expected kind name, EstimatorSpec "
                            f"or ComputeEstimator, got {estimator!r}")
        if isinstance(topology, str):
            topology = TopologySpec(
                kind=topology,
                params=tuple(sorted((topology_params or {}).items())))
        if isinstance(topology, TopologySpec):
            topo = build_topology(topology, sysm,
                                  registry=self.topologies, context=context)
        elif isinstance(topology, Topology):
            topo = topology
        else:
            raise TypeError(f"topology: expected kind name, TopologySpec "
                            f"or Topology, got {topology!r}")

        job = PredictionJob(
            estimator=est, topology=topo, slicer=plan.slicer,
            overlap=overlap, straggler_factor=straggler_factor,
            compression=compression, name=plan.name, use_cache=use_cache,
            system_name=sysm.name, cache_store=self.cache_store, plan=plan)
        return job.run()

    def campaign(self, spec, *, workloads: dict | None = None,
                 out_dir: str | None = None, executor: str = "serial",
                 max_workers: int | None = None,
                 cache_path: str | None = None,
                 schedule: str = "locality", progress: bool = False,
                 device=None):
        """Run a campaign grid through the session's registries.

        ``spec`` is a CampaignSpec, a spec dict, or a path to a spec JSON;
        everything else mirrors
        :func:`repro_torch.campaign.runner.run_campaign`, whose arch
        workloads are traced, and whose ``profiling`` estimators and
        ``host`` system measure, on ``device`` (None: the card).  The
        session's
        :attr:`cache_store` and :attr:`plan_store` back the run unless
        ``cache_path`` redirects it to another store file."""
        from .campaign.runner import run_campaign
        from .campaign.spec import CampaignSpec
        provided = frozenset(workloads or ())
        if isinstance(spec, str):
            spec = CampaignSpec.from_json(spec, session=self,
                                          provided=provided)
        elif isinstance(spec, dict):
            spec = CampaignSpec.from_dict(spec, session=self,
                                          provided=provided)
        warm = cache_path is None or cache_path == self.cache_path
        return run_campaign(
            spec, workloads=workloads, out_dir=out_dir, executor=executor,
            max_workers=max_workers,
            cache_path=cache_path or self.cache_path,
            cache=self.cache_store if warm else None,
            plan_store=self.plan_store,
            schedule=schedule, progress=progress, session=self,
            device=device)

    def search(self, spec, **kw):
        """The reference's multi-fidelity what-if search: not ported."""
        raise NotImplementedError(SEARCH_PENDING)

    # ----------------------------- listing -----------------------------

    def describe(self) -> dict:
        """The live vocabularies, JSON-ready (what ``python -m
        repro_torch.campaign list`` prints): estimator kinds, topology
        kinds, catalog systems with their source files, and what
        entry-point plugin discovery found."""
        from .core.registry import plugin_status
        return {
            "estimators": list(self.estimators.kinds()),
            "topologies": list(self.topologies.kinds()),
            "systems": [
                {"id": sid, "name": self.systems.get(sid).name,
                 "source": _short_source(self.systems.source(sid))}
                for sid in self.systems.names()],
            "plugins": plugin_status(),
        }


def _short_source(path: str) -> str:
    """Catalog sources relative to CWD when possible (display only)."""
    if not os.path.isabs(path):
        return path
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return rel if not rel.startswith("..") else os.path.normpath(path)


def load_spec(path: str):
    """Load + validate one campaign spec JSON (facade convenience)."""
    from .campaign.spec import CampaignSpec
    return CampaignSpec.from_json(path)
