"""Declarative what-if search specs (validated JSON, like campaigns): the
port's copy of the reference's ``search/spec.py``.

A :class:`SearchSpec` is a campaign grid *minus* the estimator axis,
*plus* the three things that turn a sweep into an optimizer:

* ``objectives`` — two or more row metrics to jointly minimize
  (``step_time_s``, ``usd_per_step``, ``joules_per_step``, …);
* ``constraints`` — feasibility gates (``mem_capacity_fit``, spend and
  latency ceilings) applied before and after refinement;
* ``ladder`` — an ordered list of estimator specs, cheapest first.  The
  engine scores every candidate on rung 0, ε-Pareto-prunes, then
  re-scores only the survivors on each higher rung.

The candidate set is the cross product of the workload / system /
slicer / topology axes; batch, sequence length, mesh, and parallelism
knobs live on the workload and topology entries exactly as they do in
campaign specs, so "sweep batch sizes" is just several workload entries.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

from ..campaign.spec import (CampaignSpec, EstimatorSpec, TopologySpec,
                             WorkloadSpec)

__all__ = ["SearchSpec", "OBJECTIVES", "CONSTRAINT_KEYS"]

#: metrics a search may minimize — every one is a campaign result-row
#: field, lower-is-better (``perf/$`` is reported, not searched: it is
#: the inverse of ``usd_per_step``)
OBJECTIVES = ("step_time_s", "usd_per_step", "joules_per_step",
              "compute_s", "comm_s", "exposed_comm_s")

#: recognised constraint keys and their meaning:
#: ``mem_capacity_fit`` (bool) — the plan's largest region working set
#: must fit the system's per-device HBM; ``max_*`` (float) — hard
#: ceilings on the named metric (slackened by ε at the pruning tier,
#: exact on the final tier)
CONSTRAINT_KEYS = ("mem_capacity_fit", "max_step_time_s",
                   "max_usd_per_step", "max_joules_per_step")


@dataclass
class SearchSpec:
    """The declarative what-if query (see ``docs/search.md``)."""
    name: str = "search"
    workloads: list[WorkloadSpec] = field(default_factory=list)
    systems: list[str] = field(default_factory=lambda: ["a100"])
    slicers: list[str] = field(default_factory=lambda: ["linear"])
    topologies: list[TopologySpec] = field(
        default_factory=lambda: [TopologySpec()])
    objectives: tuple = ("step_time_s", "usd_per_step")
    ladder: list[EstimatorSpec] = field(
        default_factory=lambda: [EstimatorSpec()])
    constraints: dict = field(default_factory=dict)
    #: ε-Pareto pruning slack between ladder rungs (see search/pareto.py)
    epsilon: float = 0.25
    system_catalog: list[str] = field(default_factory=list)

    #: spec file's directory when loaded via :meth:`from_json` (class
    #: attribute, not a spec key — same convention as CampaignSpec)
    base_dir = None

    @classmethod
    def from_dict(cls, d: dict, *, session=None) -> "SearchSpec":
        d = dict(d)
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown search spec keys: {sorted(unknown)}")
        spec = cls(
            name=d.get("name", "search"),
            workloads=[WorkloadSpec.from_dict(w)
                       for w in d.get("workloads", [])],
            systems=list(d.get("systems", ["a100"])),
            slicers=list(d.get("slicers", ["linear"])),
            topologies=[TopologySpec.from_dict(t)
                        for t in d.get("topologies", [{}])],
            objectives=tuple(d.get("objectives",
                                   ("step_time_s", "usd_per_step"))),
            ladder=[EstimatorSpec.from_dict(e)
                    for e in d.get("ladder", [{}])],
            constraints=dict(d.get("constraints", {})),
            epsilon=float(d.get("epsilon", 0.25)),
            system_catalog=[str(p) for p in d.get("system_catalog", [])],
        )
        spec.validate(session=session)
        return spec

    @classmethod
    def from_file_dict(cls, d: dict, path: str, *,
                       session=None) -> "SearchSpec":
        d = dict(d)
        base = os.path.dirname(os.path.abspath(path))
        if d.get("system_catalog"):
            d["system_catalog"] = [
                p if os.path.isabs(p) else os.path.join(base, p)
                for p in d["system_catalog"]]
        spec = cls.from_dict(d, session=session)
        spec.base_dir = base
        return spec

    @classmethod
    def from_json(cls, path: str, *, session=None) -> "SearchSpec":
        with open(path) as f:
            d = json.load(f)
        return cls.from_file_dict(d, path, session=session)

    def to_dict(self) -> dict:
        """JSON-ready dict form; round-trips through :meth:`from_dict`."""
        d = asdict(self)
        d["objectives"] = list(self.objectives)
        for e in d["ladder"]:
            e["options"] = dict(e["options"])
        for t in d["topologies"]:
            t["params"] = dict(t["params"])
        if not d.get("system_catalog"):
            d.pop("system_catalog", None)
        if not d.get("constraints"):
            d.pop("constraints", None)
        return d

    # ------------------------------ validation ------------------------------

    def validate(self, *, session=None) -> None:
        """Reject queries that could not run — delegates the axis checks
        to a tier-0 :class:`CampaignSpec` (same vocabularies, same
        did-you-mean errors) and adds the search-only rules."""
        if not self.ladder:
            raise ValueError("search spec: ladder needs at least one "
                             "estimator rung")
        if not self.objectives or len(set(self.objectives)) < 2:
            raise ValueError(
                "search spec: need at least two distinct objectives "
                f"(a one-objective 'frontier' is just min); have "
                f"{list(self.objectives)}")
        bad = [o for o in self.objectives if o not in OBJECTIVES]
        if bad:
            raise ValueError(f"search spec: unknown objectives {bad}; "
                             f"have {list(OBJECTIVES)}")
        if self.epsilon < 0:
            raise ValueError(
                f"search spec: epsilon must be >= 0, got {self.epsilon}")
        unknown = sorted(set(self.constraints) - set(CONSTRAINT_KEYS))
        if unknown:
            raise ValueError(f"search spec: unknown constraints {unknown}; "
                             f"have {list(CONSTRAINT_KEYS)}")
        for k, v in self.constraints.items():
            if not k.startswith("max_"):
                continue
            if not (isinstance(v, (int, float)) and v > 0):
                raise ValueError(
                    f"search spec: constraint {k} must be a positive "
                    f"number, got {v!r}")
            # ceilings are enforced on the scored objective vectors, so a
            # ceiling on an unscored metric would be silently ignored —
            # reject it instead of returning a frontier that violates it
            metric = k[len("max_"):]
            if metric not in self.objectives:
                raise ValueError(
                    f"search spec: constraint {k} needs '{metric}' among "
                    f"the objectives (ceilings are enforced on scored "
                    f"metrics only); have {list(self.objectives)}")
        self.campaign_for_rung(0).validate(session=session)

    # ------------------------------- lowering -------------------------------

    def campaign_for_rung(self, rung: int) -> CampaignSpec:
        """The campaign grid of ladder rung ``rung``: this spec's axes
        with the estimator axis pinned to that rung.  The engine expands
        it for job ids and reuses the whole plan/evaluate machinery."""
        cs = CampaignSpec(
            name=self.name,
            workloads=self.workloads,
            systems=list(self.systems),
            estimators=[self.ladder[rung]],
            slicers=list(self.slicers),
            topologies=list(self.topologies),
            system_catalog=list(self.system_catalog),
        )
        cs.base_dir = self.base_dir
        return cs
