"""The multi-fidelity search engine: expand → score cheap → prune →
refine → frontier.

The port's copy of the reference's ``search/engine.py``.  One
:func:`run_search` call answers a
:class:`~repro_torch.search.spec.SearchSpec` query:

1. **expand** the candidate grid (workload × system × slicer × topology)
   and drop candidates that fail *structural* constraints up front —
   memory-capacity fit, missing cost/power ratings for a priced
   objective;
2. **score** every feasible candidate on ladder rung 0 (the cheap
   analytical tier) through the shared :class:`PlanStore` plan phase and
   the estimators' vectorized ``evaluate_batch`` fast path;
3. **calibrate**: evaluate one *anchor* candidate per
   (workload, system) group at the top rung and rescale the whole
   group's cheap scores by the anchor's bias ratio.  The cheap tier's
   error against the refined tier is dominated by a per-system,
   per-problem-size utilization term (measured ~5× across this repo's
   catalog, vs ~1.0× within a group across topology/slicer choices),
   so a multiplicative anchor correction turns a hopelessly biased
   ranking into a nearly rank-faithful one;
4. **prune** on the calibrated scores with the deterministic ε-Pareto
   filter plus ε-slackened constraint ceilings — ε now only needs to
   cover the small *residual* (post-calibration) error, then **refine**
   the survivors on each higher rung, reusing the same (H, C, R) cache
   store — a refinement re-visits regions the cheap tier already
   fingerprinted, so only genuinely new (estimator-config, region)
   pairs miss;
5. emit the exact (ε=0) Pareto **frontier** of the final-rung values,
   with per-point provenance of every rung that scored it and
   ``uncertainty_s`` carried through from a learned rung.

Domination is judged **within a workload group**: candidates that solve
different problems (a 1 k GEMM vs an 8 k GEMM, decode at batch 4 vs
batch 32) are never compared, so the frontier is the union of one
sub-frontier per workload entry — "for each what-if, which
system × slicer × topology points are worth it".

Everything is deterministic — candidate order is canonical, the filter
is order-independent, and evaluation reuses the campaign ``_execute``
path whose outputs are golden-pinned — so a search frontier can be
snapshot-tested exactly like a campaign grid.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..campaign.builders import build_system, build_topology
from ..campaign.plans import PlanStore
from ..campaign.runner import _execute, _Registries, _workload_texts
from ..campaign.spec import JobSpec
from ..core.estimators.cache import PersistentCache
from .pareto import pareto_filter
from .spec import SearchSpec

__all__ = ["run_search", "SearchResult", "candidate_key"]


def candidate_key(job: JobSpec) -> str:
    """The candidate identity a job scores — every axis except the
    estimator (which is the fidelity ladder's, not the candidate's)."""
    return " × ".join((job.workload, job.system, job.slicer,
                       job.topology.label))


@dataclass
class SearchResult:
    """Everything :func:`run_search` learned, JSON-ready via report."""
    spec: SearchSpec
    candidates: dict = field(default_factory=dict)  # key -> record
    frontier: list = field(default_factory=list)    # keys, sorted
    counters: dict = field(default_factory=dict)
    #: per-(workload × system) anchor calibration: group -> {anchor, scale}
    calibration: dict = field(default_factory=dict)
    rows: list = field(default_factory=list)        # every eval row, in order
    wall_s: float = 0.0


def _objective_values(row: dict, objectives: tuple) -> tuple | None:
    """The row's objective vector, or None when a metric is missing."""
    try:
        return tuple(float(row[o]) for o in objectives)
    except KeyError:
        return None


def _grouped_pareto(cand: dict, live: dict, eps: float) -> list[str]:
    """ε-Pareto survivors of ``live`` (key -> objective tuple), with
    domination judged only between candidates of the same workload."""
    by_group: dict[str, dict] = {}
    for k, vals in live.items():
        by_group.setdefault(cand[k]["workload"], {})[k] = vals
    out: list[str] = []
    for g in sorted(by_group):
        out.extend(pareto_filter(by_group[g], eps))
    return sorted(out)


def _intra_group_prune(cand: dict, kept: dict) -> tuple[dict, list[str]]:
    """Exact (ε=0) Pareto prune *within* each (workload, system) group.

    All members of a group share one calibration scale, so their cheap
    scores are perfectly rank-correlated with the refined tier (the
    estimator bias is per-system × per-problem-size, not per-topology)
    — which licenses exact domination here, including on ties that an
    ε-slackened comparison could never prune (e.g. sharding a workload
    whose regions all land on one device: identical step time, strictly
    more $/step).  Returns (survivors, pruned_keys)."""
    by_ws: dict[tuple, dict] = {}
    for k, vals in kept.items():
        r = cand[k]
        by_ws.setdefault((r["workload"], r["system"]), {})[k] = vals
    out: dict = {}
    pruned: list[str] = []
    for g in sorted(by_ws):
        surv = set(pareto_filter(by_ws[g], 0.0))
        for k in by_ws[g]:
            if k in surv:
                out[k] = by_ws[g][k]
            else:
                pruned.append(k)
    return out, sorted(pruned)


def _ceiling_violations(values: dict, constraints: dict,
                        slack: float) -> list[str]:
    """Names of ``max_*`` ceilings violated by ``values`` with
    multiplicative ``slack`` (0 = exact)."""
    out = []
    for ck, limit in constraints.items():
        if not ck.startswith("max_"):
            continue
        metric = ck[len("max_"):]
        v = values.get(metric)
        if v is not None and v > limit * (1.0 + slack):
            out.append(ck)
    return out


def run_search(spec: SearchSpec, *, session=None,
               cache: PersistentCache | None = None,
               cache_path: str | None = None,
               plan_store: PlanStore | None = None,
               brute_force: bool = False,
               progress: bool = False) -> SearchResult:
    """Run the fidelity-ladder search (see module docstring).

    ``session``/``cache``/``plan_store`` follow the campaign runner's
    warm-caller contract: a :class:`repro_torch.api.Session` passes its
    live stores so repeated what-ifs re-parse and re-cost nothing.
    ``brute_force=True`` scores *every* feasible candidate on the final
    rung with no pruning — the reference the prune-soundness test
    compares frontier membership against.  An arch workload is traced,
    and a measuring backend (profiling, the ``host`` system) runs, on the
    card."""
    t0 = time.perf_counter()
    spec.validate(session=session)
    cs0 = spec.campaign_for_rung(0)
    regs = _Registries.for_session(session, cs0)
    store = cache if cache is not None else PersistentCache(cache_path)
    plans = plan_store if plan_store is not None else PlanStore({})
    plans.add_texts(_workload_texts(cs0, None))

    result = SearchResult(spec=spec)
    cand = result.candidates
    objectives = spec.objectives
    constraints = spec.constraints
    top_rung = len(spec.ladder) - 1
    rungs = [top_rung] if brute_force else list(range(len(spec.ladder)))

    def log(msg: str) -> None:
        if progress:
            print(msg, flush=True)

    priced = any(o == "usd_per_step" for o in objectives) or \
        "max_usd_per_step" in constraints
    rated = any(o == "joules_per_step" for o in objectives) or \
        "max_joules_per_step" in constraints

    # candidate jobs per rung, keyed by candidate identity
    jobs_by_rung: dict[int, dict] = {}

    def jobs_for(rung: int) -> dict:
        if rung not in jobs_by_rung:
            jobs_by_rung[rung] = {
                candidate_key(j): j
                for j in spec.campaign_for_rung(rung).expand()}
        return jobs_by_rung[rung]

    evaluated_by_rung: dict[int, int] = {r: 0 for r in rungs}

    def score(key: str, rung: int) -> None:
        """Evaluate candidate ``key`` on ladder rung ``rung`` (idempotent
        — an anchor already scored at the top rung is not re-run)."""
        job = jobs_for(rung)[key]
        plan = plans.get(*plans.key_for(job))
        rec = cand.get(key)
        if rec is None:
            rec = cand[key] = {
                "key": key, "workload": job.workload,
                "system": job.system, "slicer": job.slicer,
                "topology": job.topology.label,
                "feasible": True, "rungs": [], "by_rung": {}}
            # structural feasibility, before spending any evaluation
            system = build_system(job.system, registry=regs.systems)
            ctx = regs.context(system_name=job.system,
                               program=plan.program)
            topo = build_topology(job.topology, system,
                                  registry=regs.topologies, context=ctx)
            rec["num_devices"] = topo.num_devices
            reasons = []
            if priced and system.cost_per_hour is None:
                reasons.append("unpriced (no cost_per_hour in catalog)")
            if rated and system.tdp_watts is None:
                reasons.append("unrated (no tdp_watts in catalog)")
            if constraints.get("mem_capacity_fit"):
                working_set = max(
                    (r.cost.bytes for r in plan.compute_regions),
                    default=0.0)
                if working_set > system.mem_capacity:
                    reasons.append(
                        f"mem_capacity_fit ({working_set:.3g} B > "
                        f"{system.mem_capacity:.3g} B)")
            if reasons:
                rec["feasible"] = False
                rec["reason"] = "; ".join(reasons)
        if not rec["feasible"] or rung in rec["by_rung"]:
            return
        row, _ = _execute(job, plan, store, regs)
        result.rows.append(row)
        evaluated_by_rung[rung] += 1
        values = _objective_values(row, objectives)
        if values is None:
            rec["feasible"] = False
            rec["reason"] = (
                f"row from {row['estimator']} lacks objective "
                f"metric(s) {list(objectives)}")
            return
        rec["by_rung"][rung] = dict(zip(objectives, values))
        # rec["values"] tracks the highest-fidelity scoring so far
        # (anchors get their top-rung score before the middle rungs run)
        if rung >= rec.get("_max_rung", -1):
            rec["_max_rung"] = rung
            rec["values"] = dict(zip(objectives, values))
        # merge (not replace): a learned rung's uncertainty_s stays
        # attached even after a final systolic rung re-scores
        rec.setdefault("extras", {}).update({
            k: row[k] for k in ("step_time_s", "usd_per_step",
                                "perf_per_usd", "joules_per_step",
                                "uncertainty_s", "uncertainty_rel",
                                "extrapolated")
            if k in row})
        rec["rungs"].append({
            "rung": rung, "estimator": row["estimator"],
            "fidelity": row["fidelity"],
            "values": dict(zip(objectives, values)),
            **({"uncertainty_s": row["uncertainty_s"]}
               if "uncertainty_s" in row else {})})

    # ---- rung 0: score the whole grid on the cheapest tier ----
    first = rungs[0]
    for key in sorted(jobs_for(first)):
        score(key, first)
    infeasible = sum(1 for r in cand.values() if not r["feasible"])
    log(f"  rung {first} ({spec.ladder[first].label}): "
        f"{evaluated_by_rung[first]} candidates scored, "
        f"{infeasible} infeasible")
    live = sorted(k for k, r in cand.items()
                  if r["feasible"] and first in r["by_rung"])

    # ---- calibrate + prune (only when there is a refinement rung) ----
    survivors = live
    pruned_dominated = pruned_ceiling = pruned_intra = n_anchors = 0
    if len(rungs) > 1:
        groups: dict[tuple, list] = {}
        for k in live:
            r = cand[k]
            groups.setdefault((r["workload"], r["system"]), []).append(k)
        calibrated: dict[str, dict] = {}
        for g in sorted(groups):
            members = groups[g]
            # anchor: the group's cheap-tier best on the first objective
            # (deterministic tie-break on key), scored at the TOP rung
            anchor = min(members, key=lambda k: (
                cand[k]["by_rung"][first][objectives[0]], k))
            score(anchor, top_rung)
            n_anchors += 1
            a = cand[anchor]
            top_vals = a["by_rung"].get(top_rung)
            cheap_vals = a["by_rung"][first]
            scale = {o: (top_vals[o] / cheap_vals[o]
                         if top_vals and cheap_vals[o] else 1.0)
                     for o in objectives}
            result.calibration[" × ".join(g)] = {
                "anchor": anchor, "scale": scale}
            for k in members:
                calibrated[k] = {
                    o: cand[k]["by_rung"][first][o] * scale[o]
                    for o in objectives}
        log(f"  calibrate: {n_anchors} anchors scored at "
            f"rung {top_rung} ({spec.ladder[top_rung].label})")

        # ε-slackened ceilings, exact intra-(workload, system) prune,
        # then grouped ε-Pareto on the calibrated scores — conservative
        # throughout: only clearly-out points die here
        kept = {}
        for k in live:
            viol = _ceiling_violations(calibrated[k], constraints,
                                       spec.epsilon)
            if viol:
                cand[k]["pruned"] = f"ceiling: {', '.join(viol)}"
                pruned_ceiling += 1
            else:
                kept[k] = tuple(calibrated[k][o] for o in objectives)
        kept, intra = _intra_group_prune(cand, kept)
        for k in intra:
            cand[k]["pruned"] = ("dominated within its (workload, "
                                 "system) group at the cheap rung")
        pruned_intra = len(intra)
        survivors = _grouped_pareto(cand, kept, spec.epsilon)
        for k in set(kept) - set(survivors):
            cand[k]["pruned"] = "ε-dominated at the cheap rung (calibrated)"
        pruned_dominated = len(kept) - len(survivors)
        log(f"  prune: {pruned_ceiling} over ceiling, {pruned_intra} "
            f"intra-group dominated, {pruned_dominated} ε-dominated → "
            f"{len(survivors)} survivors")

        # ---- refine survivors on every higher rung ----
        for rung in rungs[1:]:
            for key in survivors:
                score(key, rung)
            log(f"  rung {rung} ({spec.ladder[rung].label}): "
                f"{evaluated_by_rung[rung]} candidates scored")

    # ---- final: exact ceilings, exact grouped Pareto, top-rung values ----
    final_infeasible = 0
    final = {}
    for k in survivors:
        r = cand[k]
        vals = r["by_rung"].get(top_rung)
        if not r["feasible"] or vals is None:
            continue
        viol = _ceiling_violations(vals, constraints, 0.0)
        if viol:
            r["pruned"] = f"ceiling (final): {', '.join(viol)}"
            final_infeasible += 1
            continue
        final[k] = tuple(vals[o] for o in objectives)
    result.frontier = _grouped_pareto(cand, final, 0.0)
    for k in result.frontier:
        cand[k]["on_frontier"] = True
    for r in cand.values():
        r["rungs"].sort(key=lambda e: e["rung"])
        r.pop("_max_rung", None)

    n = len(cand)
    top_evals = evaluated_by_rung.get(top_rung, 0)
    result.counters = {
        "candidates": n,
        "infeasible": infeasible,
        "anchors": n_anchors,
        "pruned_ceiling": pruned_ceiling,
        "pruned_intra": pruned_intra,
        "pruned_dominated": pruned_dominated,
        "final_infeasible": final_infeasible,
        "evaluations": [
            {"rung": r, "estimator": spec.ladder[r].label,
             "evaluated": evaluated_by_rung[r]} for r in rungs],
        "top_rung_evaluations": top_evals,
        "top_rung_fraction": round(top_evals / n, 4) if n else 0.0,
        "frontier_size": len(result.frontier),
        "cache_hits": sum(r.get("cache_hits", 0) for r in result.rows),
        "cache_misses": sum(r.get("cache_misses", 0) for r in result.rows),
        "brute_force": brute_force,
    }
    result.wall_s = time.perf_counter() - t0
    return result
