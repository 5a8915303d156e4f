"""Frontier reports: JSON + markdown, golden-pinnable like campaigns.

The JSON report is the artifact ``python -m repro_torch.search run``
writes; :func:`make_frontier_golden` distills the deterministic core
(frontier membership, objective values, pruning counters) into a snapshot
(the reference's live under ``specs/golden/``; the port writes its own
into the run's output directory) and :func:`check_frontier` diffs a fresh
run against it — membership is
exact, values compare within a relative tolerance, counters must match
exactly (a pruning regression is a correctness bug here, not noise).
"""
from __future__ import annotations

from ..campaign.report import golden_path, load_json, write_json  # noqa: F401
from .engine import SearchResult

__all__ = ["build_search_report", "render_markdown",
           "make_frontier_golden", "check_frontier",
           "golden_path", "load_json", "write_json"]

#: counters whose drift means the optimizer changed behavior (pinned
#: exactly in goldens; wall-clock and cache traffic are excluded)
_PINNED_COUNTERS = ("candidates", "infeasible", "anchors",
                    "pruned_ceiling", "pruned_intra", "pruned_dominated",
                    "final_infeasible", "top_rung_evaluations",
                    "frontier_size")


def build_search_report(result: SearchResult) -> dict:
    """The full JSON report for one search run."""
    spec = result.spec
    frontier = []
    for k in result.frontier:
        r = result.candidates[k]
        point = {
            "key": k,
            "workload": r["workload"], "system": r["system"],
            "slicer": r["slicer"], "topology": r["topology"],
            "num_devices": r.get("num_devices"),
            "values": r["values"],
            "extras": r.get("extras", {}),
            "provenance": r["rungs"],
        }
        frontier.append(point)
    dominated = [
        {"key": k, "reason": r.get("pruned") or r.get("reason")
         or "dominated at final rung",
         **({"values": r["values"]} if "values" in r else {})}
        for k, r in sorted(result.candidates.items())
        if not r.get("on_frontier")]
    return {
        "search": spec.name,
        "objectives": list(spec.objectives),
        "epsilon": spec.epsilon,
        "ladder": [e.label for e in spec.ladder],
        "constraints": dict(spec.constraints),
        "counters": result.counters,
        "calibration": result.calibration,
        "frontier": frontier,
        "dominated": dominated,
        "wall_s": round(result.wall_s, 4),
    }


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def render_markdown(report: dict) -> str:
    """Human-readable digest of :func:`build_search_report` output."""
    c = report["counters"]
    objectives = report["objectives"]
    lines = [f"# Search report: {report['search']}", "",
             f"Objectives (minimized): {', '.join(objectives)}; "
             f"ladder: {' → '.join(report['ladder'])}; "
             f"ε = {report['epsilon']}.", ""]
    evals = " → ".join(
        f"{e['evaluated']} @ {e['estimator']}" for e in c["evaluations"])
    lines += [
        f"{c['candidates']} candidates expanded; {c['infeasible']} "
        f"infeasible; {c['pruned_ceiling']} over ceiling, {c['pruned_intra']} intra-group dominated, and "
        f"{c['pruned_dominated']} ε-dominated at the cheap rung; "
        f"evaluations: {evals}; frontier size {c['frontier_size']} "
        f"({c['top_rung_evaluations']}/{c['candidates']} = "
        f"{c['top_rung_fraction']:.0%} of the grid scored at the top "
        "rung).", "", "## Pareto frontier", ""]
    extras = sorted({k for p in report["frontier"] for k in p["extras"]
                     if k not in objectives and k != "step_time_s"})
    headers = ["point", "devices", *objectives, *extras]
    body = []
    for p in report["frontier"]:
        row = [p["key"], p.get("num_devices", "—")]
        row += [_fmt(p["values"][o]) for o in objectives]
        for x in extras:
            v = p["extras"].get(x)
            row.append(_fmt(v) if isinstance(v, float) else
                       ("—" if v is None else str(v)))
        body.append(row)
    lines += ["| " + " | ".join(str(h) for h in headers) + " |",
              "|" + "|".join("---" for _ in headers) + "|"]
    lines += ["| " + " | ".join(str(cell) for cell in r) + " |"
              for r in body]
    if report["dominated"]:
        lines += ["", "## Dominated / pruned / infeasible", ""]
        lines += [f"- `{d['key']}` — {d['reason']}"
                  for d in report["dominated"]]
    return "\n".join(lines) + "\n"


# ----------------------------- golden snapshots -----------------------------


def make_frontier_golden(report: dict) -> dict:
    """The deterministic core of a report, as a golden snapshot."""
    return {
        "search": report["search"],
        "objectives": report["objectives"],
        "epsilon": report["epsilon"],
        "ladder": report["ladder"],
        "counters": {k: report["counters"][k] for k in _PINNED_COUNTERS},
        "frontier": [{"key": p["key"], "values": p["values"]}
                     for p in report["frontier"]],
    }


def check_frontier(golden: dict, report: dict,
                   tolerance: float = 1e-9) -> list[str]:
    """Diff a fresh report against its golden; returns failure strings
    (empty = pass).  Membership and counters are exact; objective values
    compare within relative ``tolerance``."""
    failures = []
    want = {p["key"]: p["values"] for p in golden["frontier"]}
    have = {p["key"]: p["values"] for p in report["frontier"]}
    for k in sorted(set(want) - set(have)):
        failures.append(f"frontier point {k!r} missing from this run")
    for k in sorted(set(have) - set(want)):
        failures.append(f"unexpected frontier point {k!r}")
    for k in sorted(set(want) & set(have)):
        for o, wv in want[k].items():
            hv = have[k].get(o)
            if hv is None:
                failures.append(f"{k}: objective {o} missing")
                continue
            denom = max(abs(wv), 1e-30)
            if abs(hv - wv) / denom > tolerance:
                failures.append(
                    f"{k}: {o} drifted {wv} -> {hv} "
                    f"(rel {abs(hv - wv) / denom:.3e} > {tolerance})")
    for ck in _PINNED_COUNTERS:
        wv, hv = golden["counters"].get(ck), report["counters"].get(ck)
        if wv != hv:
            failures.append(f"counter {ck}: golden {wv} != run {hv}")
    return failures
