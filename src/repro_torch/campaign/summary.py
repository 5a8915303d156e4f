"""Campaign summaries: best/worst grid points and cross-architecture
relative-trend ranks (the comparison behind paper Figs 6 and 11 — do
different estimator classes agree on *which system is faster*, even when
their absolute numbers differ?).
"""
from __future__ import annotations

import itertools
from collections import defaultdict


def _point(row: dict) -> dict:
    return {k: row[k] for k in ("workload", "system", "estimator", "slicer",
                                "topology") if k in row}


def summarize(name: str, rows: list[dict]) -> dict:
    ok = [r for r in rows if "error" not in r and "step_time_s" in r]
    failed = [r for r in rows if "error" in r]
    errors_by_type: dict[str, int] = {}
    for r in failed:
        et = r.get("error_type", "unknown")
        errors_by_type[et] = errors_by_type.get(et, 0) + 1
    out: dict = {
        "campaign": name,
        "num_jobs": len(rows),
        "num_ok": len(ok),
        "num_failed": len(failed),
        # stable taxonomy (plan/evaluate/transport): what a resume run
        # reads to report exactly which failure classes it is retrying
        "errors_by_type": errors_by_type,
        "num_resumed": sum(1 for r in rows if r.get("resumed")),
        "failures": [{"job_id": r["job_id"], "error": r["error"],
                      "error_type": r.get("error_type", "unknown"),
                      **_point(r)} for r in failed],
    }
    if not ok:
        return out

    best = min(ok, key=lambda r: r["step_time_s"])
    worst = max(ok, key=lambda r: r["step_time_s"])
    out["best"] = {**_point(best), "step_time_s": best["step_time_s"]}
    out["worst"] = {**_point(worst), "step_time_s": worst["step_time_s"]}
    out["system_ranks"] = system_ranks(ok)
    out["rank_agreement"] = rank_agreement(out["system_ranks"])
    return out


def system_ranks(rows: list[dict]) -> dict:
    """workload -> estimator -> systems ordered fastest-first.

    Step times are averaged over the remaining axes (slicer, topology,
    knobs) so the rank reflects the estimator's overall cross-architecture
    trend for that workload."""
    acc: dict = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for r in rows:
        acc[r["workload"]][r["estimator"]][r["system"]].append(
            r["step_time_s"])
    ranks: dict = {}
    for wl, by_est in acc.items():
        ranks[wl] = {}
        for est, by_sys in by_est.items():
            means = {s: sum(v) / len(v) for s, v in by_sys.items()}
            ranks[wl][est] = sorted(means, key=means.get)
    return ranks


def rank_agreement(ranks: dict) -> dict:
    """Pairwise concordance of system orderings between estimators.

    For each workload and each estimator pair, the fraction of system
    pairs ranked in the same order (Kendall-tau distance, normalized to
    [0, 1]; 1.0 = identical relative trends)."""
    out: dict = {}
    for wl, by_est in ranks.items():
        pairs = {}
        for (e1, r1), (e2, r2) in itertools.combinations(
                sorted(by_est.items()), 2):
            common = [s for s in r1 if s in r2]
            if len(common) < 2:
                continue
            pos1 = {s: i for i, s in enumerate(r1)}
            pos2 = {s: i for i, s in enumerate(r2)}
            concordant = total = 0
            for a, b in itertools.combinations(common, 2):
                total += 1
                if ((pos1[a] - pos1[b]) * (pos2[a] - pos2[b])) > 0:
                    concordant += 1
            pairs[f"{e1} vs {e2}"] = concordant / total if total else 1.0
        if pairs:
            out[wl] = pairs
    return out


def format_table(summary: dict) -> str:
    """Human-readable digest for the CLI."""
    lines = [f"campaign {summary['campaign']}: "
             f"{summary['num_ok']}/{summary['num_jobs']} jobs ok"]
    resume = summary.get("resume")
    if resume:
        by_type = ", ".join(
            f"{k}={v}"
            for k, v in sorted(resume["rerun_errors_by_type"].items()))
        lines.append(
            f"  resume: {resume['resumed']} rows replayed, "
            f"{resume['rerun_errors']} errors retried "
            f"({by_type or 'none'}), "
            f"{resume['missing']} missing, {resume['stale']} stale")
    retries = summary.get("retries")
    if retries and retries.get("rows_retried"):
        lines.append(f"  retries: {retries['rows_retried']} rows retried "
                     f"(up to {retries['configured']} attempts)")
    for r in summary.get("failures", []):
        lines.append(f"  FAILED job {r['job_id']} "
                     f"[{r.get('error_type', 'unknown')}]: {r['error']}")
    if "best" in summary:
        # _point only carries the axes present in the row — rows from a
        # reduced grid (e.g. server resume payloads) may omit some
        def _axes(p: dict) -> str:
            return " × ".join(str(p.get(k, "—"))
                              for k in ("workload", "system", "estimator",
                                        "slicer"))
        b, w = summary["best"], summary["worst"]
        lines.append(
            f"  best : {_axes(b)} = {b['step_time_s'] * 1e3:.3f} ms")
        lines.append(
            f"  worst: {_axes(w)} = {w['step_time_s'] * 1e3:.3f} ms")
    for wl, by_est in summary.get("system_ranks", {}).items():
        for est, order in sorted(by_est.items()):
            lines.append(f"  rank [{wl} / {est}]: {' < '.join(order)}")
    for wl, pairs in summary.get("rank_agreement", {}).items():
        for pair, tau in sorted(pairs.items()):
            lines.append(f"  agreement [{wl}] {pair}: {tau:.2f}")
    cache = summary.get("cache")
    if cache:
        line = (
            f"  cache: {cache['hits']} hits / {cache['misses']} misses "
            f"(hit rate {cache['hit_rate']:.1%}), "
            f"{cache['loaded_entries']} loaded, "
            f"{cache['new_entries']} new entries")
        if cache.get("time_saving_fraction"):
            line += (f", eval time saved "
                     f"{cache['time_saving_fraction']:.1%}")
        lines.append(line)
    if "wall_s" in summary:
        lines.append(f"  wall: {summary['wall_s']:.2f} s")
    return "\n".join(lines)
