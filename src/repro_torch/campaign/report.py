"""Campaign evaluation reports + golden-prediction regression checks.

This module turns any campaign result set (in-memory rows, or a streamed
``results.jsonl``) into the paper's evaluation artifacts:

* **accuracy** — per-figure MAPE of every estimator against recorded
  reference rows (``specs/references/<campaign>.json``; offline, the
  recorded reference is the analytical baseline standing in for the
  paper's measured hardware);
* **rank preservation** — Kendall-τ and Spearman-ρ between every pair of
  (estimator-fidelity) columns, along both trend axes: do two estimators
  order *systems* the same way for each workload (the cross-architecture
  claim, Figs 6/11), and do they order *workloads* the same way on each
  system (the scaling claim, Figs 7/9/10)?
* **fidelity comparison** — step-time tables per (workload, system)
  across estimator fidelities, with ratios against the grid's reference
  estimator;
* **golden snapshots** — checked-in per-grid-point predictions
  (``specs/golden/<campaign>.json``); :func:`check_rows` fails on any
  prediction drifting beyond tolerance, any grid-shape change, and any
  rank inversion relative to the snapshot.

Everything here is pure stdlib (no numpy/jax): reports can be built from
a results file in a minimal environment, and the ``report`` CLI only
pulls in the runner when it actually has to execute a campaign.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from collections import defaultdict

#: the axes that identify one grid point in a result row (``fidelity`` is
#: the *effective* fidelity the plan costed — part of the prediction's
#: identity, so a fidelity fallback change is a detected drift)
KEY_AXES = ("workload", "fidelity", "system", "estimator", "slicer",
            "topology", "overlap", "straggler_factor", "compression")
#: float prediction fields compared under relative tolerance
PREDICTION_FIELDS = ("step_time_s", "compute_s", "comm_s",
                     "exposed_comm_s")
#: integer structure fields compared exactly
COUNT_FIELDS = ("num_segments", "num_comm")

DEFAULT_TOLERANCE = 0.05


def row_key(row: dict) -> tuple:
    """The grid-point identity of a result row."""
    return tuple(row.get(a) for a in KEY_AXES)


def ok_rows(rows: list[dict]) -> list[dict]:
    return [r for r in rows if "error" not in r and "step_time_s" in r]


# ------------------------- rank statistics (stdlib) -------------------------


def kendall_tau(x: list[float], y: list[float]) -> float:
    """Kendall's τ-b between two paired value lists (ties corrected).

    1.0 = identical orderings, -1.0 = fully inverted, 0.0 = unrelated
    (or degenerate: fewer than two pairs / all ties)."""
    n = len(x)
    if n != len(y):
        raise ValueError("kendall_tau: length mismatch")
    if n < 2:
        return 0.0
    concordant = discordant = ties_x = ties_y = 0
    for (xa, ya), (xb, yb) in itertools.combinations(zip(x, y), 2):
        dx, dy = xa - xb, ya - yb
        if dx == 0 and dy == 0:
            ties_x += 1
            ties_y += 1
        elif dx == 0:
            ties_x += 1
        elif dy == 0:
            ties_y += 1
        elif (dx > 0) == (dy > 0):
            concordant += 1
        else:
            discordant += 1
    n0 = n * (n - 1) // 2
    denom = math.sqrt((n0 - ties_x) * (n0 - ties_y))
    return (concordant - discordant) / denom if denom else 0.0


def _ranks(values: list[float]) -> list[float]:
    """Fractional ranks (1-based, ties averaged)."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while (j + 1 < len(order)
               and values[order[j + 1]] == values[order[i]]):
            j += 1
        avg = (i + j) / 2 + 1
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman_rho(x: list[float], y: list[float]) -> float:
    """Spearman's ρ: Pearson correlation of the fractional ranks."""
    if len(x) != len(y):
        raise ValueError("spearman_rho: length mismatch")
    n = len(x)
    if n < 2:
        return 0.0
    rx, ry = _ranks(x), _ranks(y)
    mx, my = sum(rx) / n, sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    denom = math.sqrt(vx * vy)
    return cov / denom if denom else 0.0


# ----------------------------- trend extraction -----------------------------


def mean_step_times(rows: list[dict], outer: str, inner: str) -> dict:
    """estimator -> outer-axis value -> inner-axis value -> mean step
    seconds (averaged over every remaining axis), for ok rows."""
    acc: dict = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for r in ok_rows(rows):
        acc[r["estimator"]][r[outer]][r[inner]].append(r["step_time_s"])
    return {est: {o: {i: sum(v) / len(v) for i, v in by_inner.items()}
                  for o, by_inner in by_outer.items()}
            for est, by_outer in acc.items()}


def trend_orderings(rows: list[dict]) -> dict:
    """Fastest-first orderings along both trend axes.

    ``{"systems": {workload: {estimator: [system, ...]}},
       "workloads": {system: {estimator: [workload, ...]}}}``

    The ``systems`` orderings are the paper's cross-architecture trend
    (which system is faster?); the ``workloads`` orderings are the
    scaling trend (do predictions track workload size?).  Golden checks
    fail when either inverts."""
    out: dict = {"systems": {}, "workloads": {}}
    for axis, inner in (("systems", "system"), ("workloads", "workload")):
        outer = "workload" if axis == "systems" else "system"
        means = mean_step_times(rows, outer, inner)
        per_outer: dict = defaultdict(dict)
        for est, by_outer in means.items():
            for o, by_inner in by_outer.items():
                # exact ties break by name, so the ordering is a pure
                # function of the values — golden and fresh row sets
                # arrive in different orders and must not disagree on
                # tied entries
                per_outer[o][est] = sorted(
                    by_inner, key=lambda k: (by_inner[k], k))
        out[axis] = {o: dict(sorted(v.items()))
                     for o, v in sorted(per_outer.items())}
    return out


def rank_preservation(rows: list[dict]) -> dict:
    """Kendall-τ / Spearman-ρ for every estimator pair, along both trend
    axes; plus the headline minima over all pairs."""
    out: dict = {"systems": {}, "workloads": {}}
    taus: list[float] = []
    for axis, inner in (("systems", "system"), ("workloads", "workload")):
        outer = "workload" if axis == "systems" else "system"
        means = mean_step_times(rows, outer, inner)
        section: dict = {}
        for e1, e2 in itertools.combinations(sorted(means), 2):
            for o in sorted(set(means[e1]) & set(means[e2])):
                common = sorted(set(means[e1][o]) & set(means[e2][o]))
                if len(common) < 2:
                    continue
                v1 = [means[e1][o][i] for i in common]
                v2 = [means[e2][o][i] for i in common]
                tau = kendall_tau(v1, v2)
                taus.append(tau)
                section.setdefault(o, {})[f"{e1} vs {e2}"] = {
                    "kendall_tau": round(tau, 6),
                    "spearman_rho": round(spearman_rho(v1, v2), 6),
                    "n": len(common),
                }
        out[axis] = section
    out["min_kendall_tau"] = round(min(taus), 6) if taus else None
    out["all_trends_preserved"] = (all(t > 0 for t in taus)
                                   if taus else None)
    return out


# ------------------------------ accuracy (MAPE) -----------------------------


def mape_against_reference(rows: list[dict], reference: dict) -> dict:
    """Per-estimator MAPE (%) of predicted step time against recorded
    reference rows.

    ``reference`` is the checked-in form: ``{"source": ..., "rows":
    [{"workload": ..., "system": ..., "step_time_s": ...}, ...]}``;
    result rows match on (workload, system) and every matching grid
    point contributes one absolute percentage error."""
    ref_vals = {(r["workload"], r["system"]): float(r["step_time_s"])
                for r in reference.get("rows", [])}
    per_est: dict = defaultdict(lambda: {"errors": [], "per_system":
                                         defaultdict(list), "per_workload":
                                         defaultdict(list)})
    for r in ok_rows(rows):
        ref = ref_vals.get((r["workload"], r["system"]))
        if ref is None or ref <= 0:
            continue
        err = abs(r["step_time_s"] - ref) / ref * 100.0
        e = per_est[r["estimator"]]
        e["errors"].append(err)
        e["per_system"][r["system"]].append(err)
        e["per_workload"][r["workload"]].append(err)

    def _mean(v):
        return round(sum(v) / len(v), 3) if v else None

    return {
        "reference_source": reference.get("source", "unknown"),
        "reference_rows": len(ref_vals),
        "mape_pct": {
            est: {
                "overall": _mean(e["errors"]),
                "matched_rows": len(e["errors"]),
                "per_system": {s: _mean(v)
                               for s, v in sorted(e["per_system"].items())},
                "per_workload": {w: _mean(v)
                                 for w, v in
                                 sorted(e["per_workload"].items())},
            }
            for est, e in sorted(per_est.items())
        },
    }


def reference_estimator(rows: list[dict]) -> str | None:
    """The grid's designated reference estimator: the label of the
    lowest-job_id ok row (i.e. the spec's first estimator)."""
    ok = ok_rows(rows)
    if not ok:
        return None
    return min(ok, key=lambda r: r.get("job_id", 0))["estimator"]


def fidelity_table(rows: list[dict]) -> dict:
    """Step-time comparison across estimator fidelities.

    One entry per (workload, system): mean step milliseconds per
    estimator plus each estimator's ratio against the grid's reference
    estimator (>1 = slower prediction than the reference fidelity)."""
    means = mean_step_times(rows, "workload", "system")
    ref = reference_estimator(rows)
    cells: dict = defaultdict(dict)
    for est, by_w in means.items():
        for w, by_s in by_w.items():
            for s, v in by_s.items():
                cells[(w, s)][est] = v
    table = []
    for (w, s), by_est in sorted(cells.items()):
        ref_v = by_est.get(ref)
        table.append({
            "workload": w,
            "system": s,
            "step_time_ms": {e: round(v * 1e3, 6)
                             for e, v in sorted(by_est.items())},
            "ratio_vs_reference": {
                e: round(v / ref_v, 4) if ref_v else None
                for e, v in sorted(by_est.items())},
        })
    return {"reference_estimator": ref, "rows": table}


def cost_table(rows: list[dict]) -> dict:
    """TCO view per (workload, system): mean ``$/step``, ``joules/step``
    and ``perf/$`` over the remaining axes, from the cost columns the
    runner derives off the catalog's per-device ratings.  Rows priced on
    systems without cost/power fields simply don't appear."""
    acc: dict = defaultdict(lambda: defaultdict(list))
    for r in ok_rows(rows):
        for f in ("usd_per_step", "joules_per_step", "perf_per_usd"):
            if f in r:
                acc[(r["workload"], r["system"])][f].append(r[f])
    table = []
    for (w, s), by_f in sorted(acc.items()):
        entry = {"workload": w, "system": s}
        for f, vals in by_f.items():
            entry[f] = sum(vals) / len(vals)
        table.append(entry)
    return {"rows": table}


# --------------------------------- report -----------------------------------


def build_report(name: str, rows: list[dict],
                 reference: dict | None = None) -> dict:
    """The full evaluation report for one campaign's result rows."""
    ok = ok_rows(rows)
    report = {
        "campaign": name,
        "num_rows": len(rows),
        "num_ok": len(ok),
        "num_failed": len(rows) - len(ok),
        "fidelity_comparison": fidelity_table(rows),
        "rank_preservation": rank_preservation(rows),
        "trend_orderings": trend_orderings(rows),
        "cost": cost_table(rows),
    }
    if reference is not None:
        report["accuracy"] = mape_against_reference(rows, reference)
    return report


def _md_table(headers: list[str], rows: list[list]) -> list[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return out


def render_markdown(report: dict) -> str:
    """Human-readable markdown digest of :func:`build_report` output."""
    name = report["campaign"]
    lines = [f"# Campaign report: {name}", "",
             f"{report['num_ok']}/{report['num_rows']} grid points ok."]
    acc = report.get("accuracy")
    if acc:
        lines += ["", f"## Accuracy vs recorded reference "
                      f"({acc['reference_source']})", ""]
        rows = [[est, m["overall"], m["matched_rows"]]
                for est, m in acc["mape_pct"].items()]
        lines += _md_table(["estimator", "MAPE %", "rows"], rows)
    rp = report["rank_preservation"]
    lines += ["", "## Rank preservation (Kendall-τ / Spearman-ρ)", ""]
    if rp["min_kendall_tau"] is not None:
        verdict = ("preserved" if rp["all_trends_preserved"]
                   else "**INVERTED**")
        lines.append(f"All pairwise trends {verdict}; "
                     f"min τ = {rp['min_kendall_tau']}.")
    for axis, label in (("systems", "system ordering per workload"),
                        ("workloads", "workload ordering per system")):
        rows = [[o, pair, s["kendall_tau"], s["spearman_rho"], s["n"]]
                for o, pairs in rp[axis].items()
                for pair, s in pairs.items()]
        if rows:
            lines += ["", f"### {label}", ""]
            lines += _md_table(["group", "estimator pair", "τ", "ρ", "n"],
                               rows)
    fc = report["fidelity_comparison"]
    if fc["rows"]:
        ests = sorted({e for r in fc["rows"] for e in r["step_time_ms"]})
        lines += ["", f"## Fidelity comparison (step ms; ratio vs "
                      f"`{fc['reference_estimator']}`)", ""]
        rows = []
        for r in fc["rows"]:
            cells = [f"{r['step_time_ms'].get(e, '—')}"
                     f" ({r['ratio_vs_reference'].get(e, '—')}×)"
                     for e in ests]
            rows.append([r["workload"], r["system"], *cells])
        lines += _md_table(["workload", "system", *ests], rows)
    cost = report.get("cost", {}).get("rows") or []
    if cost:
        lines += ["", "## Cost model (mean per grid point)", ""]
        body = []
        for r in cost:
            body.append([
                r["workload"], r["system"],
                f"{r['usd_per_step']:.3e}" if "usd_per_step" in r else "—",
                (f"{r['joules_per_step']:.4g}"
                 if "joules_per_step" in r else "—"),
                f"{r['perf_per_usd']:.4g}" if "perf_per_usd" in r else "—"])
        lines += _md_table(
            ["workload", "system", "$/step", "joules/step", "perf/$"], body)
    check = report.get("golden_check")
    if check is not None:
        lines += ["", "## Golden-snapshot check", ""]
        if check["failures"]:
            lines.append(f"**FAILED** ({len(check['failures'])} "
                         "violations):")
            lines += [f"- {f}" for f in check["failures"]]
        else:
            lines.append(f"OK — {check['rows_checked']} grid points "
                         f"within tolerance {check['tolerance']}, "
                         "no rank inversions.")
    return "\n".join(lines) + "\n"


# ----------------------------- golden snapshots -----------------------------


def make_golden(name: str, rows: list[dict], *,
                tolerance: float = DEFAULT_TOLERANCE,
                meta: dict | None = None) -> dict:
    """The checked-in snapshot form of a campaign's predictions: one
    record per grid point (key axes + prediction fields), plus the drift
    tolerance the CI gate applies."""
    ok = ok_rows(rows)
    if len(ok) != len(rows):
        bad = [r.get("error", "?") for r in rows if "error" in r]
        raise ValueError(
            f"golden {name!r}: refusing to snapshot a failing campaign "
            f"({len(bad)} error rows; first: {bad[:1]})")
    dupes = _duplicate_keys(ok)
    if dupes:
        # e.g. two topologies of one kind with no num_devices param get
        # the same label — the snapshot would silently collapse their
        # grid points and the gate would never check the dropped ones
        raise ValueError(
            f"golden {name!r}: grid points are not distinguishable by "
            f"their row keys {sorted(KEY_AXES)}; first collision: "
            f"{dupes[0]}.  Make colliding axis entries distinguishable "
            "— e.g. pair same-label topologies with distinct workloads "
            "via a zip group (the fig9 pattern)")
    golden_rows = []
    for r in sorted(ok, key=row_key):
        rec = {a: r[a] for a in KEY_AXES}
        rec.update({f: r[f] for f in PREDICTION_FIELDS + COUNT_FIELDS})
        golden_rows.append(rec)
    return {
        "campaign": name,
        "tolerance": tolerance,
        "meta": meta or {},
        "rows": golden_rows,
    }


def _duplicate_keys(rows: list[dict]) -> list[tuple]:
    """Row keys shared by more than one row (grid points the key axes
    cannot tell apart — a keyed comparison would silently drop rows)."""
    seen: set = set()
    dupes: list[tuple] = []
    for r in rows:
        k = row_key(r)
        if k in seen:
            dupes.append(k)
        seen.add(k)
    return dupes


def check_rows(golden: dict, rows: list[dict],
               tolerance: float | None = None) -> dict:
    """Compare fresh campaign rows against a golden snapshot.

    Returns ``{"failures": [...], "rows_checked": n, "tolerance": t}``.
    Failures cover: error rows in the fresh run, ambiguous grids
    (duplicate row keys on either side), grid-shape changes
    (missing/extra grid points), any prediction field drifting beyond
    the relative tolerance (count fields compare exactly), and any
    trend-ordering inversion relative to the snapshot."""
    tol = tolerance if tolerance is not None else float(
        golden.get("tolerance", DEFAULT_TOLERANCE))
    name = golden.get("campaign", "campaign")
    failures: list[str] = []
    fresh_ok = ok_rows(rows)
    for r in rows:
        if "error" in r:
            failures.append(
                f"{name}: job {r.get('job_id')} failed: {r['error']}")
    for side, side_rows in (("fresh", fresh_ok),
                            ("golden", golden.get("rows", []))):
        for key in _duplicate_keys(side_rows):
            failures.append(
                f"{name}: duplicate {side} grid point {key} — row keys "
                "must be unique (make colliding axis entries "
                "distinguishable, e.g. via a zip group)")
    fresh = {row_key(r): r for r in fresh_ok}
    gold = {row_key(r): r for r in golden.get("rows", [])}
    for key in sorted(gold.keys() - fresh.keys()):
        failures.append(
            f"{name}: grid point missing from fresh run: {key} "
            "(grid changed? regenerate with --update-golden)")
    for key in sorted(fresh.keys() - gold.keys()):
        failures.append(
            f"{name}: grid point not in golden snapshot: {key} "
            "(grid changed? regenerate with --update-golden)")
    checked = 0
    max_drift = 0.0
    for key in sorted(gold.keys() & fresh.keys()):
        g, f = gold[key], fresh[key]
        checked += 1
        for fieldname in PREDICTION_FIELDS:
            gv, fv = float(g[fieldname]), float(f[fieldname])
            scale = max(abs(gv), 1e-12)
            drift = abs(fv - gv) / scale
            max_drift = max(max_drift, drift)
            if drift > tol:
                failures.append(
                    f"{name}: {key} {fieldname} drifted "
                    f"{drift:.2%} > {tol:.2%} "
                    f"(golden {gv!r}, fresh {fv!r})")
        for fieldname in COUNT_FIELDS:
            if int(g[fieldname]) != int(f[fieldname]):
                failures.append(
                    f"{name}: {key} {fieldname} changed "
                    f"(golden {g[fieldname]}, fresh {f[fieldname]})")
    # rank inversions: orderings must match the snapshot exactly
    golden_trends = trend_orderings(golden.get("rows", []))
    fresh_trends = trend_orderings(fresh_ok)
    for axis in ("systems", "workloads"):
        for group, by_est in golden_trends[axis].items():
            for est, order in by_est.items():
                got = fresh_trends[axis].get(group, {}).get(est)
                if got is not None and got != order:
                    failures.append(
                        f"{name}: rank inversion [{axis} / {group} / "
                        f"{est}]: golden {order} vs fresh {got}")
    # tolerance note: predictions are deterministic — the vectorized
    # evaluate path and the streaming front end are bit-identical to
    # the scalar/legacy ones on a given machine (tests/
    # test_campaign_diff.py, tests/test_parser_diff.py), so on the
    # machine that recorded the golden the observed drift should be
    # exactly 0; the tolerance exists solely to absorb cross-platform
    # libm/BLAS variance between recorder and checker.
    notes = [f"max prediction drift {max_drift:.3e} of tolerance "
             f"{tol:.2%}; expected exactly 0 on the recording machine "
             "(evaluate paths are bit-identical per "
             "tests/test_campaign_diff.py) — the tolerance absorbs "
             "cross-platform float variance only"]
    return {"failures": failures, "rows_checked": checked,
            "tolerance": tol, "max_drift": max_drift, "notes": notes}


def make_reference(name: str, rows: list[dict], *,
                   source: str | None = None) -> dict:
    """Record reference rows for the MAPE section from a campaign run:
    the reference estimator's mean step time per (workload, system).

    Offline, the analytical baseline stands in for the paper's measured
    hardware; the recorded file keeps MAPE stable even when the grid's
    estimator axis later changes."""
    ref = reference_estimator(rows)
    if ref is None:
        raise ValueError(f"reference {name!r}: no ok rows to record")
    means = mean_step_times(rows, "workload", "system").get(ref, {})
    ref_rows = [{"workload": w, "system": s, "step_time_s": v}
                for w, by_s in sorted(means.items())
                for s, v in sorted(by_s.items())]
    return {
        "campaign": name,
        "source": source or (
            f"recorded {ref} predictions (offline stand-in for measured "
            "hardware; see docs/campaign.md#reports)"),
        "estimator": ref,
        "rows": ref_rows,
    }


# --------------------------------- file I/O ---------------------------------


def golden_path(spec_path: str, campaign: str) -> str:
    """Canonical golden location: ``<specdir>/golden/<campaign>.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(spec_path)),
                        "golden", f"{campaign}.json")


def reference_path(spec_path: str, campaign: str) -> str:
    """Canonical reference location:
    ``<specdir>/references/<campaign>.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(spec_path)),
                        "references", f"{campaign}.json")


def load_json(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_json(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")
    return path
