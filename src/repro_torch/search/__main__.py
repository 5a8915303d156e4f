"""CLI for the what-if search engine: the port's counterpart of
``python -m repro.search``.

::

    python -m repro_torch.search run specs/search_gemm.json
    python -m repro_torch.search run specs/search_gemm.json --check
    python -m repro_torch.search run specs/search_gemm.json --update-golden
    python -m repro_torch.search run specs/search_gemm.json --brute-force
    python -m repro_torch.search validate specs/search_gemm.json ...

``run`` writes ``frontier.json`` / ``frontier.md`` / ``rows.jsonl``
under ``--out`` (default ``artifacts/search/<name>/``).  ``--check``
diffs the frontier against its golden snapshot next to the spec
(``specs/golden/<name>.json``) and exits 1 on drift.
``--brute-force`` scores every feasible candidate at the top ladder rung
with no pruning — the reference for prune soundness.

Where the port differs from the reference's CLI:

* ``--update-golden`` writes the new snapshot to ``<out>/golden.json``:
  the snapshots under ``specs/`` are the reference's, and the port never
  writes them;
* no device count is preset (that is XLA's concern): an arch workload is
  traced, and a measuring backend runs, on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .engine import run_search
from .report import (build_search_report, check_frontier, golden_path,
                     load_json, make_frontier_golden, render_markdown,
                     write_json)
from .spec import SearchSpec


def _run_command(args) -> int:
    with open(args.spec) as f:
        d = json.load(f)
    spec = SearchSpec.from_file_dict(d, args.spec)
    result = run_search(spec, cache_path=args.cache,
                        brute_force=args.brute_force,
                        progress=not args.quiet)
    report = build_search_report(result)

    out_dir = args.out or os.path.join("artifacts", "search", spec.name)
    os.makedirs(out_dir, exist_ok=True)
    paths = {"json": os.path.join(out_dir, "frontier.json"),
             "md": os.path.join(out_dir, "frontier.md"),
             "rows": os.path.join(out_dir, "rows.jsonl")}
    with open(paths["json"], "w") as f:
        json.dump(report, f, indent=2)
    with open(paths["md"], "w") as f:
        f.write(render_markdown(report))
    with open(paths["rows"], "w") as f:
        for row in result.rows:
            f.write(json.dumps(row) + "\n")

    c = result.counters
    print(f"search {spec.name!r}: {c['frontier_size']} frontier points "
          f"from {c['candidates']} candidates "
          f"({c['top_rung_evaluations']} scored at the top rung; "
          f"{c['pruned_ceiling'] + c['pruned_dominated']} pruned, "
          f"{c['infeasible']} infeasible); wall {result.wall_s:.2f} s")
    for p in report["frontier"]:
        vals = ", ".join(f"{o}={v:.6g}" for o, v in p["values"].items())
        print(f"  * {p['key']}: {vals}")
    print(f"  wrote {paths['json']}, {paths['md']}")

    if args.update_golden:
        gpath = write_json(os.path.join(out_dir, "golden.json"),
                           make_frontier_golden(report))
        print(f"  wrote golden {gpath}")
        return 0
    if args.check:
        gpath = golden_path(args.spec, spec.name)
        golden = load_json(gpath)
        if golden is None:
            print(f"  CHECK FAILED: no golden at {gpath} "
                  "(run with --update-golden to create it)")
            return 1
        failures = check_frontier(golden, report, args.tolerance)
        if failures:
            print(f"  CHECK FAILED ({len(failures)} violations):")
            for f_ in failures:
                print(f"    - {f_}")
            return 1
        print(f"  golden OK ({len(golden['frontier'])} frontier points, "
              f"tolerance {args.tolerance})")
    return 0


def _validate_command(args) -> int:
    status = 0
    for path in args.specs:
        try:
            with open(path) as f:
                spec = SearchSpec.from_file_dict(json.load(f), path)
        except (OSError, ValueError, KeyError) as e:
            print(f"INVALID {path}: {e}")
            status = 1
            continue
        n = len(spec.campaign_for_rung(0).expand())
        print(f"ok {path}: search {spec.name!r}, {n} candidates, "
              f"{len(spec.ladder)}-rung ladder, "
              f"objectives {list(spec.objectives)}")
    return status


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.search",
        description="Multi-fidelity what-if search over the system grid")
    sub = ap.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run a search spec")
    run_p.add_argument("spec", help="search spec JSON file")
    run_p.add_argument("--out", help="output dir "
                       "(default artifacts/search/<name>)")
    run_p.add_argument("--cache", help="persistent (H,C,R) cache path")
    run_p.add_argument("--check", action="store_true",
                       help="diff the frontier against its golden")
    run_p.add_argument("--update-golden", action="store_true",
                       help="write the golden frontier snapshot to "
                            "<out>/golden.json (never under specs/)")
    run_p.add_argument("--tolerance", type=float, default=1e-9,
                       help="relative tolerance for --check")
    run_p.add_argument("--brute-force", action="store_true",
                       help="score everything at the top rung, no pruning")
    run_p.add_argument("--quiet", action="store_true")
    run_p.set_defaults(func=_run_command)

    val_p = sub.add_parser("validate", help="validate search spec files")
    val_p.add_argument("specs", nargs="+")
    val_p.set_defaults(func=_validate_command)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
