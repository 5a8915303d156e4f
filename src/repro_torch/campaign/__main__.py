"""CLI entry point: ``python -m repro_torch.campaign
[run|validate|report|list]``, the port's counterpart of ``python -m
repro.campaign`` over the port's runner and report.

A spec file is either one campaign (the JSON form of
:class:`~repro_torch.campaign.spec.CampaignSpec`, ``docs/campaign.md``) or a
*suite* that sequences several::

    {"name": "paper", "suite": ["fig7_resnet.json", "fig10_gemm.json"]}

Suite entries are paths relative to the suite file (or inline campaign
dicts); sub-campaigns run one after another, sharing one persistent
(H, C, R) cache and writing results under ``<out>/<campaign-name>/``.

``validate`` checks every spec (grid axes, zip groups, workload sources,
mesh shapes) and prints the expanded grid size without running anything.
``list`` prints the live extension vocabularies (estimator kinds, topology
kinds, the system catalog with each entry's source file); ``--check``
validates every catalog record against the schema.  ``--systems PATH``
(repeatable, all subcommands) overlays user catalogs.  ``report`` turns
campaign results into the evaluation artifacts (MAPE against recorded
references, Kendall-tau/Spearman rank preservation, fidelity tables);
``--check`` gates them against the golden snapshots beside the spec
(``specs/golden/``).

Where the port differs from the reference's CLI:

* an ``arch`` workload is traced on fake tensors on ``--device`` (default:
  the card), resolved only when a workload is exported or measured:
  ``validate``, ``list`` and framework-free grids (fig10's GEMMs) run
  without a card, and an arch export without a card and without
  ``--device cpu`` raises.  The ``profiling`` estimator runs each region,
  and the ``host`` system is calibrated, on the same device.  No device
  count is preset: a mesh's fake world takes any size;
* ``--server`` (the ``serve`` daemon) raises ``NotImplementedError``: it
  is not ported yet;
* ``report --update-golden`` writes the new golden snapshot (and, when the
  spec has none, the reference rows) into the ``--out`` directory: the
  files under ``specs/`` are the reference's, and the port never writes
  them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# only spec.py at module load: `validate` and `list` need neither numpy
# nor torch; the runner loads lazily in `run` and `report`
from .spec import CampaignSpec

SERVER_PENDING = (
    "--server: the serve daemon (src/repro/serve/: server, client, fleet) "
    "is not ported to repro_torch yet (ROADMAP, Queue 1 item 12: the serve "
    "daemon)")


def load_specs(path: str,
               session=None) -> list[tuple[str, CampaignSpec]]:
    """Load a spec file into ``[(campaign_name, CampaignSpec), ...]``.

    A plain campaign yields one entry; a suite file yields one per
    sub-campaign (path entries resolved relative to the suite file).
    ``session`` scopes spec validation to its registries and catalogs."""
    with open(path) as f:
        raw = json.load(f)
    if "suite" not in raw:
        spec = CampaignSpec.from_file_dict(raw, path, session=session)
        return [(spec.name, spec)]
    base = os.path.dirname(os.path.abspath(path))
    out: list[tuple[str, CampaignSpec]] = []
    for entry in raw["suite"]:
        if isinstance(entry, str):
            spec = CampaignSpec.from_json(os.path.join(base, entry),
                                          session=session)
        else:
            spec = CampaignSpec.from_dict(entry, session=session)
        if any(spec.name == n for n, _ in out):
            # names key per-campaign output dirs: a duplicate would
            # clobber the earlier campaign's results
            raise ValueError(
                f"suite {path!r}: duplicate campaign name {spec.name!r}")
        out.append((spec.name, spec))
    return out


def _print_grid(name: str, spec: CampaignSpec) -> None:
    jobs = spec.expand()
    zipped = {a: tuple(g) for g in spec.zip_axes for a in g}
    shown, bits = set(), []
    for axis in ("workloads", "systems", "estimators", "slicers",
                 "topologies"):
        if axis in shown:
            continue
        group = zipped.get(axis)
        if group is None:
            bits.append(f"{len(getattr(spec, axis))} {axis}")
        else:
            shown.update(group)
            bits.append(f"{len(getattr(spec, axis))} zipped "
                        + "⊗".join(group))
    print(f"campaign {name!r}: {len(jobs)} grid points "
          f"({' × '.join(bits)})", flush=True)


def _load_results_jsonl(path: str) -> list[dict]:
    """Read back a streamed results file (no estimator stack needed)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _report_command(args, session=None) -> int:
    """The ``report`` subcommand: build evaluation reports (and golden
    checks, or new snapshots in ``--out``) for every campaign the spec
    arguments name."""
    from .report import (DEFAULT_TOLERANCE, build_report, check_rows,
                         golden_path, load_json, make_golden,
                         make_reference, reference_path, render_markdown,
                         write_json)

    entries = []  # (spec_file_path, campaign_name, CampaignSpec)
    for path in args.spec:
        for name, spec in load_specs(path, session=session):
            if any(name == n for _, n, _ in entries):
                raise ValueError(
                    f"report: duplicate campaign name {name!r} across "
                    "spec arguments")
            entries.append((path, name, spec))
    if args.results and len(entries) != 1:
        print("report: --results requires exactly one campaign")
        return 2

    failures: list[str] = []
    num_failed = 0
    for path, name, spec in entries:
        out_dir = os.path.join(args.out, name)
        if args.results:
            rows = _load_results_jsonl(args.results)
        else:
            from .runner import run_campaign

            _print_grid(name, spec)
            rows = run_campaign(
                spec, out_dir=out_dir, executor=args.executor,
                max_workers=args.jobs, cache_path=args.cache,
                progress=not args.quiet, session=session,
                device=args.device).rows

        reference = load_json(reference_path(path, name))
        if args.update_golden:
            # the snapshots under specs/ are the reference's: the port's
            # go into --out
            tol = (args.tolerance if args.tolerance is not None
                   else DEFAULT_TOLERANCE)
            gpath = write_json(
                os.path.join(out_dir, "golden.json"),
                make_golden(name, rows, tolerance=tol,
                            meta={"spec": os.path.basename(path)}))
            if reference is None:
                reference = make_reference(name, rows)
                rpath = write_json(os.path.join(out_dir, "reference.json"),
                                   reference)
                print(f"  wrote {gpath}, {rpath}")
            else:
                print(f"  wrote {gpath} (kept {reference_path(path, name)})")

        report = build_report(name, rows, reference=reference)
        num_failed += report["num_failed"]
        if args.check:
            golden = load_json(golden_path(path, name))
            if golden is None:
                check = {"failures": [
                    f"{name}: no golden snapshot at "
                    f"{golden_path(path, name)}"], "rows_checked": 0,
                    "tolerance": (args.tolerance
                                  if args.tolerance is not None
                                  else DEFAULT_TOLERANCE)}
            else:
                check = check_rows(golden, rows, tolerance=args.tolerance)
            report["golden_check"] = check
            failures.extend(check["failures"])

        jpath = write_json(os.path.join(out_dir, "report.json"), report)
        mpath = os.path.join(out_dir, "report.md")
        with open(mpath, "w") as f:
            f.write(render_markdown(report))
        rp = report["rank_preservation"]
        trend = ("n/a" if rp["min_kendall_tau"] is None else
                 f"min τ {rp['min_kendall_tau']}")
        check_tag = ""
        if "golden_check" in report:
            gc = report["golden_check"]
            n_fail = len(gc["failures"])
            drift = gc.get("max_drift")
            drift_tag = ("" if drift is None
                         else f", max drift {drift:.1e}")
            check_tag = (f" · golden OK{drift_tag}" if not n_fail
                         else f" · golden FAILED ({n_fail})")
        print(f"report {name!r}: {report['num_ok']}/{report['num_rows']} "
              f"rows · {trend}{check_tag}")
        print(f"  wrote {jpath}, {mpath}")

    for f in failures:
        print(f"GOLDEN-CHECK FAILURE: {f}")
    if num_failed:
        print(f"report: {num_failed} grid points failed")
    return 1 if failures or num_failed else 0


def _list_command(args) -> int:
    """The ``list`` subcommand: print (and with ``--check`` validate) the
    live extension vocabularies."""
    from .. import api
    from ..core.catalog import _DEFAULT_DIR, validate_system_dict

    failures: list[str] = []
    try:
        session = api.Session(systems=args.systems or ())
    except (OSError, ValueError, TypeError) as e:
        print(f"INVALID catalog: {e}")
        return 1
    info = session.describe()
    print("estimator kinds: " + ", ".join(info["estimators"]))
    print("topology kinds:  " + ", ".join(info["topologies"]))
    # 'host' is the card (core/systems.py::host_system), resolved at use
    print(f"systems ({len(info['systems'])} catalog entries + 'host'):")
    width = max((len(s["id"]) for s in info["systems"]), default=0)
    for s in info["systems"]:
        print(f"  {s['id']:<{width}}  {s['name']:<18} {s['source']}")
    if args.check:
        files: list[str] = []
        for p in [_DEFAULT_DIR, *(args.systems or [])]:
            if os.path.isdir(p):
                files += [os.path.join(p, n) for n in sorted(os.listdir(p))
                          if n.endswith(".json")]
            elif os.path.exists(p):
                files.append(p)
        for path in files:
            try:
                with open(path) as f:
                    validate_system_dict(json.load(f), source=path)
            except (ValueError, json.JSONDecodeError) as e:
                failures.append(str(e))
        for f in failures:
            print(f"INVALID {f}")
        print(f"catalog check: {len(files)} file(s), "
              f"{len(failures)} failure(s)")
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    command = "run"
    if argv and argv[0] in ("run", "validate", "report", "list"):
        command = argv.pop(0)

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="Run, validate, report on a prediction campaign from "
                    "a JSON grid spec (single campaign or suite), or list "
                    "the registered backends and system catalog.")
    if command != "list":
        ap.add_argument("spec", nargs="+" if command != "run" else None,
                        help="path to the campaign/suite spec (JSON)")
    ap.add_argument("--systems", action="append", default=[],
                    metavar="PATH",
                    help="extra system-catalog file or directory of JSON "
                         "records (repeatable)")
    if command == "list":
        ap.add_argument("--check", action="store_true",
                        help="validate every catalog record against the "
                             "schema; exit nonzero on failures")
    if command in ("run", "report"):
        ap.add_argument("--executor", default="thread",
                        choices=("serial", "thread", "process"),
                        help="job executor (default: thread)")
        ap.add_argument("--jobs", type=int, default=None,
                        help="max parallel workers")
        ap.add_argument("--cache", default=None, metavar="PATH",
                        help="persistent (H,C,R) cache file shared across "
                             "runs and live workers")
        ap.add_argument("--quiet", action="store_true",
                        help="suppress per-job progress lines")
        ap.add_argument("--device", default=None,
                        help="device whose fake tensors an arch workload "
                             "is traced on, and that the profiling "
                             "estimator and the 'host' system measure "
                             "(default: the card; 'cpu' only when asked)")
    if command == "run":
        ap.add_argument("--out", default="artifacts/campaign",
                        help="output directory for results.jsonl/csv + "
                             "summary.json (default: artifacts/campaign)")
        ap.add_argument("--schedule", default="locality",
                        choices=("locality", "grid"),
                        help="job ordering (default: locality)")
        ap.add_argument("--dry-run", action="store_true",
                        help="print the expanded grid and exit")
        ap.add_argument("--resume", action="store_true",
                        help="replay <out>/results.jsonl from an earlier "
                             "run: its completed rows are kept, error, "
                             "missing and stale rows re-run")
        ap.add_argument("--retries", type=int, default=0, metavar="N",
                        help="re-run a job whose evaluate phase raised, up "
                             "to N extra attempts (default: 0)")
        ap.add_argument("--fault-plan", default=None, metavar="PATH",
                        help="test-only: a deterministic fault-injection "
                             "plan (JSON; see repro_torch.serve.faults), "
                             "passed through the environment")
        ap.add_argument("--server", default=None, metavar="URL",
                        help="run on a serve daemon: not ported yet "
                             "(raises)")
    if command == "report":
        ap.add_argument("--out", default="artifacts/report",
                        help="output directory: campaign artifacts and "
                             "report.json/report.md per campaign, and the "
                             "snapshots of --update-golden (default: "
                             "artifacts/report)")
        ap.add_argument("--results", default=None, metavar="PATH",
                        help="report on an existing results.jsonl instead "
                             "of running the campaign (one campaign only)")
        ap.add_argument("--check", action="store_true",
                        help="gate predictions against the golden "
                             "snapshots beside the spec (specs/golden/)")
        ap.add_argument("--update-golden", action="store_true",
                        help="write a golden snapshot (and, where the spec "
                             "has none, reference rows) from this run into "
                             "--out; the files under specs/ are never "
                             "written")
        ap.add_argument("--tolerance", type=float, default=None,
                        help="relative drift tolerance; overrides the "
                             "per-snapshot value (and sets it with "
                             "--update-golden)")
    args = ap.parse_args(argv)

    if command == "list":
        return _list_command(args)
    if getattr(args, "server", None):
        raise NotImplementedError(SERVER_PENDING)

    from .. import api
    try:
        session = api.Session(systems=args.systems or ())
    except (OSError, ValueError, TypeError) as e:
        print(f"INVALID catalog: {type(e).__name__}: {e}")
        return 1

    if command == "report":
        return _report_command(args, session=session)

    if command == "validate":
        bad = 0
        for path in args.spec:
            try:
                with open(path) as f:
                    raw = json.load(f)
                if "ladder" in raw or "objectives" in raw:
                    # search specs live beside the campaign grids, so
                    # `validate specs/*.json` covers both kinds
                    from ..search.spec import SearchSpec
                    sspec = SearchSpec.from_file_dict(raw, path,
                                                      session=session)
                    n = len(sspec.campaign_for_rung(0).expand())
                    print(f"search {sspec.name!r}: {n} candidates, "
                          f"{len(sspec.ladder)}-rung ladder, objectives "
                          f"{list(sspec.objectives)}")
                    print(f"ok {path}")
                    continue
                for name, spec in load_specs(path, session=session):
                    spec.validate(session=session)
                    _print_grid(name, spec)
            except (OSError, ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                print(f"INVALID {path}: {type(e).__name__}: {e}")
                bad += 1
                continue
            print(f"ok {path}")
        return 1 if bad else 0

    from .summary import format_table

    if args.fault_plan:
        # through the environment, so that spawned workers inherit it
        from ..serve import faults
        os.environ[faults.ENV_PLAN] = args.fault_plan

    specs = load_specs(args.spec, session=session)
    multi = len(specs) > 1
    failed = 0
    for name, spec in specs:
        _print_grid(name, spec)
        if args.dry_run:
            for j in spec.expand():
                r = j.to_row()
                print("  " + " × ".join(str(r[k]) for k in
                                        ("workload", "fidelity", "system",
                                         "estimator", "slicer", "topology")))
            continue
        out_dir = os.path.join(args.out, name) if multi else args.out
        resume_rows = None
        if args.resume:
            prev = os.path.join(out_dir, "results.jsonl")
            resume_rows = []
            if os.path.exists(prev):
                resume_rows = _load_results_jsonl(prev)
                print(f"  resuming from {prev} "
                      f"({len(resume_rows)} prior rows)")
            else:
                print(f"  --resume: no {prev} yet, running from scratch")
        from .runner import run_campaign

        result = run_campaign(
            spec, out_dir=out_dir, executor=args.executor,
            max_workers=args.jobs, cache_path=args.cache,
            schedule=args.schedule, progress=not args.quiet,
            session=session, resume_rows=resume_rows, retries=args.retries,
            device=args.device)
        if result.csv_path:
            print(f"  wrote {result.jsonl_path}, {result.csv_path}, "
                  f"{result.summary_path}")
        print(format_table(result.summary))
        failed += result.summary["num_failed"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
