"""Record -> fit -> save a learned latency model (the ``learned`` tier):
the port's counterpart of the reference's ``tools/fit_learned_model.py``.

Builds workload plans (synthesized square GEMMs and/or pre-exported
StableHLO files), records a per-fingerprint profile through a recording
estimator on the source system (the analytical roofline stands in for
measured hardware; ``chip_smoke.py`` records on the card with the
profiling estimator), fits the per-op-family regression model, and writes
the versioned model JSON a campaign spec's ``{"kind": "learned",
"options": {"model": ...}}`` entry loads::

    PYTHONPATH=src python -m repro_torch.tools.fit_learned_model \\
        --system a100 --gemm 256,512,1024,2048,4096 --out /tmp/m.json

The output is deterministic (a pure-float fit, no timestamps): with the
same flags it is byte for byte the reference tool's.  Nothing here needs a
card.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.fit_learned_model",
        description="Record a profile and fit a transferable learned "
                    "latency model (see docs/extending.md).")
    ap.add_argument("--system", default="a100",
                    help="source system id from the catalog (default a100)")
    ap.add_argument("--recorder", default="roofline",
                    choices=("roofline", "roofline-per-op"),
                    help="recording estimator (default roofline region "
                         "mode; offline stand-in for measured hardware)")
    ap.add_argument("--gemm", default="",
                    help="comma-separated square GEMM sizes to synthesize "
                         "and record (e.g. 256,512,1024)")
    ap.add_argument("--stablehlo", action="append", default=[],
                    metavar="PATH", help="pre-exported StableHLO file to "
                                         "record (repeatable)")
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="model JSON output path")
    args = ap.parse_args(argv)

    from ..campaign.builders import _synthesize_gemm
    from ..campaign.spec import WorkloadSpec
    from ..core.catalog import default_registry
    from ..core.estimators import (RooflineEstimator, fit_model,
                                   record_profile, save_model)
    from ..core.pipeline import build_plan

    system = default_registry().get(args.system)
    regions = []
    sources = []
    for tok in filter(None, (t.strip() for t in args.gemm.split(","))):
        m = int(tok)
        w = _synthesize_gemm(WorkloadSpec(
            name=f"gemm-{m}", fidelity="raw",
            gemm={"m": m, "n": m, "k": m, "dtype": "bf16"}))
        regions += build_plan(w.program("raw"), name=w.name,
                              fidelity="raw").compute_regions
        sources.append(f"gemm-{m}")
    for path in args.stablehlo:
        from ..core.ir.parser import parse
        with open(path) as f:
            prog = parse(f.read())
        regions += build_plan(prog, name=os.path.basename(path),
                              fidelity="raw").compute_regions
        sources.append(path)
    if not regions:
        ap.error("nothing to record: give --gemm sizes and/or --stablehlo")

    mode = "per-op" if args.recorder.endswith("per-op") else "region"
    recorder = RooflineEstimator(system, mode=mode)
    profile = record_profile(regions, recorder)
    model = fit_model(regions, profile, system, meta={
        "source_system": args.system,
        "recorded_with": args.recorder,
        "workloads": sources,
    })
    save_model(args.out, model)
    fams = {f: fm.n_samples for f, fm in sorted(model.families.items())}
    print(f"fitted {model.meta['entries_fitted']} profile entries -> "
          f"{args.out} (families: {fams})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
