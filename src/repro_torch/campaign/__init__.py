"""Prediction-campaign engine: declarative grids of
workloads × systems × estimators × slicers × topologies × knobs, executed
in parallel over one shared persistent (H, C, R) latency cache.

The port's copy of the reference's ``repro.campaign``.  Workloads come
from pre-exported IR on disk, from the port's exports of registered
archs (``mode="forward"`` or ``mode="train"``, traced on fake tensors on
the card unless ``device`` says otherwise), or from synthesized GEMM
modules.  Field reference: ``docs/campaign.md``.  The command line is
``python -m repro_torch.campaign`` (``campaign/__main__.py``), and the
facade ``repro_torch.api``.

Quickstart::

    from repro_torch.campaign import CampaignSpec, run_campaign

    spec = CampaignSpec.from_json("specs/fig10_gemm.json")
    result = run_campaign(spec, cache_path=".cache/hcr.jsonl")
"""
from .report import build_report, check_rows, make_golden, render_markdown
from .spec import (CampaignSpec, EstimatorSpec, JobSpec, TopologySpec,
                   WorkloadSpec)

__all__ = [
    "CampaignSpec", "CampaignResult", "EstimatorSpec", "JobSpec",
    "TopologySpec", "WorkloadSpec", "run_campaign",
    "build_report", "check_rows", "make_golden", "render_markdown",
]


def __getattr__(name):
    """Lazy re-export of the runner (PEP 562).

    Spec and report handling are pure stdlib; the runner pulls in the
    estimator stack (numpy, and torch for arch exports).  Deferring that
    import keeps spec validation and reports usable without them."""
    if name in ("CampaignResult", "run_campaign"):
        from . import runner
        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
