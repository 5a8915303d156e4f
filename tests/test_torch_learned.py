"""The port's learned estimator and its fit tool against the reference's,
on the CPU.

``repro_torch.core.estimators.learned`` is a copy of the reference's module
that keeps its stdlib float arithmetic in the same loop order, so the
tolerance here is none: families, features, fitted coefficients and model
digests are held bit-equal, and so are the predictions, their intervals and
the campaign rows of ``specs/learned_fidelity.json`` (uncertainty fields
included; wall-clock fields left out).

The regions come from square bf16 GEMMs and llama3-1b serving steps that
each package synthesizes with its own builders, and from two smoke-size
llama3-1b train steps with layer barriers (the JAX export and the port's
chunked export), each text parsed and sliced (dependency-aware) by both
packages.

The shipped ``specs/models/learned-gemm-a100.json`` was fitted when the
catalog's ``a100`` had another ``kernel_overhead_s``, so a re-fit today
gives another digest; both packages load the shipped file as it is, and
the port's fit equals the reference's re-fit, whatever that digest is.
"""
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import pytest

import repro.campaign as ref_campaign
from repro.campaign.builders import _synthesize_gemm as ref_synthesize_gemm
from repro.campaign.builders import \
    _synthesize_serving as ref_synthesize_serving
from repro.campaign.spec import WorkloadSpec as RefWorkloadSpec
from repro.core.catalog import default_registry as ref_default_registry
from repro.core.estimators import RooflineEstimator as RefRoofline
from repro.core.estimators import learned as ref_learned
from repro.core.estimators import record_profile as ref_record_profile
from repro.core.ir.parser import parse as ref_parse
from repro.core.pipeline import build_plan as ref_build_plan
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro.train.loop import train_step_exports as jax_train_step_exports
from repro_torch import campaign
from repro_torch.campaign.__main__ import main as campaign_main
from repro_torch.campaign.builders import _synthesize_gemm, _synthesize_serving
from repro_torch.campaign.spec import WorkloadSpec
from repro_torch.core.catalog import default_registry
from repro_torch.core.estimators import (LearnedEstimator, MixedEstimator,
                                         RooflineEstimator, fit_model,
                                         load_model, record_profile,
                                         region_family, save_model)
from repro_torch.core.estimators import learned
from repro_torch.core.ir.parser import parse
from repro_torch.core.pipeline import build_plan, export_workload
from repro_torch.core.registry import ESTIMATORS
from repro_torch.models.registry import get_smoke_config
from repro_torch.tools import fit_learned_model
from repro_torch.train.loop import train_step_exports

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "specs" / "learned_fidelity.json"
SHIPPED = ROOT / "specs" / "models" / "learned-gemm-a100.json"
TRAIN_SIZES = (256, 512, 1024, 2048, 4096)
# in and out of the fitted envelope (8192 lies above it, 128 below)
PREDICT_SIZES = (128, 1024, 4096, 8192)
SYSTEMS = ("a100", "h100-paper", "h100")
SMOKE_SEQ, SMOKE_BATCH = 32, 2
TIMINGS = ("simulation_wall_s", "job_wall_s", "cache_saved_s",
           "cache_miss_cost_s")


def _gemm_regions(sizes) -> tuple[list, list]:
    """(ours, theirs): each package's own synthesized GEMM, sliced by it."""
    ours, theirs = [], []
    for m in sizes:
        g = {"m": m, "n": m, "k": m, "dtype": "bf16"}
        w = _synthesize_gemm(WorkloadSpec(name=f"g{m}", fidelity="raw",
                                          gemm=g))
        rw = ref_synthesize_gemm(RefWorkloadSpec(name=f"g{m}",
                                                 fidelity="raw", gemm=g))
        assert w.stablehlo_text == rw.stablehlo_text
        ours += build_plan(w.program("raw"), name=w.name).compute_regions
        theirs += ref_build_plan(rw.program("raw"),
                                 name=rw.name).compute_regions
    return ours, theirs


@functools.lru_cache(maxsize=None)
def _text(source: str) -> str:
    if source == "jax":
        cfg = dataclasses.replace(jax_smoke_config("llama3-1b"),
                                  scan_layers=False, layer_barriers=True)
        step, args = jax_train_step_exports(cfg, SMOKE_SEQ, SMOKE_BATCH)
        return jax_export_workload(step, *args, name="jax",
                                   compile_workload=False).stablehlo_text
    if source == "chunked":
        cfg = get_smoke_config("llama3-1b").scaled(
            attn_impl="chunked", scan_layers=False, layer_barriers=True)
        step, args = train_step_exports(cfg, SMOKE_SEQ, SMOKE_BATCH)
        return export_workload(step, *args, name=source,
                               device="cpu").stablehlo_text
    mode, batch = source.split("-")
    kw = dict(name=source, arch="llama3-1b", mode=mode, batch=int(batch),
              seq=2048, fidelity="raw")
    text = _synthesize_serving(WorkloadSpec(**kw)).stablehlo_text
    assert text == ref_synthesize_serving(RefWorkloadSpec(**kw)).stablehlo_text
    return text


LLAMA_TEXTS = ["jax", "chunked", "decode-8", "prefill-8"]


def _llama_regions(source: str) -> tuple[list, list]:
    """(ours, theirs): one text sliced by each package's dependency-aware
    slicer, whose regions span the families (the linear slicer puts a
    GEMM into every region of these texts)."""
    text = _text(source)
    return (build_plan(parse(text), name=source,
                       slicer="dep").compute_regions,
            ref_build_plan(ref_parse(text), name=source,
                           slicer="dep").compute_regions)


def _systems(name: str):
    return default_registry().get(name), ref_default_registry().get(name)


def _fit_both(ours, theirs, system="a100", recorder_mode="region"):
    sys_, ref_sys = _systems(system)
    profile = record_profile(ours, RooflineEstimator(sys_, mode=recorder_mode))
    ref_profile = ref_record_profile(theirs,
                                     RefRoofline(ref_sys, mode=recorder_mode))
    assert profile == ref_profile
    meta = {"source_system": system}
    return (fit_model(ours, profile, sys_, meta=meta),
            ref_learned.fit_model(theirs, ref_profile, ref_sys, meta=meta))


# --------------------------------------------------------------------------
# families and features
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["gemm", *LLAMA_TEXTS])
def test_family_and_features_equal_the_reference(source):
    ours, theirs = (_gemm_regions(PREDICT_SIZES + TRAIN_SIZES)
                    if source == "gemm" else _llama_regions(source))
    assert len(ours) == len(theirs) > 0
    families = set()
    for r, rr in zip(ours, theirs):
        assert r.fingerprint == rr.fingerprint
        assert region_family(r) == ref_learned.region_family(rr)
        families.add(region_family(r))
        for name in SYSTEMS:
            sys_, ref_sys = _systems(name)
            assert learned.region_features(r, sys_) == \
                ref_learned.region_features(rr, ref_sys)
    if source in ("jax", "chunked"):
        # a train step spans the families the fit keeps apart
        assert {"matmul", "elementwise", "movement"} <= families


# --------------------------------------------------------------------------
# the fit, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("recorder", ["region", "per-op"])
def test_fit_on_the_training_gemms_equals_the_reference_digest(recorder):
    """The reference tool's training set on a100: the digest is computed
    from the reference's own fit (today ``c21ffcd53198``, which the shipped
    file does not have; see the module docstring)."""
    model, ref_model = _fit_both(*_gemm_regions(TRAIN_SIZES),
                                 recorder_mode=recorder)
    assert model.to_dict() == ref_model.to_dict()
    assert model.digest() == ref_model.digest()
    assert model.families["matmul"].n_samples == len(TRAIN_SIZES)


@pytest.mark.parametrize("source", ["jax", "chunked"])
def test_fit_on_a_train_step_equals_the_reference(source):
    """Several families, duplicate fingerprints and the ridge term on a
    degenerate family: coefficients equal bit for bit."""
    model, ref_model = _fit_both(*_llama_regions(source), system="h100")
    assert model.to_dict() == ref_model.to_dict()
    assert len(model.families) >= 3
    for fam, fm in model.families.items():
        assert fm.coef == ref_model.families[fam].coef


def test_both_packages_load_the_shipped_model_to_one_digest():
    model = load_model(str(SHIPPED))
    ref_model = ref_learned.load_model(str(SHIPPED))
    assert model.to_dict() == ref_model.to_dict()
    assert model.digest() == ref_model.digest()
    assert model.source["kernel_overhead_s"] == 4e-6


def test_save_and_load_round_trip(tmp_path):
    model, _ = _fit_both(*_gemm_regions(TRAIN_SIZES))
    path = save_model(str(tmp_path / "m.json"), model)
    ref_path = ref_learned.save_model(
        str(tmp_path / "r.json"),
        ref_learned.LearnedModel.from_dict(model.to_dict()))
    assert Path(path).read_bytes() == Path(ref_path).read_bytes()
    assert load_model(path).digest() == model.digest()


# --------------------------------------------------------------------------
# predictions, intervals, quality
# --------------------------------------------------------------------------

@pytest.mark.parametrize("target", SYSTEMS)
@pytest.mark.parametrize("source", ["gemm", "jax", "decode-8"])
def test_predictions_equal_the_reference(source, target):
    """The shipped model on the source system and transferred, inside and
    outside its envelope; unsupported regions are skipped alike."""
    ours, theirs = (_gemm_regions(PREDICT_SIZES) if source == "gemm"
                    else _llama_regions(source))
    sys_, ref_sys = _systems(target)
    est = LearnedEstimator.from_model(sys_, str(SHIPPED))
    ref = ref_learned.LearnedEstimator.from_model(ref_sys, str(SHIPPED))
    assert est.cache_config_key == ref.cache_config_key
    supported = 0
    for r, rr in zip(ours, theirs):
        assert est.supports(r) == ref.supports(rr)
        if est.supports(r):
            supported += 1
            assert est.predict_with_uncertainty(r) == \
                ref.predict_with_uncertainty(rr)
    assert supported > 0
    assert est.prediction_quality(ours) == ref.prediction_quality(theirs)


def test_version_gate_and_an_unknown_family(tmp_path):
    path = tmp_path / "newer.json"
    path.write_text(json.dumps(
        {"version": learned.MODEL_VERSION + 1, "families": {}}))
    with pytest.raises(ValueError, match="version"):
        load_model(str(path))
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    with pytest.raises(ValueError, match="families"):
        load_model(str(bad))
    # the GEMM model knows one family; a train step's others are not its
    ours, _ = _llama_regions("jax")
    a100 = default_registry().get("a100")
    est = LearnedEstimator.from_model(a100, str(SHIPPED))
    other = [r for r in ours if region_family(r) != "matmul"]
    assert other and not any(est.supports(r) for r in other)
    with pytest.raises(KeyError, match="op family"):
        est.get_run_time_estimate(other[0])
    mixed = MixedEstimator(est, RooflineEstimator(a100))
    assert mixed.get_run_time_estimate(other[0]) > 0
    assert ESTIMATORS.get("learned") is LearnedEstimator
    assert ESTIMATORS.portability_errors() == []


# --------------------------------------------------------------------------
# the fit tool
# --------------------------------------------------------------------------

def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_fit_learned_model", ROOT / "tools" / "fit_learned_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--system", "a100", "--gemm", "256,512,1024,2048,4096"],
    ["--system", "h100", "--recorder", "roofline-per-op", "--gemm", "512,2048"],
    ["--system", "tpu-v5e", "--stablehlo", "{decode}", "--gemm", "1024"],
], ids=["reference-set", "per-op", "stablehlo"])
def test_fit_tool_writes_the_reference_tools_bytes(flags, tmp_path, capsys):
    decode = tmp_path / "decode.mlir"
    decode.write_text(_text("decode-8"))
    flags = [f.format(decode=decode) for f in flags]
    assert fit_learned_model.main(
        [*flags, "--out", str(tmp_path / "ours.json")]) == 0
    ours_out = capsys.readouterr().out
    assert _reference_tool().main(
        [*flags, "--out", str(tmp_path / "theirs.json")]) == 0
    theirs_out = capsys.readouterr().out
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()
    assert ours_out.replace("ours.json", "theirs.json") == theirs_out


# --------------------------------------------------------------------------
# the checked-in grid
# --------------------------------------------------------------------------

def test_learned_fidelity_rows_equal_the_reference_and_its_golden(tmp_path,
                                                                  capsys):
    ours = campaign.run_campaign(campaign.CampaignSpec.from_json(str(SPEC)))
    theirs = ref_campaign.run_campaign(
        ref_campaign.CampaignSpec.from_json(str(SPEC)))
    assert len(ours.rows) == len(theirs.rows) == 16
    assert ours.summary["num_failed"] == 0
    for a, b in zip(ours.rows, theirs.rows):
        assert {k: v for k, v in a.items() if k not in TIMINGS} == \
            {k: v for k, v in b.items() if k not in TIMINGS}
    rows = [r for r in ours.rows if r["estimator"].startswith("learned-")]
    assert len(rows) == 8
    for r in rows:
        assert {"uncertainty_s", "uncertainty_rel", "extrapolated"} <= set(r)
        assert r["extrapolated"] is (r["system"] != "a100"
                                     or r["workload"] == "gemm-8192")
    before = (ROOT / "specs" / "golden" / "learned-fidelity.json").read_bytes()
    assert campaign_main(["report", str(SPEC), "--check", "--quiet",
                          "--out", str(tmp_path)]) == 0
    assert "golden OK" in capsys.readouterr().out
    assert (ROOT / "specs" / "golden" /
            "learned-fidelity.json").read_bytes() == before
