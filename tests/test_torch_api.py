"""The port's facade (``repro_torch.api``) and campaign CLI (``python -m
repro_torch.campaign``) against the reference's, on the CPU.

The counterparts of ``tests/test_api.py``: the session's vocabularies,
``workload``/``plan``/``predict`` on a framework-free text with rows equal
to ``repro.api.Session``'s bit for bit (wall-clock fields left out),
campaigns from a dict and from a path, scoped registries that do not leak,
a session-registered system and estimator in a campaign, the ``host``
system (the card, the CPU only when asked), and the parts that are not
ported (``search``, ``--server``, search specs), which raise.  The CLI validates, lists, runs and reports
``specs/fig10_gemm.json`` to the reference CLI's rows; an arch workload
exports only on the card or with ``--device cpu``; ``report
--update-golden`` writes its snapshot into ``--out``, never under
``specs/``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import api as ref_api
from repro.campaign.__main__ import main as ref_main
from repro.core.estimators.base import ComputeEstimator as RefEstimator
from repro_torch import api
from repro_torch.campaign.__main__ import main
from repro_torch.core.estimators.base import ComputeEstimator

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "specs"
# wall-clock seconds in a row: measured, never predicted
TIMINGS = ("simulation_wall_s", "job_wall_s", "cache_saved_s",
           "cache_miss_cost_s")

GEMM_TEXT = """module @g {
  func.func public @main(%arg0: tensor<64x32xbf16>, %arg1: tensor<32x48xbf16>) -> tensor<64x48xbf16> {
    %0 = stablehlo.dot_general %arg0, %arg1, contracting_dims = [1] x [0], precision = [DEFAULT, DEFAULT] : (tensor<64x32xbf16>, tensor<32x48xbf16>) -> tensor<64x48xbf16>
    return %0 : tensor<64x48xbf16>
  }
}
"""

MYCHIP = {
    "name": "MyChip-1", "peak_flops": {"bf16": 5e14}, "mem_bw": 2e12,
    "mem_capacity": 3.2e10,
    "interconnect": {"kind": "all_to_all", "link_bw": 1e11},
}


def _gemm_spec(**overrides) -> dict:
    d = {"name": "api-t",
         "workloads": [{"name": "g", "fidelity": "raw",
                        "gemm": {"m": 64, "n": 48, "k": 32}}],
         "systems": ["a100", "h100"],
         "estimators": [{"kind": "roofline"}, {"kind": "systolic"}]}
    d.update(overrides)
    return d


def _row(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in TIMINGS}


def _fixed(base):
    """A third-party-style backend on ``base``: constant latency a
    region."""
    class Fixed(base):
        toolchain = "fixed"

        def __init__(self, system, latency=1e-6):
            super().__init__(system)
            self.latency = float(latency)

        @classmethod
        def from_spec(cls, options, system, context):
            return cls(system, latency=float(options.get("latency", 1e-6)))

        def get_run_time_estimate(self, region):
            return self.latency

        @property
        def cache_config_key(self):
            return f"lat{self.latency!r}"
    return Fixed


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------

def test_describe_lists_the_reference_vocabularies():
    ours, ref = api.Session().describe(), ref_api.Session().describe()
    assert ours["estimators"] == ref["estimators"]
    assert ours["topologies"] == ref["topologies"]
    assert ([(s["id"], s["name"], s["source"]) for s in ours["systems"]]
            == [(s["id"], s["name"], s["source"]) for s in ref["systems"]])
    assert "plugins" in ours


@pytest.mark.parametrize("estimator,options", [
    ("roofline", None), ("roofline", {"mode": "per-op"}),
    ("systolic", None), ("mixed", None)])
def test_workload_plan_predict_rows_equal_the_reference(estimator, options):
    rows = []
    for mod in (api, ref_api):
        s = mod.Session()
        w = s.workload(name="g", stablehlo=GEMM_TEXT)
        plan = s.plan(w, slicer="linear")
        assert plan.fidelity == "raw" and plan.compute_regions
        p = s.predict(plan, system="h100", estimator=estimator,
                      options=options, topology="a2a",
                      topology_params={"num_devices": 1})
        assert p.step_time_s > 0
        rows.append(_row(p.to_row()))
    assert rows[0] == rows[1]


def test_workload_from_files_and_the_optimized_fidelity(tmp_path):
    path = tmp_path / "g.mlir"
    path.write_text(GEMM_TEXT)
    s = api.Session()
    w = s.workload(name="g", stablehlo_path=str(path), hlo_path=str(path))
    assert s.plan(w).fidelity == "optimized"
    assert s.plan(w, fidelity="raw").fidelity == "raw"


def test_predict_accepts_live_objects_and_rejects_other_types():
    from repro_torch.campaign.builders import build_estimator, build_topology
    from repro_torch.campaign.spec import EstimatorSpec, TopologySpec

    s = api.Session()
    w = s.workload(name="g", stablehlo=GEMM_TEXT)
    system = s.get_system("a100")
    est = build_estimator(EstimatorSpec(kind="roofline"), system)
    topo = build_topology(TopologySpec(kind="a2a", params=(
        ("num_devices", 1),)), system)
    by_object = s.predict(w, system=system, estimator=est, topology=topo)
    by_name = s.predict(w, system="a100", topology="a2a",
                        topology_params={"num_devices": 1})
    assert by_object.step_time_s == by_name.step_time_s
    with pytest.raises(TypeError, match="estimator"):
        s.predict(w, estimator=42)
    with pytest.raises(TypeError, match="topology"):
        s.predict(w, topology=42)


def test_cache_store_is_shared_and_flushed(tmp_path):
    path = str(tmp_path / "hcr.jsonl")
    s = api.Session(cache_path=path)
    w = s.workload(name="g", stablehlo=GEMM_TEXT)
    s.predict(w, system="a100")
    first = s.predict(w, system="a100")
    assert first.cache_stats.hits >= 1
    assert s.cache_store is s.cache_store and s.plan_store is s.plan_store
    s.flush_cache()
    assert os.path.getsize(path) > 0
    again = api.Session(cache_path=path).predict(
        api.Session().workload(name="g", stablehlo=GEMM_TEXT),
        system="a100")
    assert again.cache_stats.misses == 0


def test_campaign_from_a_dict_and_from_a_path_equals_the_reference(
        tmp_path):
    spec = _gemm_spec()
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    ours = api.Session().campaign(spec)
    assert [_row(r) for r in api.Session().campaign(str(path)).rows] == [
        _row(r) for r in ours.rows]
    ref = ref_api.Session().campaign(spec)
    assert [_row(r) for r in ours.rows] == [_row(r) for r in ref.rows]
    assert len(ours.rows) == 4 and not [r for r in ours.rows
                                        if "error" in r]


def test_load_spec_validates():
    spec = api.load_spec(str(SPECS / "fig10_gemm.json"))
    assert spec.name == "fig10-gemm"


def test_scoped_kinds_do_not_leak():
    a, b = api.Session(), api.Session()
    a.register_estimator("fixed-a", _fixed(ComputeEstimator))
    a.register_system("mychip", MYCHIP)
    assert "fixed-a" in a.describe()["estimators"]
    assert "fixed-a" not in b.describe()["estimators"]
    assert "mychip" not in {s["id"] for s in b.describe()["systems"]}
    with pytest.raises(KeyError):
        b.get_system("mychip")


def test_session_system_and_estimator_in_a_campaign():
    spec = _gemm_spec(systems=["mychip"],
                      estimators=[{"kind": "fixed", "options": {
                          "latency": 2e-6}}, {"kind": "roofline"}])
    rows = []
    for mod, base in ((api, ComputeEstimator), (ref_api, RefEstimator)):
        s = mod.Session()
        s.register_estimator("fixed", _fixed(base))
        s.register_system("mychip", MYCHIP)
        result = s.campaign(spec)
        assert not [r for r in result.rows if "error" in r]
        rows.append([_row(r) for r in result.rows])
    assert rows[0] == rows[1]
    assert {r["system"] for r in rows[0]} == {"mychip"}
    fixed = [r for r in rows[0] if r["estimator"].startswith("fixed")]
    assert fixed and all(r["compute_s"] == 2e-6 for r in fixed)


def test_search_and_the_host_system_raise():
    """Search is not ported; ``host`` is the card, so without one it
    raises unless the CPU is asked for."""
    s = api.Session()
    with pytest.raises(NotImplementedError, match="item 8"):
        s.search(str(SPECS / "search_gemm.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.get_system("host")
    assert s.get_system("host", device="cpu") is api.host_system("cpu")
    assert s.get_system("host", device="cpu").name == \
        ref_api.host_system(calibrate=False).name


def test_export_traces_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from repro_torch.models.resnet import ResNetConfig, resnet_train_exports

    step, args = resnet_train_exports(
        ResNetConfig(depth=18, width=8, num_classes=10), 2, 32)
    s = api.Session()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        s.export(step, *args, name="r18")
    w = s.export(step, *args, name="r18", device="cpu")
    assert w.stablehlo_text.count("stablehlo.convolution(") == 62
    p = s.predict(w, system="h100", fidelity="raw")
    assert p.compute_s > 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_validate_and_list(capsys):
    assert main(["validate", str(SPECS / "paper_full.json")]) == 0
    out = capsys.readouterr().out
    assert "campaign 'fig7-resnet': 4 grid points" in out
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "estimator kinds: roofline" in out and "a100" in out
    assert main(["validate", str(SPECS / "fig10_gemm.json"),
                 "--systems", str(SPECS / "systems")]) == 0


def test_cli_run_and_report_equal_the_reference_cli(tmp_path, capsys):
    spec = str(SPECS / "fig10_gemm.json")
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert main(["run", spec, "--out", str(ours), "--quiet"]) == 0
    assert ref_main(["run", spec, "--out", str(ref), "--quiet"]) == 0

    def rows(d):
        with open(d / "results.jsonl") as f:
            return sorted((_row(json.loads(line)) for line in f),
                          key=lambda r: r["job_id"])
    assert rows(ours) == rows(ref) and len(rows(ours)) == 24
    capsys.readouterr()
    assert main(["report", spec, "--results", str(ours / "results.jsonl"),
                 "--check", "--out", str(tmp_path / "report")]) == 0
    assert "golden OK" in capsys.readouterr().out


def test_cli_update_golden_writes_into_out_and_not_specs(tmp_path):
    golden = SPECS / "golden" / "fig10-gemm.json"
    before = golden.read_bytes()
    out = tmp_path / "report"
    assert main(["report", str(SPECS / "fig10_gemm.json"), "--quiet",
                 "--update-golden", "--out", str(out)]) == 0
    assert golden.read_bytes() == before
    written = json.loads((out / "fig10-gemm" / "golden.json").read_text())
    assert written["rows"] == json.loads(before)["rows"]


def test_cli_server_and_search_specs_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="serve daemon"):
        main(["run", str(SPECS / "fig10_gemm.json"), "--server",
              "http://127.0.0.1:8733", "--out", str(tmp_path)])
    for command in ("validate", "run"):
        with pytest.raises(NotImplementedError, match="item 8"):
            main([command, str(SPECS / "search_gemm.json"), "--out",
                  str(tmp_path)] if command == "run"
                 else [command, str(SPECS / "search_gemm.json")])


def _arch_spec(tmp_path) -> str:
    path = tmp_path / "r18.json"
    path.write_text(json.dumps({
        "name": "r18", "workloads": [{
            "name": "resnet18", "arch": "resnet18", "mode": "train",
            "batch": 2, "img": 32, "fidelity": "raw"}],
        "systems": ["h100"], "estimators": [{"kind": "roofline"}]}))
    return str(path)


def test_cli_arch_export_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _arch_spec(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["run", spec, "--out", str(tmp_path / "card"), "--quiet"])
    assert main(["run", spec, "--out", str(tmp_path / "cpu"), "--quiet",
                 "--device", "cpu"]) == 0
    with open(tmp_path / "cpu" / "results.jsonl") as f:
        [row] = [json.loads(line) for line in f]
    assert row["workload"] == "resnet18" and row["step_time_s"] > 0


def test_cli_module_runs_as_a_program():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.campaign", "list", "--check"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "catalog check:" in proc.stdout and "0 failure(s)" in \
        proc.stdout
