"""The port's what-if search (``repro_torch.search``) against the
reference's, on the CPU.

The search is a copy of the reference's over the port's campaign runner, so
its determinism is part of the result: the ε-Pareto filter and spec
validation equal the reference's case by case; on the two checked-in
specs, a tiny inline grid with its infeasible and three-rung variants, and
search_gemm's grid at ε 0 and 2, the frontier
membership, the pruning counters (cache traffic included) and the
per-(workload × system) anchor calibration equal the reference's run
exactly, and every frontier value agrees to a relative 1e-9 (the golden
snapshots' tolerance).  The ladder's frontier equals a brute-force run's, a
warm re-search pays no cold miss, and the CLI's ``--check`` passes while
``--update-golden`` writes into ``--out`` and never under ``specs/``.
"""
import json
from pathlib import Path

import pytest

from repro import api as ref_api
from repro.search import pareto as ref_pareto
from repro.search.report import build_search_report as ref_build_report
from repro.search.spec import SearchSpec as RefSearchSpec
from repro_torch import api
from repro_torch.search import pareto
from repro_torch.search.__main__ import main
from repro_torch.search.report import (build_search_report, check_frontier,
                                       golden_path, load_json,
                                       make_frontier_golden)
from repro_torch.search.spec import SearchSpec

ROOT = Path(__file__).resolve().parents[1]
SPECS = {"gemm": ROOT / "specs" / "search_gemm.json",
         "serving": ROOT / "specs" / "search_serving.json"}
FRONTIER_SIZES = {"gemm": 11, "serving": 8}
RTOL = 1e-9

TINY = {
    "name": "tiny",
    "workloads": [
        {"name": "gemm-512", "fidelity": "raw",
         "gemm": {"m": 512, "n": 512, "k": 512, "dtype": "bf16"}},
        {"name": "gemm-2048", "fidelity": "raw",
         "gemm": {"m": 2048, "n": 2048, "k": 2048, "dtype": "bf16"}},
    ],
    "systems": ["a100", "h100"],
    "objectives": ["step_time_s", "usd_per_step"],
    "ladder": [{"kind": "roofline"},
               {"kind": "systolic", "options": {"preset": "scalesim"}}],
    "constraints": {"mem_capacity_fit": True},
    "topologies": [{"kind": "a2a", "params": {"num_devices": 1}},
                   {"kind": "a2a", "params": {"num_devices": 4}}],
}
HUGE = [{"name": "gemm-huge", "fidelity": "raw",
         "gemm": {"m": 131072, "n": 131072, "k": 131072, "dtype": "f32"}}]
GRIDS = {
    "tiny": TINY,
    "impossible-ceiling": dict(TINY,
                               constraints={"max_step_time_s": 1e-12}),
    "mem-capacity": dict(TINY, workloads=HUGE),
    "three-rungs": dict(TINY, ladder=[
        {"kind": "roofline"},
        {"kind": "roofline", "options": {"mode": "per-op"}},
        {"kind": "systolic", "options": {"preset": "onnxim"}}]),
    # search_gemm's grid with exact and with wide pruning slack: the
    # ε-dominated count moves with ε (3 at 0, 2 at 0.25, 0 at 2)
    "gemm-exact": dict(json.loads(SPECS["gemm"].read_text()), epsilon=0.0),
    "gemm-wide": dict(json.loads(SPECS["gemm"].read_text()), epsilon=2.0),
}


def _spec(name):
    return str(SPECS[name]) if name in SPECS else GRIDS[name]


def _assert_equal_runs(ours, theirs):
    assert ours.frontier == theirs.frontier
    assert ours.counters == theirs.counters
    assert ours.calibration == theirs.calibration
    assert set(ours.candidates) == set(theirs.candidates)
    for k, r in theirs.candidates.items():
        mine = ours.candidates[k]
        assert mine["feasible"] == r["feasible"]
        assert mine.get("pruned") == r.get("pruned")
        assert mine.get("reason") == r.get("reason")
        assert [e["rung"] for e in mine["rungs"]] == \
            [e["rung"] for e in r["rungs"]]
        for o, v in r.get("values", {}).items():
            assert mine["values"][o] == pytest.approx(v, rel=RTOL, abs=0)


# --------------------------------------------------------------------------
# the filter and the spec, case by case
# --------------------------------------------------------------------------

POINTS = {"a": (1.0, 4.0), "b": (2.0, 2.0), "c": (4.0, 1.0),
          "d": (3.0, 3.0), "e": (2.0, 2.0)}


@pytest.mark.parametrize("a,b,eps", [
    ((1.0, 1.0), (2.0, 2.0), 0.0),
    ((2.0, 2.0), (1.0, 1.0), 0.0),
    ((1.0, 2.0), (1.0, 2.0), 0.0),
    ((1.0, 2.0), (1.0, 2.0), 0.5),
    ((1.0, 3.0), (2.0, 2.0), 0.0),
    ((1.0, 1.0), (1.2, 1.2), 0.0),
    ((1.0, 1.0), (1.2, 1.2), 0.25),
    ((1.0, 1.0), (1.2, 1.2), 0.1),
    ((1.0, 2.0, 3.0), (1.0, 2.0, 3.5), 0.0),
    ((1.0,), (1.0, 2.0), 0.0),
])
def test_dominates_equals_the_reference(a, b, eps):
    try:
        want = ref_pareto.dominates(a, b, eps)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            pareto.dominates(a, b, eps)
        return
    assert pareto.dominates(a, b, eps) is want


@pytest.mark.parametrize("points,eps", [
    (POINTS, 0.0),
    (POINTS, 0.6),
    ({"x": (1.0, 1.0), "y": (1.1, 1.1), "z": (5.0, 5.0)}, 0.0),
    ({"x": (1.0, 1.0), "y": (1.1, 1.1), "z": (5.0, 5.0)}, 0.25),
    (dict(reversed(list(POINTS.items()))), 0.0),
    ({"only": (3.0, 3.0)}, 0.0),
])
def test_pareto_filter_equals_the_reference(points, eps):
    assert pareto.pareto_filter(points, eps) == \
        ref_pareto.pareto_filter(points, eps)


_BASE = {"name": "t", "workloads": TINY["workloads"][:1],
         "systems": ["a100"], "objectives": ["step_time_s", "usd_per_step"],
         "ladder": [{"kind": "roofline"}]}


@pytest.mark.parametrize("over", [
    {},
    {"objectives": ["step_time_s", "happiness"]},
    {"objectives": ["step_time_s"]},
    {"epsilon": -0.1},
    {"constraints": {"max_vibes": 1.0}},
    {"constraints": {"max_step_time_s": 0}},
    {"constraints": {"max_joules_per_step": 1.0}},
    {"ladder": []},
    {"objective": ["step_time_s"]},
    {"ladder": [{"kind": "rooflin"}]},
    {"systems": ["a1000"]},
    {"ladder": [{"kind": "learned"}]},
], ids=["valid", "objective", "one-objective", "epsilon", "constraint",
        "ceiling", "unscored-ceiling", "empty-ladder", "unknown-key",
        "unknown-kind", "unknown-system", "learned-without-model"])
def test_spec_validation_equals_the_reference(over):
    d = {**_BASE, **over}
    try:
        want = RefSearchSpec.from_dict(d).to_dict()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            SearchSpec.from_dict(d)
        assert str(got.value) == str(e)
        return
    assert SearchSpec.from_dict(d).to_dict() == want


# --------------------------------------------------------------------------
# the engine against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*SPECS, *GRIDS])
def test_search_equals_the_reference(name):
    ours = api.Session().search(_spec(name))
    theirs = ref_api.Session().search(_spec(name))
    _assert_equal_runs(ours, theirs)
    report, ref_report = build_search_report(ours), ref_build_report(theirs)
    golden = make_frontier_golden(report)
    assert golden["counters"] == make_frontier_golden(ref_report)["counters"]
    if name in SPECS:
        assert len(ours.frontier) == FRONTIER_SIZES[name]
        assert check_frontier(load_json(golden_path(_spec(name),
                                                    report["search"])),
                              report, RTOL) == []
    if name in ("impossible-ceiling", "mem-capacity"):
        assert ours.frontier == []


@pytest.mark.parametrize("name", [*SPECS, "tiny"])
def test_brute_force_frontier_equals_the_ladders(name):
    ladder = api.Session().search(_spec(name))
    brute = api.Session().search(_spec(name), brute_force=True)
    _assert_equal_runs(brute, ref_api.Session().search(_spec(name),
                                                       brute_force=True))
    assert ladder.frontier == brute.frontier
    for k in ladder.frontier:
        assert ladder.candidates[k]["values"] == brute.candidates[k]["values"]
    pruned = {k for k, r in ladder.candidates.items() if r.get("pruned")}
    assert pruned and pruned.isdisjoint(brute.frontier)
    if name in SPECS:
        assert 0 < ladder.counters["top_rung_fraction"] < 0.5


@pytest.mark.parametrize("name", [*SPECS])
def test_a_warm_re_search_pays_no_cold_miss(name):
    session = api.Session()
    cold = session.search(_spec(name))
    parses = session.plan_store.parse_count
    warm = session.search(_spec(name))
    assert cold.counters["cache_misses"] > 0
    assert warm.counters["cache_misses"] == 0
    assert warm.counters["cache_hits"] > 0
    assert session.plan_store.parse_count == parses
    assert warm.frontier == cold.frontier


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*SPECS])
def test_cli_check_passes_and_update_golden_writes_into_out(name, tmp_path,
                                                             capsys):
    spec = str(SPECS[name])
    gpath = Path(golden_path(spec, json.loads(
        SPECS[name].read_text())["name"]))
    before = gpath.read_bytes()
    assert main(["run", spec, "--check", "--quiet",
                 "--out", str(tmp_path / "check")]) == 0
    out = capsys.readouterr().out
    assert f"golden OK ({FRONTIER_SIZES[name]} frontier points" in out
    for f in ("frontier.json", "frontier.md", "rows.jsonl"):
        assert (tmp_path / "check" / f).exists()
    assert main(["run", spec, "--update-golden", "--quiet",
                 "--out", str(tmp_path / "new")]) == 0
    assert gpath.read_bytes() == before
    written = json.loads((tmp_path / "new" / "golden.json").read_text())
    assert check_frontier(json.loads(before), {
        "frontier": written["frontier"],
        "counters": written["counters"]}, RTOL) == []
    assert main(["validate", spec]) == 0
    assert "ok " in capsys.readouterr().out
