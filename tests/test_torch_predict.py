"""The port's prediction slice against the JAX package, on the CPU.

``repro_torch`` keeps its own copies of the reference's slicers,
estimators, network layer, pipeline and campaign runner.  Here they are
held against the reference on the same text: every estimator and topology
kind the five paper grids name, both slicers, five texts (a smoke-size JAX
export, the port's smoke-size kernel and chunked exports, the reference's
synthesized sharded stack, which carries all-reduces and loops, and a
module of the other collective kinds), with rows equal bit for bit; fig10 against the reference and its
golden; fig6 through the port's own exports, ranked as the golden ranks
its systems; the persistent cache; spec validation; and the system
catalog.

Wall-clock fields (``simulation_wall_s``, ``job_wall_s`` and the cache's
``cache_saved_s``/``cache_miss_cost_s``, which are seconds the estimator
took) are timings, not predictions: the comparisons leave them out.

The file takes about three and a half minutes on one worker; fig6's three
llama3 exports at 4x2048 (test (c)) are about 25 s of it and fig7's four
ResNet exports at 8x32 about two minutes.
"""
import dataclasses
import functools
import math
from pathlib import Path

import pytest

import repro.campaign as ref_campaign
from repro.campaign import builders as ref_builders
from repro.campaign.builders import (synthesize_gemm_stack as
                                     ref_gemm_stack,
                                     synthesize_sharded_stack as
                                     ref_sharded_stack)
from repro.campaign.spec import WorkloadSpec as RefWorkloadSpec
from repro.core import catalog as ref_catalog
from repro.core import ir as ref_ir
from repro.core import registry as ref_registry
from repro.core.pipeline import PredictionJob as RefPredictionJob
from repro.core.pipeline import Workload as RefWorkload
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro.train.loop import train_step_exports as jax_train_step_exports
from repro_torch import campaign
from repro_torch.campaign.builders import (build_estimator, build_topology,
                                           build_workload,
                                           synthesize_gemm_stack,
                                           synthesize_sharded_stack)
from repro_torch.campaign.report import check_rows, kendall_tau, load_json
from repro_torch.campaign.spec import (EstimatorSpec, TopologySpec,
                                       WorkloadSpec)
from repro_torch.core import catalog, ir, registry
from repro_torch.core.pipeline import PredictionJob, Workload, export_workload
from repro_torch.models.registry import get_smoke_config
from repro_torch.train.loop import train_step_exports

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "specs"
# wall-clock seconds in a row: measured, never predicted
TIMINGS = ("simulation_wall_s", "job_wall_s", "cache_saved_s",
           "cache_miss_cost_s")
SMOKE_SEQ, SMOKE_BATCH = 32, 2

# every estimator the five grids name (fig6/9/11: roofline by region and
# per-op with overheads; fig10: systolic with its four presets; fig11:
# mixed), every topology kind with a grid's parameters (fig6: auto over 4
# devices; fig10: a2a over 1; fig9: its first dragonfly; fig11: its torus;
# multipod, which no grid names, as two fig11 tori), both slicers
ESTIMATORS = [
    {"kind": "roofline"},
    {"kind": "roofline",
     "options": {"mode": "per-op", "include_overheads": True}},
    *({"kind": "systolic", "options": {"preset": p}}
      for p in ("onnxim", "cocossim", "scalesim", "zigzag")),
    {"kind": "mixed", "options": {"preset": "cocossim"}},
]
TORUS = {"dims": [4, 2], "link_bw": 70e9}
TOPOLOGIES = [
    {"kind": "auto", "params": {"num_devices": 4}},
    {"kind": "a2a", "params": {"num_devices": 1}},
    {"kind": "dragonfly", "params": {
        "num_nodes": 4, "gpus_per_node": 4, "nodes_per_router": 1,
        "routers_per_group": 2, "groups": 2,
        "intra_bw": 150e9, "inter_bw": 25e9}},
    {"kind": "torus", "params": TORUS},
    {"kind": "multipod", "params": {"pod": TORUS, "num_pods": 2}},
]
SLICERS = ["linear", "dep"]
# a GPU and a TPU: auto derives an all-to-all node on one and the
# system's torus on the other (where an explicit num_devices is an
# evaluate error in both packages, held equal like any other row)
SYSTEMS = ["h100", "tpu-v3"]
SHARDED_SHAPES = [(256, 512, 128), (256, 128, 512), (128, 256, 256)]
_GROUP = ("channel_handle = #stablehlo.channel_handle<handle = {}, type = "
          "1>, replica_groups = dense<[[0, 1, 2, 3, 4, 5, 6, 7]]> : "
          "tensor<1x8xi64>")
_T, _DOT = "tensor<256x256xbf16>", (
    "stablehlo.dot_general {}, %arg1, contracting_dims = [1] x [0], "
    "precision = [DEFAULT, DEFAULT] : ({}, tensor<256x256xbf16>) -> {}")
# all_gather, reduce_scatter, all_to_all and collective_permute between
# GEMMs, in the forms jax.jit(shard_map(...)).lower() prints them, with a
# barrier in the chain and a GEMM that the dependency-aware slicer may
# overlap with the communication
COLLECTIVES = f"""module @collectives attributes {{mhlo.num_partitions = 8 : i32}} {{
  func.func public @main(%arg0: {_T}, %arg1: {_T}) -> {_T} {{
    %0 = {_DOT.format("%arg0", _T, _T)}
    %1 = "stablehlo.all_gather"(%0) <{{all_gather_dim = 0 : i64, {_GROUP.format(1)}, use_global_device_ids}}> : ({_T}) -> tensor<2048x256xbf16>
    %2 = {_DOT.format("%1", "tensor<2048x256xbf16>", "tensor<2048x256xbf16>")}
    %3 = "stablehlo.reduce_scatter"(%2) <{{{_GROUP.format(2)}, scatter_dimension = 0 : i64, use_global_device_ids}}> ({{
    ^bb0(%lhs: tensor<bf16>, %rhs: tensor<bf16>):
      %s = stablehlo.add %lhs, %rhs : tensor<bf16>
      stablehlo.return %s : tensor<bf16>
    }}) : (tensor<2048x256xbf16>) -> {_T}
    %4 = "stablehlo.all_to_all"(%3) <{{{_GROUP.format(3)}, concat_dimension = 1 : i64, split_count = 8 : i64, split_dimension = 1 : i64}}> : ({_T}) -> {_T}
    %5 = stablehlo.optimization_barrier %4 : {_T}
    %6 = {_DOT.format("%5", _T, _T)}
    %7 = "stablehlo.collective_permute"(%6) <{{channel_handle = #stablehlo.channel_handle<handle = 4, type = 1>, source_target_pairs = dense<[[0, 1], [1, 0]]> : tensor<2x2xi64>}}> : ({_T}) -> {_T}
    %8 = {_DOT.format("%arg0", _T, _T)}
    %9 = stablehlo.add %7, %8 : {_T}
    return %9 : {_T}
  }}
}}
"""


def _no_timings(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in TIMINGS}


def _assert_rows_equal(ours: list[dict], theirs: list[dict]) -> None:
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert _no_timings(a) == _no_timings(b)


# --------------------------------------------------------------------------
# the four texts
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _text(source: str) -> str:
    if source == "jax":
        step, args = jax_train_step_exports(
            jax_smoke_config("llama3-1b"), SMOKE_SEQ, SMOKE_BATCH)
        return jax_export_workload(step, *args, name="jax",
                                   compile_workload=False).stablehlo_text
    if source in ("kernel", "chunked"):
        cfg = get_smoke_config("llama3-1b").scaled(attn_impl=source)
        step, args = train_step_exports(cfg, SMOKE_SEQ, SMOKE_BATCH)
        return export_workload(step, *args, name=source,
                               device="cpu").stablehlo_text
    if source == "collectives":
        return COLLECTIVES
    assert source == "sharded"
    text = synthesize_sharded_stack(SHARDED_SHAPES, groups=8, steps=3,
                                    microbatches=2)
    assert text == ref_sharded_stack(SHARDED_SHAPES, groups=8, steps=3,
                                     microbatches=2)
    return text


TEXTS = ["jax", "kernel", "chunked", "sharded", "collectives"]


def _grid(name: str) -> dict:
    return {"name": name,
            "workloads": [{"name": name, "fidelity": "raw"}],
            "systems": SYSTEMS, "estimators": ESTIMATORS,
            "slicers": SLICERS, "topologies": TOPOLOGIES,
            "overlap": [False, True]}


# --------------------------------------------------------------------------
# (a) bit for bit on the same Program
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source", TEXTS)
def test_rows_equal_the_reference_on_the_same_text(source):
    """The whole grid (7 estimators x 5 topologies x 2 slicers x 2
    systems, with and without overlap of communication and compute)
    through both packages' campaign runners on one text: every row equal,
    field by field, error rows included."""
    text = _text(source)
    ours = campaign.run_campaign(
        campaign.CampaignSpec.from_dict(_grid(source), provided={source}),
        workloads={source: Workload(source, stablehlo_text=text)})
    theirs = ref_campaign.run_campaign(
        ref_campaign.CampaignSpec.from_dict(_grid(source),
                                            provided={source}),
        workloads={source: RefWorkload(source, stablehlo_text=text)})
    _assert_rows_equal(ours.rows, theirs.rows)
    ok = ours.ok_rows
    # only auto over 4 devices on the TPU's fixed torus fails
    assert len(ok) == len(ours.rows) - 2 * len(ESTIMATORS) * len(SLICERS)
    assert all(math.isfinite(r["step_time_s"]) and r["step_time_s"] > 0
               for r in ok)
    if source in ("sharded", "collectives"):
        assert all(r["num_comm"] > 0 and r["comm_s"] > 0 for r in ok)


@pytest.mark.parametrize("source", TEXTS)
@pytest.mark.parametrize("slicer", SLICERS)
def test_prediction_job_equals_the_reference(source, slicer):
    """One :class:`PredictionJob` a text and slicer, as phase 9 of
    ``chip_smoke.py`` runs it (h100, a2a over one device, fig6's two
    roofline estimators): ``Prediction.to_row()`` equal to the
    reference's, and the two packages' Programs equal."""
    text = _text(source)
    ours, theirs = ir.parse(text), ref_ir.parse(text)
    assert ours.num_ops == theirs.num_ops
    assert ir.program_cost(ours).flops == ref_ir.program_cost(theirs).flops
    topo = TopologySpec.from_dict({"kind": "a2a",
                                   "params": {"num_devices": 1}})
    ref_topo = ref_campaign.TopologySpec.from_dict(
        {"kind": "a2a", "params": {"num_devices": 1}})
    system = catalog.default_registry().get("h100")
    ref_system = ref_catalog.default_registry().get("h100")
    for est in ESTIMATORS[:2]:
        row = PredictionJob(
            program=ours, slicer=slicer, name=source, system_name="h100",
            estimator=build_estimator(EstimatorSpec.from_dict(est), system),
            topology=build_topology(topo, system)).run().to_row()
        ref_row = RefPredictionJob(
            program=theirs, slicer=slicer, name=source, system_name="h100",
            estimator=ref_builders.build_estimator(
                ref_campaign.EstimatorSpec.from_dict(est), ref_system),
            topology=ref_builders.build_topology(ref_topo, ref_system)
        ).run().to_row()
        assert _no_timings(row) == _no_timings(ref_row)


def test_synthesized_texts_are_the_references_byte_for_byte():
    for shapes in ([(64, 64, 64)], SHARDED_SHAPES):
        assert synthesize_gemm_stack(shapes) == ref_gemm_stack(shapes)
        for kw in ({}, {"steps": 2}, {"steps": 2, "microbatches": 3}):
            assert (synthesize_sharded_stack(shapes, groups=4, **kw)
                    == ref_sharded_stack(shapes, groups=4, **kw))
    for d in ({"name": "g", "gemm": {"m": 128, "n": 64, "k": 32}},
              {"name": "p", "arch": "llama3-1b", "mode": "prefill",
               "seq": 128, "batch": 2},
              {"name": "d", "arch": "llama3-1b", "mode": "decode",
               "seq": 256, "batch": 8}):
        ours = build_workload(WorkloadSpec.from_dict(d), device="cpu")
        theirs = ref_builders.build_workload(
            RefWorkloadSpec.from_dict(d))
        assert ours.stablehlo_text == theirs.stablehlo_text
        assert ours.meta == theirs.meta


# --------------------------------------------------------------------------
# (b) fig10: the reference's rows and its golden
# --------------------------------------------------------------------------

def test_fig10_rows_equal_the_reference_and_the_golden():
    path = str(SPECS / "fig10_gemm.json")
    ours = campaign.run_campaign(campaign.CampaignSpec.from_json(path))
    theirs = ref_campaign.run_campaign(
        ref_campaign.CampaignSpec.from_json(path))
    _assert_rows_equal(ours.rows, theirs.rows)
    golden = load_json(str(SPECS / "golden" / "fig10-gemm.json"))
    assert check_rows(golden, ours.rows)["failures"] == []
    assert ref_campaign.check_rows(golden, theirs.rows)["failures"] == []


# --------------------------------------------------------------------------
# (c) fig6 through the port's own exports
# --------------------------------------------------------------------------

def test_fig6_raw_rows_rank_the_systems_as_the_golden():
    """fig6 as checked in, exported by the port (traced on the CPU): 24
    rows, the 12 raw rows costed on the global step's text and the 12
    optimized rows on the per-rank text of the ``[4, 1]`` data mesh.  Per
    workload and fidelity the rows rank the four systems as the golden's
    rows of that fidelity do.  The ratios to the golden are a finding (the
    port's texts are not JAX's), printed, not asserted."""
    spec = campaign.CampaignSpec.from_json(str(SPECS / "fig6_gpu.json"))
    result = campaign.run_campaign(spec, device="cpu")
    assert len(result.rows) == 24 and not [r for r in result.rows
                                           if "error" in r]
    golden = {(r["workload"], r["system"], r["fidelity"]): r["step_time_s"]
              for r in load_json(str(SPECS / "golden" / "fig6-gpu.json"))[
                  "rows"]}
    for fidelity in ("raw", "optimized"):
        for workload in ("llama3-100m", "llama3-500m", "llama3-1b"):
            rows = [r for r in result.rows if r["workload"] == workload
                    and r["fidelity"] == fidelity]
            assert len(rows) == 4
            ours = [r["step_time_s"] for r in rows]
            theirs = [golden[(workload, r["system"], fidelity)]
                      for r in rows]
            print(workload, fidelity, ", ".join(
                f"{r['system']} {a / b:.3f}"
                for r, a, b in zip(rows, ours, theirs)))
            assert kendall_tau(ours, theirs) == 1.0
    optimized = [r for r in result.rows if r["fidelity"] == "optimized"]
    assert all(r["num_segments"] > 1 and r["comm_s"] > 0 for r in optimized)


# fig7 cut to 8 images of 32 pixels (its widths, depths, f16 and [4, 1]
# as checked in); the four exports take about two minutes on the CPU
FIG7_SMALL = {"batch": 8, "img": 32}


@functools.lru_cache(maxsize=None)
def _fig7_small() -> dict:
    spec = campaign.CampaignSpec.from_json(str(SPECS / "fig7_resnet.json"))
    return {w.name: build_workload(dataclasses.replace(w, **FIG7_SMALL),
                                   device="cpu") for w in spec.workloads}


def test_mesh_and_resnet_workloads():
    """A mesh gives both texts: the global step's raw text and the
    per-rank text with its collectives; without a mesh the optimized text
    is absent and asking for it raises.  ResNet's train step is a
    workload of the same kind (fig7's resnet18, cut to 8 x 32); its other
    modes raise."""
    spec = {"name": "t", "arch": "llama3-100m", "mode": "train", "seq": 16,
            "batch": 4, "mesh": [4, 1]}
    w = build_workload(WorkloadSpec.from_dict(spec), device="cpu")
    assert w.meta["mesh"] == [4, 1]
    assert w.program("raw").meta.get("num_partitions") == 1
    assert w.program("optimized").meta["num_partitions"] == 4
    assert "stablehlo.reduce_scatter" in w.hlo_text
    assert "stablehlo.all_gather" not in w.stablehlo_text
    del spec["mesh"]
    w = build_workload(WorkloadSpec.from_dict(spec), device="cpu")
    assert w.hlo_text is None
    with pytest.raises(ValueError, match="with a mesh"):
        w.program("optimized")
    w = _fig7_small()["resnet18"]
    assert w.meta["mesh"] == [4, 1]
    assert w.program("raw").meta.get("num_partitions") == 1
    assert w.program("optimized").meta["num_partitions"] == 4
    assert "stablehlo.convolution(" in w.stablehlo_text
    assert "stablehlo.all_reduce" in w.hlo_text
    assert "stablehlo.all_reduce" not in w.stablehlo_text
    with pytest.raises(ValueError, match="train-only"):
        build_workload(WorkloadSpec.from_dict(
            {"name": "r", "arch": "resnet18", "mode": "forward"}),
            device="cpu")


def test_fig7_small_rows_keep_the_goldens_order():
    """fig7 (``a100``, roofline, ``a2a`` over 4) on the port's exports cut
    to 8 x 32: its four optimized rows rank the workloads as the golden's
    do.  The full size (64 x 224) is held on the card (``chip_smoke.py``
    phase 11)."""
    spec = campaign.CampaignSpec.from_json(str(SPECS / "fig7_resnet.json"))
    result = campaign.run_campaign(spec, workloads=_fig7_small())
    rows = sorted(result.rows, key=lambda r: r["workload"])
    assert len(rows) == 4 and not [r for r in rows if "error" in r]
    golden = {r["workload"]: r["step_time_s"] for r in load_json(
        str(SPECS / "golden" / "fig7-resnet.json"))["rows"]}
    assert all(r["fidelity"] == "optimized" and r["num_comm"] > 0
               for r in rows)
    assert kendall_tau([r["step_time_s"] for r in rows],
                       [golden[r["workload"]] for r in rows]) == 1.0


def test_an_optimized_job_without_optimized_text_is_a_plan_error_row():
    """No row is computed from the raw text in place of the optimized
    text: the job is a ``plan`` error row that names what is missing."""
    spec = campaign.CampaignSpec.from_dict({
        "name": "no-mesh", "workloads": [{"name": "w"}],
        "systems": ["h100"], "estimators": [{"kind": "roofline"}],
        "topologies": [{"kind": "a2a", "params": {"num_devices": 1}}]},
        provided={"w"})
    result = campaign.run_campaign(spec, workloads={"w": Workload(
        "w", stablehlo_text=_text("sharded"))})
    [row] = result.rows
    assert row["fidelity"] == "optimized" and row["error_type"] == "plan"
    assert "with a mesh" in row["error"] and "step_time_s" not in row


# --------------------------------------------------------------------------
# (d) the persistent cache
# --------------------------------------------------------------------------

def test_a_second_run_on_the_same_cache_hits_every_region(tmp_path):
    spec = campaign.CampaignSpec.from_dict(_grid("sharded"),
                                           provided={"sharded"})
    workloads = {"sharded": Workload("sharded",
                                     stablehlo_text=_text("sharded"))}
    cache = str(tmp_path / "hcr.jsonl")
    first = campaign.run_campaign(spec, workloads=workloads,
                                  cache_path=cache)
    second = campaign.run_campaign(spec, workloads=workloads,
                                   cache_path=cache)
    assert first.cache["misses"] > 0
    assert second.cache["misses"] == 0 and second.cache["hit_rate"] == 1.0
    assert second.cache["loaded_entries"] == first.cache["total_entries"]
    drop = TIMINGS + ("cache_hits", "cache_misses", "cache_hit_rate")
    for a, b in zip(first.rows, second.rows):
        assert ({k: v for k, v in a.items() if k not in drop}
                == {k: v for k, v in b.items() if k not in drop})


# --------------------------------------------------------------------------
# (e) spec validation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(SPECS.glob("fig*.json")),
                         ids=lambda p: p.stem)
def test_every_paper_grid_validates(path):
    ours = campaign.CampaignSpec.from_json(str(path))
    theirs = ref_campaign.CampaignSpec.from_json(str(path))
    assert ours.to_dict() == theirs.to_dict()
    assert ([j.to_row() for j in ours.expand()]
            == [j.to_row() for j in theirs.expand()])


@pytest.mark.parametrize("kind,module", [
    ("learned", "repro_torch.core.estimators.learned")])
def test_unported_estimator_kinds_fail_naming_their_slice(kind, module):
    """Every estimator kind of the reference is ported now: each resolves
    to the port's own class, and the checked-in grid naming it loads."""
    assert registry.ESTIMATORS.kinds() == ref_registry.ESTIMATORS.kinds()
    assert kind in registry.ESTIMATORS
    cls = registry.ESTIMATORS.get(kind)
    assert cls.__module__ == module
    d = {"name": "x", "workloads": [{"name": "g", "gemm": {
        "m": 64, "n": 64, "k": 64}}], "estimators": [{"kind": kind}]}
    assert [j.estimator.kind for j in
            campaign.CampaignSpec.from_dict(d).expand()] == [kind]
    # the checked-in grid of the learned tier
    spec = campaign.CampaignSpec.from_json(str(SPECS / "learned_fidelity.json"))
    assert len(spec.expand()) == 16


def test_the_profiling_kind_resolves_and_a_spec_naming_it_validates():
    """The profiling slice is ported: its kind resolves to the port's own
    estimator, and a spec that names it validates."""
    from repro_torch.core.estimators.profiling import ProfilingEstimator
    assert registry.ESTIMATORS.get("profiling") is ProfilingEstimator
    assert not hasattr(registry.ESTIMATORS, "pending_message")
    d = {"name": "x", "workloads": [{"name": "g", "gemm": {
        "m": 64, "n": 64, "k": 64}}], "systems": ["host", "h100"],
        "estimators": [{"kind": "profiling", "options": {"runs": 1}}]}
    spec = campaign.CampaignSpec.from_dict(d)
    assert [j.system for j in spec.expand()] == ["host", "h100"]


def test_topology_vocabulary_and_plugin_group():
    assert registry.TOPOLOGIES.kinds() == ref_registry.TOPOLOGIES.kinds()
    assert registry.PLUGIN_GROUP == "repro_torch.backends"


# --------------------------------------------------------------------------
# (f) the system catalog
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted((SPECS / "systems").glob("*.json")),
                         ids=lambda p: p.stem)
def test_catalog_systems_equal_the_reference(path):
    ours = catalog.default_registry().get(path.stem)
    theirs = ref_catalog.default_registry().get(path.stem)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.interconnect.to_dict() == theirs.interconnect.to_dict()


def test_host_system_raises():
    """``host`` is the calibrated card: without one, resolving it raises
    and says how to ask for the CPU, which it then is (the reference's
    ``host-cpu``, calibrated by a bf16 GEMM)."""
    assert catalog.default_registry().names() == \
        ref_catalog.default_registry().names()
    assert "host" in catalog.default_registry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        catalog.default_registry().get("host")
    from repro_torch.core.systems import host_system
    cpu = host_system("cpu")
    assert cpu.name == "host-cpu" and cpu is host_system("cpu")
    assert catalog.default_registry().get("host", device="cpu") is cpu
    assert catalog.SystemRegistry(
        parent=catalog.default_registry()).get("HOST", "cpu") is cpu
    assert cpu.flops_for("bf16") > 0 and cpu.mem_bw == 20e9
