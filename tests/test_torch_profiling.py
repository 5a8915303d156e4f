"""The profiling slice of the port against the JAX package, on the CPU.

The port's profiling estimator re-emits each compute region with its copy
of the reference's ``region_to_module`` and runs it with its own executor
(``repro_torch.core.executor``) where the reference compiles it with XLA.
Here, on four texts at smoke size in f32 (llama3-1b's train step with the
kernels and with the chunked attention, a barrier after each layer; the
compute regions of its per-rank step on a ``[4, 1]`` data mesh; resnet18's
train step with a barrier after each block):

* (i) the port's ``region_to_module`` gives the reference's text byte for
  byte for every region;
* (ii) the executor's outputs equal XLA's run of the same module, for
  every region and for the whole module (within ``XLA_RTOL`` of each
  output's largest magnitude), and the texts together hold every op the
  emitter writes into a region (the two that no model of the port writes,
  ``tanh`` and ``or``, and each form of a convolution, are held alone);
* (iii) each ``call`` of an operator of the port's library, run through
  the text's ``call`` table, equals its private function's body run op by
  op;
* (iv) the profiling estimator costs every region with no emit failure; an
  unknown op raises naming itself (and only such failures fall back to
  roofline, counted); a ``call @repro_torch.*`` missing from the table
  raises; the ``host`` system on the CPU;
* resnet18's block barriers cut JAX's regions.

Region inputs are the values the whole module computes on the smoke
step's inputs (recorded by the executor), except in the per-rank text,
whose collectives the executor does not run: there they are the profiling
estimator's synthetic inputs.
"""
import dataclasses
import functools
import inspect
import re

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.core.slicing import linear_split as jax_linear_split
from repro.core.slicing.emit import RegionEmitError as JaxRegionEmitError
from repro.core.slicing.emit import region_to_module as jax_region_to_module
from repro.models import resnet as jr
from repro_torch.core import ir, stablehlo
from repro_torch.core.estimators.profiling import (ProfilingEstimator,
                                                   synthetic, typed_program)
from repro_torch.core.executor import _OPS, Executor
from repro_torch.core.pipeline import build_plan, export_workload
from repro_torch.core.slicing import linear_split
from repro_torch.core.slicing.emit import RegionEmitError, region_to_module
from repro_torch.core.systems import host_system
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models import resnet as tr
from repro_torch.train.loop import train_step_exports
from repro_torch.train.optimizer import OptimizerConfig
from test_torch_export import XLA_RTOL, _run_xla, _smoke, _smoke_inputs

SEQ, BATCH = 16, 2
RANK_BATCH = 8
TEXTS = ["kernel", "chunked", "per-rank", "resnet18"]
_SSA = re.compile(r"%[\w.\-#]+")


# --------------------------------------------------------------------------
# the four texts and their inputs
# --------------------------------------------------------------------------

def _llama_cfg(impl: str):
    return dataclasses.replace(_smoke(impl), scan_layers=False,
                               layer_barriers=True)


@functools.lru_cache(maxsize=None)
def _text(source: str):
    """(workload, the whole module's inputs or None, fidelity)."""
    ocfg = OptimizerConfig()
    if source in ("kernel", "chunked", "kernel-whole"):
        cfg = _llama_cfg(source.split("-")[0])
        if source == "kernel-whole":
            cfg = dataclasses.replace(cfg, layer_barriers=False)
        step, args = train_step_exports(cfg, SEQ, BATCH, opt_cfg=ocfg)
        w = export_workload(step, *args, name=source, device="cpu")
        params, opt, batch = _smoke_inputs(cfg, ocfg)
        return w, pytree.tree_leaves((params, opt, batch)), "raw"
    if source == "per-rank":
        cfg = _smoke("kernel")
        step, args = train_step_exports(cfg, SEQ, RANK_BATCH, opt_cfg=ocfg)
        with traced_mesh((4, 1), "cpu") as mesh:
            rstep, rargs = train_step_exports(cfg, SEQ, RANK_BATCH, mesh,
                                              opt_cfg=ocfg)
            w = export_workload(step, *args, name=source, device="cpu",
                                per_rank=(rstep, rargs, mesh))
        return w, None, "optimized"
    assert source == "resnet18"
    cfg = tr.ResNetConfig(depth=18, width=8, dtype="float32",
                          num_classes=10, block_barriers=True)
    step, args = tr.resnet_train_exports(cfg, BATCH, 32)
    w = export_workload(step, *args, name=source, device="cpu")
    rng = np.random.default_rng(0)
    leaves = []
    for a in pytree.tree_leaves(args):
        if a.dtype.is_floating_point:
            scale = 0.1 if a.dim() > 1 else 1.0
            leaves.append(torch.from_numpy(rng.normal(
                0, scale, tuple(a.shape)).astype(np.float32)).to(a.dtype))
        else:
            leaves.append(torch.from_numpy(rng.integers(
                0, 10, tuple(a.shape)).astype(np.int32)).to(a.dtype))
    return w, leaves, "raw"


@functools.lru_cache(maxsize=None)
def _plan(source: str):
    w, _, fidelity = _text(source)
    return build_plan(w.program(fidelity), name=source, fidelity=fidelity,
                      calls=w.calls(fidelity))


@functools.lru_cache(maxsize=None)
def _record(source: str) -> dict:
    """Every value of the whole module's run on the step's inputs."""
    w, leaves, fidelity = _text(source)
    record: dict = {}
    Executor(w.program(fidelity), calls=w.calls(fidelity),
             device="cpu").run(leaves, record)
    record.update(zip([a for a, _ in w.program(fidelity).meta["func_args"]
                       ["main"]], leaves))
    return record


def _region_inputs(source: str, region, module: str, types) -> list:
    """The region's inputs: the whole run's values of the names that
    ``region_to_module`` renamed ``%rin0``, ``%rin1``... (its body's
    tokens are the region's, in order, after the inlined constants)."""
    if _text(source)[1] is None:
        return synthetic(types, "cpu")
    ours = _SSA.findall("\n".join(op.raw for op in region.ops))
    main = module[module.index("func.func public @main"):]
    body = _SSA.findall(main[main.index("\n"):main.rindex("return")])
    names = {}
    for old, new in zip(ours, body[len(body) - len(ours):]):
        names.setdefault(new, old)
    record = _record(source)
    return [record[names[f"%rin{i}"]] for i in range(len(types))]


def _xla_text(module: str, calls: dict) -> str:
    """The module as XLA reads it: ``@main`` typed as its body uses its
    arguments and results.  The reference's ``region_to_module`` declares
    an argument defined by an op printed over several lines with the type
    the front end reads from that op's attributes (a ``reduce_window``'s
    ``tensor<4x2xi64>``), and returns a multi-result op's bare name, when
    none of the op's results is used inside the region, typed as its last
    result, where MLIR reads a bare name as the first result.  XLA refuses
    both; the executor takes the body's types, and so does XLA here."""
    ex = Executor(module, calls=calls, device="cpu")
    lines = module.splitlines()
    i = next(k for k, line in enumerate(lines)
             if line.startswith("  func.func public @main("))
    j = max(k for k, line in enumerate(lines)
            if line.startswith("    return "))

    def ty(t):
        return f"tensor<{t}>"
    args = ", ".join(f"{n}: {ty(t)}" for n, t in zip(ex.main.params,
                                                      ex.input_types))
    rets = ", ".join(ty(t) for t in ex.output_types)
    lines[i] = f"  func.func public @main({args}) -> ({rets}) {{"
    lines[j] = lines[j].split(" : ")[0] + f" : {rets}"
    return "\n".join(lines) + "\n"


def _largest(arrays) -> float:
    """The largest finite magnitude among the float arrays."""
    return max((float(np.abs(w[np.isfinite(w)]).max(initial=0.0))
                for w in map(np.asarray, arrays) if w.dtype.kind == "f"),
               default=0.0)


def _assert_close(got, want, label, scale: float | None = None) -> None:
    """Equal shapes, equal integers and booleans, NaN where XLA has NaN,
    and each float output within ``XLA_RTOL`` of its own largest
    magnitude, or of ``scale`` when given."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy() if g.dtype != torch.bool else \
            g.numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), (label, i)
            continue
        w = w.astype(np.float32)
        assert np.array_equal(np.isnan(g), np.isnan(w)), (label, i)
        finite = np.isfinite(w)
        assert np.array_equal(g[~finite], w[~finite]) or \
            np.all(np.isnan(w[~finite])), (label, i)
        own = scale if scale is not None else \
            float(np.abs(w[finite]).max(initial=0.0))
        own = max(own, 1e-30)
        err = float(np.abs(g[finite] - w[finite]).max(initial=0.0))
        assert err <= XLA_RTOL * own, (label, i, err / own)


# --------------------------------------------------------------------------
# (i) region_to_module: the reference's text
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source", TEXTS)
def test_region_modules_are_the_references_byte_for_byte(source):
    """Every region of the text, from the Program both front ends read:
    the same module text and input types, or the same error.  The
    per-rank text's regions that take a reduce-scatter's or an
    all-reduce's result do not re-emit in either package (the front end
    leaves a collective printed with its reduction region untyped); the
    profiling estimator re-emits from :func:`typed_program`."""
    w, _, fidelity = _text(source)
    text = w.hlo_text if fidelity == "optimized" else w.stablehlo_text
    program, jax_program = ir.parse(text), jax_ir.parse(text)
    ours = [s.region for s in linear_split(program) if s.kind == "COMP"]
    theirs = [s.region for s in jax_linear_split(jax_program)
              if s.kind == "COMP"]
    assert len(ours) == len(theirs) > 1
    refused = 0
    for a, b in zip(ours, theirs):
        try:
            ref = jax_region_to_module(b.ops, jax_program, name="r")
        except JaxRegionEmitError as e:
            refused += 1
            with pytest.raises(RegionEmitError, match=re.escape(str(e))):
                region_to_module(a.ops, program, name="r")
            continue
        mine = region_to_module(a.ops, program, name="r")
        assert mine[0] == ref[0]
        assert [(t.shape, t.dtype) for t in mine[1]] == \
            [(t.shape, t.dtype) for t in ref[1]]
        # a typed program changes only the declared types
        typed = region_to_module(a.ops, typed_program(program), name="r")
        assert _SSA.findall(typed[0]) == _SSA.findall(mine[0])
    assert (refused > 0) == (source == "per-rank")


def test_a_region_the_emitter_cannot_write_raises_its_error():
    program = ir.parse(_text("kernel")[0].stablehlo_text)
    program.dialect = "hlo"
    with pytest.raises(RegionEmitError, match="stablehlo"):
        region_to_module(program.entry[:3], program)


# --------------------------------------------------------------------------
# (ii) the executor against XLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source", TEXTS)
def test_every_region_runs_to_xlas_outputs(source):
    """Each region's outputs within ``XLA_RTOL`` of the largest magnitude
    among them: a region's outputs include values that are rounding by
    math (the gradient of the chunked softmax's running maximum, about
    1e-11 beside values of 1; with the per-rank text's synthetic inputs,
    sums that cancel), which have no scale of their own."""
    plan = _plan(source)
    regions = plan.compute_regions
    assert len(regions) > 1
    for i, region in enumerate(regions):
        module, _ = region_to_module(region.ops, typed_program(plan.program),
                                     name="profiled_region")
        ex = Executor(module, calls=plan.calls, device="cpu")
        inputs = _region_inputs(source, region, module, ex.input_types)
        got = ex.run(inputs)
        want = _run_xla(_xla_text(module, plan.calls), inputs)
        _assert_close(got, want, (source, i), _largest(want))


@pytest.mark.parametrize("source", ["kernel", "chunked", "resnet18"])
def test_the_whole_module_runs_to_xlas_outputs(source):
    w, leaves, fidelity = _text(source)
    got = Executor(w.stablehlo_text, calls=w.calls(fidelity),
                   device="cpu").run(leaves)
    _assert_close(got, _run_xla(w.stablehlo_text, leaves), source)


def _emitter_ops() -> set[str]:
    """Every op name ``core/stablehlo.py`` can write into a region (its
    collectives lie between regions)."""
    src = inspect.getsource(stablehlo)
    names = (set(re.findall(r"stablehlo\.(\w+)", src))
             | set(stablehlo._UNARY.values()) | set(stablehlo._BINARY.values())
             | set(re.findall(r'region_op\(\s*"(\w+)"', src)) | {"call"})
    return names - {"return", "channel_handle"}


# ops that none of the port's models writes, each held alone below
ALONE = {"tanh", "or"}


def test_the_texts_hold_every_op_the_emitter_writes():
    """The ops the two tests above run: every region's, and the whole
    modules' (whose layer and block barriers no region holds: the linear
    slicer cuts at them)."""
    ops = set()
    for source in TEXTS:
        plan = _plan(source)
        for region in plan.compute_regions:
            ops.update(op.op for op in region.ops)
        if source != "per-rank":
            ops.update(op.op for op in plan.program.walk())
    assert _emitter_ops() <= set(_OPS)
    assert _emitter_ops() - ops == ALONE


def _module(body: str, args: str, ret: str) -> str:
    return (f"module @m {{\n  func.func public @main({args}) -> {ret} {{\n"
            f"{body}\n  }}\n}}\n")


@pytest.mark.parametrize("op,dt", [("tanh", "f32"), ("or", "i1")])
def test_an_op_no_model_writes_runs_to_xlas_output(op, dt):
    ty = f"tensor<4x8x{dt}>"
    if op == "tanh":
        body = f"    %0 = stablehlo.tanh %arg0 : {ty}\n    return %0 : {ty}"
        args = f"%arg0: {ty}"
        inputs = [torch.linspace(-3, 3, 32).reshape(4, 8)]
    else:
        body = (f"    %0 = stablehlo.or %arg0, %arg1 : {ty}\n"
                f"    return %0 : {ty}")
        args = f"%arg0: {ty}, %arg1: {ty}"
        inputs = [torch.arange(32).reshape(4, 8) % 2 == 0,
                  torch.arange(32).reshape(4, 8) % 3 == 0]
    text = _module(body, args, ty)
    _assert_close(Executor(text, device="cpu").run(inputs),
                  _run_xla(text, inputs), op)


# a convolution in each of JAX's three forms, and the lhs-dilated form
# that is not a transposed convolution (a pad wider than the kernel)
CONVS = {
    "forward": ("[b, f, 0, 1]x[o, i, 0, 1]->[b, f, 0, 1]", (2, 3, 9, 9),
                (4, 3, 3, 3), "stride = [2, 2], pad = [[0, 1], [1, 1]], "
                "lhs_dilate = [1, 1], rhs_dilate = [1, 1]", (2, 4, 4, 5)),
    "data gradient": ("[b, f, 0, 1]x[i, o, 0, 1]->[b, f, 0, 1]",
                      (2, 4, 4, 4), (4, 3, 3, 3),
                      "stride = [1, 1], pad = [[2, 2], [1, 2]], "
                      "lhs_dilate = [2, 2], rhs_dilate = [1, 1]",
                      (2, 3, 9, 8)),
    "weight gradient": ("[f, b, 0, 1]x[i, o, 0, 1]->[f, b, 0, 1]",
                        (2, 3, 9, 9), (2, 4, 4, 4),
                        "stride = [1, 1], pad = [[0, 1], [1, 0]], "
                        "lhs_dilate = [1, 1], rhs_dilate = [2, 2]",
                        (4, 3, 4, 4)),
    "dilated, wide pad": ("[b, f, 0, 1]x[o, i, 0, 1]->[b, f, 0, 1]",
                          (2, 3, 4, 4), (4, 3, 2, 2),
                          "stride = [1, 1], pad = [[3, 3], [2, 2]], "
                          "lhs_dilate = [2, 2], rhs_dilate = [1, 1], "
                          "reverse = [true, false]", (2, 4, 12, 10)),
}


@pytest.mark.parametrize("form", CONVS)
def test_each_convolution_form_runs_to_xlas_output(form):
    dims, lhs, rhs, window, out = CONVS[form]
    t = [f"tensor<{'x'.join(map(str, s))}xf32>" for s in (lhs, rhs, out)]
    body = (f"    %0 = stablehlo.convolution(%arg0, %arg1) dim_numbers = "
            f"{dims}, window = {{{window}}} {{batch_group_count = 1 : i64, "
            "feature_group_count = 1 : i64, precision_config = "
            "[#stablehlo<precision DEFAULT>, #stablehlo<precision "
            f"DEFAULT>]}} : ({t[0]}, {t[1]}) -> {t[2]}\n"
            f"    return %0 : {t[2]}")
    text = _module(body, f"%arg0: {t[0]}, %arg1: {t[1]}", t[2])
    gen = torch.Generator().manual_seed(0)
    inputs = [torch.randn(lhs, generator=gen), torch.randn(rhs, generator=gen)]
    _assert_close(Executor(text, device="cpu").run(inputs),
                  _run_xla(text, inputs), form)


# --------------------------------------------------------------------------
# (iii) a call through the table equals its body
# --------------------------------------------------------------------------

def test_each_call_through_its_operator_equals_its_body():
    """The kernel text without barriers is one region, whose calls are
    K1 (with its log-sum-exp), K1b, K2 and K2b: each, on the values the
    whole step gives it, through the ``call`` table's operator and
    arguments (on the CPU the plain version) equals its private function
    run op by op."""
    w, leaves, _ = _text("kernel-whole")
    plan = build_plan(w.program("raw"), calls=w.calls("raw"))
    (region,) = plan.compute_regions
    ex = Executor(plan.program, calls=plan.calls, device="cpu")
    record = _record("kernel-whole")
    seen = set()
    for op in region.ops:
        if op.op != "call":
            continue
        name = op.called[0]
        entry = plan.calls[name]
        seen.add(entry.op)
        inputs = [record[n] for n in op.operands]
        through = entry.overload(*entry.bind(inputs))
        through = list(through) if isinstance(through, (tuple, list)) \
            else [through]
        _assert_close(through, [t.numpy() for t in
                                ex.run_function(name, inputs)], name)
    assert seen == {"repro_torch::flash_attention_lse",
                    "repro_torch::flash_attention_bwd",
                    "repro_torch::rmsnorm", "repro_torch::rmsnorm_bwd"}


def test_the_call_table_names_each_operator_and_its_arguments():
    calls = _text("kernel")[0].calls("raw")
    cfg = _llama_cfg("kernel")
    by_op = {}
    for name, entry in calls.items():
        assert name.startswith("repro_torch.")
        by_op.setdefault(entry.op, []).append(entry)
    (k1,) = by_op["repro_torch::flash_attention_lse"]
    assert k1.args[3:] == (True, 0, 0.0, 0)
    assert [a.index for a in k1.args[:3]] == [0, 1, 2]
    for entry in by_op["repro_torch::rmsnorm"]:
        assert entry.args[2:] == (cfg.rms_eps, 0.0)
    # the text's bytes carry none of it
    assert "eps" not in _text("kernel")[0].stablehlo_text


# --------------------------------------------------------------------------
# (iv) the estimator, its failures, the host system
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source", TEXTS)
def test_the_estimator_profiles_every_region_without_an_emit_failure(
        source):
    plan = _plan(source)
    est = ProfilingEstimator(program=plan.program, calls=plan.calls,
                             runs=1, device="cpu")
    times = est.get_run_time_estimates(plan.compute_regions)
    assert est.emit_failures == 0
    assert all(t > 0 for t in times)
    assert est.system.name == "host-cpu"
    assert est.toolchain == "torch-eager"


def test_an_unknown_op_raises_naming_itself_and_falls_back_counted():
    ty = "tensor<4xf32>"
    text = _module(f"    %0 = stablehlo.cbrt %arg0 : {ty}\n"
                   f"    return %0 : {ty}", f"%arg0: {ty}", ty)
    with pytest.raises(NotImplementedError, match="cbrt"):
        Executor(text, device="cpu")
    program = ir.parse(text)
    plan = build_plan(program)
    est = ProfilingEstimator(program=program, runs=1, device="cpu")
    (region,) = plan.compute_regions
    assert est.get_run_time_estimate(region) == \
        est.fallback.get_run_time_estimate(region)
    assert est.emit_failures == 1


def test_a_library_call_missing_from_the_table_raises():
    plan = _plan("kernel")
    with pytest.raises(ValueError, match="call table"):
        Executor(plan.program, calls={}, device="cpu")
    region = next(r for r in plan.compute_regions
                  if any(op.op == "call" for op in r.ops))
    est = ProfilingEstimator(program=plan.program, runs=1, device="cpu")
    with pytest.raises(ValueError, match="call table"):
        est.get_run_time_estimate(region)
    assert est.emit_failures == 0


def test_ground_truth_and_projection():
    """On ``host`` the measured time is the latency; onto another system
    it is rescaled by the two systems' roofline ratio."""
    plan = _plan("kernel")
    host = host_system("cpu")
    from repro_torch.core.catalog import default_registry
    h100 = default_registry().get("h100")
    region = plan.compute_regions[0]
    est = ProfilingEstimator(program=plan.program, calls=plan.calls,
                             target_system=h100, device="cpu")
    assert est.system is host
    projected = est._project(region, 1.0)
    ratios = {host.flops_for(d) / h100.flops_for(d) for d in ("f32",)} | \
        {host.mem_bw / h100.mem_bw}
    assert projected in ratios
    assert est.cache_hw_key == "host-cpu->H100-80GB-SXM"
    native = ProfilingEstimator(program=plan.program, device="cpu")
    assert native._project(region, 1.0) == 1.0
    assert native.cache_hw_key == "host-cpu->native"
    assert native.get_exec_args()["runs"] == 5


# --------------------------------------------------------------------------
# resnet18's block barriers against JAX's text
# --------------------------------------------------------------------------

def test_resnet_block_barriers_cut_jaxs_regions():
    """resnet18 with ``block_barriers``: as many barriers as JAX's text,
    and the linear slicer cuts both into regions of equal convolution and
    ``dot_general`` FLOPs, in order."""
    w = _text("resnet18")[0]
    jcfg = jr.ResNetConfig(depth=18, width=8, dtype="float32",
                           num_classes=10, block_barriers=True)
    jstep, jargs = jr.resnet_train_exports(jcfg, BATCH, 32)
    jtext = jax_export_workload(jstep, *jargs,
                                compile_workload=False).stablehlo_text
    count = "stablehlo.optimization_barrier"
    assert w.stablehlo_text.count(count) == jtext.count(count) == 16

    def regions(text):
        cut = jax_linear_split(jax_ir.parse(text))
        return [(round(r.cost.by_op.get("convolution", 0.0)),
                 round(r.cost.by_op.get("dot_general", 0.0)))
                for r in (s.region for s in cut if s.kind == "COMP")]
    ours, theirs = regions(w.stablehlo_text), regions(jtext)
    assert len(ours) == len(theirs) == 17
    assert ours == theirs
