"""The port's export slice against the JAX package, on the CPU.

The port traces its train step (and its forward) on fake tensors and emits
StableHLO text; here that text is held against the reference's export of
the same step: equal ``dot_general`` FLOPs by the reference's cost model
(and by the port's copy of it) for fig6's three llama3 cells, equal Programs
from both of the reference's front ends and from the port's copies, XLA on
the CPU running the text to the port's own eager results, the layer
barriers, and the kernels as opaque operators that tracing never launches.

A CPU-only PyTorch cannot run autograd or indexing on fake ``cuda`` tensors
(it has no CUDA device guard), so the trace on a ``cuda`` device runs on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 8.  Here the
card's configuration (``attn_impl="kernel"``) is traced on ``cpu``; the
operators' fakes are the same on both devices.

The file takes about two minutes alone and about three beside five other
pytest workers; (a), its three cells, about 50 s alone and 100 s beside
them.  Most of the rest is the llama3-1b traces of (b), (c) and (e).
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax._src import compiler, xla_bridge
from jax._src.lib import xla_client
from torch.utils import _pytree as pytree

from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models.registry import get_config as jax_get_config
from repro.train.loop import train_step_exports as jax_train_step_exports
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ir
from repro_torch.core.export import trace
from repro_torch.core.pipeline import Workload, export_workload
from repro_torch.core.stablehlo import emit
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import registry
from repro_torch.models.params import abstract_params, init_params
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import model_specs
from repro_torch.train.loop import (forward_exports, make_train_step,
                                    train_step_exports)
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

SEQ, BATCH = 2048, 4
FIG6 = ["llama3-100m", "llama3-500m", "llama3-1b"]
# the JAX raw export of llama3-1b's train step at 4x2048
LLAMA3_1B_FLOPS = 57_724_360_458_240
# K1's plain backward recomputes the scores: one more [S, S] product of
# 2 B Hq S^2 D FLOPs a layer than autograd of the chunked attention takes
K1_RECOMPUTE = 16 * 2 * BATCH * 32 * SEQ ** 2 * 64


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch), **kw)


@functools.lru_cache(maxsize=None)
def _port(arch: str, attn_impl: str, barriers: bool = False) -> Workload:
    kw = dict(scan_layers=False, layer_barriers=True) if barriers else {}
    step, args = train_step_exports(_cfg(arch, attn_impl=attn_impl, **kw),
                                    SEQ, BATCH)
    return export_workload(step, *args, name=arch, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(arch: str) -> str:
    step, args = jax_train_step_exports(jax_get_config(arch), SEQ, BATCH)
    return jax_export_workload(step, *args, name=arch,
                               compile_workload=False).stablehlo_text


def _dot_flops(cost) -> int:
    return int(cost.by_op["dot_general"])


# --------------------------------------------------------------------------
# (a) equal dot_general FLOPs with the JAX export, fig6's three cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FIG6)
def test_train_step_flops_equal_the_jax_export(arch):
    text = _port(arch, "chunked").stablehlo_text
    ours = _dot_flops(jax_ir.program_cost(jax_ir.parse(text)))
    theirs = _dot_flops(jax_ir.program_cost(jax_ir.parse(_jax(arch))))
    assert ours == theirs
    assert _dot_flops(ir.program_cost(ir.parse(text))) == ours
    if arch == "llama3-1b":
        assert ours == LLAMA3_1B_FLOPS


def test_forward_flops_against_the_jax_export():
    """The forward pass (what the reference's campaign exports for
    ``mode="forward"``) runs the same products as JAX's."""
    cfg = _cfg("llama3-1b", attn_impl="chunked")
    step, args = forward_exports(cfg, SEQ, BATCH)
    text = export_workload(step, *args, device="cpu").stablehlo_text
    jcfg = jax_get_config("llama3-1b")
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.models import input_specs
    from repro.models.params import abstract_params as jax_abstract
    from repro.models.transformer import forward, model_specs as jax_specs
    jtext = jax_export_workload(
        jax.jit(lambda p, b: forward(jcfg, p, b)),
        jax_abstract(jax_specs(jcfg)),
        input_specs(jcfg, JaxShape("f", SEQ, BATCH, "train")),
        compile_workload=False).stablehlo_text
    assert (_dot_flops(ir.program_cost(ir.parse(text)))
            == _dot_flops(jax_ir.program_cost(jax_ir.parse(jtext))))


# --------------------------------------------------------------------------
# (b) the card's configuration: opaque operators, nothing launched
# --------------------------------------------------------------------------

def _counters():
    return [f.launches for f in (flash_attention, flash_attention_bwd,
                                 rmsnorm, rmsnorm_bwd, ssd_scan)]


@pytest.fixture
def no_launch(monkeypatch):
    """Building the library or reading a pointer fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the trace built or launched a kernel")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(torch.Tensor, "data_ptr", refuse)
    before = _counters()
    yield
    assert _counters() == before


def test_kernel_configuration_traces_opaque_operators(no_launch):
    w = _port.__wrapped__("llama3-1b", "kernel")    # traced here, not cached
    assert w.meta["kernel_ops"] == {"flash_attention_lse": 16,
                                    "flash_attention_bwd": 16,
                                    "rmsnorm": 33, "rmsnorm_bwd": 33}
    text = w.stablehlo_text
    assert (_dot_flops(jax_ir.program_cost(jax_ir.parse(text)))
            == LLAMA3_1B_FLOPS + K1_RECOMPUTE == 58_823_872_086_016)
    # each call is a call of its operator's plain version
    calls = [ln for ln in text.splitlines() if " = call @repro_torch." in ln]
    assert len(calls) == 16 + 16 + 33 + 33
    assert w.meta["trace_s"] > 0 and w.meta["text_bytes"] == len(
        text.encode())


def test_forward_traces_one_node_per_kernel_call(no_launch):
    step, args = forward_exports(get_config("llama3-1b"), SEQ, BATCH)
    traced = trace(step, *args, device="cpu")
    assert traced.op_counts == {"flash_attention": 16, "rmsnorm": 33}
    # one plain-version function for each distinct call
    assert len(traced.plain) == 2


# --------------------------------------------------------------------------
# (c) both front ends, the reference's and the port's copies
# --------------------------------------------------------------------------

def _port_programs_equal_reference(text: str) -> None:
    for frontend in ("legacy", "streaming"):
        ref = jax_ir.parse_stablehlo(text, frontend=frontend)
        ours = ir.parse_stablehlo(text, frontend=frontend)
        # two packages' dataclasses: equal fields print equally
        assert repr(ours) == repr(ref), frontend


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_reference_front_ends_agree_on_the_port_text(impl):
    text = _port("llama3-1b", impl).stablehlo_text
    jax_ir.assert_programs_equal(
        jax_ir.parse_stablehlo(text, frontend="legacy"),
        jax_ir.parse_stablehlo(text, frontend="streaming"))
    ir.assert_programs_equal(ir.parse_stablehlo(text, frontend="legacy"),
                             ir.parse_stablehlo(text, frontend="streaming"))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_port_ir_copies_equal_the_reference(source):
    text = (_port("llama3-1b", "chunked").stablehlo_text if source == "port"
            else _jax("llama3-1b"))
    _port_programs_equal_reference(text)


# --------------------------------------------------------------------------
# (d) XLA runs the emitted text to the port's eager results
# --------------------------------------------------------------------------

# An f32 step in two compilers: sums in another order and other exp/log
# approximations.  Weights are N(0, 0.02) (the "normal" init) so that the
# step is well conditioned: with the reference's scaled init at the smoke
# width the softmax is near one-hot, and rounding differences grow through
# it.  Each output is held within 2^-16 (1.5e-5) of its largest magnitude;
# a wrong lowering moves outputs by far more.
XLA_RTOL = 2.0 ** -16


def _smoke(attn_impl):
    # two attention chunks over the 16 tokens: the chunked path's slices
    return _cfg("llama3-1b", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
                attn_impl=attn_impl, attn_chunk=8)


def _smoke_inputs(cfg, ocfg):
    rng = np.random.default_rng(0)
    params = pytree.tree_map(
        lambda t: (torch.from_numpy(rng.normal(0, 0.02, t.shape)
                                    .astype(np.float32)) if t.dim() > 1
                   else torch.ones(t.shape)),
        init_params(model_specs(cfg), torch.Generator(), "cpu"))
    init, _ = make_optimizer(ocfg)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                              dtype=np.int32))
             for k in ("tokens", "targets")}
    return params, init(params, ocfg), batch


def _run_xla(text: str, leaves):
    backend = xla_bridge.get_backend("cpu")
    devs = backend.devices()[:1]
    exe = backend.compile_and_load(text, xla_client.DeviceList(tuple(devs)),
                                   compiler.get_compile_options(1, 1))
    out = exe.execute([backend.buffer_from_pyval(x.numpy(), devs[0])
                       for x in leaves])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("impl,optimizer", [
    ("chunked", "adamw"), ("kernel", "adamw"), ("dense", "adafactor")])
def test_xla_runs_the_text_to_the_eager_step(impl, optimizer):
    cfg, ocfg = _smoke(impl), OptimizerConfig(name=optimizer)
    params, opt, batch = _smoke_inputs(cfg, ocfg)
    step, args = train_step_exports(cfg, 16, 2, opt_cfg=ocfg)
    text = export_workload(step, *args, device="cpu").stablehlo_text
    got = _run_xla(text, pytree.tree_leaves((params, opt, batch)))
    want, _ = pytree.tree_flatten_with_path(
        make_train_step(cfg, ocfg)(params, opt, batch))
    assert len(got) == len(want)
    names = set()
    for (path, w), g in zip(want, got):
        name = pytree.keystr(path)
        names.add(name)
        w = w.detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= XLA_RTOL * scale, name
    assert {"[2]['loss']", "[2]['grad_norm']", "[1]['step']"} <= names


# --------------------------------------------------------------------------
# (e) layer barriers
# --------------------------------------------------------------------------

def test_layer_barriers_as_in_the_jax_export():
    ours = _port("llama3-1b", "chunked", barriers=True).stablehlo_text
    jcfg = dataclasses.replace(jax_get_config("llama3-1b"),
                               scan_layers=False, layer_barriers=True)
    step, args = jax_train_step_exports(jcfg, SEQ, BATCH)
    theirs = jax_export_workload(step, *args,
                                 compile_workload=False).stablehlo_text
    count = "stablehlo.optimization_barrier"
    assert ours.count(count) == theirs.count(count) == 32
    assert (_dot_flops(jax_ir.program_cost(jax_ir.parse(ours)))
            == _dot_flops(jax_ir.program_cost(jax_ir.parse(theirs)))
            == LLAMA3_1B_FLOPS)
    # the torch text has no layer loop (the reference's default has one)
    assert "stablehlo.while" not in ours


@pytest.mark.parametrize("scan_layers", [True, False])
def test_barriers_leave_the_eager_step_bit_identical(scan_layers):
    ocfg = OptimizerConfig()
    runs = []
    for barriers in (False, True):
        cfg = dataclasses.replace(_smoke("chunked"), scan_layers=scan_layers,
                                  layer_barriers=barriers)
        params, opt, batch = _smoke_inputs(cfg, ocfg)
        runs.append(pytree.tree_leaves(
            make_train_step(cfg, ocfg)(params, opt, batch)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_barrier_count_follows_the_reference_rule():
    """A barrier after each layer only when the stack is unrolled, and an
    optimization_barrier on the value and on its cotangent."""
    for scan_layers, want in ((False, 4), (True, 0)):
        cfg = dataclasses.replace(_smoke("chunked"), scan_layers=scan_layers,
                                  layer_barriers=True)
        step, args = train_step_exports(cfg, 16, 2)
        w = export_workload(step, *args, device="cpu")
        assert w.stablehlo_text.count("stablehlo.optimization_barrier") \
            == want
        assert w.meta["kernel_ops"].get("barrier", 0) == want


# --------------------------------------------------------------------------
# (f) no silent skip; the workload and the abstract arguments
# --------------------------------------------------------------------------

def test_an_op_with_no_lowering_raises_and_names_it():
    def f(x):
        return torch.cumsum(x, dim=0)

    traced = trace(f, torch.empty(8, 4, device="meta"), device="cpu")
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        emit(traced)


def test_optimized_fidelity_raises_for_a_torch_export():
    w = Workload("w", stablehlo_text=_port("llama3-1b", "kernel")
                 .stablehlo_text)
    assert w.program("raw").num_ops > 0
    with pytest.raises(ValueError, match="optimized"):
        w.program("optimized")
    with pytest.raises(ValueError):
        w.program("fused")


def test_abstract_arguments_match_the_reference():
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.models import registry as jax_registry
    from repro.models.params import abstract_params as jax_abstract
    from repro.models.transformer import model_specs as jax_specs

    def shapes(tree):
        return {pytree.keystr(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
                for p, x in pytree.tree_flatten_with_path(tree)[0]}

    def jshapes(tree):
        return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}

    for arch, kind in (("llama3-1b", "train"), ("llama3-1b", "decode"),
                       ("mamba2-370m", "decode")):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        shape, jshape = ShapeConfig("s", 128, 8, kind), JaxShape(
            "s", 128, 8, kind)
        assert shapes(registry.input_specs(cfg, shape)) == jshapes(
            jax_registry.input_specs(jcfg, jshape))
        assert shapes(registry.cache_specs_abstract(cfg, shape)) == jshapes(
            jax_registry.cache_specs_abstract(jcfg, jshape))
        assert shapes(abstract_params(model_specs(cfg))) == jshapes(
            jax_abstract(jax_specs(jcfg)))
    ps = abstract_params(model_specs(get_config("llama3-1b")))
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(ps))
    with pytest.raises(NotImplementedError, match="distribution"):
        registry.input_specs(get_config("llama3-1b"),
                             ShapeConfig("s", 128, 8, "train"), mesh=object())
    assert math.prod(ps["embed"].shape) == 32768 * 2048
