"""The families' train steps exported on the CPU, against the JAX package.

Every family the port serves also trains, and its train step exports to
StableHLO: mixtral-8x22b (the MoE's backward: the gradient of its
``index_add`` as a ``gather``, of its ``topk`` as a replacing ``scatter``),
gemma2-27b, qwen2.5-32b, deepseek-67b, mamba2-370m (its ``split`` of
the projection into slices, softplus's ``log_plus_one``, the depthwise
causal conv as the reference writes it, the backward of ``cumsum`` as a
``reverse``), stablelm-12b, zamba2-2.7b (the hybrid: Mamba2 layers and
one shared attention block, whose weights' gradient sums its uses),
deepseek-v3-671b (MLA before a sigmoid-gated MoE), qwen2-vl-7b (M-RoPE:
its text takes the three position streams as an input, as JAX's does) and
the encoder-only hubert-xlarge.  At
smoke size in f32, with two SSD chunks so that the states' gradients are
taken as JAX takes them:

* (d) the campaign's text (chunked attention) of each train step, and
  mamba2's forward, reads through both front ends to the JAX export's
  ``dot_general`` FLOPs;
* (e) XLA runs mixtral's, mamba2's, qwen2-vl-7b's (M-RoPE over an
  image's three position streams) and hubert-xlarge's (frame embeddings,
  no causal mask) train texts on the CPU to the eager step's outputs:
  loss, gradient norm, new parameters and moments; and deepseek-v3-671b's
  under Adafactor taken a slice of a leaf at a time;
* (f) the executor (``core/executor.py``) runs each op these texts added
  to XLA's values, alone and in the whole mamba2 and mixtral texts; the
  card's configuration's mamba2 text has one ``call`` of
  ``ssd_scan_states`` and one of ``ssd_scan_bwd`` a layer, each of which,
  through the text's call table (their plain versions here), equals its
  body run by XLA.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models import registry as jax_registry
from repro.train.loop import train_step_exports as jax_train_step_exports
from repro_torch.core import ir
from repro_torch.core.executor import Executor
from repro_torch.core.pipeline import export_workload
from repro_torch.models import registry
from repro_torch.train.loop import (forward_exports, make_train_step,
                                    train_step_exports)
from repro_torch.train import optimizer
from repro_torch.train.optimizer import OptimizerConfig
from test_torch_export import XLA_RTOL, _run_xla
from test_torch_profiling import _assert_close, _module
from test_torch_qwen2_vl import image_streams

FAMILIES = ["mixtral-8x22b", "gemma2-27b", "qwen2.5-32b", "deepseek-67b",
            "mamba2-370m", "stablelm-12b", "zamba2-2.7b", "deepseek-v3-671b",
            "qwen2-vl-7b", "hubert-xlarge"]
# two of mamba2-smoke's 32-row chunks: with one chunk no state reaches a
# later chunk, and autograd prunes the gradients JAX's scan still takes
SEQ, BATCH = 64, 2


def _dot_flops(text, parser) -> int:
    return int(parser.program_cost(parser.parse(text)).by_op["dot_general"])


@functools.lru_cache(maxsize=None)
def _text(arch: str, impl: str = "chunked", kind: str = "train",
          dtype: str = "bfloat16"):
    cfg = registry.get_smoke_config(arch).scaled(attn_impl=impl, dtype=dtype)
    exports = train_step_exports if kind == "train" else forward_exports
    step, args = exports(cfg, SEQ, BATCH)
    return export_workload(step, *args, name=arch, device="cpu")


def _jax_text(arch: str, kind: str) -> str:
    jcfg = jax_registry.get_smoke_config(arch)
    if kind == "train":
        step, args = jax_train_step_exports(jcfg, SEQ, BATCH)
    else:
        import jax
        from repro.configs.base import ShapeConfig as JaxShape
        from repro.models import input_specs
        from repro.models import transformer as jax_tf
        from repro.models.params import abstract_params
        step = jax.jit(lambda p, b: jax_tf.forward(jcfg, p, b))
        args = (abstract_params(jax_tf.model_specs(jcfg)),
                input_specs(jcfg, JaxShape("f", SEQ, BATCH, "train")))
    return jax_export_workload(step, *args, name=arch,
                               compile_workload=False).stablehlo_text


# --------------------------------------------------------------------------
# (d) dot_general FLOPs equal the JAX export's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [(a, "train") for a in FAMILIES]
                         + [("mamba2-370m", "forward")])
def test_the_campaigns_text_has_the_jax_exports_flops(arch, kind):
    text = _text(arch, kind=kind).stablehlo_text
    theirs = _dot_flops(_jax_text(arch, kind), jax_ir)
    assert _dot_flops(text, jax_ir) == _dot_flops(text, ir) == theirs > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_cards_configuration_calls_each_kernel_once_a_layer(arch):
    """The card's text (``attn_impl="kernel"``, traced here on the CPU):
    each mixer's forward and backward operator once a layer, the norms'
    twice and once more for the final norm.  The hybrid's Mamba2 layers
    call the SSD scan's, and its shared attention block, once a
    super-block, K1's and two more norms.  MLA's layers call the norms four
    times (ln1, q_norm, kv_norm, ln2)."""
    cfg = registry.get_smoke_config(arch)
    ops = _text(arch, "kernel").meta["kernel_ops"]
    n = cfg.num_layers
    ssd = {"ssd_scan_states": n, "ssd_scan_bwd": n}
    if cfg.family == "hybrid":
        n_attn = n // cfg.hybrid_attn_every
        mixers = dict(ssd, flash_attention_lse=n_attn,
                      flash_attention_bwd=n_attn)
        norms = 2 * n + 2 * n_attn + 1
    else:
        mixers = ssd if cfg.family == "ssm" else {
            "flash_attention_lse": n, "flash_attention_bwd": n}
        norms = (4 if cfg.mla is not None else 2) * n + 1
    assert ops == dict(mixers, rmsnorm=norms, rmsnorm_bwd=norms)


# --------------------------------------------------------------------------
# (e) XLA runs the f32 train texts to the eager step
# --------------------------------------------------------------------------

def _step_inputs(cfg, ocfg, seed=0):
    """Parameters of std 0.3 (the router's top-k margins far above the
    rounding that separates XLA's products from torch's), the optimizer's
    initial state and a batch: tokens, or a stub front end's frame
    embeddings, and with M-RoPE an image's three position streams."""
    rng = np.random.default_rng(seed)
    step, args = train_step_exports(cfg, SEQ, BATCH, opt_cfg=ocfg)
    params = pytree.tree_map(
        lambda t: (torch.from_numpy(rng.normal(0, 0.3, tuple(t.shape))
                                    .astype(np.float32)) if t.dim() > 1
                   else torch.ones(tuple(t.shape))), args[0])
    opt = pytree.tree_map(lambda t: torch.zeros(tuple(t.shape),
                                                dtype=t.dtype), args[1])
    batch = {}
    for k, t in args[2].items():
        if k == "embeds":
            x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        elif k == "mrope_positions":
            x = image_streams(BATCH, SEQ, 5, 6)
        else:
            x = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
        batch[k] = torch.from_numpy(x)
    return params, opt, batch


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-370m",
                                  "qwen2-vl-7b", "hubert-xlarge"])
def test_xla_runs_the_train_text_to_the_eager_step(arch):
    cfg = registry.get_smoke_config(arch).scaled(attn_impl="chunked",
                                                 dtype="float32")
    ocfg = OptimizerConfig()
    params, opt, batch = _step_inputs(cfg, ocfg)
    text = _text(arch, dtype="float32").stablehlo_text
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


def test_xla_runs_the_sliced_adafactor_text_to_the_eager_step(monkeypatch):
    """deepseek-v3-671b's train step under Adafactor as the card runs it, a
    leaf's slices in two passes (here factored at 16 and cut at 4096
    elements, so that the smoke config's stacked leaves take both), exported
    in f32 and run by XLA to the eager step's outputs."""
    monkeypatch.setattr(optimizer, "SLICE_ELEMENTS", 4096)
    cfg = registry.get_smoke_config("deepseek-v3-671b").scaled(
        attn_impl="chunked", dtype="float32")
    ocfg = OptimizerConfig(name="adafactor", min_dim_size_to_factor=16)
    params, opt, batch = _step_inputs(cfg, ocfg)
    assert any(t.numel() > 4096 and t.dim() > 2
               for t in pytree.tree_leaves(params))
    step, args = train_step_exports(cfg, SEQ, BATCH, opt_cfg=ocfg)
    text = export_workload(step, *args, name="deepseek-v3-adafactor",
                           device="cpu").stablehlo_text
    got = _run_xla(text, pytree.tree_leaves((params, opt, batch)))
    want = pytree.tree_leaves(make_train_step(cfg, ocfg)(params, opt, batch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= XLA_RTOL * scale


# --------------------------------------------------------------------------
# (f) the executor runs each new op to XLA's values
# --------------------------------------------------------------------------

_REPLACE = (
    '    %0 = "stablehlo.scatter"(%arg0, %arg1, %arg2) '
    "<{indices_are_sorted = false, scatter_dimension_numbers = "
    "#stablehlo.scatter<inserted_window_dims = [1], input_batching_dims = "
    "[0], scatter_indices_batching_dims = [0], "
    "scatter_dims_to_operand_dims = [1], index_vector_dim = 2>, "
    "unique_indices = false}> ({\n"
    "    ^bb0(%lhs0: tensor<f32>, %rhs0: tensor<f32>):\n"
    "      stablehlo.return %rhs0 : tensor<f32>\n"
    "    }) : (tensor<4x8xf32>, tensor<4x3x1xi32>, tensor<4x3xf32>) -> "
    "tensor<4x8xf32>\n    return %0 : tensor<4x8xf32>")
_TAKE = (
    '    %0 = "stablehlo.gather"(%arg0, %arg1) <{dimension_numbers = '
    "#stablehlo.gather<offset_dims = [0, 2], collapsed_slice_dims = [1], "
    "start_index_map = [1], index_vector_dim = 1>, indices_are_sorted = "
    "false, slice_sizes = array<i64: 3, 1, 5>}> : (tensor<3x7x5xf32>, "
    "tensor<6x1xi32>) -> tensor<3x6x5xf32>\n"
    "    return %0 : tensor<3x6x5xf32>")
# one module per op: (body, arguments, result, inputs)
OPS = {
    "log_plus_one": (
        "    %0 = stablehlo.log_plus_one %arg0 : tensor<4x8xf32>\n"
        "    return %0 : tensor<4x8xf32>", "%arg0: tensor<4x8xf32>",
        "tensor<4x8xf32>", lambda: [torch.linspace(-0.9, 5, 32).reshape(4, 8)]),
    "and_i1": (
        "    %0 = stablehlo.and %arg0, %arg1 : tensor<4x8xi1>\n"
        "    return %0 : tensor<4x8xi1>",
        "%arg0: tensor<4x8xi1>, %arg1: tensor<4x8xi1>", "tensor<4x8xi1>",
        lambda: [torch.arange(32).reshape(4, 8) % 2 == 0,
                 torch.arange(32).reshape(4, 8) % 3 == 0]),
    "reverse": (
        "    %0 = stablehlo.reverse %arg0, dims = [0, 2] : tensor<3x4x5xf32>\n"
        "    return %0 : tensor<3x4x5xf32>", "%arg0: tensor<3x4x5xf32>",
        "tensor<3x4x5xf32>", lambda: [torch.arange(60.0).reshape(3, 4, 5)]),
    # a replacing scatter along dim 1, one index out of range (dropped)
    "scatter_replace": (
        _REPLACE, "%arg0: tensor<4x8xf32>, %arg1: tensor<4x3x1xi32>, "
        "%arg2: tensor<4x3xf32>", "tensor<4x8xf32>",
        lambda: [torch.arange(32.0).reshape(4, 8),
                 torch.tensor([[[0], [5], [7]], [[1], [2], [3]],
                               [[6], [9], [4]], [[7], [0], [2]]],
                              dtype=torch.int32),
                 -torch.arange(12.0).reshape(4, 3) - 1]),
    # jnp.take along dim 1 (index_select), one index out of range (clamped)
    "gather_take": (
        _TAKE, "%arg0: tensor<3x7x5xf32>, %arg1: tensor<6x1xi32>",
        "tensor<3x6x5xf32>",
        lambda: [torch.arange(105.0).reshape(3, 7, 5),
                 torch.tensor([[6], [0], [3], [3], [9], [1]],
                              dtype=torch.int32)]),
    "f64": (
        "    %0 = stablehlo.convert %arg0 : (tensor<4x8xf32>) -> "
        "tensor<4x8xf64>\n"
        "    %1 = stablehlo.constant dense<0.1> : tensor<f64>\n"
        "    %2 = stablehlo.broadcast_in_dim %1, dims = [] : (tensor<f64>) "
        "-> tensor<4x8xf64>\n"
        "    %3 = stablehlo.multiply %0, %2 : tensor<4x8xf64>\n"
        "    return %3 : tensor<4x8xf64>", "%arg0: tensor<4x8xf32>",
        "tensor<4x8xf64>", lambda: [torch.linspace(-3, 3, 32).reshape(4, 8)]),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_each_new_op_runs_to_xlas_output(op):
    body, args, ret, inputs = OPS[op]
    text = _module(body, args, ret)
    xs = inputs()
    got = Executor(text, device="cpu").run(xs)
    want = _run_xla(text, xs)
    if op == "f64":
        assert got[0].dtype == torch.float64
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        return
    _assert_close(got, want, op)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-370m"])
def test_the_executor_runs_the_train_text_to_xlas_outputs(arch):
    cfg = registry.get_smoke_config(arch).scaled(attn_impl="chunked",
                                                 dtype="float32")
    w = _text(arch, dtype="float32")
    leaves = pytree.tree_leaves(_step_inputs(cfg, OptimizerConfig()))
    got = Executor(w.stablehlo_text, calls=w.calls("raw"),
                   device="cpu").run(leaves)
    _assert_close(got, _run_xla(w.stablehlo_text, leaves), arch)


def test_the_scans_calls_equal_their_bodies():
    """mamba2's train text in the card's configuration (f32): its
    ``ssd_scan_states`` and ``ssd_scan_bwd`` calls run through the call
    table (the plain versions) to the values XLA's run of the whole text
    gives; and the executor runs the whole text to XLA's outputs."""
    cfg = registry.get_smoke_config("mamba2-370m").scaled(dtype="float32")
    w = _text("mamba2-370m", "kernel", dtype="float32")
    calls = w.calls("raw")
    assert sorted({c.op for c in calls.values()}) == [
        "repro_torch::rmsnorm", "repro_torch::rmsnorm_bwd",
        "repro_torch::ssd_scan_bwd", "repro_torch::ssd_scan_states"]
    leaves = pytree.tree_leaves(_step_inputs(cfg, OptimizerConfig()))
    ex = Executor(w.stablehlo_text, calls=calls, device="cpu")
    got = ex.run(leaves)
    _assert_close(got, _run_xla(w.stablehlo_text, leaves), "mamba2 kernel")
    # each call of the scan's operators alone, on the values the whole
    # step gives it: through its operator, and its body run op by op
    record: dict = {}
    Executor(w.stablehlo_text, calls=calls, device="cpu").run(leaves, record)
    seen = set()
    for op in w.program("raw").walk():
        if op.op != "call" or op.called[0] not in calls:
            continue
        entry = calls[op.called[0]]
        if "ssd_scan" not in entry.op:
            continue
        seen.add(entry.op)
        inputs = [record[n] for n in op.operands]
        through = entry.overload(*entry.bind(inputs))
        _assert_close(list(through), [t.numpy() for t in ex.run_function(
            op.called[0], inputs)], op.called[0])
    assert seen == {"repro_torch::ssd_scan_states",
                    "repro_torch::ssd_scan_bwd"}
