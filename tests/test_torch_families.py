"""The families slice of the port against the JAX package, on the CPU in f32:
deepseek-67b and qwen2.5-32b (dense, GQA; qwen's QKV bias), gemma2-27b
(local and global layers, tanh caps on the scores and the logits, tied
embeddings, GeGLU) and mixtral-8x22b (sliding window, the sort-based sparse
MoE).  The same parameters (carried across by ``params_from_jax``) and the
same inputs (numpy's seeded generator) go through both packages:

* configs field for field, ``param_count``, the shape cells and skip
  reasons, the parameter trees;
* ``forward`` (loss and logits), ``prefill``, ``decode_step`` (logits and
  cache) and greedy tokens of each smoke config, mixtral's ring cache
  wrapping past its window, gemma2 up to its cache and the port's
  ``ValueError`` past it;
* ``moe_forward`` with and without capacity drops (the same tokens
  dropped), the DeepSeek-V3 gate branch, ``moe_aux_loss``;
* the forward export: ``dot_general`` FLOPs equal to the JAX export's, both
  front ends reading the text, XLA running it to the eager values; the
  MoE's FLOPs tracking top-k, not the expert count; the serving synth text.

Where routing decides an output, the test also holds that the smallest
top-k margin of the router logits exceeds twice the largest difference
between the two packages' router logits, so that a routing flip cannot
pass unseen.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compiler, xla_bridge
from jax._src.lib import xla_client
from torch.utils import _pytree as pytree

from repro.campaign.builders import _synthesize_serving as jax_synthesize
from repro.campaign.spec import WorkloadSpec as JaxWorkloadSpec
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models import common as jax_common
from repro.models import input_specs as jax_input_specs
from repro.models import mlp as jax_mlp
from repro.models import params as jax_params
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.models.attention import gqa_forward as jax_gqa_forward
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro_torch.campaign.builders import _synthesize_serving
from repro_torch.campaign.spec import WorkloadSpec
from repro_torch.core import ir
from repro_torch.core.pipeline import export_workload
from repro_torch.models import common, mlp, params, registry, transformer
from repro_torch.models.attention import gqa_forward
from repro_torch.serve.decode import greedy_decode
from repro_torch.train.loop import forward_exports

MODULE_TOL = dict(atol=2e-5, rtol=2e-5)   # one module in f32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # a whole LM in f32
FAMILIES = ["deepseek-67b", "qwen2.5-32b", "gemma2-27b", "mixtral-8x22b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the port's attention impls and the JAX package's counterparts
JAX_IMPL = {"kernel": "pallas", "chunked": "chunked", "dense": "dense"}
# the JAX export's run through XLA against the eager forward (f32)
XLA_RTOL = 2.0 ** -16


def _configs(arch, impl="kernel", **kw):
    """The same f32 smoke config in both packages.  gemma2's kernel path is
    held against the reference's plain chunked path: the reference's
    ``"pallas"`` path takes gemma2's per-layer window as a traced value,
    which its kernel does not apply (positions past the window differ by
    0.7) and whose fallback then leaks a tracer."""
    jimpl = ("chunked" if impl == "kernel" and arch == "gemma2-27b"
             else JAX_IMPL[impl])
    jcfg = jax_registry.get_smoke_config(arch).scaled(
        dtype="float32", attn_impl=jimpl, **kw)
    tcfg = registry.get_smoke_config(arch).scaled(dtype="float32",
                                                  attn_impl=impl, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jax_params.init_params(jax_tf.model_specs(jcfg),
                                jax.random.PRNGKey(seed))
    return jp, params.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batches(toks):
    targets = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targets)})


def _top_k_margin(logits: np.ndarray, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router logit
    (softmax and sigmoid keep the order)."""
    s = np.sort(logits, axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


def _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks) -> None:
    """Walk the layers of both packages (each on its own hidden state) and
    hold, at every MoE layer, the smallest top-k margin of the router
    logits above twice the largest difference between the packages'."""
    jb, tb = _batches(toks)
    b, s = toks.shape
    jh, th = jax_tf._embed(jcfg, jp, jb), transformer._embed(tcfg, tp, tb)
    jpos, tpos = jax_tf._positions(jb), transformer._positions(tb)
    tlayers = transformer._unstack(tp["layers"], tcfg.num_layers)
    d = jcfg.d_model
    for i, tl in enumerate(tlayers):
        jl = jax.tree.map(lambda x: x[i], jp["layers"])
        window = transformer._layer_window(tcfg, i)
        jh = jh + jax_gqa_forward(
            jcfg, jl["attn"], jax_common.rms_norm(jh, jl["ln1"],
                                                  jcfg.rms_eps),
            jpos, layer_window=window)
        th = th + gqa_forward(tcfg, tl["attn"],
                              common.rms_norm(th, tl["ln1"], tcfg.rms_eps),
                              tpos, layer_window=window)
        jx = jax_common.rms_norm(jh, jl["ln2"], jcfg.rms_eps)
        tx = common.rms_norm(th, tl["ln2"], tcfg.rms_eps)
        jr = np.asarray(jx.reshape(b * s, d) @ jl["moe"]["router"])
        tr = (tx.reshape(b * s, d) @ tl["moe"]["router"]).numpy()
        margin = _top_k_margin(tr, tcfg.moe.top_k)
        assert margin > 2 * float(np.abs(jr - tr).max()), (i, margin)
        jh = jh + jax_mlp.moe_forward(jcfg, jl["moe"], jx)
        th = th + mlp.moe_forward(tcfg, tl["moe"], tx)


# --------------------------------------------------------------------------
# configs, parameter trees, shape cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_param_count_and_cells_equal_the_reference(arch, which):
    """Field for field (the port's ``attn_impl`` defaults to ``kernel``,
    the reference's to ``chunked``), and so ``param_count``, the shape
    cells and each cell's skip reason."""
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    ours, ref = getattr(registry, get)(arch), getattr(jax_registry, get)(arch)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    assert (a.pop("attn_impl"), b.pop("attn_impl")) == ("kernel", "chunked")
    assert a == b
    assert ours.param_count() == ref.param_count()
    assert registry.shape_cells(ours) == jax_registry.shape_cells(ref)
    for shape in SHAPES:
        assert (registry.skip_reason(ours, shape)
                == jax_registry.skip_reason(ref, shape))


@pytest.mark.parametrize("arch", FAMILIES)
def test_parameter_trees_equal_the_reference(arch):
    jspecs = jax_tf.model_specs(jax_registry.get_config(arch))
    tspecs = transformer.model_specs(registry.get_config(arch))
    assert params.param_count(tspecs) == jax_params.param_count(jspecs)
    assert params.param_bytes(tspecs) == jax_params.param_bytes(jspecs)
    jpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in jax_params.tree_paths(jspecs).items()}
    tpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in params.tree_paths(tspecs).items()}
    assert tpaths == jpaths


# --------------------------------------------------------------------------
# forward, prefill, decode, greedy tokens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_logits(arch):
    # 32 tokens: past the smoke windows of 16 (gemma2's even layers,
    # mixtral's every layer)
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(5, 2, 32, jcfg.vocab_size)
    if tcfg.moe is not None:
        _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks)
    jb, tb = _batches(toks)
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits(arch, impl):
    jcfg, tcfg = _configs(arch, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(6, 2, 48, jcfg.vocab_size)
    if tcfg.moe is not None:
        _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks)
    jb, tb = _batches(toks)
    out = transformer.prefill(tcfg, tp, tb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), jax_tf.prefill(jcfg, jp, jb),
                               **MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_logits_and_cache(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, seed=2)
    b, max_len = 2, 8
    jcache = jax_params.init_params(jax_tf.init_cache_specs(jcfg, b, max_len),
                                    jax.random.PRNGKey(0))
    tcache = params.params_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    toks = _tokens(7, b, 5, jcfg.vocab_size)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1]
        logits, tcache = transformer.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        rlogits, jcache = jax_tf.decode_step(jcfg, jp, jcache,
                                             {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == 5
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), jcache[name],
                                   **MODEL_TOL)


# (prompt length, new tokens, max_len): mixtral decodes 40 tokens past its
# window of 16, so that its ring cache wraps; gemma2 fills its cache of
# min(max_len, 16) slots exactly
GREEDY = {"deepseek-67b": (5, 8, 16), "qwen2.5-32b": (5, 8, 16),
          "gemma2-27b": (5, 11, 32), "mixtral-8x22b": (5, 40, 64)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_tokens_equal_the_reference(arch):
    s0, new, max_len = GREEDY[arch]
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, seed=3)
    prompt = _tokens(8, 2, s0, jcfg.vocab_size)
    out = greedy_decode(tcfg, tp, torch.from_numpy(prompt),
                        max_new_tokens=new, max_len=max_len)
    ref = jax_greedy_decode(jcfg, jp, jnp.asarray(prompt),
                            max_new_tokens=new, max_len=max_len)
    assert out.steps == ref.steps == new
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


@pytest.mark.parametrize("new", [11, 12, 27])
def test_gemma2_past_its_cache_raises_before_any_step(new):
    """Every layer's cache has min(max_len, sliding_window) = 16 slots; past
    them a global layer has no slot (the reference writes a clamped one),
    so the port refuses, in ``greedy_decode`` and ``generate`` alike."""
    _, tcfg = _configs("gemma2-27b")
    _, tp = _params(_configs("gemma2-27b")[0], seed=3)
    prompt = torch.from_numpy(_tokens(8, 2, 5, tcfg.vocab_size))
    model = transformer.TransformerLM(tcfg, tp)
    if new == 11:
        assert greedy_decode(tcfg, tp, prompt, new, 32).tokens.shape == (2, 11)
        return
    for run in (lambda: greedy_decode(tcfg, tp, prompt, new, 32),
                lambda: model.generate(prompt, new, 32)):
        with pytest.raises(ValueError, match="alternates local and global"):
            run()


# --------------------------------------------------------------------------
# the sparse MoE
# --------------------------------------------------------------------------

def _moe_pair(capacity_factor=1.25, seed=0, **kw):
    jcfg, tcfg = _configs("mixtral-8x22b", **kw)
    jcfg = jcfg.scaled(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    tcfg = tcfg.scaled(moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(seed)
    tree = {k: (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in jax_mlp.moe_specs(jcfg).items()}
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params.params_from_jax(tree, device="cpu"), x)


def _reference_keep(jcfg, jp, x) -> np.ndarray:
    """The reference's kept slots, in its sorted order, from its own
    routing (its algorithm step by step in numpy: a stable sort by expert,
    positions within each expert's segment, the capacity)."""
    mo = jcfg.moe
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    scores = jax.nn.softmax(xf @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(scores, mo.top_k)
    flat = np.asarray(top_e).reshape(-1)
    se = flat[np.argsort(flat, kind="stable")]
    counts = np.bincount(se, minlength=mo.num_experts)
    starts = np.cumsum(counts) - counts
    return (np.arange(se.size) - starts[se]) < jax_mlp._capacity(
        xf.shape[0], mo)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_forward_drops_the_references_tokens(capacity_factor):
    jcfg, tcfg, jp, tp, x = _moe_pair(capacity_factor)
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    logits = (xf @ tp["router"]).numpy()
    jlogits = np.asarray(jnp.asarray(x.reshape(-1, x.shape[-1]))
                         @ jp["router"])
    assert _top_k_margin(logits, 2) > 2 * np.abs(logits - jlogits).max()
    _, top_e = mlp.moe_route(tcfg, tp, xf)
    keep = mlp.moe_dispatch(top_e, tcfg.moe.num_experts,
                            mlp._capacity(xf.shape[0], tcfg.moe))[2]
    np.testing.assert_array_equal(keep.numpy(), _reference_keep(jcfg, jp, x))
    assert bool(keep.all()) == (capacity_factor > 1)
    out = mlp.moe_forward(tcfg, tp, torch.from_numpy(x))
    ref = jax_mlp.moe_forward(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


def test_deepseek_v3_gate_and_shared_expert():
    """A mixtral smoke config renamed into the DeepSeek-V3 family takes the
    sigmoid gate with renormalised top-k weights, plus one shared
    expert."""
    def dsv3(cfg):
        return cfg.scaled(name="deepseek-v3-moe-smoke", moe=dataclasses.replace(
            cfg.moe, num_shared_experts=1, d_ff_shared=32))
    jcfg, tcfg = _configs("mixtral-8x22b")
    jcfg, tcfg = dsv3(jcfg), dsv3(tcfg)
    rng = np.random.default_rng(4)
    tree = {k: (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in jax_mlp.moe_specs(jcfg).items()}
    assert {"w_gate_shared", "w_up_shared", "w_down_shared"} <= set(tree)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    tp = params.params_from_jax(tree, device="cpu")
    top_w, _ = mlp.moe_route(tcfg, tp, torch.from_numpy(x.reshape(64, -1)))
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, rtol=1e-6)
    out = mlp.moe_forward(tcfg, tp, torch.from_numpy(x))
    ref = jax_mlp.moe_forward(jcfg, jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


def test_moe_aux_loss():
    jcfg, tcfg, jp, tp, x = _moe_pair()
    out = mlp.moe_aux_loss(tcfg, tp, torch.from_numpy(x))
    ref = jax_mlp.moe_aux_loss(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(float(out), float(ref), **MODULE_TOL)


def test_moe_ep_shardmap_raises_naming_the_mesh_item():
    """``moe_ep_shardmap`` on one device is ``moe_forward``, bit for bit,
    as the reference's fallback (its ``test_single_device_fallback``); the
    expert-parallel dispatch on a mesh: test_torch_expert_parallel.py."""
    _, tcfg, _, tp, x = _moe_pair()
    want = mlp.moe_forward(tcfg, tp, torch.from_numpy(x))
    got = mlp.moe_forward(tcfg.scaled(moe_ep_shardmap=True), tp,
                          torch.from_numpy(x))
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the forward export and the serving synth
# --------------------------------------------------------------------------

SEQ, BATCH = 32, 2


def _dot_flops(text, parser) -> int:
    return int(parser.program_cost(parser.parse(text)).by_op["dot_general"])


def _forward_text(cfg) -> str:
    step, args = forward_exports(cfg, SEQ, BATCH)
    return export_workload(step, *args, device="cpu").stablehlo_text


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_export_flops_equal_the_jax_export(arch):
    """The campaign's ``mode="forward"`` export (chunked attention, as the
    reference's campaign) of the smoke config: both front ends read the
    text to the JAX export's ``dot_general`` FLOPs."""
    text = _forward_text(registry.get_smoke_config(arch).scaled(
        attn_impl="chunked"))
    jcfg = jax_registry.get_smoke_config(arch)
    jtext = jax_export_workload(
        jax.jit(lambda p, b: jax_tf.forward(jcfg, p, b)),
        jax_params.abstract_params(jax_tf.model_specs(jcfg)),
        jax_input_specs(jcfg, JaxShape("f", SEQ, BATCH, "train")),
        compile_workload=False).stablehlo_text
    theirs = _dot_flops(jtext, jax_ir)
    assert _dot_flops(text, jax_ir) == _dot_flops(text, ir) == theirs > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_xla_runs_the_forward_text_to_the_eager_values(arch):
    """The f32 forward text through XLA on the CPU: the loss and logits of
    the eager forward (the MoE's top-k, sort, cumulative sum, gathers and
    scatter-adds, gemma2's tanh GeLU included)."""
    cfg = registry.get_smoke_config(arch).scaled(attn_impl="chunked",
                                                 dtype="float32")
    text = _forward_text(cfg)
    rng = np.random.default_rng(0)
    step, args = forward_exports(cfg, SEQ, BATCH)
    tree = pytree.tree_map(
        lambda t: (torch.from_numpy(rng.normal(0, 0.3, tuple(t.shape))
                                    .astype(np.float32)) if t.dim() > 1
                   else torch.ones(tuple(t.shape))), args[0])
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (BATCH, SEQ), dtype=np.int32))
             for k in ("tokens", "targets")}
    backend = xla_bridge.get_backend("cpu")
    devs = backend.devices()[:1]
    exe = backend.compile_and_load(text, xla_client.DeviceList(tuple(devs)),
                                   compiler.get_compile_options(1, 1))
    got = exe.execute([backend.buffer_from_pyval(x.numpy(), devs[0])
                       for x in pytree.tree_leaves((tree, batch))])
    want = transformer.forward(cfg, tree, batch)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g, w = np.asarray(g), w.numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= XLA_RTOL * float(
            np.abs(w).max())


def test_moe_flops_scale_with_top_k_not_experts():
    """The reference's check on the port's export of ``moe_forward``:
    doubling the experts does not double the FLOPs (a one-hot dispatch
    would), and each count equals the JAX export's."""
    def flops(n_experts):
        cfg = registry.get_smoke_config("mixtral-8x22b")
        moe = dataclasses.replace(cfg.moe, num_experts=n_experts,
                                  capacity_factor=1.0)
        cfg, jcfg = cfg.scaled(moe=moe), jax_registry.get_smoke_config(
            "mixtral-8x22b").scaled(moe=dataclasses.replace(
                jax_registry.get_smoke_config("mixtral-8x22b").moe,
                num_experts=n_experts, capacity_factor=1.0))
        x = torch.empty(2, 128, cfg.d_model, dtype=torch.bfloat16,
                        device="meta")
        text = export_workload(
            lambda p, x: mlp.moe_forward(cfg, p, x),
            params.abstract_params(mlp.moe_specs(cfg)), x,
            device="cpu").stablehlo_text
        jtext = jax.jit(lambda p, x: jax_mlp.moe_forward(jcfg, p, x)).lower(
            jax_params.abstract_params(jax_mlp.moe_specs(jcfg)),
            jax.ShapeDtypeStruct((2, 128, cfg.d_model), jnp.bfloat16)
        ).as_text()
        ours = jax_ir.program_cost(jax_ir.parse(text)).flops
        theirs = jax_ir.program_cost(jax_ir.parse(jtext)).flops
        assert _dot_flops(text, jax_ir) == _dot_flops(jtext, jax_ir)
        return ours, theirs
    (f4, j4), (f8, j8) = flops(4), flops(8)
    assert f8 < 1.5 * f4 and j8 < 1.5 * j4


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_synth_text_equals_the_reference(arch, mode):
    kw = dict(name=f"{arch}-{mode}", arch=arch, mode=mode, batch=8,
              seq=2048, fidelity="raw")
    ours = _synthesize_serving(WorkloadSpec(**kw))
    ref = jax_synthesize(JaxWorkloadSpec(**kw))
    assert ours.stablehlo_text == ref.stablehlo_text
    assert ours.meta == ref.meta
