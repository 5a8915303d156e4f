"""The head-dim and hybrid slice of the port against the JAX package, on the
CPU in f32: stablelm-12b (dense, GQA, head_dim 160) and zamba2-2.7b (the
hybrid: super-blocks of Mamba2 layers, each closed by one attention block
whose weights every super-block shares; head_dim 80).  The same parameters
(carried across by ``params_from_jax``) and the same inputs (numpy's seeded
generator) go through both packages:

* configs field for field, ``param_count``, the shape cells and skip
  reasons, the parameter trees (zamba2's ``shared_attn`` included) and
  ``params_from_jax`` carrying them leaf for leaf;
* ``forward`` (loss and logits), ``prefill`` with ``attn_impl`` ``kernel``
  (the plain version on the CPU; the reference's Pallas kernel in interpret
  mode) and ``chunked``, ``decode_step`` (logits and every cache entry) and
  greedy tokens;
* the forward export's ``dot_general`` FLOPs equal to the JAX export's (the
  port unrolls the reference's two nested scans), and the serving synth
  text in prefill and decode mode.

Each runs on the ``SMOKE`` config (head_dim 16) and on a narrow variant at
the published head width: stablelm-12b with 2 query heads and 1 KV head of
160 (d_model 320), zamba2-2.7b with 2 heads of 80 (d_model 160) in two
super-blocks of two Mamba2 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign.builders import _synthesize_serving as jax_synthesize
from repro.campaign.spec import WorkloadSpec as JaxWorkloadSpec
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models import input_specs as jax_input_specs
from repro.models import params as jax_params
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro_torch.campaign.builders import _synthesize_serving
from repro_torch.campaign.spec import WorkloadSpec
from repro_torch.core import ir
from repro_torch.core.pipeline import export_workload
from repro_torch.models import params, registry, transformer
from repro_torch.serve.decode import greedy_decode
from repro_torch.train.loop import forward_exports

MODULE_TOL = dict(atol=2e-5, rtol=2e-5)   # one module in f32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # a whole LM in f32
ARCHS = ["stablelm-12b", "zamba2-2.7b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the port's attention impls and the JAX package's counterparts
JAX_IMPL = {"kernel": "pallas", "chunked": "chunked", "dense": "dense"}
# the narrow variants at the published head width (d_model / num_heads)
WIDE = {"stablelm-12b": dict(d_model=320, num_heads=2, num_kv_heads=1),
        "zamba2-2.7b": dict(d_model=160, num_heads=2, num_kv_heads=2)}
VARIANTS = ["smoke", "head_width"]


def _configs(arch, variant="smoke", impl="kernel", **kw):
    """The same f32 config in both packages: the smoke config, or its
    narrow variant at the published head width."""
    if variant == "head_width":
        kw = dict(WIDE[arch], name=f"{arch}-head-width", **kw)
    jcfg = jax_registry.get_smoke_config(arch).scaled(
        dtype="float32", attn_impl=JAX_IMPL[impl], **kw)
    tcfg = registry.get_smoke_config(arch).scaled(dtype="float32",
                                                  attn_impl=impl, **kw)
    if variant == "head_width":
        hd = registry.get_config(arch).resolved_head_dim
        assert jcfg.resolved_head_dim == tcfg.resolved_head_dim == hd
    return jcfg, tcfg


def _fan_in(spec, x):
    """A ``scaled`` weight at std 1/sqrt(its input width).  The reference's
    init divides a layer-stacked weight by the square root of its first
    dim, the layer count, so that its smoke weights are drawn at std
    1/sqrt(2) or 1/2: then the head-width variants' scores reach the
    hundreds, and the softmax turns the packages' f32 rounding of RoPE
    (XLA's fused sin and cos) into logits 1e-4 apart.  Chip phase 7 draws
    its gate's weights the same way."""
    if spec.init != "scaled" or spec.axes[0] != "layers":
        return x
    return x * np.sqrt(spec.shape[0] / spec.shape[1])


def _params(jcfg, seed=0):
    specs = jax_tf.model_specs(jcfg)
    jp = jax_params.init_params(specs, jax.random.PRNGKey(seed))

    def rescale(s, x):
        if jax_params.is_spec(s):
            return _fan_in(s, x)
        return {k: rescale(s[k], x[k]) for k in s}
    jp = rescale(specs, jp)
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


# --------------------------------------------------------------------------
# configs, parameter trees, shape cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_param_count_and_cells_equal_the_reference(arch, which):
    """Field for field (the port's ``attn_impl`` defaults to ``kernel``,
    the reference's to ``chunked``), and so ``param_count``, the shape
    cells (the hybrid's ``long_500k`` included) and each cell's skip
    reason."""
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


def test_published_sizes_and_head_widths():
    """About 12.14 B parameters at head_dim 160, and 2.42 B at 80; the
    hybrid's shared block is counted once."""
    stablelm, zamba2 = (registry.get_config(a) for a in ARCHS)
    assert stablelm.param_count()[0] == 12_142_919_680
    assert zamba2.param_count()[0] == 2_422_098_368
    assert (stablelm.resolved_head_dim, zamba2.resolved_head_dim) == (160, 80)
    assert "long_500k" in registry.shape_cells(zamba2)
    assert "long_500k" not in registry.shape_cells(stablelm)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_equal_the_reference(arch, which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    jspecs = jax_tf.model_specs(getattr(jax_registry, get)(arch))
    tspecs = transformer.model_specs(getattr(registry, get)(arch))
    assert params.param_count(tspecs) == jax_params.param_count(jspecs)
    assert params.param_bytes(tspecs) == jax_params.param_bytes(jspecs)
    jpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in jax_params.tree_paths(jspecs).items()}
    tpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in params.tree_paths(tspecs).items()}
    assert tpaths == jpaths
    if arch == "zamba2-2.7b":
        assert {"attn", "ln1", "ln2", "mlp"} == set(tspecs["shared_attn"])
        # 54 Mamba2 layers stacked; the attention weights unstacked
        n = getattr(registry, get)(arch).num_layers
        assert tspecs["layers"]["ln"].shape[0] == n
        assert tspecs["shared_attn"]["attn"]["wq"].shape[0] == (
            tspecs["shared_attn"]["ln1"].shape[0])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch, variant):
    """``params_from_jax`` carries the JAX tree (zamba2's ``shared_attn``
    subtree included) leaf for leaf; ``TransformerLM`` owns it as is."""
    jcfg, tcfg = _configs(arch, variant)
    jp, tp = _params(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(params.tree_paths(
        transformer.model_specs(tcfg)))
    for path, leaf in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    model = transformer.TransformerLM(tcfg, tp)
    assert (sum(p.numel() for p in model.parameters())
            == params.param_count(transformer.model_specs(tcfg)))
    if arch == "zamba2-2.7b":
        assert model.params["shared_attn"]["mlp"].keys() == tp[
            "shared_attn"]["mlp"].keys()


# --------------------------------------------------------------------------
# forward, prefill, decode, greedy tokens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_logits(arch, variant):
    # 64 tokens: two of the zamba2 smoke config's 32-token SSD chunks
    jcfg, tcfg = _configs(arch, variant)
    jp, tp = _params(jcfg)
    jb, tb = _batches(_tokens(5, 2, 64, jcfg.vocab_size))
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(arch, variant, impl):
    jcfg, tcfg = _configs(arch, variant, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batches(_tokens(6, 2, 64, jcfg.vocab_size))
    out = transformer.prefill(tcfg, tp, tb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), jax_tf.prefill(jcfg, jp, jb),
                               **MODEL_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache(arch, variant):
    """Every cache entry after each step: the hybrid's Mamba2 states
    ([L, ...]) and the shared block's K/V ([n_super, ...]), and the
    index."""
    jcfg, tcfg = _configs(arch, variant)
    jp, tp = _params(jcfg, seed=2)
    b, max_len = 2, 8
    jcache = jax_params.init_params(jax_tf.init_cache_specs(jcfg, b, max_len),
                                    jax.random.PRNGKey(0))
    tcache = params.params_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    assert set(tcache) == set(jcache)
    if arch == "zamba2-2.7b":
        assert set(tcache) == {"index", "ssm_state", "conv_state", "k", "v"}
        n_super = tcfg.num_layers // tcfg.hybrid_attn_every
        assert tcache["k"].shape[0] == n_super
        assert tcache["ssm_state"].shape[0] == tcfg.num_layers
    toks = _tokens(7, b, 5, jcfg.vocab_size)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1]
        logits, tcache = transformer.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        rlogits, jcache = jax_tf.decode_step(jcfg, jp, jcache,
                                             {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
        for name in set(jcache) - {"index"}:
            np.testing.assert_allclose(tcache[name].float().numpy(),
                                       np.asarray(jcache[name], np.float32),
                                       **MODEL_TOL, err_msg=name)
    assert int(tcache["index"]) == int(jcache["index"]) == 5


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference(arch, variant):
    jcfg, tcfg = _configs(arch, variant)
    jp, tp = _params(jcfg, seed=3)
    prompt = _tokens(8, 2, 5, jcfg.vocab_size)
    out = greedy_decode(tcfg, tp, torch.from_numpy(prompt),
                        max_new_tokens=8, max_len=16)
    ref = jax_greedy_decode(jcfg, jp, jnp.asarray(prompt),
                            max_new_tokens=8, max_len=16)
    assert out.steps == ref.steps == 8
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    model = transformer.TransformerLM(tcfg, tp)
    np.testing.assert_array_equal(
        model.generate(torch.from_numpy(prompt), 8, 16).tokens.numpy(),
        out.tokens.numpy())


def test_hybrid_remat_full_recomputes_the_same_gradients():
    """``remat == "full"`` checkpoints each super-block (the reference's
    ``jax.checkpoint`` of the outer scan's body): the loss and every
    gradient are those of the run that keeps its activations."""
    _, tcfg = _configs("zamba2-2.7b")
    _, tp = _params(_configs("zamba2-2.7b")[0], seed=4)
    _, tb = _batches(_tokens(9, 2, 32, tcfg.vocab_size))
    leaves = params.trainable(tp)
    flat = [t for t in jax.tree_util.tree_leaves(leaves)]
    grads = []
    for remat in ("none", "full"):
        loss, _ = transformer.forward(tcfg.scaled(remat=remat), leaves, tb)
        grads.append((loss.detach(), torch.autograd.grad(loss, flat)))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# --------------------------------------------------------------------------
# the forward export and the serving synth
# --------------------------------------------------------------------------

SEQ, BATCH = 64, 2


def _dot_flops(text, parser) -> int:
    return int(parser.program_cost(parser.parse(text)).by_op["dot_general"])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_export_flops_equal_the_jax_export(arch, variant):
    """The campaign's ``mode="forward"`` export (chunked attention, as the
    reference's campaign): both front ends read the port's text to the
    JAX export's ``dot_general`` FLOPs, whose scans the port unrolls."""
    jcfg, tcfg = _configs(arch, variant, "chunked")
    jcfg, tcfg = jcfg.scaled(dtype="bfloat16"), tcfg.scaled(dtype="bfloat16")
    step, args = forward_exports(tcfg, SEQ, BATCH)
    text = export_workload(step, *args, device="cpu").stablehlo_text
    jtext = jax_export_workload(
        jax.jit(lambda p, b: jax_tf.forward(jcfg, p, b)),
        jax_params.abstract_params(jax_tf.model_specs(jcfg)),
        jax_input_specs(jcfg, JaxShape("f", SEQ, BATCH, "train")),
        compile_workload=False).stablehlo_text
    theirs = _dot_flops(jtext, jax_ir)
    assert _dot_flops(text, jax_ir) == _dot_flops(text, ir) == theirs > 0


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_synth_text_equals_the_reference(arch, mode):
    kw = dict(name=f"{arch}-{mode}", arch=arch, mode=mode, batch=8,
              seq=2048, fidelity="raw")
    ours = _synthesize_serving(WorkloadSpec(**kw))
    ref = jax_synthesize(JaxWorkloadSpec(**kw))
    assert ours.stablehlo_text == ref.stablehlo_text
    assert ours.meta == ref.meta
