"""The MLA slice of the port against the JAX package, on the CPU in f32:
deepseek-v3-671b's multi-head latent attention (queries and keys 192 wide,
128 without rope and 64 with; values 128 wide; the absorbed-form decode
over the compressed ``ckv`` cache) before its sigmoid-gated MoE of 256
experts at top-8.  The same parameters (carried across by
``params_from_jax``) and the same inputs (numpy's seeded generator) go
through both packages:

* configs field for field, ``param_count``, the shape cells and skip
  reasons, the parameter trees and ``params_from_jax`` carrying every MLA
  leaf;
* ``mla_forward`` with ``attn_impl`` ``kernel`` (the plain version of K1 on
  the CPU), ``chunked`` and ``dense``, and ``mla_decode`` step by step with
  its cache, against the reference's chunked and dense paths (its Pallas
  kernel cannot take a value width apart from the query width: its
  ``multihead_attention`` falls back to the chunked path);
* ``forward`` (loss and logits), ``prefill``, ``decode_step`` (logits and
  the ``ckv`` cache) and greedy tokens;
* K1's plain version at value widths apart from the query width against the
  reference's ``_dense_attention`` and ``_chunked_attention``, and its fake
  operator's output shape;
* the forward export's ``dot_general`` FLOPs equal to the JAX export's, and
  the serving synth text in prefill and decode mode.

Each runs on the ``SMOKE`` config (qk 16 + 8, v 16), on an asymmetric
variant whose values are wider than its queries (qk 8 + 16, v 40, other
ranks), and the modules also at the published head widths (qk 128 + 64, v
128, two heads).  Where routing decides an output, the smallest top-k
margin of the router logits is held above twice the packages' largest
router-logit difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign.builders import _synthesize_serving as jax_synthesize
from repro.campaign.spec import WorkloadSpec as JaxWorkloadSpec
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import input_specs as jax_input_specs
from repro.models import mlp as jax_mlp
from repro.models import params as jax_params
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro_torch.campaign.builders import _synthesize_serving
from repro_torch.campaign.spec import WorkloadSpec
from repro_torch.configs.base import MLAConfig
from repro_torch.core import ir
from repro_torch.core.pipeline import export_workload
from repro_torch.kernels.flash_attention import ops as k1_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention, common, mlp, params, registry
from repro_torch.models import transformer
from repro_torch.serve.decode import greedy_decode
from repro_torch.train.loop import forward_exports

ARCH = "deepseek-v3-671b"
MODULE_TOL = dict(atol=2e-5, rtol=2e-5)   # one module in f32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # a whole LM in f32
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the reference's attention path for each of the port's: its Pallas kernel
# does not take dv != dqk, so the port's kernel path (the plain version on
# the CPU) is held against the chunked recurrence it falls back to
JAX_IMPL = {"kernel": "chunked", "chunked": "chunked", "dense": "dense"}
# the asymmetric variant (values wider than queries, other ranks) and the
# published head widths on a narrow model (two heads, small ranks)
MLA_VARIANTS = {
    "asymmetric": dict(q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=8,
                       qk_rope_head_dim=16, v_head_dim=40),
    "head_width": dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128),
}
WIDE = {"head_width": dict(num_heads=2, num_kv_heads=2)}
LM_VARIANTS = ["smoke", "asymmetric"]
VARIANTS = LM_VARIANTS + ["head_width"]


def _configs(variant="smoke", impl="kernel", **kw):
    """The same f32 config in both packages: the smoke config or one of its
    MLA variants (each name starts with deepseek-v3, which picks the
    sigmoid gate in both)."""
    jmla = tmla = {}
    if variant != "smoke":
        kw = dict(WIDE.get(variant, {}), name=f"deepseek-v3-{variant}", **kw)
        jmla = dict(mla=JaxMLAConfig(**MLA_VARIANTS[variant]))
        tmla = dict(mla=MLAConfig(**MLA_VARIANTS[variant]))
    jcfg = jax_registry.get_smoke_config(ARCH).scaled(
        dtype="float32", attn_impl=JAX_IMPL[impl], **kw, **jmla)
    tcfg = registry.get_smoke_config(ARCH).scaled(
        dtype="float32", attn_impl=impl, **kw, **tmla)
    return jcfg, tcfg


def _fan_in(spec, x):
    """A layer-stacked ``scaled`` weight at std 1/sqrt(its input width):
    the reference's init divides it by the square root of the layer count,
    so its smoke scores would reach the tens and the softmax would turn the
    packages' f32 rounding of RoPE into outputs 1e-4 apart (as in
    tests/test_torch_hybrid.py)."""
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


def _layer(jp, tp, i):
    n = tp["layers"]["ln1"].shape[0]
    return (jax.tree.map(lambda x: x[i], jp["layers"]),
            transformer._unstack(tp["layers"], n)[i])


def _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks) -> None:
    """Walk both packages' layers (each on its own hidden state) and hold,
    at every MoE layer, the smallest top-k margin of the router logits
    above twice the largest difference between the packages' (sigmoid
    keeps the order)."""
    jb, tb = _batches(toks)
    b, s = toks.shape
    jh, th = jax_tf._embed(jcfg, jp, jb), transformer._embed(tcfg, tp, tb)
    jpos, tpos = jax_tf._positions(jb), transformer._positions(tb)
    k = tcfg.moe.top_k
    for i in range(tcfg.num_layers):
        jl, tl = _layer(jp, tp, i)
        jh = jh + jax_attention.mla_forward(
            jcfg, jl["attn"], jax_common.rms_norm(jh, jl["ln1"],
                                                  jcfg.rms_eps), jpos)
        th = th + attention.mla_forward(
            tcfg, tl["attn"], common.rms_norm(th, tl["ln1"], tcfg.rms_eps),
            tpos)
        jx = jax_common.rms_norm(jh, jl["ln2"], jcfg.rms_eps)
        tx = common.rms_norm(th, tl["ln2"], tcfg.rms_eps)
        jr = np.asarray(jx.reshape(b * s, -1) @ jl["moe"]["router"])
        tr = (tx.reshape(b * s, -1) @ tl["moe"]["router"]).numpy()
        srt = np.sort(tr, axis=-1)[:, ::-1]
        margin = float((srt[:, k - 1] - srt[:, k]).min())
        assert margin > 2 * float(np.abs(jr - tr).max()), (i, margin)
        jh = jh + jax_mlp.moe_forward(jcfg, jl["moe"], jx)
        th = th + mlp.moe_forward(tcfg, tl["moe"], tx)


# --------------------------------------------------------------------------
# configs, parameter trees, shape cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_param_count_and_cells_equal_the_reference(which):
    """Field for field (the port's ``attn_impl`` defaults to ``kernel``,
    the reference's to ``chunked``), and so ``param_count``, the shape
    cells and each cell's skip reason."""
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    ours, ref = getattr(registry, get)(ARCH), getattr(jax_registry, get)(ARCH)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    assert (a.pop("attn_impl"), b.pop("attn_impl")) == ("kernel", "chunked")
    assert a == b
    assert ours.param_count() == ref.param_count()
    assert registry.shape_cells(ours) == jax_registry.shape_cells(ref)
    for shape in SHAPES:
        assert (registry.skip_reason(ours, shape)
                == jax_registry.skip_reason(ref, shape))


def test_published_sizes_and_attention_widths():
    """703.8 B parameters (the published 671 B with its three dense layers
    made MoE, as the reference's config has them); K1's pair (192, 128);
    one layer's 256 routed experts are 11.27 B parameters."""
    cfg = registry.get_config(ARCH)
    m = cfg.mla
    assert cfg.param_count() == jax_registry.get_config(ARCH).param_count()
    assert cfg.param_count()[0] == 703_797_680_128
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (192,
                                                                       128)
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim,
            m.v_head_dim) in k1_ops.HEAD_DIM_PAIRS
    mo = cfg.moe
    assert mo.num_experts * 3 * cfg.d_model * mo.d_ff_expert == 11_274_289_152
    specs = transformer.model_specs(cfg)
    assert specs["layers"]["attn"]["wuq"].shape == (61, 1536, 128, 192)
    assert specs["layers"]["moe"]["we_gate"].shape == (61, 256, 7168, 2048)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_parameter_trees_equal_the_reference(which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    jspecs = jax_tf.model_specs(getattr(jax_registry, get)(ARCH))
    tspecs = transformer.model_specs(getattr(registry, get)(ARCH))
    assert params.param_count(tspecs) == jax_params.param_count(jspecs)
    assert params.param_bytes(tspecs) == jax_params.param_bytes(jspecs)
    jpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in jax_params.tree_paths(jspecs).items()}
    tpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in params.tree_paths(tspecs).items()}
    assert tpaths == jpaths
    assert set(tspecs["layers"]["attn"]) == {
        "wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wo"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_params_from_jax_carries_every_leaf(variant):
    jcfg, tcfg = _configs(variant)
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
    assert set(model.params["layers"]["attn"]) == set(tp["layers"]["attn"])


def test_cache_specs_are_the_compressed_cache():
    """``ckv`` [L, B, S_max, kv_lora_rank + qk_rope_head_dim] and the index,
    as in the reference (576 wide at the published config)."""
    for get in ("get_config", "get_smoke_config"):
        ours = transformer.cache_shapes(getattr(registry, get)(ARCH), 3, 40)
        ref = jax_tf.cache_shapes(getattr(jax_registry, get)(ARCH), 3, 40)
        assert ours == ref
    assert transformer.cache_shapes(registry.get_config(ARCH), 8, 128)[
        "ckv"][0] == (61, 8, 128, 576)


# --------------------------------------------------------------------------
# the modules: mla_forward, mla_decode, K1's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "chunked", "dense"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_mla_forward_equals_the_reference(variant, impl):
    """One layer's MLA on 2 x 40 tokens; the chunked paths over chunks of
    16 (three, the last ragged)."""
    jcfg, tcfg = _configs(variant, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    jl, tl = _layer(jp, tp, 0)
    x = np.random.default_rng(2).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    out = attention.mla_forward(tcfg, tl["attn"], torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    ref = jax_attention.mla_forward(jcfg, jl["attn"], jnp.asarray(x),
                                    jnp.asarray(pos))
    assert out.shape == (2, 40, jcfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_mla_decode_and_its_cache_equal_the_reference(variant):
    """Six absorbed-form steps over a cache of 8 slots: each step's output
    and the whole cache after it (the port writes the entry in place)."""
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=3)
    jl, tl = _layer(jp, tp, 1)
    m = jcfg.mla
    width = m.kv_lora_rank + m.qk_rope_head_dim
    jcache = jnp.zeros((2, 8, width), jnp.float32)
    tcache = torch.zeros(2, 8, width)
    xs = np.random.default_rng(4).standard_normal(
        (6, 2, 1, jcfg.d_model)).astype(np.float32)
    for i, x in enumerate(xs):
        y, out_cache = attention.mla_decode(tcfg, tl["attn"],
                                            torch.from_numpy(x), tcache,
                                            torch.tensor(i, dtype=torch.int32))
        assert out_cache is tcache
        ry, jcache = jax_attention.mla_decode(jcfg, jl["attn"],
                                              jnp.asarray(x), jcache,
                                              jnp.int32(i))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **MODULE_TOL)
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                                   **MODULE_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_by_mla_decode_equals_mla_forward(variant):
    """The absorbed form over the compressed cache is the materialised
    attention: the last decode step's output is the forward's last row."""
    _, tcfg = _configs(variant)
    _, tp = _params(_configs(variant)[0], seed=5)
    tl = transformer._unstack(tp["layers"], 2)[0]
    s = 7
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32))
    full = attention.mla_forward(tcfg, tl["attn"], x,
                                 torch.arange(s).expand(2, s))
    m = tcfg.mla
    cache = torch.zeros(2, s, m.kv_lora_rank + m.qk_rope_head_dim)
    for i in range(s):
        y, cache = attention.mla_decode(tcfg, tl["attn"], x[:, i:i + 1],
                                        cache, torch.tensor(i))
    torch.testing.assert_close(y[:, 0], full[:, -1], **MODULE_TOL)


# (B, Hq, Hkv, Sq, Skv, D, Dv, causal, q_offset)
K1_PLAIN_CASES = [(2, 4, 2, 24, 24, 24, 16, True, 0),
                  (1, 2, 2, 19, 37, 192, 128, True, 18),
                  (2, 2, 1, 33, 33, 192, 128, False, 0),
                  (1, 4, 4, 40, 40, 16, 40, True, 0)]


@pytest.mark.parametrize("case", K1_PLAIN_CASES,
                         ids=lambda c: f"d{c[5]}_dv{c[6]}_"
                         f"{'causal' if c[7] else 'bidir'}_sq{c[3]}")
def test_k1_plain_version_at_a_value_width_apart(case):
    """K1's plain version (the CPU path of ``flash_attention`` and the
    card's reference) against the reference's ``_dense_attention`` and
    ``_chunked_attention`` (chunks of 16, ragged), with the output as wide
    as V and the scores scaled by 1/sqrt of q's width."""
    b, hq, hkv, sq, skv, d, dv, causal, off = case
    rng = np.random.default_rng(sum(case[:7]))
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dv)).astype(np.float32)
    kw = dict(causal=causal, q_offset=off)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention_ref(*t, **kw)
    via_op = k1_ops.flash_attention(*t, **kw)
    assert out.shape == via_op.shape == (b, hq, sq, dv)
    torch.testing.assert_close(via_op, out, atol=0, rtol=0)
    args = jax_attention.AttnArgs(causal=causal, q_offset=off)
    j = [jnp.asarray(a) for a in (q, k, v)]
    for ref in (jax_attention._dense_attention(*j, args),
                jax_attention._chunked_attention(*j, args, 16)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   **MODULE_TOL)


def test_k1_fake_output_is_as_wide_as_v():
    """The operator's fake (what an export's trace records) writes o as
    [B, Sq, Hq, Dv] seen as [B, Hq, Sq, Dv]: V's width, not q's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 8, 40, 192)
        k = torch.empty(2, 8, 50, 192)
        v = torch.empty(2, 8, 50, 128)
        for op in (torch.ops.repro_torch.flash_attention,
                   torch.ops.repro_torch.flash_attention_lse):
            out = op(q, k, v, True, 0, 0.0, 0)
            o = out[0] if isinstance(out, tuple) else out
            assert o.shape == (2, 8, 40, 128)
            assert o.transpose(1, 2).is_contiguous()
        assert torch.ops.repro_torch.flash_attention_lse(
            q, k, v, True, 0, 0.0, 0)[1].shape == (2, 8, 40)


def test_k1b_refuses_a_value_width_apart():
    """K1 takes (192, 128) beside the (d, d) pairs; K1b's backward raises a
    ValueError for dv != dqk, naming the training slice, before any launch
    (it never falls back to the plain backward)."""
    assert (192, 128) in k1_ops.HEAD_DIM_PAIRS
    assert (128, 192) not in k1_ops.HEAD_DIM_PAIRS
    assert all((d, d) in k1_ops.HEAD_DIM_PAIRS for d in k1_ops.HEAD_DIMS)
    q, k, v = (torch.zeros(1, 2, 8, w) for w in (192, 192, 128))
    o, lse = torch.zeros(1, 2, 8, 128), torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=r"Queue 1 item 11\.3"):
        k1_ops.flash_attention_bwd(q, k, v, o, lse, o)


# --------------------------------------------------------------------------
# the whole LM: forward, prefill, decode, greedy tokens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_forward_loss_and_logits(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg)
    toks = _tokens(5, 2, 32, jcfg.vocab_size)
    _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks)
    jb, tb = _batches(toks)
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_prefill_logits(variant, impl):
    jcfg, tcfg = _configs(variant, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(6, 2, 40, jcfg.vocab_size)
    _assert_routing_cannot_flip(jcfg, jp, tcfg, tp, toks)
    jb, tb = _batches(toks)
    out = transformer.prefill(tcfg, tp, tb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), jax_tf.prefill(jcfg, jp, jb),
                               **MODEL_TOL)


@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_decode_step_logits_and_cache(variant):
    """The ``ckv`` cache ([L, B, S_max, rank + rope]) and the index after
    each step, and each step's logits."""
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=2)
    b, max_len = 2, 8
    jcache = jax_params.init_params(jax_tf.init_cache_specs(jcfg, b, max_len),
                                    jax.random.PRNGKey(0))
    tcache = params.params_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    assert set(tcache) == set(jcache) == {"index", "ckv"}
    toks = _tokens(7, b, 5, jcfg.vocab_size)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1]
        logits, tcache = transformer.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        rlogits, jcache = jax_tf.decode_step(jcfg, jp, jcache,
                                             {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
        np.testing.assert_allclose(tcache["ckv"].numpy(),
                                   np.asarray(jcache["ckv"]), **MODEL_TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == 5


@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_greedy_tokens_equal_the_reference(variant):
    jcfg, tcfg = _configs(variant)
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


# --------------------------------------------------------------------------
# the forward export and the serving synth
# --------------------------------------------------------------------------

SEQ, BATCH = 64, 2


def _dot_flops(text, parser) -> int:
    return int(parser.program_cost(parser.parse(text)).by_op["dot_general"])


@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_forward_export_flops_equal_the_jax_export(variant):
    """The campaign's ``mode="forward"`` export (chunked attention, as the
    reference's campaign): both front ends read the port's text to the
    JAX export's ``dot_general`` FLOPs."""
    jcfg, tcfg = _configs(variant, "chunked")
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


def test_kernel_export_records_k1_at_the_value_width():
    """The card's configuration traced on the CPU: one K1 call a layer,
    whose result the text types [B, H, S, v_head_dim] (the operator's fake
    is V's width), and the text still parses."""
    _, tcfg = _configs("asymmetric")
    tcfg = tcfg.scaled(dtype="bfloat16")
    step, args = forward_exports(tcfg, 32, 2)
    text = export_workload(step, *args, device="cpu").stablehlo_text
    calls = [line for line in text.splitlines()
             if "call @" in line and "flash_attention" in line]
    assert len(calls) == tcfg.num_layers
    h, dv = tcfg.num_heads, tcfg.mla.v_head_dim
    assert all(f"tensor<2x{h}x32x{dv}xbf16>" in line for line in calls)
    assert _dot_flops(text, ir) > 0


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_synth_text_equals_the_reference(mode):
    """``_synthesize_serving`` resolves the config by module name: the
    port's deepseek-v3 text and meta are the reference's."""
    kw = dict(name=f"{ARCH}-{mode}", arch=ARCH, mode=mode, batch=8,
              seq=2048, fidelity="raw")
    ours = _synthesize_serving(WorkloadSpec(**kw))
    ref = jax_synthesize(JaxWorkloadSpec(**kw))
    assert ours.stablehlo_text == ref.stablehlo_text
    assert ours.meta == ref.meta
