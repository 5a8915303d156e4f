"""The port's model modules against the JAX package, on the CPU in f32, with
the same parameters (carried across by ``params_from_jax``) and the same
inputs (numpy's seeded generator).  The port's ``attn_impl="kernel"`` is
held against JAX's ``"pallas"`` (interpret mode), ``"chunked"`` and
``"dense"`` against their namesakes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.models import rope as jax_rope
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.models import attention, common, mlp, rope, transformer
from repro_torch.models.params import params_from_jax
from repro_torch.models.registry import get_config, get_smoke_config

MODULE_TOL = dict(atol=2e-5, rtol=2e-5)   # one module in f32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # a whole LM in f32: sums of up to
#                                           d_ff terms in another order
JAX_IMPL = {"kernel": "pallas", "chunked": "chunked", "dense": "dense"}
LLAMAS = ["llama3-100m", "llama3-500m", "llama3-1b", "llama3-3b", "llama2-7b"]


def _configs(arch="llama3-1b", impl="kernel", full=False, **kw):
    """The same f32 config in both packages."""
    jget, tget = ((jax_get_config, get_config) if full
                  else (jax_get_smoke_config, get_smoke_config))
    jcfg = jget(arch).scaled(dtype="float32", attn_impl=JAX_IMPL[impl], **kw)
    tcfg = tget(arch).scaled(dtype="float32", attn_impl=impl, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jax_init_params(jax_tf.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np_tree(tree, rng):
    """Random f32 values for a JAX spec tree (norm weights around 1,
    biases nonzero), as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v, rng) for k, v in tree.items()}
    x = rng.standard_normal(tree.shape).astype(np.float32)
    return 1.0 + 0.1 * x if tree.init == "ones" else 0.2 * x


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _tokens(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _batches(toks):
    targets = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targets)})


def _positions(b, s):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    out = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                          offset)
    ref = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    out = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles up to 4096 rad: f32 cos/sin of the two libraries differ by ulps
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_forward(act):
    jcfg, tcfg = _configs(act=act)
    rng = np.random.default_rng(2)
    jp, tp = _both(_np_tree(jax_mlp.mlp_specs(jcfg), rng))
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    out = mlp.mlp_forward(tcfg, tp, torch.from_numpy(x))
    ref = jax_mlp.mlp_forward(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


ATTN_VARIANTS = {
    "base": {},
    "swa_cap": {"sliding_window": 48, "attn_logit_softcap": 30.0},
    "bias_pad": {"qkv_bias": True, "pad_heads": 2},
}


@pytest.mark.parametrize("impl", ["dense", "chunked", "kernel"])
@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_gqa_forward(impl, variant):
    # attn_chunk 32 < S: the chunked impl really runs its KV loop
    kw = dict(ATTN_VARIANTS[variant], attn_chunk=32)
    jcfg, tcfg = _configs(impl=impl, **kw)
    rng = np.random.default_rng(3)
    jp, tp = _both(_np_tree(jax_attention.attention_specs(jcfg), rng))
    x = rng.standard_normal((2, 128, jcfg.d_model)).astype(np.float32)
    jpos, tpos = _positions(2, 128)
    window = jcfg.sliding_window
    out = attention.gqa_forward(tcfg, tp, torch.from_numpy(x), tpos,
                                layer_window=window)
    ref = jax_attention.gqa_forward(jcfg, jp, jnp.asarray(x), jpos,
                                    layer_window=window)
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


@pytest.mark.parametrize("window,index", [(0, 5), (4, 9), (16, 20)],
                         ids=["full", "window", "ring"])
def test_gqa_decode(window, index):
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(4)
    jp, tp = _both(_np_tree(jax_attention.attention_specs(jcfg), rng))
    b, s_max, kv, hd = 2, 16, jcfg.num_kv_heads, jcfg.resolved_head_dim
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
              for _ in range(2))
    y, nk, nv = attention.gqa_decode(
        tcfg, tp, torch.from_numpy(x), torch.from_numpy(ck.copy()),
        torch.from_numpy(cv.copy()), torch.tensor(index, dtype=torch.int32),
        layer_window=window)
    ry, rk, rv = jax_attention.gqa_decode(
        jcfg, jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(index), layer_window=window)
    np.testing.assert_allclose(y.numpy(), ry, **MODULE_TOL)
    np.testing.assert_allclose(nk.numpy(), rk, **MODULE_TOL)
    np.testing.assert_allclose(nv.numpy(), rv, **MODULE_TOL)


# --------------------------------------------------------------------------
# the LM: forward, prefill, decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LLAMAS)
def test_forward_loss_and_logits(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    jb, tb = _batches(_tokens(5, 2, 16, jcfg.vocab_size))
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["dense", "chunked", "kernel"])
def test_prefill_logits(impl):
    jcfg, tcfg = _configs(impl=impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batches(_tokens(6, 2, 64, jcfg.vocab_size))
    out = transformer.prefill(tcfg, tp, tb)
    ref = jax_tf.prefill(jcfg, jp, jb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_decode_step_logits_and_cache():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=2)
    b, max_len = 2, 8
    jcache = jax_init_params(jax_tf.init_cache_specs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    tcache = params_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    toks = _tokens(7, b, 3, jcfg.vocab_size)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1]
        logits, tcache = transformer.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        rlogits, jcache = jax_tf.decode_step(jcfg, jp, jcache,
                                             {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == 3
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), jcache[name],
                                   **MODEL_TOL)


def test_full_width_one_layer_prefill():
    # llama3-1b's widths (d_model 2048, 32/8 heads, head_dim 64, d_ff 8192)
    # with the depth and vocab cut to fit a CPU test
    jcfg, tcfg = _configs(full=True, num_layers=1, vocab_size=512)
    jp, tp = _params(jcfg, seed=3)
    jb, tb = _batches(_tokens(8, 1, 128, jcfg.vocab_size))
    out = transformer.prefill(tcfg, tp, tb)
    ref = jax_tf.prefill(jcfg, jp, jb)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)
