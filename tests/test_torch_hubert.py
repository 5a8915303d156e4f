"""hubert-xlarge (the encoder-only audio family: frame embeddings in through
the stub front end, no causal mask, tanh GeLU, no decode) against the JAX
package, on the CPU in f32.  The same parameters (carried across by
``params_from_jax``) and the same inputs (numpy's seeded generator) go
through both packages:

* the config field for field, ``param_count``, the shape cells (no decode
  cell) and skip reasons, the parameter tree;
* ``forward`` (loss and logits) and ``prefill`` from ``embeds``, with
  ``attn_impl`` ``kernel`` (K1's plain version here, without the causal
  mask; the reference's Pallas kernel in interpret mode) and ``chunked``;
* three train steps under AdamW on the reference's stub batches
  (``SyntheticSource``), K1b's and K2b's plain backwards here;

on the ``SMOKE`` config (head_dim 16), on a narrow variant at the published
head width (2 heads of 80, d_model 160) and at the published width with one
layer.  The train step's export at JAX's FLOPs is in
``tests/test_torch_train_export.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import params as jax_params
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.train import data as jax_data
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.models import params, registry, transformer
from repro_torch.train import data, loop, optimizer
from test_torch_hybrid import JAX_IMPL, MODEL_TOL, SHAPES, _params

ARCH = "hubert-xlarge"
VARIANTS = {
    "smoke": {},
    # the published head width: 2 heads of 80
    "head_width": dict(d_model=160, num_heads=2, num_kv_heads=2),
}


def _configs(variant="smoke", impl="kernel", **kw):
    if variant == "full_width":
        get, jget = registry.get_config, jax_registry.get_config
        kw = dict(kw, num_layers=1)
    else:
        get, jget = registry.get_smoke_config, jax_registry.get_smoke_config
        kw = dict(VARIANTS[variant], **kw)
    jcfg = jget(ARCH).scaled(dtype="float32", attn_impl=JAX_IMPL[impl], **kw)
    tcfg = get(ARCH).scaled(dtype="float32", attn_impl=impl, **kw)
    return jcfg, tcfg


def _batches(seed, b, s, cfg):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"embeds": jnp.asarray(embeds), "targets": jnp.asarray(targets)},
            {"embeds": torch.from_numpy(embeds),
             "targets": torch.from_numpy(targets)})


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_tree_and_cells_equal_the_reference(which):
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
    jspecs, tspecs = jax_tf.model_specs(ref), transformer.model_specs(ours)
    assert params.param_count(tspecs) == jax_params.param_count(jspecs)
    jpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in jax_params.tree_paths(jspecs).items()}
    tpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in params.tree_paths(tspecs).items()}
    assert tpaths == jpaths


def test_an_encoder_with_no_decode_cell():
    cfg = registry.get_config(ARCH)
    assert cfg.is_encoder_only and cfg.frontend == "stub"
    assert cfg.resolved_head_dim == 80 and cfg.act == "gelu"
    assert registry.shape_cells(cfg) == ["train_4k", "prefill_32k"]
    assert registry.skip_reason(cfg, "decode_32k") == (
        "encoder-only: no autoregressive decode step")


@pytest.mark.parametrize("variant", ["smoke", "head_width", "full_width"])
def test_forward_loss_and_logits(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg)
    jb, tb = _batches(5, 2, 40, jcfg)
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)
    model = transformer.TransformerLM(tcfg, tp)
    torch.testing.assert_close(model(tb)[1], logits, atol=0, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("variant", ["smoke", "head_width"])
def test_prefill_logits(variant, impl):
    """No causal mask: the last position's logits see every frame, so a
    change to the first frame moves them."""
    jcfg, tcfg = _configs(variant, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batches(6, 2, 48, jcfg)
    out = transformer.prefill(tcfg, tp, tb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), jax_tf.prefill(jcfg, jp, jb),
                               **MODEL_TOL)
    first = dict(tb, embeds=tb["embeds"].clone())
    first["embeds"][:, 0] += 1.0
    assert not torch.allclose(transformer.prefill(tcfg, tp, first), out,
                              atol=1e-4)


@pytest.mark.parametrize("variant", ["smoke", "head_width"])
def test_train_step_matches_jax_over_three_steps(variant):
    """``make_train_step`` against the reference's under AdamW (its chunked
    attention: the Pallas kernel has no derivative) on the stub batches of
    ``SyntheticSource``, which the port draws bit for bit."""
    from test_torch_train import _assert_params_close

    jcfg, tcfg = _configs(variant)
    jcfg = jcfg.scaled(attn_impl="chunked")
    ocfg_j = jax_opt.OptimizerConfig(warmup_steps=2)
    ocfg_t = optimizer.OptimizerConfig(warmup_steps=2)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, ocfg_j))
    tstep = loop.make_train_step(tcfg, ocfg_t)
    jp, tp = _params(jcfg, seed=4)
    js = jax_opt.make_optimizer(ocfg_j)[0](jp, ocfg_j)
    ts = params.params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=24, global_batch=4, seed=3,
              frontend="stub", d_model=jcfg.d_model)
    source = data.SyntheticSource(data.DataConfig(**kw))
    jsource = jax_data.SyntheticSource(jax_data.DataConfig(**kw))
    for _ in range(3):
        batch, jbatch = next(source), next(jsource)
        for k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, jbatch))
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
    _assert_params_close(tp, jp, lr=ocfg_t.learning_rate, steps=3,
                         share=0.999)
