"""qwen2-vl-7b (the VLM backbone: M-RoPE over three position streams,
QKV bias, GQA) against the JAX package, on the CPU in f32.  The same
parameters (carried across by ``params_from_jax``) and the same inputs
(numpy's seeded generator) go through both packages:

* ``apply_mrope`` against the reference's on distinct streams, at the smoke
  sections (4, 2, 2) and the published (16, 24, 24) of head_dim 128; equal
  streams give plain RoPE, distinct ones do not;
* the config field for field, ``param_count``, the shape cells, the
  parameter tree, ``input_specs`` key for key (``mrope_positions``
  [3, B, S] except for decode) and a data mesh's rows of the streams;
* ``forward`` (loss and logits) with three distinct streams and without
  them (plain RoPE, as the reference falls back), ``prefill`` with
  ``attn_impl`` ``kernel`` (the plain version here; the reference's Pallas
  kernel in interpret mode) and ``chunked``, ``decode_step`` (logits and
  every cache entry: the step's position on all three streams), greedy
  tokens, and three train steps with the streams in the batch;
* the same at the published width and one layer (the vocabulary cut to
  512): prefill with distinct streams and greedy tokens.

The streams are laid out as Qwen2-VL lays out an image
(``test_torch_cuda.image_streams``, which imports no JAX): a text prefix, a
1 x g x g patch grid at (t0, t0 + row, t0 + col), then text resuming at the
largest position + 1.  The train step's export at JAX's
FLOPs is in ``tests/test_torch_train_export.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.models import input_specs as jax_input_specs
from repro.models import params as jax_params
from repro.models import registry as jax_registry
from repro.models import rope as jax_rope
from repro.models import transformer as jax_tf
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import params, registry, rope, transformer
from repro_torch.serve.decode import greedy_decode
from repro_torch.train import data, loop, optimizer
from test_torch_cuda import image_streams
from test_torch_hybrid import (JAX_IMPL, MODEL_TOL, MODULE_TOL, SHAPES,
                               _params, _tokens)

ARCH = "qwen2-vl-7b"
# the published width at one layer, its vocabulary cut (the untied
# 152064-token head and embedding would be 4.4 GB in f32)
FULL_WIDTH = dict(num_layers=1, vocab_size=512)


def _configs(variant="smoke", impl="kernel", **kw):
    if variant == "full_width":
        jcfg = jax_registry.get_config(ARCH).scaled(
            dtype="float32", attn_impl=JAX_IMPL[impl], **FULL_WIDTH, **kw)
        tcfg = registry.get_config(ARCH).scaled(
            dtype="float32", attn_impl=impl, **FULL_WIDTH, **kw)
    else:
        jcfg = jax_registry.get_smoke_config(ARCH).scaled(
            dtype="float32", attn_impl=JAX_IMPL[impl], **kw)
        tcfg = registry.get_smoke_config(ARCH).scaled(
            dtype="float32", attn_impl=impl, **kw)
    return jcfg, tcfg


def _batches(toks, streams=None):
    targets = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)}
    tb = {"tokens": torch.from_numpy(toks),
          "targets": torch.from_numpy(targets)}
    if streams is not None:
        jb["mrope_positions"] = jnp.asarray(streams)
        tb["mrope_positions"] = torch.from_numpy(streams)
    return jb, tb


# --------------------------------------------------------------------------
# apply_mrope
# --------------------------------------------------------------------------

MROPE_CASES = {  # B, S, H, D, sections, theta, prefix, grid
    "smoke": (2, 24, 3, 16, (4, 2, 2), 10000.0, 3, 4),
    "published": (1, 40, 2, 128, (16, 24, 24), 1e6, 5, 5),
}


@pytest.mark.parametrize("case", sorted(MROPE_CASES))
def test_apply_mrope_matches_the_reference(case):
    b, s, h, d, sections, theta, prefix, grid = MROPE_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    streams = image_streams(b, s, prefix, grid)
    ours = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(streams),
                            sections, theta)
    ref = jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(streams),
                               sections, theta)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **MODULE_TOL)
    # the image's tokens differ from plain RoPE at the text positions;
    # three equal streams are plain RoPE
    text = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    plain = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(text),
                            theta)
    image = slice(prefix + 1, prefix + grid * grid)
    assert not torch.allclose(ours[:, image], plain[:, image], atol=1e-3)
    same = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(
        np.broadcast_to(text, (3, b, s)).copy()), sections, theta)
    torch.testing.assert_close(same, plain, atol=1e-6, rtol=1e-6)


def test_apply_mrope_asserts_the_sections_fill_half_the_head():
    x = torch.zeros(1, 2, 1, 16)
    with pytest.raises(AssertionError):
        rope.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32),
                         (4, 2, 1))


# --------------------------------------------------------------------------
# config, parameter tree, input specs
# --------------------------------------------------------------------------

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


def test_published_size_group_and_sections():
    cfg = registry.get_config(ARCH)
    assert cfg.param_count()[0] == 7_615_483_904
    assert cfg.num_heads // cfg.num_kv_heads == 7
    assert cfg.resolved_head_dim == 128
    assert sum(cfg.mrope_sections) == cfg.resolved_head_dim // 2


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hubert-xlarge"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_equal_the_reference(arch, kind):
    """Key for key, shape for shape and dtype for dtype: qwen2-vl's
    ``mrope_positions`` [3, B, S] int32 except for decode, hubert's
    ``embeds`` [B, S, d_model]."""
    for get in ("get_config", "get_smoke_config"):
        ours = registry.input_specs(getattr(registry, get)(arch),
                                    ShapeConfig("s", 64, 4, kind))
        ref = jax_input_specs(getattr(jax_registry, get)(arch),
                              JaxShape("s", 64, 4, kind))
        assert list(ours) == list(ref)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), k
            assert str(t.dtype)[6:] == str(ref[k].dtype), k
    assert ("mrope_positions" in ours) == (arch == ARCH and kind != "decode")


def test_a_data_mesh_takes_its_rows_of_the_streams():
    """``input_specs`` and ``ShardedLoader`` cut the streams' batch dim
    (dim 1: the axes ("norm", "batch", "seq")) over a [2, 1] mesh."""
    from repro_torch.launch.mesh import traced_mesh

    cfg = registry.get_smoke_config(ARCH)
    streams = image_streams(4, 32, 3, 4)
    streams[:, 2:] += 100          # rank 1's rows
    toks = _tokens(0, 4, 32, cfg.vocab_size)
    with traced_mesh((2, 1), "cpu") as mesh:
        specs = registry.input_specs(cfg, ShapeConfig("s", 32, 4, "train"),
                                     mesh)
        assert tuple(specs["mrope_positions"].shape) == (3, 2, 32)
        batch = next(data.ShardedLoader(iter([{
            "tokens": toks, "targets": toks, "mrope_positions": streams}]),
            mesh))
    assert tuple(batch["mrope_positions"].shape) == (3, 2, 32)
    np.testing.assert_array_equal(batch["mrope_positions"].numpy(),
                                  streams[:, :2])
    np.testing.assert_array_equal(batch["tokens"].numpy(), toks[:2])


def test_a_data_mesh_exports_the_per_rank_step_with_the_streams():
    """The per-rank train step of a [2, 1] data mesh takes its rows of the
    streams (``data_parallel``'s per-rank forward passes the batch whole):
    its text's ``dot_general`` FLOPs are the whole step's over 2."""
    from repro_torch.core import ir
    from repro_torch.core.pipeline import export_workload
    from repro_torch.launch.mesh import traced_mesh
    from repro_torch.train.loop import train_step_exports

    cfg = registry.get_smoke_config(ARCH).scaled(attn_impl="chunked")
    step, args = train_step_exports(cfg, 32, 4)
    with traced_mesh((2, 1), "cpu") as mesh:
        rstep, rargs = train_step_exports(cfg, 32, 4, mesh)
        w = export_workload(step, *args, device="cpu",
                            per_rank=(rstep, rargs, mesh))
    assert tuple(rargs[2]["mrope_positions"].shape) == (3, 2, 32)

    def flops(text):
        return int(ir.program_cost(ir.parse_stablehlo(text)).by_op[
            "dot_general"])
    assert 2 * flops(w.hlo_text) == flops(w.stablehlo_text) > 0


# --------------------------------------------------------------------------
# forward, prefill, decode, greedy tokens, the train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("streams", ["image", "none"])
def test_forward_loss_and_logits(streams):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    toks = _tokens(5, 2, 48, jcfg.vocab_size)
    pos = image_streams(2, 48, 6, 5) if streams == "image" else None
    jb, tb = _batches(toks, pos)
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)
    if streams == "image":
        # the streams reach every layer: without them the logits move
        _, text = transformer.forward(tcfg, tp, _batches(toks)[1])
        assert not torch.allclose(logits, text, atol=1e-3)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("variant", ["smoke", "full_width"])
def test_prefill_logits_with_image_streams(variant, impl):
    jcfg, tcfg = _configs(variant, impl, attn_chunk=16)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(6, 2, 48, jcfg.vocab_size)
    jb, tb = _batches(toks, image_streams(2, 48, 4, 6))
    out = transformer.prefill(tcfg, tp, tb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), jax_tf.prefill(jcfg, jp, jb),
                               **MODEL_TOL)
    model = transformer.TransformerLM(tcfg, tp)
    torch.testing.assert_close(model.prefill(tb), out, atol=0, rtol=0)


def test_decode_step_logits_and_cache():
    """A decoded token takes its position on all three streams, in both
    packages; every cache entry after each step."""
    jcfg, tcfg = _configs()
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
        for name in set(jcache) - {"index"}:
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       **MODEL_TOL, err_msg=name)
    assert int(tcache["index"]) == int(jcache["index"]) == 5


@pytest.mark.parametrize("variant", ["smoke", "full_width"])
def test_greedy_tokens_equal_the_reference(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=3)
    prompt = _tokens(8, 2, 5, jcfg.vocab_size)
    out = greedy_decode(tcfg, tp, torch.from_numpy(prompt),
                        max_new_tokens=6, max_len=16)
    ref = jax_greedy_decode(jcfg, jp, jnp.asarray(prompt),
                            max_new_tokens=6, max_len=16)
    assert out.steps == ref.steps == 6
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    model = transformer.TransformerLM(tcfg, tp)
    np.testing.assert_array_equal(
        model.generate(torch.from_numpy(prompt), 6, 16).tokens.numpy(),
        out.tokens.numpy())


def test_train_step_with_image_streams_matches_jax_over_three_steps():
    """``make_train_step`` (K1b's and K2b's plain backwards here) against
    the reference's under AdamW (its chunked attention: the Pallas kernel
    has no derivative), each batch carrying its three streams."""
    from test_torch_train import _assert_params_close

    jcfg, tcfg = _configs()
    jcfg = jcfg.scaled(attn_impl="chunked")
    ocfg_j = jax_opt.OptimizerConfig(warmup_steps=2)
    ocfg_t = optimizer.OptimizerConfig(warmup_steps=2)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, ocfg_j))
    tstep = loop.make_train_step(tcfg, ocfg_t)
    jp, tp = _params(jcfg, seed=4)
    js = jax_opt.make_optimizer(ocfg_j)[0](jp, ocfg_j)
    ts = params.params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for i in range(3):
        jb, tb = _batches(_tokens(10 + i, 4, 32, jcfg.vocab_size),
                          image_streams(4, 32, 2 + i, 4))
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
    _assert_params_close(tp, jp, lr=ocfg_t.learning_rate, steps=3,
                         share=0.999)
