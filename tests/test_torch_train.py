"""The port's training slice against the JAX package, on the CPU in f32: the
plain backwards of K1 and K2 against ``jax.grad`` of the JAX references, the
optimizers, the data source, the losses, and ``make_train_step`` on two
Llama smoke configs; then the loop's checkpoint/restart, the checkpoint's
bf16 round trip and the CLI.  Inputs come from numpy's seeded generator;
JAX parameters and optimizer state carry across with ``params_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.train import data as jax_data
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_fwd_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.models.params import params_from_jax
from repro_torch.models.registry import get_smoke_config
from repro_torch.train import data, loop, optimizer
from repro_torch.train.checkpoint import CheckpointManager

# one f32 function in two libraries: sums of at most a few hundred terms in
# another order
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(ours, ref, **tol):
    flat_ref = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                jax.tree_util.tree_leaves_with_path(ref)}
    flat = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_leaves_with_path(ours)}
    assert flat.keys() == flat_ref.keys()
    for name, x in flat.items():
        np.testing.assert_allclose(x.float().numpy(),
                                   flat_ref[name].astype(np.float32),
                                   err_msg=name, **tol)


# --------------------------------------------------------------------------
# kernels' plain backwards
# --------------------------------------------------------------------------

ATTN_CASES = {  # B, Hq, Hkv, Sq, Skv, D, causal, window, cap, q_offset
    "causal_d64": (2, 4, 4, 24, 24, 64, True, 0, 0.0, 0),
    "gqa_d32": (1, 8, 2, 20, 20, 32, True, 0, 0.0, 0),
    "window_gqa": (2, 4, 2, 32, 32, 64, True, 7, 0.0, 0),
    "cap_d128": (1, 4, 2, 16, 16, 128, True, 0, 2.0, 0),
    "offset_bidir": (1, 4, 2, 8, 40, 32, False, 0, 0.0, 0),
    "offset_causal": (1, 4, 1, 12, 40, 64, True, 16, 1.5, 28),
}


def _attn_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, causal, window, cap, off = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off)
    return q, k, v, do, kw


def _jax_attention_grads(q, k, v, do, kw):
    group = q.shape[1] // k.shape[1]

    def f(q, k, v):
        out = jax_attention_ref(q, jnp.repeat(k, group, axis=1),
                                jnp.repeat(v, group, axis=1), **kw)
        return jnp.sum(out * do)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_ref_matches_jax_grad(case):
    q, k, v, do, kw = _attn_inputs(case)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_attention_fwd_ref(tq, tk, tv, **kw)
    ours = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for name, x, ref in zip("qkv", ours, _jax_attention_grads(q, k, v, do,
                                                             kw)):
        np.testing.assert_allclose(x.numpy(), ref, err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_autograd_is_the_plain_backward(case):
    # the wrapper's gradient on the CPU, against torch.autograd through the
    # plain forward's own ops
    q, k, v, do, kw = _attn_inputs(case, seed=1)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, **kw), leaves,
                                _t(do))
    ref_leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    from repro_torch.kernels.flash_attention.ref import _scores
    scores, _, mask = _scores(ref_leaves[0], ref_leaves[1], **kw)
    probs = torch.softmax(scores.masked_fill(~mask, -2.0e38), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, ref_leaves[2])
    refs = torch.autograd.grad(out.reshape(q.shape), ref_leaves, _t(do))
    for name, x, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(x.numpy(), ref.numpy(), err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_lse_is_the_logsumexp_of_the_visible_scores(case):
    q, k, v, _, kw = _attn_inputs(case, seed=2)
    _, lse = flash_attention_fwd_ref(*map(_t, (q, k, v)), **kw)
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    kk = np.repeat(k, hq // k.shape[1], axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(d)
    if kw["logit_cap"] > 0:
        s = kw["logit_cap"] * np.tanh(s / kw["logit_cap"])
    diff = (np.arange(sq)[:, None] + kw["q_offset"]) - np.arange(skv)[None]
    mask = np.ones_like(diff, dtype=bool)
    if kw["causal"]:
        mask &= diff >= 0
    if kw["window"]:
        mask &= diff < kw["window"]
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-6)


def test_rows_without_a_visible_key_give_no_gradient():
    # q_offset past the window: no query sees any key, lse is -inf, and the
    # gradients are exactly 0 (no NaN)
    rng = np.random.default_rng(3)
    q, k, v, do = (_t(rng.standard_normal((1, 2, 8, 32)).astype(np.float32))
                   for _ in range(4))
    kw = dict(causal=True, window=4, q_offset=64)
    o, lse = flash_attention_fwd_ref(q, k, v, **kw)
    assert torch.isneginf(lse).all()
    for g in flash_attention_bwd_ref(q, k, v, o, lse, do, **kw):
        assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_bwd_ref_matches_jax_grad_and_autograd(offset):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((3, 8, 64)).astype(np.float32)
    dx, dw = rmsnorm_bwd_ref(_t(x), _t(w), _t(dy), 1e-5, offset)
    jdx, jdw = jax.jit(jax.grad(lambda x, w: jnp.sum(
        jax_common.rms_norm(x, w, 1e-5, offset) * dy), argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **GRAD_TOL)
    # the wrapper's CPU gradient and torch.autograd of the plain forward
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = torch.autograd.grad(rmsnorm(tx, tw, 1e-5, offset), (tx, tw),
                              _t(dy))
    ref = torch.autograd.grad(rmsnorm_ref(tx, tw, 1e-5, offset), (tx, tw),
                              _t(dy))
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **GRAD_TOL)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def _opt_tree(rng):
    """A parameter tree with factored (>= 128 x 128) and unfactored
    leaves, in f32 and bf16."""
    return {"w": rng.standard_normal((2, 128, 160)).astype(np.float32),
            "b": rng.standard_normal((160,)).astype(np.float32),
            "e": {"t": (0.1 * rng.standard_normal((130, 8))).astype(
                jnp.bfloat16)}}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax_over_three_steps(name):
    rng = np.random.default_rng(5)
    cfg_j = jax_opt.OptimizerConfig(name=name, warmup_steps=2)
    cfg_t = optimizer.OptimizerConfig(name=name, warmup_steps=2)
    jinit, jupd = jax_opt.make_optimizer(cfg_j)
    jupd = jax.jit(jupd, static_argnums=3)
    tinit, tupd = optimizer.make_optimizer(cfg_t)
    jp = jax.tree.map(jnp.asarray, _opt_tree(rng))
    js = jinit(jp, cfg_j)
    tp, ts = params_from_jax(_np(jp), "cpu"), params_from_jax(_np(js), "cpu")
    assert ts["step"].dtype == torch.int32
    _assert_tree_close(ts, js, atol=0, rtol=0)
    _assert_tree_close(tinit(tp, cfg_t), js, atol=0, rtol=0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)).astype(p.dtype), jp)
        jp, js, jm = jupd(jp, g, js, cfg_j)
        tp, ts, tm = tupd(tp, params_from_jax(_np(g), "cpu"), ts, cfg_t)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    # f32 elementwise arithmetic in the same order: within a few ulps; a bf16
    # leaf may round the other way on a tie of those ulps (2^-8)
    _assert_tree_close({k: v for k, v in tp.items() if k != "e"},
                       {k: v for k, v in jp.items() if k != "e"},
                       atol=1e-6, rtol=1e-6)
    _assert_tree_close(tp["e"], jp["e"], atol=1e-3, rtol=2 ** -8)
    _assert_tree_close(ts, js, atol=1e-6, rtol=1e-5)


def test_opt_state_abstract_shapes_match_jax():
    specs = transformer.model_specs(get_smoke_config("llama3-1b"))
    jspecs = jax_tf.model_specs(jax_get_smoke_config("llama3-1b"))
    for name in ("adamw", "adafactor"):
        ours = optimizer.opt_state_abstract(specs, name)
        ref = jax_opt.opt_state_abstract(jspecs, name)
        shapes = [(tuple(x.shape), str(x.dtype).split(".")[-1], x.device.type)
                  for x in jax.tree.leaves(ours)]
        assert shapes == [(tuple(x.shape), str(x.dtype), "meta")
                          for x in jax.tree.leaves(ref)]


def test_schedule_clip_and_int8_match_jax():
    cfg_j, cfg_t = jax_opt.OptimizerConfig(), optimizer.OptimizerConfig()
    for step in (0, 1, 50, 100, 250):
        assert float(optimizer.lr_schedule(cfg_t, torch.tensor(step))) == \
            float(jax_opt.lr_schedule(cfg_j, jnp.int32(step)))
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "b": {"c": 3 * rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        ours, norm = optimizer.clip_by_global_norm(
            params_from_jax(tree, "cpu"), max_norm)
        ref, jnorm = jax_opt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        _assert_tree_close(ours, ref, atol=1e-7, rtol=1e-6)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    q, s = loop.quantize_int8(_t(g))
    jq, js = jax_loop.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    np.testing.assert_allclose(
        loop.dequantize_int8(q, s, torch.float32).numpy(),
        jax_loop.dequantize_int8(jq, js, jnp.float32), rtol=1e-6)


# --------------------------------------------------------------------------
# data and losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["none", "stub"])
def test_synthetic_source_is_jax_bit_for_bit_and_resumable(frontend):
    kw = dict(vocab_size=97, seq_len=12, global_batch=3, seed=7,
              frontend=frontend, d_model=8)
    ours = data.SyntheticSource(data.DataConfig(**kw))
    ref = jax_data.SyntheticSource(jax_data.DataConfig(**kw))
    batches = [next(ours) for _ in range(3)]
    for b in batches:
        r = next(ref)
        assert b.keys() == r.keys()
        for k in b:
            assert b[k].dtype == r[k].dtype and np.array_equal(b[k], r[k])
    resumed = data.SyntheticSource(data.DataConfig(**kw))
    resumed.restore({"step": 1, "seed": 7})
    assert all(np.array_equal(x, y) for x, y in
               zip(next(resumed).values(), batches[1].values()))
    assert ours.state() == {"step": 3, "seed": 7}


@pytest.mark.parametrize("vocab,chunk", [(256, 64), (250, 64), (256, 256)])
def test_chunked_cross_entropy_matches_jax_and_full_ce(vocab, chunk):
    # vocab 250 is not a multiple of the chunk: the last chunk is narrower
    jcfg = jax_get_smoke_config("llama3-1b").scaled(dtype="float32",
                                                     vocab_size=vocab)
    tcfg = get_smoke_config("llama3-1b").scaled(dtype="float32",
                                                vocab_size=vocab)
    jp = jax_init_params(jax_tf.model_specs(jcfg), jax.random.PRNGKey(1))
    tp = params_from_jax(_np(jp), "cpu")
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, vocab, (2, 6)).astype(np.int32)
    ours = transformer.chunked_cross_entropy(tcfg, tp, _t(h), _t(tgt), chunk)
    ref = jax_tf.chunked_cross_entropy(jcfg, jp, jnp.asarray(h),
                                       jnp.asarray(tgt), chunk)
    full = transformer.cross_entropy(
        transformer._logits(tcfg, tp, _t(h)), _t(tgt))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(ours), float(full), rtol=1e-6)


# --------------------------------------------------------------------------
# the slice as a whole: make_train_step
# --------------------------------------------------------------------------

STEP_CONFIGS = {
    # GQA group 2
    "llama3-1b": ("llama3-1b", {}),
    # two padded query heads: group 3 over 2 KV heads
    "llama3-500m-pad": ("llama3-500m", {"pad_heads": 2}),
}
STEP_VARIANTS = {
    "adamw": ({}, {}),
    "adafactor": ({}, {"name": "adafactor"}),
    "microbatch2": ({"microbatch": 2}, {}),
    "int8_grads": ({"gradient_compression": True}, {}),
    "vocab_chunk": ({"loss_vocab_chunk": 96}, {}),
    "remat_full": ({"remat": "full"}, {}),
}


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_make_train_step_matches_jax_over_three_steps(config, variant):
    arch, model_kw = STEP_CONFIGS[config]
    step_kw, opt_kw = (dict(kw) for kw in STEP_VARIANTS[variant])
    cfg_kw = dict(model_kw, dtype="float32")
    for key in ("loss_vocab_chunk", "remat"):
        if key in step_kw:
            cfg_kw[key] = step_kw.pop(key)
    jcfg = jax_get_smoke_config(arch).scaled(**cfg_kw)     # "chunked"
    tcfg = get_smoke_config(arch).scaled(**cfg_kw)         # "kernel"
    assert tcfg.attn_impl == "kernel"
    opt_j = jax_opt.OptimizerConfig(warmup_steps=2, **opt_kw)
    opt_t = optimizer.OptimizerConfig(warmup_steps=2, **opt_kw)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, opt_j, **step_kw))
    tstep = loop.make_train_step(tcfg, opt_t, **step_kw)
    jp = jax_init_params(jax_tf.model_specs(jcfg), jax.random.PRNGKey(0))
    js = jax_opt.make_optimizer(opt_j)[0](jp, opt_j)
    tp, ts = params_from_jax(_np(jp), "cpu"), params_from_jax(_np(js), "cpu")
    source = data.SyntheticSource(data.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=3))
    for _ in range(3):
        batch = next(source)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, {k: _t(v) for k, v in batch.items()})
        # f32 forward and backward of a 2-layer model in two libraries.
        # Steps 2 and 3 start from parameters that already differ where the
        # optimizer amplified f32 noise (see _assert_params_close), which
        # moves the gradient's norm by up to a few parts in 1e4.  With int8
        # gradients an element within f32 noise of a half level rounds to
        # the other level (1/127 of its leaf's largest gradient), which
        # moves the norm by up to a few parts in 1e3
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            float(tm["grad_norm"]), float(jm["grad_norm"]),
            rtol=2e-3 if step_kw.get("gradient_compression") else 5e-4)
    _assert_params_close(
        tp, jp, lr=opt_t.learning_rate, steps=3,
        share=0.99 if step_kw.get("gradient_compression") else 0.999)


def _assert_params_close(ours, ref, *, lr, steps, share):
    """Parameters after ``steps`` optimizer steps of rate at most ``lr``.
    Adam and Adafactor divide a gradient by its own running magnitude, so
    where a gradient is at the noise level of f32 (an embedding row that
    hardly any token hits), two libraries' rounding can move that element's
    update by up to lr a step; so can an int8 gradient that rounds to the
    other level.  So: ``share`` of each leaf's elements within 1e-5, and
    every element within 2 lr a step."""
    flat_ref = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                jax.tree_util.tree_leaves_with_path(ref)}
    for p, x in jax.tree_util.tree_leaves_with_path(ours):
        name = jax.tree_util.keystr(p)
        r = flat_ref[name].astype(np.float32)
        diff = np.abs(x.float().numpy() - r)
        assert (diff <= 1e-5 + 1e-5 * np.abs(r)).mean() >= share, name
        assert diff.max() <= 2 * lr * steps, (name, diff.max())


# --------------------------------------------------------------------------
# loop, checkpoint, CLI
# --------------------------------------------------------------------------

def _smoke_run(**kw):
    cfg = get_smoke_config("llama3-1b").scaled(num_layers=1)
    return RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"), **kw)


def test_train_restarts_from_checkpoint_after_injected_failure(tmp_path):
    res = loop.train(_smoke_run(), device="cpu", num_steps=5,
                     checkpoint_dir=str(tmp_path), checkpoint_every=1,
                     log_every=0, inject_failure_at=3)
    assert res.restarts == 1 and res.steps == 5
    assert np.isfinite(res.final_loss) and len(res.losses) == 5
    # resuming after the end runs no step
    again = loop.train(_smoke_run(), device="cpu", num_steps=5,
                       checkpoint_dir=str(tmp_path), resume=True, log_every=0)
    assert again.steps == 0


def test_checkpoint_round_trip_keeps_bf16_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(300, 7, generator=gen).bfloat16(),
                        "n": {"b": torch.randn(5, generator=gen)}},
             "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state, {"step": step, "seed": 0})
    mgr.wait()
    assert mgr.committed_steps() == [2, 3]
    tree, ds, step = mgr.restore_latest("cpu")
    assert step == 3 and ds == {"step": 3, "seed": 0}
    w = tree["params"]["w"]
    assert w.dtype == torch.bfloat16 and torch.equal(
        w.view(torch.int16), state["params"]["w"].view(torch.int16))
    assert torch.equal(tree["params"]["n"]["b"], state["params"]["n"]["b"])
    assert tree["opt"]["step"].dtype == torch.int32
    assert int(tree["opt"]["step"]) == 4


def test_cli_runs_two_smoke_steps_on_the_cpu(capsys):
    train_cli.main(["--arch", "llama3-1b", "--smoke", "--steps", "2",
                    "--seq", "16", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "finished 2 steps" in out
