"""The port's ResNet (fig7's workload family) against the JAX package, on
the CPU.

(a) ``repro_torch.models.resnet`` against ``repro.models.resnet`` in f32 at
a small width (8 channels, 10 classes, 4 images of 32 pixels at depth 18
(basic blocks), of 64 at depth 50 (bottlenecks)): the loss and the logits,
every leaf's gradient against ``jax.grad``'s, and one AdamW step against
the reference's jitted ``resnet_train_exports`` step, its update held
element by element; and one f16 step's update, cast back as the reference
casts it.  The stride-2 windows of ``"SAME"`` padding are asymmetric;
padding them symmetrically moves every window by a pixel and keeps the
shapes, which these comparisons see.

(b) The data mesh: 4 gloo ranks (``tests/torch_dist_ranks.py``) run the
resnet18 rank step on 2 images each; its loss, gradient norm and new
parameters equal JAX's global step on the 8 images, which takes its
batch-norm statistics over all of them.

(c) The export, in f16 as fig7 has it: resnet18 at 2 x 32 has JAX's 62
convolutions, their FLOPs and the head's ``dot_general`` FLOPs, read by
both front ends; the per-rank text of ``[4, 1]`` at 8 x 32 has a quarter of
the convolution FLOPs and every collective typed by its payload; and in
f32, XLA on the CPU runs the raw text to the eager step's results.
"""
import dataclasses
import multiprocessing
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src import compiler, xla_bridge
from jax._src.lib import xla_client
from torch.utils import _pytree as pytree

import torch_dist_ranks
from repro.core import ir as jax_ir
from repro.core.pipeline import export_workload as jax_export_workload
from repro.models import resnet as jr
from repro.models.params import init_params as jax_init_params
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.campaign.builders import build_workload
from repro_torch.campaign.spec import WorkloadSpec
from repro_torch.core import ir
from repro_torch.core.ir.collectives import collect_collectives
from repro_torch.core.pipeline import export_workload
from repro_torch.models import resnet as tr
from repro_torch.models.params import params_from_jax
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

BATCH, IMG, CLASSES, WIDTH = 4, 32, 10, 8
# the image size of the f32 comparisons: at 32 pixels depth 50's last
# stage would normalise over 4 values a channel (4 images of 1 x 1), at 64
# over 16
STEP_IMG = {18: IMG, 50: 64}
# the step's optimizer: the reference's AdamW with the learning rate
# reached on the first step, so that the update is not 1/100 of it
OPT = dict(name="adamw", warmup_steps=1, learning_rate=3e-4)

# f32 tolerances, from the spread over 16 draws of parameters and images
# besides the test's own (jax 0.9 and torch 2.13 on the CPU), at the sizes
# above.  Depth 18: the loss to 1e-4 relative (largest 2.5e-5) and the
# logits to 1e-4 of their largest magnitude (7.3e-5).  Depth 50: the loss
# to 2e-4 (largest 3.9e-5) and the logits to 5e-4 (1.1e-4).
#
# A gradient tree (and each moment of the step) is held as a whole to a
# share of its norm ("grad_norm") and each leaf to a share of its own norm
# ("leaf_norm").  A ReLU whose input lies within rounding of 0 in one
# package and not in the other flips its mask, and the flip moves every
# gradient upstream of it by up to a few percent of that leaf: at depth 18
# the largest are 2.5e-4 of the tree and 1.5e-3 of a leaf (the draw the
# tests take), at depth 50 3.6e-2 and 9.2e-2 (a flip in 10 of 17 draws).
# A window moved by one pixel (symmetric padding) moves the loss by more
# than 1e-2 at either depth.
#
# The new parameters: see _updates_close.  "loose" is the share of all
# elements whose update may differ by more than the tight bound, all of
# them elements whose gradient is not decided (largest 1.5e-3 at depth 18
# and 6.0e-2 at depth 50; the decided elements' largest is 0.22 of the
# tight bound).
TOL = {18: {"loss": 1e-4, "logits": 1e-4, "grad_norm": 1e-2,
            "leaf_norm": 0.1, "loose": 5e-3},
       50: {"loss": 2e-4, "logits": 5e-4, "grad_norm": 0.1,
            "leaf_norm": 0.2, "loose": 0.15}}
LR = 3e-4
# OptimizerConfig's defaults
B1, EPS = 0.9, 1e-8
# a first moment at least this (|g| >= 1e3 eps) decides its update's sign
# and size against eps
DECIDED_M = 1e3 * EPS * (1 - B1)


def _cfgs(depth: int, dtype: str = "float32"):
    kw = dict(depth=depth, dtype=dtype, width=WIDTH, num_classes=CLASSES)
    return jr.ResNetConfig(**kw), tr.ResNetConfig(**kw)


def _inputs(depth: int, batch: int = BATCH, dtype: str = "float32",
            img: int = IMG):
    jcfg, tcfg = _cfgs(depth, dtype)
    jp = jax_init_params(jr.resnet_specs(jcfg), jax.random.PRNGKey(depth))
    rng = np.random.default_rng(depth)
    images = rng.standard_normal((batch, img, img, 3)).astype(np.float16)
    labels = rng.integers(0, CLASSES, batch).astype(np.int32)
    return jcfg, tcfg, jp, images, labels


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _close(got, want, rtol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _trees_close(got: dict, want: dict, rtol: float, what: str) -> None:
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        _close(got[name], want[name], rtol, f"{what} {name}")


def _gradients_close(got: dict, want: dict, depth: int, what: str) -> None:
    """The whole tree to TOL's "grad_norm" of its norm, each leaf to its
    "leaf_norm" of the leaf's norm."""
    tol = TOL[depth]
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    err = {k: float(((got[k] - want[k]).astype(np.float64) ** 2).sum())
           for k in want}
    norm = {k: float((want[k].astype(np.float64) ** 2).sum()) for k in want}
    total = sum(norm.values())
    assert sum(err.values()) <= tol["grad_norm"] ** 2 * total, (
        what, (sum(err.values()) / total) ** 0.5)
    for k in want:
        assert err[k] <= tol["leaf_norm"] ** 2 * norm[k], (
            what, k, (err[k] / max(norm[k], 1e-300)) ** 0.5)


def _updates_close(old: dict, got: dict, want: dict, got_m: dict,
                   want_m: dict, loose: float, what: str) -> None:
    """New parameters against the reference's, element by element.

    AdamW's first step moves a parameter by lr (g / (|g| + eps) + wd p):
    about lr sign(g) + lr wd p wherever |g| is far above eps.  Where the
    gradient is decided (the reference's first moment, 1 - b1 times the
    clipped gradient, at least DECIDED_M, and the port's within a tenth of
    it, so that the two cannot differ in sign or against eps), the update
    (new - old, i.e. new itself, old being shared) is held to 1e-3 lr plus
    4 ulps of the parameter (its roundings in two compilers); in f16, where
    both packages round the same f32 value, to equality, or one ulp on at
    most 1e-3 of the decided elements.  On the other elements (a gradient
    within rounding of 0, or moved by a flipped ReLU mask) the sign may
    flip, so the update is held to 2 lr (plus the rounding allowance), and
    at most ``loose`` of all elements may differ by more than the tight
    bound.  A step that skips its update, flips its sign or scales its lr
    misses the tight bound on every decided element."""
    old, got, want = _flat(old), _flat(got), _flat(want)
    got_m, want_m = _flat(got_m), _flat(want_m)
    assert got.keys() == want.keys() == old.keys() == want_m.keys()
    total = beyond = decided_n = apart = 0
    for name, p in old.items():
        assert got[name].dtype == want[name].dtype == p.dtype, name
        err = np.abs(got[name].astype(np.float64) - want[name])
        m, mr = got_m[name], want_m[name].astype(np.float64)
        decided = (np.abs(mr) >= DECIDED_M) & (np.abs(m - mr)
                                               <= 0.1 * np.abs(mr))
        if p.dtype == np.float16:
            tight = np.zeros_like(err)
            ulp = np.spacing(np.maximum(np.abs(want[name]), np.abs(
                got[name]))).astype(np.float64)
            assert (err[decided] <= ulp[decided]).all(), (what, name)
            apart += int((err[decided] > 0).sum())
        else:
            ulp = 4 * np.spacing(np.abs(p)).astype(np.float64)
            tight = 1e-3 * LR + ulp
            assert (err[decided] <= tight[decided]).all(), (
                what, name, float((err - tight)[decided].max()))
        assert (err <= 2 * LR + ulp).all(), (what, name, float(err.max()))
        total += err.size
        decided_n += int(decided.sum())
        beyond += int((err > tight).sum())
    assert apart <= 1e-3 * decided_n, (what, apart, decided_n)
    assert beyond <= loose * total, (what, beyond, total)


# --------------------------------------------------------------------------
# (a) forward, gradients and the step in f32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                   (56, 1, 2), (56, 3, 1), (7, 3, 1),
                                   (15, 3, 2), (16, 3, 2), (32, 7, 2)])
def test_same_pads_are_xlas(n, k, s):
    assert tr.same_pads(n, k, s) == tuple(lax.padtype_to_pads(
        (n,), (k,), (s,), "SAME")[0])


def _spec_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), tuple(v.axes), v.init,
                               v.dtype)
    return out


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_specs_are_the_reference_tree(depth):
    jcfg, tcfg = _cfgs(depth, "float16")
    assert _spec_leaves(tr.resnet_specs(tcfg)) == _spec_leaves(
        jr.resnet_specs(jcfg))
    assert tr.resnet_arch_config(f"resnet{depth}") == tr.ResNetConfig(
        depth=depth)


def test_unknown_resnet_ids_raise():
    for arch in ("resnet19", "resnetx", "llama3-1b"):
        with pytest.raises(ValueError):
            tr.resnet_arch_config(arch)


def test_f16_parameters_carry_across_bit_for_bit():
    _, tcfg, jp, _, _ = _inputs(18, dtype="float16")
    got = _flat(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    for name, want in _flat(jax.tree.map(np.asarray, jp)).items():
        assert want.dtype == np.float16
        assert got[name].dtype == np.float16
        assert np.array_equal(got[name].view(np.uint16),
                              want.view(np.uint16)), name


@pytest.mark.parametrize("depth", [18, 50])
def test_forward_and_gradients_equal_the_reference(depth):
    jcfg, tcfg, jp, images, labels = _inputs(depth, img=STEP_IMG[depth])
    (jloss, jlogits), jgrads = jax.value_and_grad(
        lambda p: jr.resnet_forward(jcfg, p, images, labels),
        has_aux=True)(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    timages, tlabels = torch.from_numpy(images), torch.from_numpy(labels)
    loss, logits = tr.resnet_forward(tcfg, params, timages, tlabels)
    tol = TOL[depth]
    _close(float(loss), float(jloss), tol["loss"], "loss")
    _close(logits.numpy(), np.asarray(jlogits), tol["logits"], "logits")
    gloss, grads = tr._value_and_grad(tcfg, params, timages, tlabels)
    assert float(gloss) == float(loss)
    _gradients_close(grads, jax.tree.map(np.asarray, jgrads), depth,
                     "gradient")


def _both_steps(depth: int, dtype: str, img: int):
    """One AdamW step of the reference's jitted step and of the port's on
    the same parameters and images: (old parameters, the reference's
    (new, opt, loss), the port's)."""
    jcfg, tcfg, jp, images, labels = _inputs(depth, dtype=dtype, img=img)
    jopt_cfg = JaxOptimizerConfig(**OPT)
    jstep, _ = jr.resnet_train_exports(jcfg, BATCH, img, opt_cfg=jopt_cfg)
    jinit, _ = jax_make_optimizer(jopt_cfg)
    old = jax.tree.map(np.array, jp)
    params = params_from_jax(old, device="cpu")
    # the jitted step donates its parameters and state
    ref = jax.tree.map(np.asarray, jstep(
        jp, jinit(jp, jopt_cfg), jnp.asarray(images), jnp.asarray(labels)))
    opt_cfg = OptimizerConfig(**OPT)
    init, _ = make_optimizer(opt_cfg)
    step, args = tr.resnet_train_exports(tcfg, BATCH, img, opt_cfg=opt_cfg)
    # the same abstract arguments (JAX's trees flatten in sorted key order)
    assert sorted(tuple(a.shape) for a in pytree.tree_leaves(args)) == \
        sorted(a.shape for a in jax.tree.leaves(jr.resnet_train_exports(
            jcfg, BATCH, img, opt_cfg=jopt_cfg)[1]))
    got = step(params, init(params, opt_cfg), torch.from_numpy(images),
               torch.from_numpy(labels))
    return old, ref, got


@pytest.mark.parametrize("depth", [18, 50])
def test_one_adamw_step_equals_the_reference(depth):
    """New parameters, both moments (which carry the clipped gradient) and
    the loss of one step, against the reference's jitted step."""
    old, (jnew, jopt, jloss), (new, opt, loss) = _both_steps(
        depth, "float32", STEP_IMG[depth])
    tol = TOL[depth]
    _close(float(loss), float(jloss), tol["loss"], "loss")
    assert int(opt["step"]) == int(jopt["step"]) == 1
    _updates_close(old, new, jnew, opt["m"], jopt["m"], tol["loose"],
                   "parameters")
    for moment in ("m", "v"):
        _gradients_close(opt[moment], jopt[moment], depth, moment)


# f16, resnet18 at 4 x 32: the packages' f16 forwards round apart, so the
# loss is held to 1e-2 relative (largest 2.4e-3 over 13 draws); the
# moments' ReLU flips move far more elements than in f32 (up to 9.2e-2 of
# them beyond the tight bound, in the test's draw), held to 0.25
F16_LOSS, F16_LOOSE = 1e-2, 0.25


def test_an_f16_step_updates_as_the_reference():
    """The f32 update cast back to f16 parameters, as the reference's
    optimizer does it: on every decided element the same f16 value."""
    old, (jnew, jopt, jloss), (new, opt, loss) = _both_steps(
        18, "float16", IMG)
    _close(float(loss), float(jloss), F16_LOSS, "loss")
    _updates_close(old, new, jnew, opt["m"], jopt["m"], F16_LOOSE,
                   "f16 parameters")


def test_an_f16_step_keeps_f32_moments_and_f16_parameters():
    _, tcfg, jp, images, labels = _inputs(18, dtype="float16")
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    opt_cfg = OptimizerConfig(**OPT)
    init, _ = make_optimizer(opt_cfg)
    new, opt, loss = tr.make_resnet_train_step(tcfg, opt_cfg)(
        params, init(params, opt_cfg), torch.from_numpy(images),
        torch.from_numpy(labels))
    assert np.isfinite(float(loss)) and loss.dtype == torch.float32
    assert {t.dtype for t in pytree.tree_leaves(new)} == {torch.float16}
    assert {t.dtype for t in pytree.tree_leaves((opt["m"], opt["v"]))} == {
        torch.float32}


# --------------------------------------------------------------------------
# (b) the data mesh: 4 gloo ranks against JAX's global step
# --------------------------------------------------------------------------

WORLD, MESH_BATCH = 4, 8
# a spawned rank that has not finished by then is terminated
RANK_TIMEOUT_S = 240
# f32, resnet18 at 8 x 32: the ranks sum their batch-norm statistics, the
# loss and the gradients in another order than XLA does on the whole batch.
# The loss and the gradient norm are held to 1e-4 relative, the new
# parameters and the moments as depth 18's above.
MESH_TOL = 1e-4


def _mesh_reference():
    jcfg, tcfg, jp, images, labels = _inputs(18, batch=MESH_BATCH)
    jopt_cfg = JaxOptimizerConfig(**OPT)
    jstep, _ = jr.resnet_train_exports(jcfg, MESH_BATCH, IMG,
                                       opt_cfg=jopt_cfg)
    jinit, _ = jax_make_optimizer(jopt_cfg)
    grads = jax.grad(lambda p: jr.resnet_forward(jcfg, p, images,
                                                 labels)[0])(jp)
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree.leaves(grads))))
    whole = jax.tree.map(np.array, jp)
    # the jitted step donates its parameters and state
    new, opt, loss = jax.tree.map(np.asarray, jstep(
        jp, jinit(jp, jopt_cfg), jnp.asarray(images), jnp.asarray(labels)))
    return tcfg, whole, images, labels, {"loss": float(loss), "norm": norm,
                                      "old": whole, "params": new,
                                      "opt": opt}


@pytest.fixture(scope="module")
def gloo_resnet(tmp_path_factory):
    work = tmp_path_factory.mktemp("resnet_gloo")
    tcfg, jp, images, labels, ref = _mesh_reference()
    torch.save({"cfg": tcfg, "opt_cfg": OptimizerConfig(**OPT),
                "params": params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu"),
                "images": torch.from_numpy(images),
                "labels": torch.from_numpy(labels)},
               work / "inputs.pt")
    return _spawn(work, "resnet"), ref, tcfg


def _spawn(work: Path, job: str) -> list[dict]:
    ctx = multiprocessing.get_context("spawn")
    store = str(work / "store")
    procs = [ctx.Process(target=torch_dist_ranks.run,
                         args=(r, WORLD, store, str(work), job))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_four_gloo_ranks_equal_jax_global_step(gloo_resnet):
    ranks, ref, tcfg = gloo_resnet
    for r in ranks:
        _close(float(r["loss"]), ref["loss"], MESH_TOL, "loss")
        _close(float(r["grad_norm"]), ref["norm"], MESH_TOL, "grad norm")
    # each rank's shards, joined in rank order, are JAX's whole leaves
    whole = _whole_from_ranks(ranks)
    _updates_close(ref["old"], whole["params"], ref["params"],
                   whole["opt"]["m"], ref["opt"]["m"], TOL[18]["loose"],
                   "parameters")
    for moment in ("m", "v"):
        _gradients_close(whole["opt"][moment], ref["opt"][moment], 18,
                         moment)


def _whole_from_ranks(ranks) -> dict:
    """The ranks' shards joined along each leaf's sharded dim."""
    dims = ranks[0]["dims"]

    def join(key):
        def go(trees, d):
            if isinstance(d, dict):
                return {k: go([t[k] for t in trees], d[k]) for k in d}
            return trees[0] if d is None else torch.cat(trees, d)
        return go([r[key] for r in ranks], dims)
    return {"params": join("params"),
            "opt": {m: join(m) for m in ("m", "v")}}


def test_per_rank_batch_norm_statistics_are_another_function(gloo_resnet):
    """The ranks' step is not the per-rank statistics' step: each rank's
    loss with batch norm over its own 2 images differs from the global
    loss by far more than the tolerance."""
    ranks, ref, _ = gloo_resnet
    local = [float(r["local_loss"]) for r in ranks]
    assert max(abs(x - ref["loss"]) for x in local) > 100 * MESH_TOL * abs(
        ref["loss"])


# --------------------------------------------------------------------------
# (c) the export
# --------------------------------------------------------------------------

def _conv_and_dot(text: str, parse) -> tuple[int, float, float]:
    cost = parse.program_cost(parse.parse_stablehlo(text))
    return (text.count("stablehlo.convolution("),
            cost.by_op.get("convolution", 0.0),
            cost.by_op.get("dot_general", 0.0))


@pytest.fixture(scope="module")
def exported_r18():
    jcfg, tcfg = jr.ResNetConfig(depth=18), tr.ResNetConfig(depth=18)
    jstep, jargs = jr.resnet_train_exports(jcfg, 2, IMG)
    jtext = jax_export_workload(jstep, *jargs, name="r18").stablehlo_text
    step, args = tr.resnet_train_exports(tcfg, 2, IMG)
    return jtext, export_workload(step, *args, name="r18", device="cpu")


def test_f16_export_has_jaxs_convolutions_and_flops(exported_r18):
    jtext, w = exported_r18
    text = w.stablehlo_text
    assert "xf16>" in text
    want = _conv_and_dot(jtext, jax_ir)
    assert want[0] == 62
    assert _conv_and_dot(text, jax_ir) == want
    assert _conv_and_dot(text, ir) == want
    # JAX's forms: 20 reversed kernels for the data gradients, the
    # stride-2 windows padded (0, 1) and the stem (2, 3)
    assert text.count("stablehlo.reverse ") == jtext.count(
        "stablehlo.reverse ") == 20
    for window in ("pad = [[2, 3], [2, 3]]", "pad = [[0, 1], [0, 1]], "
                   "lhs_dilate = [1, 1], rhs_dilate = [1, 1]",
                   "lhs_dilate = [2, 2]", "rhs_dilate = [2, 2]"):
        assert text.count(window) == jtext.count(window), window
    for op in ("reduce_window", "select_and_scatter"):
        assert text.count(f'"stablehlo.{op}"') == jtext.count(
            f'"stablehlo.{op}"') == 1
    # the max pool's backward: JAX writes its -inf pad out, scatters over
    # the padded input with no padding of its own and slices the pad off
    for op in ("pad", "slice"):
        assert _rank4(text, op) == _rank4(jtext, op) == 1, op
    assert text.count("padding = dense<0>") == jtext.count(
        "padding = dense<0>")


def _rank4(text: str, op: str) -> int:
    """The ``stablehlo.<op>`` lines whose operand is a 4-d tensor."""
    return len(re.findall(rf"stablehlo\.{op} [^\n]*: \(tensor<\d+x\d+x\d+x"
                          rf"\d+x", text))


@pytest.mark.parametrize("frontends", ["reference", "port"])
def test_both_front_ends_read_the_export(exported_r18, frontends):
    text = exported_r18[1].stablehlo_text
    mod = jax_ir if frontends == "reference" else ir
    legacy = mod.parse_stablehlo(text, frontend="legacy")
    streaming = mod.parse_stablehlo(text, frontend="streaming")
    mod.assert_programs_equal(legacy, streaming)


@pytest.fixture(scope="module")
def exported_mesh():
    return build_workload(WorkloadSpec.from_dict({
        "name": "resnet18", "arch": "resnet18", "mode": "train",
        "batch": 8, "img": IMG, "mesh": [4, 1]}), device="cpu")


def test_per_rank_text_has_a_quarter_of_the_convolution_flops(
        exported_mesh):
    w = exported_mesh
    assert w.meta["mesh"] == [4, 1]
    raw = ir.parse_stablehlo(w.stablehlo_text)
    rank = ir.parse_stablehlo(w.hlo_text)
    assert rank.meta["num_partitions"] == 4
    g = ir.program_cost(raw).by_op["convolution"]
    assert ir.program_cost(rank).by_op["convolution"] * 4 == g
    assert w.hlo_text.count("stablehlo.convolution(") == 62


def test_every_per_rank_collective_is_typed_by_its_payload(exported_mesh):
    """The gathers and reduce-scatters move the sharded leaves, the
    all-reduces the replicated leaves' gradients, the loss, the clip's sum
    and the synchronised batch norm's f32 channel sums: two forward and two
    backward for each of resnet18's 21 batch norms."""
    rank = jax_ir.parse_stablehlo(exported_mesh.hlo_text)
    kinds: dict = {}
    for c, mult in collect_collectives(ir.parse_stablehlo(
            exported_mesh.hlo_text)):
        assert c.bytes_in > 0 and c.group_size == 4, c
        kinds[c.kind] = kinds.get(c.kind, 0) + mult
    sharded = 21          # the 20 convolutions past the stem, the head
    replicated = 1 + 42   # the stem's convolution, 21 scales, 21 biases
    assert kinds == {"all_gather": sharded, "reduce_scatter": sharded,
                     "all_reduce": replicated + 2 + 4 * 21}
    assert rank.meta["num_partitions"] == 4


def _like(tree, template):
    """``tree``'s leaves in ``template``'s key order."""
    if not isinstance(template, dict):
        return tree
    return {k: _like(tree[k], v) for k, v in template.items()}


def _run_xla(text: str, leaves):
    backend = xla_bridge.get_backend("cpu")
    devs = backend.devices()[:1]
    exe = backend.compile_and_load(text, xla_client.DeviceList(tuple(devs)),
                                   compiler.get_compile_options(1, 1))
    out = exe.execute([backend.buffer_from_pyval(x.numpy(), devs[0])
                       for x in leaves])
    return [np.asarray(o) for o in out]


# f32 in two compilers, at depth 18's size (at 2 images the last stage
# would normalise over 2 values a channel, whose normalised values are +-1
# whatever they are, so that every gradient upstream of it is rounding):
# the loss within 2^-14, the new parameters and the moments as depth 18's
# (see TOL)
XLA_RTOL = 2.0 ** -14


def test_xla_runs_the_f32_text_to_the_eager_step():
    _, tcfg, jp, images, labels = _inputs(18)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    opt_cfg = OptimizerConfig(**OPT)
    init, _ = make_optimizer(opt_cfg)
    opt = init(params, opt_cfg)
    step, args = tr.resnet_train_exports(tcfg, BATCH, IMG, opt_cfg=opt_cfg)
    text = export_workload(step, *args, device="cpu").stablehlo_text
    # the text takes its arguments in the abstract trees' order
    inputs = (_like(params, args[0]), _like(opt, args[1]),
              torch.from_numpy(images), torch.from_numpy(labels))
    got = _run_xla(text, pytree.tree_leaves(inputs))
    flat, spec = pytree.tree_flatten(step(*inputs))
    assert len(got) == len(flat)
    for g, w in zip(got, flat):
        assert g.shape == tuple(w.shape), (g.shape, w.shape)
    new, opt, loss = pytree.tree_unflatten(
        [torch.from_numpy(np.array(g)) for g in got], spec)
    want_new, want_opt, want_loss = step(*inputs)
    _close(float(loss), float(want_loss), XLA_RTOL, "loss")
    _updates_close(params, new, want_new, opt["m"], want_opt["m"],
                   TOL[18]["loose"], "parameters")
    assert int(opt["step"]) == int(want_opt["step"]) == 1
    for moment in ("m", "v"):
        _gradients_close(opt[moment], want_opt[moment], 18, moment)
