"""Tensor parallelism and the pod axis for the dense family: the per-rank
train step and forward on ``[data, model]`` and ``[pod, data, model]``
meshes, held against JAX on the whole batch, and their per-rank text.

* gloo ranks (spawned processes, one set a mesh running every arch of that
  mesh, each rank with its own timeout) of the per-rank ``make_train_step``
  for two clipped AdamW steps and of the per-rank forward, against JAX's
  ``make_train_step`` and ``forward`` on the whole batch, the ranks' shards
  joined (``models/params.py::join_shards``):
  - ``[2, 2]``: llama3-1b, qwen2.5-32b (QKV bias) and gemma2-27b (tied
    table, softcaps) smoke configs;
  - ``[1, 4]``: llama3-1b smoke, heads 4 split and kv 2 whole (each rank's
    query head reads kv head ``h // 2`` of the whole K and V);
  - ``[2, 1, 2]``: llama3-1b smoke on the pod axis;
* XLA on 4 CPU devices (a subprocess) runs the ``[2, 2]`` per-rank text to
  the gloo ranks' first step: the text reads each rank's model coordinate
  from ``partition_id``;
* the per-rank texts themselves: ``test_torch_tensor_parallel_text.py``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.models.params import init_params as jax_init_params
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import model_specs as jax_model_specs
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.core.pipeline import export_workload
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models.params import join_shards, params_from_jax
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import model_specs
from repro_torch.train import data, loop, optimizer
from test_torch_distributed import (_XLA_SCRIPT, XLA_RTOL, _assert_close,
                                    _spawn)

SEQ, BATCH, STEPS = 16, 8, 2
# the meshes and the archs each set of 4 gloo ranks runs
MESHES = {"2x2": ((2, 2), ("llama3-1b", "qwen2.5-32b", "gemma2-27b")),
          "1x4": ((1, 4), ("llama3-1b",)),
          "2x1x2": ((2, 1, 2), ("llama3-1b",))}
CASES = [(m, a) for m, (_, archs) in MESHES.items() for a in archs]
# low enough that the clip engages on every case (held below)
CLIP = 0.05


def _configs(arch):
    kw = dict(dtype="float32")
    return (get_smoke_config(arch).scaled(**kw),
            jax_get_smoke_config(arch).scaled(**kw))


def _weights(jcfg) -> dict:
    """Seeded weights, N(0, 0.02) for each matrix (the QKV biases too) and
    ones for each norm, as ``test_torch_distributed.py`` draws them."""
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: (rng.normal(0, 0.02, x.shape).astype(np.float32)
                   if x.ndim > 1 else np.ones(x.shape, np.float32)),
        jax_init_params(jax_model_specs(jcfg), jax.random.PRNGKey(0)))


def _batches(cfg):
    source = data.SyntheticSource(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3))
    return [next(source) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def references():
    """JAX's two steps and forward on the whole batch, one arch at a time
    (shared by the meshes)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, jcfg = _configs(arch)
            opt_j = jax_opt.OptimizerConfig(warmup_steps=2, grad_clip=CLIP)
            weights = _weights(jcfg)
            batches = _batches(cfg)
            jstep = jax.jit(jax_loop.make_train_step(jcfg, opt_j))
            jp = jax.tree.map(jax.numpy.asarray, weights)
            js = jax_opt.make_optimizer(opt_j)[0](jp, opt_j)
            _, logits = jax_forward(jcfg, jp, jax.tree.map(jax.numpy.asarray,
                                                           batches[0]))
            steps = []
            for batch in batches:
                jp, js, jm = jstep(jp, js, jax.tree.map(jax.numpy.asarray,
                                                        batch))
                steps.append(jax.tree.map(np.asarray, (jp, js, jm)))
            cache[arch] = dict(weights=weights, batches=batches, steps=steps,
                               logits=np.asarray(logits))
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, references):
    """The 4 gloo ranks of each mesh, spawned once a mesh for all its
    archs: a list (by rank) of lists (by arch) of the rank's outputs."""
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            shape, archs = MESHES[mesh_id]
            work = tmp_path_factory.mktemp(f"tp{mesh_id}")
            cases = []
            for arch in archs:
                ref = references(arch)
                cases.append({
                    "cfg": _configs(arch)[0],
                    "opt_cfg": optimizer.OptimizerConfig(warmup_steps=2,
                                                         grad_clip=CLIP),
                    "params": params_from_jax(ref["weights"], "cpu"),
                    "batches": ref["batches"]})
            torch.save(cases, work / "inputs.pt")
            cache[mesh_id] = _spawn(work, "tp", shape)
        return cache[mesh_id]
    return get


def _joined(mesh_id, arch, ranks, tree_of):
    """The ranks' shards of ``tree_of(rank output)`` (parameters, or
    moments laid out as them) joined into whole leaves."""
    shape, archs = MESHES[mesh_id]
    i = archs.index(arch)
    cfg = _configs(arch)[0]
    outs = [r[i] for r in ranks]
    return join_shards(model_specs(cfg), [tree_of(o) for o in outs],
                       [o["coordinate"] for o in outs], shape)


@pytest.mark.parametrize("mesh_id,arch", CASES)
def test_ranks_equal_jax_make_train_step(gloo, references, mesh_id, arch):
    """Loss and grad_norm of each clipped step, and the parameters and
    moments (the ranks' shards joined), against JAX's step on the whole
    batch, with ``test_torch_distributed.py``'s tolerances."""
    ranks, ref = gloo(mesh_id), references(arch)
    i = MESHES[mesh_id][1].index(arch)
    lr = optimizer.OptimizerConfig().learning_rate
    for step in range(STEPS):
        jp, js, jm = ref["steps"][step]
        assert float(jm["grad_norm"]) > CLIP     # the clip engages
        metrics = ranks[0][i]["steps"][step][2]
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
        assert int(ranks[0][i]["steps"][step][1]["step"]) == step + 1
        _assert_close(_joined(mesh_id, arch, ranks,
                              lambda o: o["steps"][step][0]), jp,
                      lr * (step + 1))
        for moment in ("m", "v"):
            _assert_close(_joined(mesh_id, arch, ranks,
                                  lambda o: o["steps"][step][1][moment]),
                          js[moment])


@pytest.mark.parametrize("mesh_id,arch", CASES)
def test_every_rank_reports_the_same_loss_and_norm(gloo, mesh_id, arch):
    ranks = gloo(mesh_id)
    i = MESHES[mesh_id][1].index(arch)
    for step in range(STEPS):
        metrics = [r[i]["steps"][step][2] for r in ranks]
        for key in ("loss", "grad_norm"):
            assert all(torch.equal(m[key], metrics[0][key])
                       for m in metrics[1:]), key


@pytest.mark.parametrize("mesh_id,arch", CASES)
def test_per_rank_forward_logits_equal_jax_forward(gloo, references, mesh_id,
                                                   arch):
    """The per-rank forward's logits (the rank's rows over ``(pod, data)``
    and its vocab block over ``model``, joined) against JAX's ``forward``
    on the whole batch in f32, and its loss, the mean over the ranks."""
    shape, archs = MESHES[mesh_id]
    ranks, ref = gloo(mesh_id), references(arch)
    i = archs.index(arch)
    axes = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    rows, vocab = BATCH // (axes.get("pod", 1) * axes["data"]), \
        ref["logits"].shape[-1] // axes["model"]
    whole = np.empty_like(ref["logits"])
    for r in ranks:
        at = dict(zip(("pod", "data", "model")[-len(shape):],
                      r[i]["coordinate"]))
        block = at.get("pod", 0) * axes["data"] + at["data"]
        logits = r[i]["forward"][1].numpy()
        assert logits.shape == (rows, SEQ, vocab)
        whole[block * rows:(block + 1) * rows, :,
              at["model"] * vocab:(at["model"] + 1) * vocab] = logits
    np.testing.assert_allclose(whole, ref["logits"], atol=1e-4, rtol=1e-4)
    jloss, _ = jax_forward(_configs(arch)[1], ref["weights"],
                           ref["batches"][0])
    for r in ranks:
        np.testing.assert_allclose(float(r[i]["forward"][0]), float(jloss),
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# XLA runs the per-rank text
# --------------------------------------------------------------------------

def test_xla_runs_the_2x2_text_to_the_gloo_step(gloo, tmp_path):
    """XLA on 4 CPU devices runs the ``[2, 2]`` per-rank text of
    llama3-1b (one program for the four ranks: each reads its model
    coordinate from ``partition_id``) on each rank's shards and rows, to
    the gloo ranks' first step."""
    ranks = gloo("2x2")
    cfg = _configs("llama3-1b")[0]
    opt_cfg = optimizer.OptimizerConfig(warmup_steps=2, grad_clip=CLIP)
    with traced_mesh((2, 2), "cpu") as mesh:
        step, args = loop.train_step_exports(cfg, SEQ, BATCH, mesh,
                                             opt_cfg=opt_cfg)
        text = export_workload(step, *args, device="cpu",
                               per_rank=(step, args, mesh)).hlo_text
    assert "stablehlo.partition_id" in text
    (tmp_path / "rank.mlir").write_text(text)
    for r, rank in enumerate(ranks):
        np.savez(tmp_path / f"in{r}.npz", **{
            f"a{i}": x.numpy() for i, x in enumerate(
                pytree.tree_leaves(rank[0]["inputs"]))})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _XLA_SCRIPT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    for r, rank in enumerate(ranks):
        got = np.load(tmp_path / f"out{r}.npz")
        want = pytree.tree_leaves(rank[0]["steps"][0])
        assert len(got.files) == len(want)
        for i, w in enumerate(want):
            g, w = got[f"a{i}"], w.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, i
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= XLA_RTOL * scale, (r, i)
