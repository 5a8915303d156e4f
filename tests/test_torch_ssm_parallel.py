"""The SSM and hybrid families on the model axis: the per-rank train step
and forward of mamba2-370m and zamba2-2.7b (smoke configs, f32) on ``[data,
model]`` and ``[pod, data, model]`` meshes, held against JAX on the whole
batch, and the split-row norm's plain versions against the whole row's.

* gloo ranks (spawned processes, one set a mesh running every arch of that
  mesh, ``tests/torch_dist_ranks.py`` job ``"tp"``, each rank with its own
  timeout) of the per-rank ``make_train_step`` for two clipped AdamW steps
  and of the per-rank forward, against JAX's ``make_train_step`` and
  ``forward`` on the whole batch, the ranks' shards joined
  (``models/params.py::join_shards``):
  - ``[2, 2]``: mamba2 and zamba2 smoke (8 SSM heads -> 4 a rank; zamba2's
    shared attention block on the dense family's path);
  - ``[1, 4]``: both, 2 SSM heads a rank: in_proj's block of 74 packed
    [z, x, B, C, dt] columns straddles the z/x boundary, and the gated
    norm's row of 128 is split in blocks of 32; and mamba2 with 2 heads of
    64 and a vocab of 258, which the axis divides neither (the layer whole
    on every model rank, the head and loss over the whole vocab);
  - ``[2, 1, 2]``: zamba2 smoke (the pod axis);
* XLA on 4 CPU devices (a subprocess) runs zamba2's ``[2, 2]`` per-rank
  text to the gloo ranks' first step;
* the split-row K2 and K2b's plain versions (``kernels/rmsnorm/ref.py``)
  over a row's blocks, with each row's sums added over the blocks, against
  ``rmsnorm_ref`` and ``rmsnorm_bwd_ref`` over the whole row.

The per-rank texts: ``test_torch_ssm_parallel_text.py``.
"""
import os
import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.distributed.sharding import PARAM_RULES as JAX_PARAM_RULES
from repro.distributed.sharding import logical_to_spec as jax_logical_to_spec
from repro.models.params import tree_paths as jax_tree_paths
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.models.transformer import model_specs as jax_model_specs
from repro.models.transformer import forward as jax_forward
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.core.pipeline import export_workload
from repro_torch.kernels.rmsnorm import ref as k2
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models.params import join_shards, params_from_jax
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import model_specs
from repro_torch.train import loop, optimizer
from test_torch_distributed import (_XLA_SCRIPT, XLA_RTOL, _assert_close,
                                    _spawn)
from test_torch_tensor_parallel import _batches, _weights

SEQ, BATCH, STEPS = 16, 8, 2
ARCHS = ("mamba2-370m", "zamba2-2.7b")
# each case's arch and the fields its smoke config changes: "mamba2-whole"
# takes 2 SSM heads of 64 and a vocab of 258, which a model axis of 4
# divides neither: the Mamba2 layer runs whole on every model rank from
# its gathered leaves, and the head and loss over the whole vocab
VARIANTS = {"mamba2-370m": ("mamba2-370m", {}),
            "zamba2-2.7b": ("zamba2-2.7b", {}),
            "mamba2-whole": ("mamba2-370m", {"vocab_size": 258,
                                             "head_dim": 64})}
# the meshes and the cases each set of 4 gloo ranks runs
MESHES = {"2x2": ((2, 2), ARCHS),
          "1x4": ((1, 4), (*ARCHS, "mamba2-whole")),
          "2x1x2": ((2, 1, 2), ("zamba2-2.7b",))}
CASES = [(m, a) for m, (_, archs) in MESHES.items() for a in archs]
# low enough that the clip engages on every case (held below)
CLIP = 0.05


def _configs(case):
    arch, fields = VARIANTS[case]
    out = []
    for get in (get_smoke_config, jax_get_smoke_config):
        cfg = get(arch)
        kw = dict(dtype="float32")
        if "vocab_size" in fields:
            kw["vocab_size"] = fields["vocab_size"]
        if "head_dim" in fields:
            kw["ssm"] = replace(cfg.ssm, head_dim=fields["head_dim"])
        out.append(cfg.scaled(**kw))
    return tuple(out)


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
            jloss, logits = jax_forward(jcfg, jp, jax.tree.map(
                jax.numpy.asarray, batches[0]))
            steps = []
            for batch in batches:
                jp, js, jm = jstep(jp, js, jax.tree.map(jax.numpy.asarray,
                                                        batch))
                steps.append(jax.tree.map(np.asarray, (jp, js, jm)))
            cache[arch] = dict(weights=weights, batches=batches, steps=steps,
                               logits=np.asarray(logits), loss=float(jloss))
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
            work = tmp_path_factory.mktemp(f"ssm{mesh_id}")
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
    outs = [r[i] for r in ranks]
    return join_shards(model_specs(_configs(arch)[0]),
                       [tree_of(o) for o in outs],
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
def test_every_ssm_shard_has_the_rules_shape(gloo, references, mesh_id,
                                             arch):
    """Each rank's SSM leaves have the shapes the reference's rules give
    them on the mesh (``ssm_inner`` and ``ssm_heads`` over the model axis,
    ``embed`` over the data axis, ``norm`` whole), and the ranks' shards
    joined rebuild the whole parameters."""
    shape, archs = MESHES[mesh_id]
    ranks, i = gloo(mesh_id), archs.index(arch)
    names = ("pod", "data", "model")[-len(shape):]
    sizes = dict(zip(names, shape))
    mesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    want = {}
    for path, s in jax_tree_paths(jax_model_specs(_configs(arch)[1])).items():
        if not path.startswith("layers/ssm/"):
            continue
        spec = tuple(jax_logical_to_spec(s.axes, JAX_PARAM_RULES, mesh,
                                         s.shape))
        spec += (None,) * (len(s.shape) - len(spec))
        want[path.rsplit("/", 1)[1]] = tuple(
            n // int(np.prod([sizes[a] for a in (
                () if p is None else (p,) if isinstance(p, str) else p)]))
            for n, p in zip(s.shape, spec))
    cfg = _configs(arch)[0]
    nh, m = cfg.ssm.n_heads(cfg.d_model), shape[-1]
    assert want["out_norm"][-1] == cfg.ssm.d_inner(cfg.d_model)
    assert want["a_log"][-1] == (nh if nh % m else nh // m)
    for r in ranks:
        ssm = r[i]["inputs"][0]["layers"]["ssm"]
        assert {k: tuple(v.shape) for k, v in ssm.items()} == want
    _assert_close(_joined(mesh_id, arch, ranks, lambda o: o["inputs"][0]),
                  references(arch)["weights"], 0.0)


@pytest.mark.parametrize("mesh_id,arch", CASES)
def test_per_rank_forward_logits_equal_jax_forward(gloo, references, mesh_id,
                                                   arch):
    """The per-rank forward's logits (the rank's rows over ``(pod, data)``
    and its vocab block over ``model``, joined) against JAX's ``forward``
    on the whole batch in f32, and its loss."""
    shape, archs = MESHES[mesh_id]
    ranks, ref = gloo(mesh_id), references(arch)
    i = archs.index(arch)
    axes = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    # the vocab block of a rank: the whole vocab where the axis does not
    # divide it
    v = ref["logits"].shape[-1]
    split = v % axes["model"] == 0
    rows, vocab = BATCH // (axes.get("pod", 1) * axes["data"]), \
        v // axes["model"] if split else v
    whole = np.empty_like(ref["logits"])
    for r in ranks:
        at = dict(zip(("pod", "data", "model")[-len(shape):],
                      r[i]["coordinate"]))
        block = at.get("pod", 0) * axes["data"] + at["data"]
        logits = r[i]["forward"][1].numpy()
        assert logits.shape == (rows, SEQ, vocab)
        first = at["model"] * vocab if split else 0
        whole[block * rows:(block + 1) * rows, :,
              first:first + vocab] = logits
        if not split:
            np.testing.assert_allclose(
                logits, ref["logits"][block * rows:(block + 1) * rows],
                atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(whole, ref["logits"], atol=1e-4, rtol=1e-4)
    for r in ranks:
        np.testing.assert_allclose(float(r[i]["forward"][0]), ref["loss"],
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# XLA runs the per-rank text
# --------------------------------------------------------------------------

def test_xla_runs_the_2x2_text_to_the_gloo_step(gloo, tmp_path):
    """XLA on 4 CPU devices runs the ``[2, 2]`` per-rank text of zamba2
    (one program for the four ranks: each reads its model coordinate from
    ``partition_id``; the split norm's all-reduces between its passes) on
    each rank's shards and rows, to the gloo ranks' first step."""
    ranks = gloo("2x2")
    i = MESHES["2x2"][1].index("zamba2-2.7b")
    cfg = _configs("zamba2-2.7b")[0]
    opt_cfg = optimizer.OptimizerConfig(warmup_steps=2, grad_clip=CLIP)
    with traced_mesh((2, 2), "cpu") as mesh:
        step, args = loop.train_step_exports(cfg, SEQ, BATCH, mesh,
                                             opt_cfg=opt_cfg)
        text = export_workload(step, *args, device="cpu",
                               per_rank=(step, args, mesh)).hlo_text
    assert "stablehlo.partition_id" in text
    assert "@repro_torch.rmsnorm_sumsq" in text
    (tmp_path / "rank.mlir").write_text(text)
    for r, rank in enumerate(ranks):
        np.savez(tmp_path / f"in{r}.npz", **{
            f"a{j}": x.numpy() for j, x in enumerate(
                pytree.tree_leaves(rank[i]["inputs"]))})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _XLA_SCRIPT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    for r, rank in enumerate(ranks):
        got = np.load(tmp_path / f"out{r}.npz")
        want = pytree.tree_leaves(rank[i]["steps"][0])
        assert len(got.files) == len(want)
        for j, w in enumerate(want):
            g, w = got[f"a{j}"], w.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, j
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= XLA_RTOL * scale, (r, j)


# --------------------------------------------------------------------------
# the split-row norm's plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [1, 4, 16])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_split_row_plain_versions_equal_the_whole_row(blocks, offset):
    """A row of 128 in ``blocks`` blocks: each block's sums of squares and
    of x (offset + w) dy, added over the blocks, then each block's y, dx
    and dw, joined, against the whole row's plain forward and backward:
    each element within 1e-6 of its tensor's largest magnitude (the sums
    run in another order; an f32 ulp is 1.2e-7 of a value)."""
    rng = np.random.default_rng(5)
    d = 128
    x = torch.from_numpy(rng.standard_normal((3, 7, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 7, d)).astype(np.float32))
    xs, ws, gs = (torch.chunk(t, blocks, -1) for t in (x, w, dy))
    total = sum(k2.rmsnorm_sumsq_ref(b) for b in xs)
    dot = sum(k2.rmsnorm_bwd_dot_ref(a, b, c, offset)
              for a, b, c in zip(xs, ws, gs))
    y = torch.cat([k2.rmsnorm_split_ref(a, b, total, 1e-5, offset, d)
                   for a, b in zip(xs, ws)], -1)
    parts = [k2.rmsnorm_bwd_split_ref(a, b, c, total, dot, 1e-5, offset, d)
             for a, b, c in zip(xs, ws, gs)]
    dx = torch.cat([p[0] for p in parts], -1)
    dw = torch.cat([p[1] for p in parts], -1)
    rdx, rdw = k2.rmsnorm_bwd_ref(x, w, dy, 1e-5, offset)
    for got, want in ((y, k2.rmsnorm_ref(x, w, 1e-5, offset)), (dx, rdx),
                      (dw, rdw)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale
