"""Expert parallelism and MLA on the model axis: the per-rank train step and
forward of the MoE family (mixtral's GQA, deepseek-v3's MLA before a
sigmoid-gated MoE with a shared expert) on ``[data, model]`` and ``[pod,
data, model]`` meshes, held against JAX on the whole batch.

* gloo ranks (spawned processes, one set a mesh running every case of that
  mesh, ``tests/torch_dist_ranks.py`` job ``"ep"``; the ``[1, 4]`` and
  ``[2, 1, 2]`` sets run in ``test_torch_expert_parallel_schemes.py``) of
  the per-rank ``make_train_step`` for two clipped AdamW steps and of the
  per-rank forward, against JAX's ``make_train_step`` and ``forward`` on
  the whole batch, the ranks' shards joined
  (``models/params.py::join_shards``):
  - ``[1, 4]``: mixtral smoke (4 experts, scheme ``"expert"``, one a rank)
    and the reference's ``cfg2`` (2 experts, d_ff_expert 64: scheme
    ``"ffn"``, every expert on a quarter of its width), at the default
    capacity factor; mixtral's routing is skewed toward expert 0 so that
    assignments are dropped (held), and, since cfg2's top-2 of 2 experts
    cannot overflow at a factor of 1 or more, cfg2 also runs at 0.5, where
    they are dropped;
  - ``[2, 2]``: mixtral smoke and deepseek-v3 smoke (MLA's 4 heads -> 2,
    8 experts -> 4, the shared expert split);
  - ``[2, 1, 2]``: deepseek-v3 smoke (the pod axis).
  With a data axis above 1 a rank reckons its capacity from its own tokens
  (the reference's ``moe_forward_ep``), where JAX's default MoE on the
  whole batch reckons it from all of them, so those cases take a capacity
  factor of the expert count, at which no assignment can drop;
* the same ``[2, 2]`` ranks run the MoE alone on their rows at the default
  capacity factor, with drops, against JAX's ``moe_forward_ep`` on a 2 x 2
  JAX mesh of host devices (a subprocess: the device count is locked in
  this process).

The per-rank texts and the campaign's workloads:
``test_torch_expert_parallel_text.py``.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.models.params import init_params as jax_init_params
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import model_specs as jax_model_specs
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch.models import mlp, transformer
from repro_torch.models.params import join_shards, params_from_jax
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import model_specs
from repro_torch.train import data, optimizer
from test_torch_distributed import _assert_close, _spawn
from test_torch_families import _assert_routing_cannot_flip
from test_torch_mla import \
    _assert_routing_cannot_flip as _assert_mla_routing_cannot_flip

SEQ, BATCH, STEPS = 16, 8, 2
CLIP = 0.05
# case -> (arch, MoE fields, routing skewed toward expert 0)
CASES = {
    "mixtral-drops": ("mixtral-8x22b", {}, True),
    "mixtral-ffn": ("mixtral-8x22b", {"num_experts": 2, "d_ff_expert": 64},
                    False),
    "mixtral-ffn-drops": ("mixtral-8x22b", {"num_experts": 2,
                                            "d_ff_expert": 64,
                                            "capacity_factor": 0.5}, False),
    "mixtral": ("mixtral-8x22b", {"capacity_factor": 4.0}, False),
    "deepseek-v3": ("deepseek-v3-671b", {"capacity_factor": 8.0}, False),
}
# the mesh, the cases its set of 4 gloo ranks runs, and the cases that
# drop assignments
# (the [1, 4] and [2, 1, 2] meshes: test_torch_expert_parallel_schemes.py)
MESHES = {"2x2": ((2, 2), ("mixtral", "deepseek-v3"))}
DROPS = {"mixtral-drops", "mixtral-ffn-drops"}
RUNS = [(m, c) for m, (_, cases) in MESHES.items() for c in cases]
# the MoE alone against JAX's moe_forward_ep on [2, 2], at the default
# capacity factor
MODULES = ("mixtral-8x22b", "deepseek-v3-671b")


def _configs(case):
    arch, moe, _ = CASES[case]
    out = []
    for get in (get_smoke_config, jax_get_smoke_config):
        cfg = get(arch)
        out.append(cfg.scaled(dtype="float32",
                              moe=replace(cfg.moe, **moe)))
    return tuple(out)


def _weights(case) -> dict:
    """N(0, 0.02) for each matrix and ones for each norm, as
    ``test_torch_tensor_parallel.py`` draws them.  Skewed: every embedding
    row shifted by 0.05 and the router's column of expert 0 by 0.1, so that
    the normed hidden states share a direction the router sends to expert
    0, whose capacity overflows."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (rng.normal(0, 0.02, x.shape).astype(np.float32)
                   if x.ndim > 1 else np.ones(x.shape, np.float32)),
        jax_init_params(jax_model_specs(_configs(case)[1]),
                        jax.random.PRNGKey(0)))
    if CASES[case][2]:
        tree["embed"] += np.float32(0.05)
        tree["layers"]["moe"]["router"][..., 0] += np.float32(0.1)
    return tree


def _batches(cfg):
    source = data.SyntheticSource(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3))
    return [next(source) for _ in range(STEPS)]


def _dropped(cfg, params: dict, batch: dict) -> int:
    """The assignments the port's MoE drops in a forward of the whole
    batch on one device (a ``[1, M]`` rank's tokens and capacity are the
    same)."""
    dropped = [0]
    dispatch = mlp.moe_dispatch

    def counting(top_e, num_experts, cap, discard=False):
        counts = torch.bincount(top_e.reshape(-1),
                                minlength=num_experts + discard)
        dropped[0] += int(torch.clamp(counts[:num_experts] - cap,
                                      min=0).sum())
        return dispatch(top_e, num_experts, cap, discard)
    mlp.moe_dispatch = counting
    try:
        transformer.forward(cfg, params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    finally:
        mlp.moe_dispatch = dispatch
    return dropped[0]


@pytest.fixture(scope="module")
def references():
    """JAX's two steps and forward on the whole batch, one case at a time
    (shared by the meshes), each step's routing first held unable to flip
    between the packages."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg, jcfg = _configs(case)
            opt_j = jax_opt.OptimizerConfig(warmup_steps=2, grad_clip=CLIP)
            weights = _weights(case)
            batches = _batches(cfg)
            jstep = jax.jit(jax_loop.make_train_step(jcfg, opt_j))
            jp = jax.tree.map(jax.numpy.asarray, weights)
            js = jax_opt.make_optimizer(opt_j)[0](jp, opt_j)
            _, logits = jax_forward(jcfg, jp, jax.tree.map(jax.numpy.asarray,
                                                           batches[0]))
            flip = (_assert_mla_routing_cannot_flip if cfg.mla is not None
                    else _assert_routing_cannot_flip)
            steps, dropped = [], []
            for batch in batches:
                tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
                if cfg.moe.top_k < cfg.moe.num_experts:   # else all
                    flip(jcfg, jp, cfg, tp, batch["tokens"])
                dropped.append(_dropped(cfg, tp, batch))
                jp, js, jm = jstep(jp, js, jax.tree.map(jax.numpy.asarray,
                                                        batch))
                steps.append(jax.tree.map(np.asarray, (jp, js, jm)))
            cache[case] = dict(weights=weights, batches=batches, steps=steps,
                               logits=np.asarray(logits), dropped=dropped)
        return cache[case]
    return get


def _module_inputs(arch):
    """The MoE alone: f32 weights and tokens from a numpy seed, the tokens
    shifted by 1 and the router's column of expert 0 by 0.3, so that expert
    0 overflows a rank's capacity."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    rng = np.random.default_rng(7)
    tree = {k: (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in mlp.moe_specs(cfg).items()}
    tree["router"][:, 0] += np.float32(0.3)
    x = (rng.standard_normal((4, SEQ, cfg.d_model)) + 1.0).astype(np.float32)
    return cfg, tree, x


def spawner(tmp_path_factory, references, meshes):
    """The 4 gloo ranks of each mesh of ``meshes``, spawned once a mesh
    for all its cases (``[2, 2]``'s also run the MoE alone): ``get(mesh
    id)``, a list (by rank) of the ranks' outputs."""
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            shape, cases = meshes[mesh_id]
            work = tmp_path_factory.mktemp(f"ep{mesh_id}")
            runs = []
            for case in cases:
                ref = references(case)
                runs.append({
                    "cfg": _configs(case)[0],
                    "opt_cfg": optimizer.OptimizerConfig(warmup_steps=2,
                                                         grad_clip=CLIP),
                    "params": params_from_jax(ref["weights"], "cpu"),
                    "batches": ref["batches"]})
            torch.save(runs, work / "inputs.pt")
            if shape == (2, 2):
                modules = []
                for arch in MODULES:
                    cfg, tree, x = _module_inputs(arch)
                    modules.append({"cfg": cfg, "x": torch.from_numpy(x),
                                    "params": params_from_jax(tree, "cpu")})
                torch.save(modules, work / "modules.pt")
            cache[mesh_id] = _spawn(work, "ep", shape)
        return cache[mesh_id]
    return get


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, references):
    return spawner(tmp_path_factory, references, MESHES)


def _joined(shape, i, case, ranks, tree_of):
    outs = [r["cases"][i] for r in ranks]
    return join_shards(model_specs(_configs(case)[0]),
                       [tree_of(o) for o in outs],
                       [o["coordinate"] for o in outs], shape)


def check_steps(ranks, ref, shape, i, case):
    """Loss and grad_norm of each clipped step, and the parameters and
    moments (the ranks' shards joined: the experts over ``model``, their
    ``embed`` dim over ``data``), against JAX's step on the whole batch,
    with ``test_torch_distributed.py``'s tolerances; assignments are
    dropped in the cases that say so, and in no other.  ``i``: the case's
    place in its mesh's list."""
    if case in DROPS:
        assert min(ref["dropped"]) > 0, ref["dropped"]
    else:
        assert ref["dropped"] == [0] * STEPS
    lr = optimizer.OptimizerConfig().learning_rate
    for step in range(STEPS):
        jp, js, jm = ref["steps"][step]
        assert float(jm["grad_norm"]) > CLIP     # the clip engages
        metrics = ranks[0]["cases"][i]["steps"][step][2]
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
        for r in ranks[1:]:
            other = r["cases"][i]["steps"][step][2]
            assert all(torch.equal(other[k], metrics[k])
                       for k in ("loss", "grad_norm"))
        _assert_close(_joined(shape, i, case, ranks,
                              lambda o: o["steps"][step][0]), jp,
                      lr * (step + 1))
        for moment in ("m", "v"):
            _assert_close(_joined(shape, i, case, ranks,
                                  lambda o: o["steps"][step][1][moment]),
                          js[moment])


def check_forward(ranks, ref, shape, i, case):
    """The per-rank forward's logits (the rank's rows over ``(pod, data)``
    and its vocab block over ``model``, joined) against JAX's ``forward``
    on the whole batch in f32, and its loss, the mean over the ranks."""
    names = ("pod", "data", "model")[-len(shape):]
    axes = dict(zip(names, shape))
    rows = BATCH // (axes.get("pod", 1) * axes["data"])
    vocab = ref["logits"].shape[-1] // axes["model"]
    whole = np.empty_like(ref["logits"])
    for r in ranks:
        at = dict(zip(names, r["cases"][i]["coordinate"]))
        block = at.get("pod", 0) * axes["data"] + at["data"]
        logits = r["cases"][i]["forward"][1].numpy()
        assert logits.shape == (rows, SEQ, vocab)
        whole[block * rows:(block + 1) * rows, :,
              at["model"] * vocab:(at["model"] + 1) * vocab] = logits
    np.testing.assert_allclose(whole, ref["logits"], atol=1e-4, rtol=1e-4)
    jloss, _ = jax_forward(_configs(case)[1], ref["weights"],
                           ref["batches"][0])
    for r in ranks:
        np.testing.assert_allclose(float(r["cases"][i]["forward"][0]),
                                   float(jloss), rtol=1e-5)


@pytest.mark.parametrize("mesh_id,case", RUNS)
def test_ranks_equal_jax_make_train_step(gloo, references, mesh_id, case):
    """:func:`check_steps` on the mesh's ranks."""
    shape, cases = MESHES[mesh_id]
    check_steps(gloo(mesh_id), references(case), shape, cases.index(case),
                case)


@pytest.mark.parametrize("mesh_id,case", RUNS)
def test_per_rank_forward_logits_equal_jax_forward(gloo, references, mesh_id,
                                                   case):
    """:func:`check_forward` on the mesh's ranks."""
    shape, cases = MESHES[mesh_id]
    check_forward(gloo(mesh_id), references(case), shape,
                  cases.index(case), case)


# --------------------------------------------------------------------------
# the MoE alone against JAX's moe_forward_ep on a 2 x 2 mesh
# --------------------------------------------------------------------------

_EP_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.launch.mesh import make_mesh
from repro.models.mlp import moe_forward_ep
from repro.models.registry import get_smoke_config
work = sys.argv[1]
with open(os.path.join(work, "ep.pkl"), "rb") as f:
    cases = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, (tree, x) in cases.items():
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    with mesh:
        y = jax.jit(lambda p, x: moe_forward_ep(cfg, p, x))(tree, x)
    out[arch] = np.asarray(y)
np.savez(os.path.join(work, "ep_out.npz"), **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_moe_forward_ep(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_ep")
    with open(work / "ep.pkl", "wb") as f:
        pickle.dump({a: _module_inputs(a)[1:] for a in MODULES}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _EP_SCRIPT, str(work)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(work / "ep_out.npz"))


@pytest.mark.parametrize("arch", MODULES)
def test_rank_moe_equals_jax_moe_forward_ep(gloo, jax_moe_forward_ep, arch):
    """The port's per-rank MoE on gloo ``[2, 2]`` (each rank its 2 of the
    4 rows, its experts' shards gathered along ``data``) against JAX's
    ``moe_forward_ep`` on a 2 x 2 mesh, at the default capacity factor: a
    rank's capacity is reckoned from its 2 rows, and expert 0 overflows it
    (held) on every data rank.  Both model ranks of a data rank hold the
    same output; the routing cannot flip between the packages (its top-k
    margin is held first)."""
    cfg, tree, x = _module_inputs(arch)
    params = params_from_jax(tree, "cpu")
    mo, rows = cfg.moe, x.shape[0] // 2
    for block in range(2):
        xb = torch.from_numpy(x[block * rows:(block + 1) * rows]).reshape(
            -1, cfg.d_model)
        # softmax and sigmoid keep the router logits' order
        logits = torch.sort(xb @ params["router"], -1, descending=True).values
        assert float((logits[:, mo.top_k - 1] - logits[:, mo.top_k]).min()
                     ) > 1e-4
        _, top_e = mlp.moe_route(cfg, params, xb)
        counts = torch.bincount(top_e.reshape(-1), minlength=mo.num_experts)
        assert int(counts.max()) > mlp._capacity(xb.shape[0], mo)
    i = MODULES.index(arch)
    ranks = gloo("2x2")
    want = jax_moe_forward_ep[arch]
    for r in ranks:
        out = r["modules"][i]
        block = out["coordinate"][0]
        np.testing.assert_allclose(out["y"].numpy(),
                                   want[block * rows:(block + 1) * rows],
                                   atol=2e-5, rtol=2e-5)
