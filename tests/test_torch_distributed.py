"""The distribution slice of the port: sharding rules, the per-rank train
step of a data mesh, its export with collectives, and the optimized rows
(the model and pod axes: ``test_torch_tensor_parallel.py``).

* the port's rule resolution against the reference's ``logical_to_spec``,
  dim by dim, on every parameter and input leaf of two archs;
* 4 gloo ranks of the per-rank step (spawned processes, each with its own
  timeout) against JAX's ``make_train_step`` on the whole batch, and
  ``train(run, mesh=...)`` against ``train(run)`` on one process;
* XLA on 4 CPU devices (a subprocess) runs the per-rank text to the gloo
  ranks' first step;
* the per-rank text: ``dot_general`` FLOPs the raw text's over N, every
  collective typed by its payload in both front ends, the port's IR copies
  equal to the reference's;
* fig11's llama3-100m and llama3-500m optimized rows in the golden's order
  (fig6's are in ``test_torch_predict.py``).
"""
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import torch_dist_ranks
from repro.core import ir as jax_ir
from repro.distributed.sharding import ACT_RULES as JAX_ACT_RULES
from repro.distributed.sharding import PARAM_RULES as JAX_PARAM_RULES
from repro.distributed.sharding import logical_to_spec as jax_logical_to_spec
from repro.core.ir.collectives import collect_collectives as jax_collectives
from repro.models.params import init_params as jax_init_params
from repro.models.params import tree_paths as jax_tree_paths
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.models.transformer import model_specs as jax_model_specs
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import campaign
from repro_torch.campaign.builders import build_workload
from repro_torch.campaign.report import kendall_tau, load_json
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import ir
from repro_torch.core.ir.collectives import collect_collectives
from repro_torch.core.pipeline import export_workload
from repro_torch.distributed.sharding import (ACT_RULES, PARAM_RULES,
                                              logical_to_spec)
from repro_torch.launch.mesh import fake_world, traced_mesh
from repro_torch.models.params import abstract_params, params_from_jax
from repro_torch.models.registry import (get_config, get_smoke_config,
                                         input_specs)
from repro_torch.models.transformer import model_specs
from repro_torch.train import data, loop, optimizer

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SEQ, BATCH, STEPS = 16, 8, 2
# a spawned rank that has not finished by then is terminated and fails the
# test; the collectives inside each rank time out sooner
# (torch_dist_ranks.COLLECTIVE_TIMEOUT_S)
RANK_TIMEOUT_S = 240


# --------------------------------------------------------------------------
# (a) rule resolution against the reference's
# --------------------------------------------------------------------------

def _jax_mesh(shape):
    """The two attributes the reference's ``_resolve`` reads."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(shape))


@pytest.mark.parametrize("shape", [(4, 1), (8, 1), (16, 1), (128, 1),
                                   (2, 2)], ids=str)
@pytest.mark.parametrize("arch", ["llama3-1b", "llama2-7b"])
def test_rule_resolution_equals_the_reference(arch, shape):
    assert PARAM_RULES == JAX_PARAM_RULES and ACT_RULES == JAX_ACT_RULES
    cfg = get_config(arch)
    specs = model_specs(cfg)
    jspecs = jax_tree_paths(jax_model_specs(jax_get_config(arch)))
    batch = 128
    leaves = [(s.axes, s.shape, PARAM_RULES) for s in jspecs.values()]
    leaves += [(("batch", "seq"), (batch, 2048), ACT_RULES),
               (("batch", "seq", "embed"), (batch, 2048, cfg.d_model),
                ACT_RULES)]
    with traced_mesh(shape, "cpu") as mesh:
        for axes, shp, rules in leaves:
            theirs = jax_logical_to_spec(axes, rules, _jax_mesh(shape), shp)
            assert logical_to_spec(axes, rules, mesh, shp) == tuple(theirs)
        # each rank's shard: the global shape over its axes' product
        sizes = dict(zip(("data", "model"), shape))
        ours = {n: tuple(t.shape) for n, t in _paths(abstract_params(
            specs, mesh)).items()}
        for name, s in jspecs.items():
            spec = tuple(jax_logical_to_spec(s.axes, PARAM_RULES,
                                             _jax_mesh(shape), s.shape))
            want = tuple(
                d // int(np.prod([sizes[a] for a in (
                    () if i >= len(spec) or spec[i] is None else
                    (spec[i],) if isinstance(spec[i], str) else spec[i])]))
                for i, d in enumerate(s.shape))
            assert ours[name] == want, name
        rows = input_specs(cfg, ShapeConfig("s", 2048, batch, "train"),
                           mesh)
        assert tuple(rows["tokens"].shape) == (batch // shape[0], 2048)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


# the MoE families, which take a model axis since expert parallelism
# (tests/test_torch_expert_parallel.py)
EXPERT_PARALLEL = ["mixtral-8x22b", "deepseek-v3-671b"]


@pytest.mark.parametrize("case", ["mamba2-370m", "mixtral-8x22b",
                                  "zamba2-2.7b", "deepseek-v3-671b",
                                  "a second world"])
def test_a_model_axis_and_a_second_world_raise(case):
    """The SSM and hybrid smoke configs (a Mamba2 layer over the rank's SSM
    heads) and the MoE ones (mixtral's GQA, deepseek-v3's MLA) export a
    per-rank text on ``[2, 2]`` (the dense family's:
    ``test_torch_tensor_parallel.py``); a fake world refuses to replace a
    process group that is up."""
    with traced_mesh((2, 2), "cpu") as mesh:
        if case == "a second world":
            with pytest.raises(RuntimeError, match="already initialised"):
                with fake_world(4):
                    pass
            return
        cfg = get_smoke_config(case)
        step, args = loop.train_step_exports(cfg, SEQ, BATCH, mesh)
        text = export_workload(step, *args, device="cpu",
                               per_rank=(step, args, mesh)).hlo_text
    assert "mhlo.num_partitions = 4 " in text
    assert "stablehlo.partition_id" in text


# --------------------------------------------------------------------------
# (b) 4 gloo ranks against JAX's make_train_step on the whole batch
# --------------------------------------------------------------------------

def _smoke():
    kw = dict(dtype="float32")
    return (get_smoke_config("llama3-1b").scaled(**kw),
            jax_get_smoke_config("llama3-1b").scaled(**kw))


def _spawn(work: Path, job: str, shape=None) -> list[dict]:
    """Run ``torch_dist_ranks.run`` in WORLD spawned processes (on a mesh
    of ``shape``, ``[WORLD, 1]`` by default); each must exit 0 within
    RANK_TIMEOUT_S, or the stragglers are terminated and the test fails."""
    ctx = multiprocessing.get_context("spawn")
    store = work / f"store-{job}"
    procs = [ctx.Process(target=torch_dist_ranks.run,
                         args=(r, WORLD, str(store), str(work), job, shape))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.terminate()
            p.join(10)
    assert not late, f"{len(late)} ranks still running after " \
        f"{RANK_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(work / f"rank{r}.pt") for r in range(WORLD)]


def _weights(jcfg) -> dict:
    """Seeded weights, N(0, 0.02) for each matrix and ones for each norm,
    as ``test_torch_export.py``'s XLA check draws them: with the
    reference's scaled init at the smoke width the softmax is near one-hot
    and two compilers' rounding grows through it (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: (rng.normal(0, 0.02, x.shape).astype(np.float32)
                   if x.ndim > 1 else np.ones(x.shape, np.float32)),
        jax_init_params(jax_model_specs(jcfg), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The JAX reference's two steps on the whole batch and the 4 ranks'
    two steps on their shards and rows, from the same weights."""
    work = tmp_path_factory.mktemp("gloo")
    cfg, jcfg = _smoke()
    opt_t = optimizer.OptimizerConfig(warmup_steps=2)
    opt_j = jax_opt.OptimizerConfig(warmup_steps=2)
    weights = _weights(jcfg)
    source = data.SyntheticSource(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3))
    batches = [next(source) for _ in range(STEPS)]
    torch.save({"cfg": cfg, "opt_cfg": opt_t, "batches": batches,
                "params": params_from_jax(weights, "cpu")},
               work / "inputs.pt")
    ranks = _spawn(work, "step")
    jstep = jax.jit(jax_loop.make_train_step(jcfg, opt_j))
    jp = jax.tree.map(jax.numpy.asarray, weights)
    js = jax_opt.make_optimizer(opt_j)[0](jp, opt_j)
    ref = []
    for batch in batches:
        jp, js, jm = jstep(jp, js, jax.tree.map(jax.numpy.asarray, batch))
        ref.append(jax.tree.map(np.asarray, (jp, js, jm)))
    return SimpleNamespace(cfg=cfg, opt_cfg=opt_t, ranks=ranks, ref=ref)


def _whole(gloo, step: int):
    """The ranks' outputs of ``step`` joined: shards concatenated along
    their sharded dim, the rest rank 0's (equal on every rank)."""
    cfg = gloo.cfg
    specs = model_specs(cfg)
    with traced_mesh((WORLD, 1), "cpu") as mesh:
        _, (p_abs, o_abs, _) = loop.train_step_exports(cfg, SEQ, BATCH,
                                                       mesh)
    full = pytree.tree_leaves((abstract_params(specs),
                               optimizer.opt_state_abstract(specs, "adamw")))
    shards = pytree.tree_leaves((p_abs, o_abs))
    outs = [r["steps"][step] for r in gloo.ranks]
    joined = []
    for i, (s, f) in enumerate(zip(shards, full)):
        parts = [o[i] for o in outs]
        dims = [d for d in range(s.dim()) if s.shape[d] != f.shape[d]]
        joined.append(torch.cat(parts, dims[0]) if dims else parts[0])
    tail = outs[0][len(shards):]
    _, spec = pytree.tree_flatten((p_abs, o_abs))
    params, opt = pytree.tree_unflatten(joined, spec)
    names = ("grad_norm", "lr", "loss")  # the metrics dict's order
    return params, opt, dict(zip(names, tail))


def test_four_gloo_ranks_equal_jax_make_train_step(gloo):
    """Loss and grad_norm of each step, and the parameters and moments
    (the ranks' shards concatenated), against JAX's step on the whole
    batch: the tolerances of ``test_torch_train.py``'s step parity (f32
    in two libraries, the sums of the loss, the gradients and the norm
    in another order across the ranks)."""
    lr = gloo.opt_cfg.learning_rate
    for step in range(STEPS):
        params, opt, metrics = _whole(gloo, step)
        jp, js, jm = gloo.ref[step]
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
        assert int(opt["step"]) == int(js["step"]) == step + 1
        _assert_close(params, jp, lr * (step + 1))
        for moment in ("m", "v"):
            _assert_close(opt[moment], js[moment])


def _assert_close(ours, ref, bound=None):
    """``ours`` against ``ref`` leaf by leaf, as ``test_torch_train.py``
    holds parameters after optimizer steps: 99.9% of each leaf's elements
    within 1e-5 (absolute and relative), and every element within twice
    the rate times the steps (``bound``; for moments, 2e-3 of the leaf's
    largest magnitude: the clip's scale moves with the norm)."""
    flat = _paths(ref)
    for name, x in _paths(ours).items():
        r = flat[name].astype(np.float32)
        diff = np.abs(x.float().numpy() - r)
        assert (diff <= 1e-5 + 1e-5 * np.abs(r)).mean() >= 0.999, name
        limit = 2 * bound if bound is not None else \
            2e-3 * float(np.abs(r).max())
        assert diff.max() <= limit, (name, diff.max(), limit)


def test_every_rank_reports_the_same_loss_and_norm(gloo):
    for step in range(STEPS):
        tails = [r["steps"][step][-3:] for r in gloo.ranks]
        assert all(torch.equal(a, b) for t in tails[1:]
                   for a, b in zip(t, tails[0]))


def test_train_refuses_a_device_of_another_type_than_the_mesh():
    run = RunConfig(model=get_smoke_config("llama3-1b"),
                    shape=ShapeConfig("t", SEQ, BATCH, "train"))
    with traced_mesh((WORLD, 1), "cpu") as mesh:
        with pytest.raises(ValueError, match="device type"):
            loop.train(run, device="cuda", mesh=mesh, num_steps=1)


def test_train_on_a_mesh_equals_train_on_one_process(tmp_path):
    """``train(run, mesh=...)`` in 4 gloo ranks (parameters placed by
    shard, ShardedLoader, the per-rank step) against ``train(run)`` in one
    process: the same seed, the same batches, f32."""
    cfg = get_smoke_config("llama3-1b").scaled(num_layers=1,
                                                dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"))
    torch.save(run, tmp_path / "run.pt")
    ranks = _spawn(tmp_path, "train")
    one = loop.train(run, device="cpu", num_steps=2, log_every=0)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one.losses, rtol=1e-5)


# --------------------------------------------------------------------------
# (c) XLA on 4 CPU devices runs the per-rank text to the gloo step
# --------------------------------------------------------------------------

# as test_torch_export.py's XLA check: each output within 2^-16 of its
# largest magnitude
XLA_RTOL = 2.0 ** -16

_XLA_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax._src import compiler, xla_bridge
from jax._src.lib import xla_client
from jax.sharding import Mesh, NamedSharding, PartitionSpec
work = sys.argv[1]
text = open(os.path.join(work, "rank.mlir")).read()
backend = xla_bridge.get_backend("cpu")
devs = backend.devices()[:4]
# one replica of 4 partitions, as the text's module says; XLA refuses a
# program of several partitions without its SPMD partitioner, which has
# nothing to partition here (no sharding annotation) and keeps the
# collectives as written
exe = backend.compile_and_load(text, xla_client.DeviceList(tuple(devs)),
                               compiler.get_compile_options(1, 4))
inputs = [np.load(os.path.join(work, f"in{r}.npz")) for r in range(4)]
rep = NamedSharding(Mesh(np.array(devs), ("p",)), PartitionSpec())
args = []
for i in range(len(inputs[0].files)):
    per = [jax.device_put(inputs[r][f"a{i}"], d) for r, d in enumerate(devs)]
    args.append(jax.make_array_from_single_device_arrays(
        per[0].shape, rep, per))
outs = exe.execute_sharded(args).disassemble_into_single_device_arrays()
for r in range(4):
    np.savez(os.path.join(work, f"out{r}.npz"),
             **{f"a{i}": np.asarray(o[r]) for i, o in enumerate(outs)})
print("OK")
"""


def test_xla_runs_the_per_rank_text_to_the_gloo_step(gloo, tmp_path):
    cfg, opt_cfg = gloo.cfg, gloo.opt_cfg
    with traced_mesh((WORLD, 1), "cpu") as mesh:
        step, args = loop.train_step_exports(cfg, SEQ, BATCH, mesh,
                                             opt_cfg=opt_cfg)
        text = export_workload(step, *args, device="cpu",
                               per_rank=(step, args, mesh)).hlo_text
    (tmp_path / "rank.mlir").write_text(text)
    for r, rank in enumerate(gloo.ranks):
        np.savez(tmp_path / f"in{r}.npz", **{
            f"a{i}": x.numpy() for i, x in enumerate(rank["inputs"])})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _XLA_SCRIPT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    for r, rank in enumerate(gloo.ranks):
        got = np.load(tmp_path / f"out{r}.npz")
        want = rank["steps"][0]
        assert len(got.files) == len(want)
        for i, w in enumerate(want):
            g, w = got[f"a{i}"], w.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, i
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= XLA_RTOL * scale, (r, i)


# --------------------------------------------------------------------------
# (d) the per-rank text: FLOPs, collectives, front ends
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[4, 2], ids=["4x1", "2x1"])
def exported(request):
    n = request.param
    cfg = get_smoke_config("llama3-1b")
    step, args = loop.train_step_exports(cfg, SEQ, BATCH)
    with traced_mesh((n, 1), "cpu") as mesh:
        rstep, rargs = loop.train_step_exports(cfg, SEQ, BATCH, mesh)
        w = export_workload(step, *args, device="cpu",
                            per_rank=(rstep, rargs, mesh))
    return n, cfg, w


def _dot_flops(program) -> int:
    return int(ir.program_cost(program).by_op["dot_general"])


def test_per_rank_flops_are_the_raw_texts_over_n(exported):
    n, _, w = exported
    raw = _dot_flops(ir.parse_stablehlo(w.stablehlo_text))
    assert _dot_flops(ir.parse_stablehlo(w.hlo_text)) * n == raw
    assert w.meta["optimized"]["num_partitions"] == n
    assert "mhlo.num_partitions = 1 " in w.stablehlo_text
    assert f"mhlo.num_partitions = {n} " in w.hlo_text


@pytest.mark.parametrize("arch", ["mamba2-370m", "mixtral-8x22b",
                                  "zamba2-2.7b", "deepseek-v3-671b"])
def test_a_forward_workload_with_a_mesh_raises(arch, monkeypatch):
    """A forward workload on a ``[2, 2]`` mesh of the SSM, hybrid and MoE
    ids exports its per-rank forward as the optimized text (the dense
    family's: ``test_torch_tensor_parallel.py``), here at its published
    width cut to one layer, the hybrid's to one super-block of
    ``hybrid_attn_every`` Mamba2 layers and the shared block (a trace of
    every layer takes a minute and more)."""
    spec = campaign.WorkloadSpec(name="fwd", arch=arch, mode="forward",
                                 seq=SEQ, batch=BATCH, mesh=(2, 2))
    from repro_torch.models import registry

    whole = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda a: whole(a).scaled(
        num_layers=whole(a).hybrid_attn_every or 1))
    w = build_workload(spec, device="cpu")
    assert w.meta["mesh"] == [2, 2]
    assert "mhlo.num_partitions = 4 " in w.hlo_text


def test_every_collective_is_typed_by_its_payload(exported):
    """In both front ends (the port's and the reference's): each collective
    has its payload's bytes and a group of N; the gathers move the sharded
    leaves' bytes (a stacked leaf a layer at a time), the reduce-scatters
    their gradients' (in the parameters' dtype)."""
    n, cfg, w = exported
    specs = model_specs(cfg)
    shard = {k: t for k, t in _paths(abstract_params(specs)).items()}
    with traced_mesh((n, 1), "cpu") as mesh:
        ranks = _paths(abstract_params(specs, mesh))
    sharded = sum(t.numel() * t.element_size() for k, t in shard.items()
                  if ranks[k].shape != t.shape)
    gathers = sum(1 if "layers" not in k else t.shape[0]
                  for k, t in shard.items() if ranks[k].shape != t.shape)
    for pkg in (ir, jax_ir):
        for frontend in ("legacy", "streaming"):
            program = pkg.parse_stablehlo(w.hlo_text, frontend=frontend)
            assert program.meta["num_partitions"] == n
            collect = jax_collectives if pkg is jax_ir else \
                collect_collectives
            kinds = {}
            for c, _ in collect(program):
                assert c.group_size == n and c.num_groups == 1
                op = [o for o in program.entry if o.uid == c.op_uid][0]
                want_in = sum(t.nbytes for t in op.operand_types)
                assert want_in > 0 and c.bytes_in == want_in
                assert c.bytes_in == (c.bytes_out / n if c.kind ==
                                      "all_gather" else c.bytes_out * n
                                      if c.kind == "reduce_scatter" else
                                      c.bytes_out)
                k = kinds.setdefault(c.kind, [0, 0.0])
                k[0] += 1
                k[1] += c.algo_bytes
            assert kinds["all_gather"] == [gathers, sharded], frontend
            assert kinds["reduce_scatter"] == [gathers, sharded], frontend
            # the loss, each replicated leaf, the clip's sum of squares
            replicated = sum(t.numel() * t.element_size()
                             for k, t in shard.items()
                             if ranks[k].shape == t.shape)
            assert kinds["all_reduce"] == [5, replicated + 8], frontend


def test_port_ir_copies_equal_the_reference_on_the_per_rank_text(exported):
    text = exported[2].hlo_text
    for frontend in ("legacy", "streaming"):
        assert repr(ir.parse_stablehlo(text, frontend=frontend)) == repr(
            jax_ir.parse_stablehlo(text, frontend=frontend))
    ir.assert_programs_equal(ir.parse_stablehlo(text, frontend="legacy"),
                             ir.parse_stablehlo(text, frontend="streaming"))


# --------------------------------------------------------------------------
# (e) fig11's optimized rows in the golden's order
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig11_small():
    """fig11 as checked in, cut to llama3-100m and llama3-500m for the
    CPU's time (the card runs it whole, ``chip_smoke.py`` phase 10)."""
    spec = campaign.CampaignSpec.from_json(str(ROOT / "specs" /
                                               "fig11_tpu.json")).to_dict()
    spec["workloads"] = [w for w in spec["workloads"]
                         if w["arch"] in ("llama3-100m", "llama3-500m")]
    return campaign.run_campaign(campaign.CampaignSpec.from_dict(spec),
                                 device="cpu")


def test_fig11_small_rows_keep_the_goldens_order(fig11_small):
    """Per estimator the two workloads rank as the golden's."""
    result = fig11_small
    assert len(result.rows) == 4 and not [r for r in result.rows
                                          if "error" in r]
    golden = {(r["workload"], r["estimator"]): r["step_time_s"]
              for r in load_json(str(ROOT / "specs" / "golden" /
                                     "fig11-tpu.json"))["rows"]}
    for est in ("roofline", "mixed-cocossim"):
        rows = [r for r in result.rows if r["estimator"] == est]
        assert all(r["fidelity"] == "optimized" for r in rows)
        ours = [r["step_time_s"] for r in rows]
        theirs = [golden[(r["workload"], est)] for r in rows]
        assert kendall_tau(ours, theirs) == 1.0, (est, ours, theirs)


def test_fig11_mixed_rows_lie_below_the_roofline_rows(fig11_small):
    """The campaign exports the reference's attention (``chunked``), so
    the attention's products are in the text and the systolic model sees
    them: each workload's mixed-cocossim row lies below its roofline row
    (with the kernel text, whose products sit in ``call``ed functions,
    the two were equal to the digit), and each estimator keeps the
    golden's order (the test above)."""
    rows = {(r["workload"], r["estimator"]): r for r in fig11_small.rows}
    for workload in ("llama3-100m", "llama3-500m"):
        mixed = rows[(workload, "mixed-cocossim")]["step_time_s"]
        roof = rows[(workload, "roofline")]["step_time_s"]
        print(workload, "mixed / roofline", mixed / roof)
        assert mixed < roof, workload


def test_the_campaign_exports_the_references_attention():
    """An arch workload is traced with ``attn_impl="chunked"``: its text
    calls no attention operator (K2 and K2b stay calls), and its FLOPs
    are the chunked export's."""
    spec = campaign.WorkloadSpec(name="w", arch="llama3-100m", mode="train",
                                 seq=SEQ, batch=BATCH)
    w = build_workload(spec, device="cpu")
    assert set(w.meta["kernel_ops"]) == {"rmsnorm", "rmsnorm_bwd"}
    assert {e.op for e in w.calls("raw").values()} == {
        "repro_torch::rmsnorm", "repro_torch::rmsnorm_bwd"}
    cfg = get_config("llama3-100m").scaled(attn_impl="chunked")
    step, args = loop.train_step_exports(cfg, SEQ, BATCH)
    assert w.stablehlo_text == export_workload(
        step, *args, name="w", device="cpu").stablehlo_text


def test_a_profiling_rerun_hits_the_cache_and_is_faster(tmp_path):
    """The counterpart of the reference's
    ``TestPersistentCache.test_second_run_hits_and_is_faster`` with a
    ``profiling`` estimator on the CPU: the port's smoke kernel text (its
    K1, K1b, K2 and K2b ``call``s run through the text's ``call`` table)
    on ``host`` (the CPU, measured) and ``h100`` (projected), both
    slicers.  A second run against the warm cache pays no estimator cost:
    every lookup hits, the rows are equal, and it is faster."""
    cfg = get_smoke_config("llama3-1b").scaled(
        dtype="float32", scan_layers=False, layer_barriers=True)
    step, args = loop.train_step_exports(cfg, SEQ, 2)
    w = export_workload(step, *args, name="toy", device="cpu")
    assert w.calls("raw")
    d = {"name": "t", "workloads": [{"name": "toy", "fidelity": "raw"}],
         "systems": ["host", "h100"], "slicers": ["linear", "dep"],
         "estimators": [{"kind": "profiling", "fidelity": "raw",
                         "options": {"runs": 1}}]}
    cache = str(tmp_path / "hcr.json")

    def run():
        return campaign.run_campaign(
            campaign.CampaignSpec.from_dict(d, provided={"toy"}),
            workloads={"toy": w}, executor="serial", cache_path=cache,
            device="cpu")
    r1 = run()
    assert r1.summary["num_failed"] == 0
    assert r1.cache["misses"] > 0 and r1.cache["new_entries"] > 0
    assert os.path.exists(cache)
    r2 = run()
    assert r2.summary["num_failed"] == 0
    assert r2.cache["loaded_entries"] == r1.cache["new_entries"]
    assert r2.cache["hits"] > 0 and r2.cache["misses"] == 0
    assert r2.cache["hit_rate"] == 1.0
    assert r2.wall_s < r1.wall_s
    t1 = {r["job_id"]: r["step_time_s"] for r in r1.ok_rows}
    t2 = {r["job_id"]: r["step_time_s"] for r in r2.ok_rows}
    assert t1 == t2 and len(t1) == 4
    assert {r["toolchain"] for r in r1.ok_rows} == {"torch-eager"}
