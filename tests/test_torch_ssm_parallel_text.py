"""The per-rank texts of the SSM and hybrid families on ``[data, model]``
and ``[pod, data, model]`` meshes (mamba2-370m and zamba2-2.7b smoke
configs): both front ends equal, the ``dot_general`` FLOPs the single-device
text's over the world plus the products every model rank computes whole,
the split norm's all-reduce between its two passes each way, the model
axis's collectives counted against the layers, and the split-row calls run
by the port's executor.  The gloo ranks against JAX, and XLA running the
``[2, 2]`` text: ``test_torch_ssm_parallel.py``.
"""
import functools
import json

import numpy as np
import pytest

from repro.core import ir as jax_ir
from repro_torch.core import ir
from repro_torch.core.estimators.profiling import ProfilingEstimator
from repro_torch.core.pipeline import build_plan, export_workload
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models.registry import get_smoke_config
from repro_torch.train import loop

SEQ, BATCH = 16, 8
# (arch, mesh) of each exported text
TEXTS = [("mamba2-370m", (1, 4)), ("zamba2-2.7b", (1, 4)),
         ("zamba2-2.7b", (2, 1, 2))]
SPLIT_CALLS = ("rmsnorm_sumsq", "rmsnorm_split", "rmsnorm_bwd_dot",
               "rmsnorm_bwd_split")


@functools.lru_cache(maxsize=None)
def _export(arch: str, shape: tuple):
    """The arch's single-device train step and its per-rank step on a mesh
    of ``shape``, exported."""
    cfg = get_smoke_config(arch)
    step, args = loop.train_step_exports(cfg, SEQ, BATCH)
    with traced_mesh(shape, "cpu") as mesh:
        rank = loop.train_step_exports(cfg, SEQ, BATCH, mesh)
        w = export_workload(step, *args, device="cpu",
                            per_rank=(*rank, mesh))
    return shape, cfg, w


@pytest.fixture(scope="module", params=TEXTS,
                ids=[f"{a}-{'x'.join(map(str, s))}" for a, s in TEXTS])
def exported(request):
    return _export(*request.param)


def _mesh_groups(shape):
    """Every group of each axis of a mesh of ``shape``: the global ranks
    (row-major) that differ only in that axis's coordinate."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    names = ("pod", "data", "model")[-len(shape):]
    return {a: sorted(np.moveaxis(ranks, i, -1).reshape(-1, n).tolist())
            for i, (a, n) in enumerate(zip(names, shape))}


def _groups(raw: str):
    text = raw.split("replica_groups = dense<", 1)[1].split(">", 1)[0]
    return sorted(json.loads(text))


def test_both_front_ends_parse_the_text_alike(exported):
    """The port's two front ends give equal Programs, and the reference's
    parse the same ops, with the world's partitions."""
    text = exported[2].hlo_text
    for frontend in ("legacy", "streaming"):
        program = ir.parse_stablehlo(text, frontend=frontend)
        assert program.meta["num_partitions"] == 4
        assert repr(program) == repr(jax_ir.parse_stablehlo(
            text, frontend=frontend))
    ir.assert_programs_equal(ir.parse_stablehlo(text, frontend="legacy"),
                             ir.parse_stablehlo(text, frontend="streaming"))
    assert "stablehlo.partition_id" in text
    assert "mhlo.num_partitions = 4 " in text


def test_per_rank_flops_are_the_raw_texts_over_the_world(exported):
    """Every rule divides on these meshes, so each product is split over
    the world, but for the products of the SSD scan between the rank's
    group's B and C (n_groups 1: the group is whole on every model rank),
    which each model rank computes for the rank's rows: C B^T in K3's plain
    forward, and again in K3b's with dC and dB over the rank's heads'
    summed scores, 4 a layer of 2 x tokens x chunk x G x N.  With W those
    products over the whole batch, a rank computes (raw - W) / world +
    W / data, so rank x world = raw + (model - 1) W."""
    shape, cfg, w = exported
    raw = int(ir.program_cost(ir.parse_stablehlo(
        w.stablehlo_text)).by_op["dot_general"])
    rank = int(ir.program_cost(ir.parse_stablehlo(
        w.hlo_text)).by_op["dot_general"])
    s = cfg.ssm
    chunk = min(s.chunk_size, SEQ)
    group = 4 * 2 * BATCH * SEQ * chunk * s.n_groups * s.d_state \
        * cfg.num_layers
    assert rank * 4 == raw + (shape[-1] - 1) * group


def test_the_split_norm_all_reduces_between_its_passes(exported):
    """Each Mamba2 layer's gated norm: the block's sums of squares, their
    all-reduce over the model groups, then the block's norm from the
    totals; backward the block's sums of x w dy, their all-reduce, then dx
    and dw from both totals (the forward's saved, not reduced again)."""
    shape, cfg, w = exported
    program = ir.parse_stablehlo(w.hlo_text)
    model = str(_mesh_groups(shape)["model"])
    made = {}
    seen = {name: 0 for name in SPLIT_CALLS}
    for op in program.entry:
        for r in (op.results or ()):
            made[r] = op
        if op.op != "call":
            continue
        name = op.called[0].split(".", 1)[1].rsplit("_", 1)[0]
        if name not in ("rmsnorm_split", "rmsnorm_bwd_split"):
            if name in seen:
                seen[name] += 1
            continue
        seen[name] += 1
        # the totals: the last operand of rmsnorm_split, the last two of
        # rmsnorm_bwd_split, each an all-reduce over the model groups of a
        # pass's row sums
        sums = op.operands[-1:] if name == "rmsnorm_split" \
            else op.operands[-2:]
        for operand in sums:
            reduce = made[operand]
            assert reduce.op == "all_reduce", reduce.op
            assert str(_groups(reduce.raw)) == model
            first = made[reduce.operands[0]]
            assert first.op == "call"
            assert first.called[0].split(".", 1)[1].rsplit("_", 1)[0] in (
                "rmsnorm_sumsq", "rmsnorm_bwd_dot")
    assert seen == {name: cfg.num_layers for name in SPLIT_CALLS}


def _model_collectives(shape, program) -> dict:
    model = str(_mesh_groups(shape)["model"])
    out = {}
    for op in program.entry:
        if op.op in ("all_reduce", "all_gather", "reduce_scatter") and \
                str(_groups(op.raw)) == model:
            out[op.op] = out.get(op.op, 0) + 1
    return out


def test_the_model_axis_collectives_follow_the_layers(exported):
    """The model axis's collectives, counted against the L Mamba2 layers
    (remat none): a layer gathers its block of the packed projection and
    of conv_w and conv_b (3 all-gathers) and reduce-scatters their
    gradients (3), all-reduces the norm's row sums each way, out_proj's
    partial output (*g*) and its input's gradient (*f*) (4), and gathers
    out_norm's block's gradient (1 all-gather); the hybrid's shared block,
    the dense family's, all-reduces 4 times each time it runs.  Once a
    step: the vocab-parallel embedding's rows, the head's input gradient,
    the cross-entropy's three reductions and the clip's sum of squares
    (6)."""
    shape, cfg, w = exported
    n = cfg.num_layers
    attn = n // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    assert _model_collectives(shape, ir.parse_stablehlo(w.hlo_text)) == {
        "all_gather": 4 * n, "reduce_scatter": 3 * n,
        "all_reduce": 4 * n + 4 * attn + 6}


def test_the_executor_runs_the_split_row_calls():
    """The linear slicer's compute regions of mamba2's ``[1, 4]`` per-rank
    text hold the four split-row calls (the all-reduces between them fall
    in the communication segments), and the profiling estimator runs every
    region through the port's executor, the calls through their operators
    (on the CPU their plain versions), with no emit failure."""
    _, _, w = _export("mamba2-370m", (1, 4))
    plan = build_plan(w.program("optimized"), calls=w.calls("optimized"))
    ops = {plan.calls[op.called[0]].op for region in plan.compute_regions
           for op in region.ops if op.op == "call"}
    assert {f"repro_torch::{n}" for n in SPLIT_CALLS} <= ops
    est = ProfilingEstimator(program=plan.program, calls=plan.calls, runs=1,
                             device="cpu")
    times = est.get_run_time_estimates(plan.compute_regions)
    assert est.emit_failures == 0 and all(t > 0 for t in times)
