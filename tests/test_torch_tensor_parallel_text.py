"""The per-rank texts of the dense family on ``[data, model]`` and ``[pod,
data, model]`` meshes (llama3-1b smoke on ``[2, 2]``, ``[2, 1, 2]`` and
``[1, 4]``): both front ends equal, every group of each axis in
``replica_groups``, ``dot_general`` FLOPs a quarter of the raw text's
(``[1, 4]``: plus the whole K and V projections each rank computes), the
model axis's collectives counted against the layers; a campaign's forward
workload on ``[2, 2]`` exports and predicts.  The gloo ranks against JAX,
and XLA running the ``[2, 2]`` text: ``test_torch_tensor_parallel.py``.
"""
import json

import numpy as np
import pytest

from repro.core import ir as jax_ir
from repro_torch import campaign
from repro_torch.core import ir
from repro_torch.core.ir.collectives import collect_collectives
from repro_torch.core.pipeline import export_workload
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models.params import tree_paths
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import model_specs
from repro_torch.train import loop

SEQ, BATCH = 16, 8


@pytest.fixture(scope="module", params=[(2, 2), (2, 1, 2), (1, 4)],
                ids=["2x2", "2x1x2", "1x4"])
def exported(request):
    """llama3-1b smoke's global train step and its per-rank step on a
    mesh, exported."""
    shape = request.param
    cfg = get_smoke_config("llama3-1b")
    step, args = loop.train_step_exports(cfg, SEQ, BATCH)
    with traced_mesh(shape, "cpu") as mesh:
        rank = loop.train_step_exports(cfg, SEQ, BATCH, mesh)
        w = export_workload(step, *args, device="cpu",
                            per_rank=(*rank, mesh))
    return shape, cfg, w


def _dot_flops(program) -> int:
    return int(ir.program_cost(program).by_op["dot_general"])


def _mesh_groups(shape):
    """Every group of each axis of a mesh of ``shape``: the global ranks
    (row-major) that differ only in that axis's coordinate."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    names = ("pod", "data", "model")[-len(shape):]
    return {a: sorted(np.moveaxis(ranks, i, -1).reshape(-1, n).tolist())
            for i, (a, n) in enumerate(zip(names, shape))}


def _collectives(program):
    """(kind, axis) -> count, the axis read from ``replica_groups``."""
    out = {}
    for op in program.entry:
        if op.op not in ("all_reduce", "all_gather", "reduce_scatter"):
            continue
        groups = _replica_groups(op.raw)
        out.setdefault((op.op, str(groups)), 0)
        out[(op.op, str(groups))] += 1
    return out


def _replica_groups(raw: str):
    text = raw.split("replica_groups = dense<", 1)[1].split(">", 1)[0]
    return sorted(json.loads(text))


def test_the_text_lists_every_group_of_each_axis(exported):
    """Each collective's ``replica_groups`` lists every group of its axis
    (as XLA prints them), in both front ends (the port's and the
    reference's), with ``num_groups`` and ``group_size`` the axis's."""
    shape, _, w = exported
    axes = {str(g): (a, len(g), len(g[0]))
            for a, g in _mesh_groups(shape).items()}
    seen = set()
    for pkg in (ir, jax_ir):
        for frontend in ("legacy", "streaming"):
            program = pkg.parse_stablehlo(w.hlo_text, frontend=frontend)
            assert program.meta["num_partitions"] == 4
            for op in program.entry:
                if op.op in ("all_reduce", "all_gather", "reduce_scatter"):
                    groups = str(_replica_groups(op.raw))
                    assert groups in axes, groups
                    seen.add(axes[groups][0])
            for c, _ in collect_collectives(program):
                assert (c.num_groups, c.group_size) in {
                    v[1:] for v in axes.values()}
    sizes = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    # an axis of size 1 moves nothing
    assert seen == {a for a, n in sizes.items() if n > 1}


def test_port_ir_copies_equal_the_reference_on_the_text(exported):
    text = exported[2].hlo_text
    for frontend in ("legacy", "streaming"):
        assert repr(ir.parse_stablehlo(text, frontend=frontend)) == repr(
            jax_ir.parse_stablehlo(text, frontend=frontend))
    ir.assert_programs_equal(ir.parse_stablehlo(text, frontend="legacy"),
                             ir.parse_stablehlo(text, frontend="streaming"))


def test_per_rank_flops_are_the_raw_texts_over_the_world(exported):
    """Every dim of llama3-1b smoke divides on ``[2, 2]`` and ``[2, 1,
    2]``, so no product is computed twice: the per-rank FLOPs are a quarter
    of the raw text's.  On ``[1, 4]`` kv 2 stays whole, and each rank
    computes the K and V projections (forward, and their weight and input
    gradients) of both kv heads: 3 products of 2 x d x (kv x hd) FLOPs a
    token each for K and for V, a layer, beyond the quarter."""
    shape, cfg, w = exported
    raw = _dot_flops(ir.parse_stablehlo(w.stablehlo_text))
    rank = _dot_flops(ir.parse_stablehlo(w.hlo_text))
    assert w.meta["optimized"]["num_partitions"] == 4
    assert "mhlo.num_partitions = 4 " in w.hlo_text
    if shape != (1, 4):
        assert rank * 4 == raw
        return
    tokens = SEQ * BATCH
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    whole = 2 * 3 * 2 * tokens * cfg.d_model * kv * cfg.num_layers
    assert rank == raw // 4 + whole - whole // 4


def test_the_model_axis_collectives_follow_the_layers(exported):
    """The model axis's collectives, counted against llama3-1b smoke's
    layers L: a layer all-reduces the attention's and the MLP's row-parallel
    outputs forward (*g*) and their column-parallel inputs' gradients
    backward (*f*), 4; on ``[1, 4]`` (kv whole) also the gradients of K and
    V before the rank takes its kv head, 2 more.  Once a step: the
    vocab-parallel embedding's rows (1), the head's input gradient (1), the
    cross-entropy's max, sum of exponentials and target logit (3), and the
    clip's sum of squares of the model-sharded leaves (1)."""
    shape, cfg, w = exported
    groups = _mesh_groups(shape)
    counts = _collectives(ir.parse_stablehlo(w.hlo_text))
    model = {kind: n for (kind, g), n in counts.items()
             if g == str(groups["model"])}
    per_layer = 4 + (2 if shape == (1, 4) else 0)
    assert model == {"all_reduce": per_layer * cfg.num_layers + 1 + 1 + 3
                     + 1}
    if shape == (2, 1, 2):
        pod = {kind: n for (kind, g), n in counts.items()
               if g == str(groups["pod"])}
        # the loss, and every gradient leaf once
        leaves = len(tree_paths(model_specs(cfg)))
        assert pod == {"all_reduce": 1 + leaves}


def test_a_forward_workload_on_a_2x2_mesh_exports_and_predicts():
    """A campaign's ``mode="forward"`` workload with ``"mesh": [2, 2]``
    for a dense id exports the per-rank forward as its optimized text (a
    quarter of the raw text's FLOPs) and predicts from it."""
    spec = campaign.WorkloadSpec(name="fwd", arch="llama3-100m",
                                 mode="forward", seq=SEQ, batch=BATCH,
                                 mesh=(2, 2))
    w = campaign.builders.build_workload(spec, device="cpu")
    raw = _dot_flops(ir.parse_stablehlo(w.stablehlo_text))
    assert _dot_flops(ir.parse_stablehlo(w.hlo_text)) * 4 == raw
    d = {"name": "t", "workloads": [{"name": "fwd", "fidelity":
                                     "optimized"}],
         "systems": ["h100"], "estimators": [{"kind": "roofline"}]}
    result = campaign.run_campaign(
        campaign.CampaignSpec.from_dict(d, provided={"fwd"}),
        workloads={"fwd": w}, executor="serial", device="cpu")
    assert result.summary["num_failed"] == 0 and len(result.ok_rows) == 1
    row = result.ok_rows[0]
    assert row["fidelity"] == "optimized" and row["step_time_s"] > 0
