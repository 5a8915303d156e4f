"""The per-rank texts of the MoE family on a ``[2, 2]`` mesh (mixtral smoke:
GQA and 4 experts, 2 a rank; deepseek-v3 smoke: MLA's 4 heads, 2 a rank, 8
experts, 4 a rank, and the shared expert split): both front ends equal,
every group of each axis in ``replica_groups``, the model axis's
collectives counted against the layers, and the ``dot_general`` FLOPs
against a reckoning at the rank's capacity; a campaign's train and forward
workloads on ``[2, 2]`` of both ids export and predict.  The gloo ranks
against JAX: ``test_torch_expert_parallel.py``.
"""
import pytest

from repro.core import ir as jax_ir
from repro_torch import campaign
from repro_torch.campaign.builders import build_workload
from repro_torch.core import ir
from repro_torch.core.pipeline import export_workload
from repro_torch.launch.mesh import traced_mesh
from repro_torch.models import mlp
from repro_torch.models.registry import get_smoke_config
from repro_torch.train import loop
from test_torch_tensor_parallel_text import (_collectives, _dot_flops,
                                             _mesh_groups, _replica_groups)

SEQ, BATCH = 16, 8
MESH = (2, 2)
ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")


@pytest.fixture(scope="module", params=ARCHS)
def exported(request):
    """The smoke config's per-rank train step on ``[2, 2]``, exported."""
    cfg = get_smoke_config(request.param)
    with traced_mesh(MESH, "cpu") as mesh:
        step, args = loop.train_step_exports(cfg, SEQ, BATCH, mesh)
        w = export_workload(step, *args, device="cpu",
                            per_rank=(step, args, mesh))
    return cfg, w


def rank_flops(cfg, m: int, b: int, s: int) -> int:
    """The ``dot_general`` FLOPs of one rank's train step (no remat) at
    ``b`` x ``s`` rows a rank on a model axis of ``m`` that divides the
    heads, the kv heads, the vocab, the experts and the shared expert.
    Each product runs forward and backward for its two operands (3 times):
    a layer's attention projections over the rank's heads (MLA: the down
    projections whole), the router over every expert on the rank's tokens,
    the grouped expert GEMMs over the rank's E/m capacity buffers of
    ``_capacity(b * s)`` rows, the shared expert over its block, and the
    head over the rank's vocab block.  K1 and K1b are written as calls of
    their plain versions, which compute every pair: Q K^T and P V forward,
    S, dP, dV, dK and dQ backward, each at its width."""
    mo, d, t = cfg.moe, cfg.d_model, b * s
    heads = cfg.num_heads // m
    if cfg.mla is not None:
        a = cfg.mla
        qk, dv = a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
        proj = 2 * t * (d * (a.q_lora_rank + a.kv_lora_rank
                             + a.qk_rope_head_dim)
                        + heads * (a.q_lora_rank * qk
                                   + a.kv_lora_rank * (a.qk_nope_head_dim
                                                       + dv)
                                   + dv * d))
    else:
        qk = dv = cfg.resolved_head_dim
        kv = cfg.num_kv_heads // m
        proj = 2 * t * d * qk * (2 * heads + 2 * kv)
    cap = mlp._capacity(t, mo)
    moe = 2 * t * d * mo.num_experts + 3 * 2 * (
        mo.num_experts // m) * cap * d * mo.d_ff_expert
    if mo.num_shared_experts:
        moe += 3 * 2 * t * d * mlp._mlp_width(cfg, "_shared") // m
    pairs = 2 * b * heads * s * s
    attention = pairs * (qk + dv) + pairs * (3 * qk + 2 * dv)
    head = 2 * t * d * cfg.vocab_size // m
    return cfg.num_layers * (3 * (proj + moe) + attention) + 3 * head


def test_the_text_lists_every_group_and_both_front_ends_agree(exported):
    """Each collective's ``replica_groups`` lists every group of its axis,
    in the port's and the reference's front ends, legacy and streaming,
    which agree; ``num_partitions`` is the world's."""
    _, w = exported
    axes = {str(g): a for a, g in _mesh_groups(MESH).items()}
    seen = set()
    for pkg in (ir, jax_ir):
        for frontend in ("legacy", "streaming"):
            program = pkg.parse_stablehlo(w.hlo_text, frontend=frontend)
            assert program.meta["num_partitions"] == 4
            for op in program.entry:
                if op.op in ("all_reduce", "all_gather", "reduce_scatter"):
                    groups = str(_replica_groups(op.raw))
                    assert groups in axes, groups
                    seen.add(axes[groups])
            assert repr(program) == repr(
                ir.parse_stablehlo(w.hlo_text, frontend=frontend))
    assert seen == {"data", "model"}
    ir.assert_programs_equal(
        ir.parse_stablehlo(w.hlo_text, frontend="legacy"),
        ir.parse_stablehlo(w.hlo_text, frontend="streaming"))


def test_the_model_axis_collectives_follow_the_layers(exported):
    """The model axis's collectives, counted against the layers L.  A
    layer: the attention's row-parallel output forward (*g*) and the
    gradients of what enters its heads' region backward (*f*: GQA's x, 1;
    MLA's three latents, 3); the MoE's partial token outputs (the shared
    expert's with them) forward and its input's gradient backward, 2
    all-reduces; the router's columns gathered forward and their gradient
    reduce-scattered backward.  Once a step: the vocab-parallel embedding's
    rows, the head's input gradient, the cross-entropy's max, sum and
    target logit, and the clip's sum of squares of the model-sharded
    leaves (6 all-reduces)."""
    cfg, w = exported
    counts = _collectives(ir.parse_stablehlo(w.hlo_text))
    model = str(_mesh_groups(MESH)["model"])
    got = {kind: n for (kind, g), n in counts.items() if g == model}
    attention = 1 + (3 if cfg.mla is not None else 1)
    layers = cfg.num_layers
    assert got == {"all_reduce": (attention + 2) * layers + 6,
                   "all_gather": layers, "reduce_scatter": layers}


def test_per_rank_flops_equal_the_reckoning_at_the_ranks_capacity(
        exported):
    """The per-rank text's ``dot_general`` FLOPs equal :func:`rank_flops`
    at the rank's 4 x 16 tokens and their capacity (the global text's
    routing and capacity are the whole batch's, so they are not the raw
    text's over 4)."""
    cfg, w = exported
    got = _dot_flops(ir.parse_stablehlo(w.hlo_text))
    assert got == rank_flops(cfg, MESH[1], BATCH // MESH[0], SEQ)


@pytest.mark.parametrize("mode", ["train", "forward"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_campaign_workload_on_a_2x2_mesh_exports_and_predicts(
        arch, mode, monkeypatch):
    """A campaign's workload with ``"mesh": [2, 2]`` of an MoE id at its
    published width, cut to one layer (a trace of every layer takes
    minutes), exports the per-rank program as its optimized text and
    predicts from it on ``h100``."""
    from repro_torch.models import registry

    whole = registry.get_config
    monkeypatch.setattr(registry, "get_config",
                        lambda a: whole(a).scaled(num_layers=1))
    spec = campaign.WorkloadSpec(name="w", arch=arch, mode=mode, seq=SEQ,
                                 batch=BATCH, mesh=MESH)
    w = build_workload(spec, device="cpu")
    assert w.meta["mesh"] == list(MESH)
    assert "mhlo.num_partitions = 4 " in w.hlo_text
    assert _dot_flops(ir.parse_stablehlo(w.hlo_text)) > 0
    d = {"name": "t", "workloads": [{"name": "w", "fidelity": "optimized"}],
         "systems": ["h100"], "estimators": [{"kind": "roofline"}]}
    result = campaign.run_campaign(
        campaign.CampaignSpec.from_dict(d, provided={"w"}),
        workloads={"w": w}, executor="serial", device="cpu")
    assert result.summary["num_failed"] == 0 and len(result.ok_rows) == 1
    row = result.ok_rows[0]
    assert row["fidelity"] == "optimized" and row["step_time_s"] > 0
