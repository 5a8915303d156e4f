"""Materialize estimators, topologies, and workloads from campaign specs:
the port's copy of the reference's ``campaign/builders.py``.

Everything here turns a primitives-only spec into live pipeline objects,
which is what lets :class:`~repro_torch.campaign.spec.JobSpec` records cross a
process boundary: the worker rebuilds the objects locally from the spec.

Estimator and topology kinds resolve through the open registries
(:mod:`repro_torch.core.registry`): each backend class carries a
``from_spec(options, system, context)`` constructor, so adding a kind is
one decorated class — no edits here.  Systems resolve through the
catalog (:mod:`repro_torch.core.catalog`).  Callers with session-scoped
backends pass their registries; the defaults are the globals.

Workloads: the GEMM and sharded-stack syntheses and the serving steps
are copies (the same text, byte for byte, from the port's ``configs/``).
An ``arch`` workload in ``mode="train"``/``"forward"`` is the port's own
export: :func:`repro_torch.train.loop.train_step_exports` (or
``forward_exports``; for a ``resnet*`` arch
:func:`repro_torch.models.resnet.resnet_train_exports`) traced by
:func:`repro_torch.core.pipeline.export_workload` on fake tensors on
``device`` (None: the card), with the arch's config as the port registers
it but for its attention: ``attn_impl="chunked"``, the reference's default
and what its campaign exports, so that the attention's products are in
the text itself, where the systolic model and per-op roofline see them.
(The card's configuration, ``"kernel"``, writes K1 and K1b as ``call``s
of private functions, which neither estimator follows; K2 and K2b are
``call``s in both, since their operator is always used.)  The
raw text is the global step, which is what the reference's raw text of a
sharded ``jit`` computes.  With a mesh (recorded in
``Workload.meta["mesh"]``) the optimized text is the per-rank program of
the data mesh with its collectives, the port's counterpart of the
reference's compiled per-device text; without one there is no optimized
text, and a job that asks for it becomes a ``plan`` error row.
"""
from __future__ import annotations

from ..core.catalog import SystemRegistry, default_registry
from ..core.estimators.base import ComputeEstimator
from ..core.ir.graph import Program
from ..core.network import Topology
from ..core.pipeline import Workload, export_workload
from ..core.registry import ESTIMATORS, TOPOLOGIES, BuildContext, Registry
from ..core.systems import System
from .spec import EstimatorSpec, TopologySpec, WorkloadSpec


def build_estimator(spec: EstimatorSpec, system: System, *,
                    system_name: str = "", program: Program | None = None,
                    registry: Registry | None = None,
                    context: BuildContext | None = None) -> ComputeEstimator:
    reg = registry or ESTIMATORS
    if spec.kind not in reg:
        raise ValueError(reg.unknown_message(spec.kind))
    if context is None:
        context = BuildContext(system_name=system_name, program=program,
                               estimators=reg)
    return reg.get(spec.kind).from_spec(spec.options_dict, system, context)


def build_topology(spec: TopologySpec, system: System, *,
                   registry: Registry | None = None,
                   context: BuildContext | None = None) -> Topology:
    reg = registry or TOPOLOGIES
    if spec.kind not in reg:
        raise ValueError(reg.unknown_message(spec.kind))
    if context is None:
        context = BuildContext(topologies=reg)
    return reg.get(spec.kind).from_spec(spec.params_dict, system, context)


def build_system(name: str, registry: SystemRegistry | None = None, *,
                 device=None) -> System:
    """A catalog system, or for ``host`` the calibrated host on
    ``device`` (None: the card)."""
    return (registry or default_registry()).get(name, device)


def build_workload(spec: WorkloadSpec, *, device=None) -> Workload:
    """Materialize a workload from its spec source: read pre-exported IR
    from disk, synthesize a GEMM or a serving step, or export the port's
    step (forward or full train step, per ``spec.mode``) traced on fake
    tensors on ``device`` (None: the card; the CPU only when asked)."""
    if spec.stablehlo_path or spec.hlo_path:
        w = Workload(name=spec.name)
        if spec.stablehlo_path:
            with open(spec.stablehlo_path) as f:
                w.stablehlo_text = f.read()
        if spec.hlo_path:
            with open(spec.hlo_path) as f:
                w.hlo_text = f.read()
        return w
    if spec.gemm is not None:
        return _synthesize_gemm(spec)
    if spec.mode in ("prefill", "decode"):
        return _synthesize_serving(spec)
    return _export_from_arch(spec, device)


def _synthesize_gemm(spec: WorkloadSpec) -> Workload:
    """A single-``dot_general`` StableHLO workload, written directly as
    MLIR text (no framework needed) — the operator-level unit of the paper's
    Fig 10 GEMM sweeps.  The lone compute region it slices into carries
    exactly the (M, N, K, dtype) the systolic/roofline estimators cost."""
    g = spec.gemm
    m, n, k = int(g["m"]), int(g["n"]), int(g["k"])
    dt = str(g.get("dtype", "bf16"))
    lhs, rhs, out = f"{m}x{k}x{dt}", f"{k}x{n}x{dt}", f"{m}x{n}x{dt}"
    text = (
        "module @gemm {\n"
        f"  func.func public @main(%arg0: tensor<{lhs}>, "
        f"%arg1: tensor<{rhs}>) -> tensor<{out}> {{\n"
        f"    %0 = stablehlo.dot_general %arg0, %arg1, "
        f"contracting_dims = [1] x [0], "
        f"precision = [DEFAULT, DEFAULT] : "
        f"(tensor<{lhs}>, tensor<{rhs}>) -> tensor<{out}>\n"
        f"    return %0 : tensor<{out}>\n"
        "  }\n"
        "}\n")
    return Workload(name=spec.name, stablehlo_text=text,
                    meta={"gemm": {"m": m, "n": n, "k": k, "dtype": dt}})


def synthesize_gemm_stack(shapes: list[tuple[int, int, int]]) -> str:
    """A StableHLO module of independent ``dot_general``s separated by
    ``optimization_barrier``s — one compute region per GEMM under the
    linear slicer, written directly as MLIR text (no framework needed).

    The multi-region sibling of :func:`_synthesize_gemm`; benchmarks and
    tests use it to exercise plan reuse and batched cache traffic on
    workloads with many distinct fingerprints."""
    args, body = [], []
    v = 0
    for i, (m, n, k) in enumerate(shapes):
        lhs, rhs, out = f"{m}x{k}xbf16", f"{k}x{n}xbf16", f"{m}x{n}xbf16"
        args += [f"%arg{2 * i}: tensor<{lhs}>",
                 f"%arg{2 * i + 1}: tensor<{rhs}>"]
        body.append(
            f"    %{v} = stablehlo.dot_general %arg{2 * i}, "
            f"%arg{2 * i + 1}, contracting_dims = [1] x [0], "
            f"precision = [DEFAULT, DEFAULT] : "
            f"(tensor<{lhs}>, tensor<{rhs}>) -> tensor<{out}>")
        v += 1
        body.append(f"    %{v} = stablehlo.optimization_barrier "
                    f"%{v - 1} : tensor<{out}>")
        v += 1
    m, n, _ = shapes[-1]
    return ("module @gemm_stack {\n"
            f"  func.func public @main({', '.join(args)}) -> "
            f"tensor<{m}x{n}xbf16> {{\n" + "\n".join(body) +
            f"\n    return %{v - 1} : tensor<{m}x{n}xbf16>\n  }}\n}}\n")


def _while_wrap(body: str, trips: int, carry_in: str, carry_ty: str,
                indent: str, tag: str) -> str:
    """Wrap ``body`` in a ``stablehlo.while`` counting to ``trips``,
    printed exactly as ``jax.lax.fori_loop`` lowers (counter + one carried
    tensor, cond/do blocks).  ``tag`` keeps SSA names unique across
    nesting levels."""
    i = indent
    return (
        f"{i}%c{tag} = stablehlo.constant dense<0> : tensor<i32>\n"
        f"{i}%out{tag}:2 = stablehlo.while(%iterArg{tag} = %c{tag}, "
        f"%iterArg{tag}_0 = {carry_in}) : tensor<i32>, {carry_ty}\n"
        f"{i} cond {{\n"
        f"{i}  %limit{tag} = stablehlo.constant dense<{trips}> : tensor<i32>\n"
        f"{i}  %cmp{tag} = stablehlo.compare  LT, %iterArg{tag}, "
        f"%limit{tag},  SIGNED : (tensor<i32>, tensor<i32>) -> tensor<i1>\n"
        f"{i}  stablehlo.return %cmp{tag} : tensor<i1>\n"
        f"{i}}} do {{\n" + body + "\n"
        f"{i}  %one{tag} = stablehlo.constant dense<1> : tensor<i32>\n"
        f"{i}  %next{tag} = stablehlo.add %iterArg{tag}, %one{tag} "
        f": tensor<i32>\n"
        f"{i}  stablehlo.return %next{tag}, %iterArg{tag}_0 "
        f": tensor<i32>, {carry_ty}\n"
        f"{i}}}")


def synthesize_sharded_stack(shapes: list[tuple[int, int, int]],
                             groups: int = 8,
                             steps: int | None = None,
                             microbatches: int | None = None) -> str:
    """A data-parallel sharded training stack, written directly as MLIR
    text (no framework needed): per layer a ``custom_call @Sharding`` carrying a
    quoted ``mhlo.sharding`` annotation, a ``dot_general``, a bias ``add``,
    a multi-line ``all_reduce`` region op (gradient sync) with
    ``replica_groups``/``channel_handle``, and an ``optimization_barrier``.
    With ``steps``, the whole stack sits inside a ``stablehlo.while``
    accumulation loop (the shape ``jax.lax.fori_loop`` lowers to), cond/do
    blocks written exactly as ``jax.jit(...).lower()`` prints them; with
    ``microbatches`` too, that loop nests inside an outer
    gradient-accumulation loop — the two-level pipeline-schedule shape.

    Line shapes mirror ``jax.jit(shard_map(...)).lower().as_text()``
    exports verbatim — quoted attribute strings, collective region blocks,
    and loop bodies are exactly where the two front ends diverge most in
    cost, so benchmarks use this for the cold-parse comparison and the
    differential suite parses it through both."""
    ids = ", ".join(str(d) for d in range(groups))
    depth = (steps is not None) + (microbatches is not None)
    pad = "    " + "  " * depth
    args, body = [], []
    v = 0
    for i, (m, n, k) in enumerate(shapes):
        lhs, rhs, out = f"{m}x{k}xbf16", f"{k}x{n}xbf16", f"{m}x{n}xbf16"
        args += [f"%arg{2 * i}: tensor<{lhs}>",
                 f"%arg{2 * i + 1}: tensor<{rhs}>"]
        body.append(
            f'{pad}%{v} = stablehlo.custom_call @Sharding(%arg{2 * i + 1}) '
            f'{{backend_config = "", mhlo.sharding = '
            f'"{{devices=[{groups},1]<=[{groups}]}}"}} : '
            f"(tensor<{rhs}>) -> tensor<{rhs}>")
        v += 1
        body.append(
            f"{pad}%{v} = stablehlo.dot_general %arg{2 * i}, %{v - 1}, "
            f"contracting_dims = [1] x [0], precision = [DEFAULT, DEFAULT] "
            f": (tensor<{lhs}>, tensor<{rhs}>) -> tensor<{out}>")
        v += 1
        body.append(f"{pad}%{v} = stablehlo.add %{v - 1}, %{v - 1} : "
                    f"tensor<{out}>")
        v += 1
        body.append(
            f'{pad}%{v} = "stablehlo.all_reduce"(%{v - 1}) '
            f"<{{channel_handle = #stablehlo.channel_handle<handle = "
            f"{i + 1}, type = 1>, replica_groups = dense<[[{ids}]]> : "
            f"tensor<1x{groups}xi64>, use_global_device_ids}}> ({{\n"
            f"{pad}^bb0(%lhs{i}: tensor<bf16>, %rhs{i}: tensor<bf16>):\n"
            f"{pad}  %s{i} = stablehlo.add %lhs{i}, %rhs{i} : tensor<bf16>\n"
            f"{pad}  stablehlo.return %s{i} : tensor<bf16>\n"
            f"{pad}}}) : (tensor<{out}>) -> tensor<{out}>")
        v += 1
        body.append(f"{pad}%{v} = stablehlo.optimization_barrier "
                    f"%{v - 1} : tensor<{out}>")
        v += 1
    m, n, _ = shapes[-1]
    out = f"tensor<{m}x{n}xbf16>"
    if depth == 0:
        core = "\n".join(body) + f"\n    return %{v - 1} : {out}\n"
    else:
        m0, _, k0 = shapes[0]
        acc = f"tensor<{m0}x{k0}xbf16>"
        core = "\n".join(body)
        result = "%out"
        if steps is not None:
            indent = "      " if microbatches is not None else "    "
            carry = "%iterArg_mb_0" if microbatches is not None else "%arg0"
            core = _while_wrap(core, steps, carry, acc, indent, "")
        if microbatches is not None:
            core = _while_wrap(core, microbatches, "%arg0", acc, "    ",
                               "_mb")
            result = "%out_mb"
        core += f"\n    return {result}#1 : {acc}\n"
        out = acc
    return ("module @sharded_stack attributes "
            f"{{mhlo.num_partitions = {groups} : i32}} {{\n"
            f"  func.func public @main({', '.join(args)}) -> "
            f"{out} {{\n" + core + "  }\n}\n")


def serving_step_shapes(cfg, mode: str, batch: int,
                        seq: int) -> list[tuple[int, int, int]]:
    """The (m, n, k) GEMM shapes of one serving step of ``cfg``.

    First-order attention + MLP model of what ``serve/decode.py``
    executes, flattened so every term is a plain 2-D GEMM with the right
    total FLOPs and — critically for the decode regime — the right
    dominant memory traffic:

    * ``prefill``: the whole ``batch × seq`` prompt in one pass; the
      score/context GEMMs carry the O(seq²) attention term.
    * ``decode``: one new token per sequence against a ``seq``-deep KV
      cache.  The projection GEMMs have m = batch (weight-bound) and the
      attention GEMMs are flattened GEMVs whose operand footprint is the
      *full KV cache read* (m = batch·heads·seq, k = head_dim, n = 1),
      which is exactly what makes decode KV-cache-bound rather than
      compute-bound.

    Per layer: q/k/v projections, scores, context, output projection,
    MLP up + down; one LM head GEMM closes the step.  All layers share
    shapes, so the plan's regions collapse onto a handful of distinct
    fingerprints — a serving sweep is cache-friendly by construction.
    """
    d, h, hk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.head_dim or d // h
    ff, vocab = cfg.d_ff, cfg.vocab_size
    if mode == "prefill":
        t = batch * seq                       # prompt tokens in flight
        layer = [
            (t, h * hd, d), (t, hk * hd, d), (t, hk * hd, d),  # q, k, v
            (batch * h * seq, seq, hd),       # scores  QK^T (O(seq^2))
            (batch * h * seq, hd, seq),       # context scores·V
            (t, d, h * hd),                   # output projection
            (t, ff, d), (t, d, ff),           # MLP up, down
        ]
    else:
        layer = [
            (batch, h * hd, d), (batch, hk * hd, d), (batch, hk * hd, d),
            (batch * h * seq, 1, hd),         # scores: full K-cache read
            (batch * h * hd, 1, seq),         # context: full V-cache read
            (batch, d, h * hd),
            (batch, ff, d), (batch, d, ff),
        ]
    shapes = [s for _ in range(cfg.num_layers) for s in layer]
    shapes.append((batch, vocab, d))          # LM head (last position)
    return shapes


def _synthesize_serving(spec: WorkloadSpec) -> Workload:
    """A framework-free serving-step workload (``mode="prefill"``/``"decode"``)
    synthesized from the arch's registered :class:`ModelConfig` — the
    campaign-grid promotion of ``serve/decode.py``'s execution shape.
    Pure MLIR text via :func:`synthesize_gemm_stack`, so serving sweeps
    (and the what-if search built on them) run without a framework.
    The port has every id's config (``configs/``)."""
    import importlib

    mod_name = spec.arch.replace("-", "_").replace(".", "_")
    try:
        cfg = importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
    except ImportError:
        from ..models.registry import ARCH_IDS
        raise ValueError(
            f"workload {spec.name!r}: unknown arch {spec.arch!r} for "
            f"mode {spec.mode!r}; have {sorted(ARCH_IDS)}") from None
    if cfg.num_heads <= 0 or cfg.family == "ssm":
        raise ValueError(
            f"workload {spec.name!r}: mode {spec.mode!r} models an "
            f"attention KV cache; arch {spec.arch!r} ({cfg.family}) "
            "has none")
    shapes = serving_step_shapes(cfg, spec.mode, spec.batch, spec.seq)
    return Workload(
        name=spec.name,
        stablehlo_text=synthesize_gemm_stack(shapes),
        meta={"serving": {"arch": spec.arch, "mode": spec.mode,
                          "batch": spec.batch, "seq": spec.seq,
                          "num_layers": cfg.num_layers}})


def _export_from_arch(spec: WorkloadSpec, device=None) -> Workload:
    """Export a workload from a registered model config through the
    port's own export (see the module docstring).

    ``mode="forward"`` traces one forward pass; ``mode="train"`` a full
    train step (loss + gradients + optimizer update) with abstract
    optimizer state.  A ``resnet*`` arch is train-only (the fig7 workload
    family: :func:`repro_torch.models.resnet.resnet_train_exports` at
    ``spec.batch`` images of ``spec.img`` pixels).  With a mesh (``[data,
    model]`` or ``[pod, data, model]``) a workload also gets its optimized
    text: the per-rank train step or forward, traced in a fake world of the
    mesh's size (``launch/mesh.py::traced_mesh``), the counterpart of the
    reference's ``_mesh_for`` under forced host devices.  A ``model`` axis
    above 1 takes every id of the registry (the dense, MLA, MoE, SSM and
    hybrid families), and ResNet neither a ``model`` nor a ``pod`` axis.
    The traces run on fake tensors on ``device`` (None: the card): no
    device memory, no launch."""
    from ..launch.mesh import traced_mesh
    from ..train.optimizer import OptimizerConfig

    opt_cfg = OptimizerConfig(name=spec.optimizer)
    if spec.arch.startswith("resnet"):
        from ..models.resnet import resnet_arch_config, resnet_train_exports

        if spec.mode != "train":
            raise ValueError(
                f"workload {spec.name!r}: resnet export is train-only (the "
                f"fig7 workload family), not mode {spec.mode!r}; set "
                "mode='train'")
        cfg = resnet_arch_config(spec.arch)

        def exports(mesh=None):
            return resnet_train_exports(cfg, spec.batch, spec.img, mesh,
                                        opt_cfg=opt_cfg)
    else:
        from ..models.registry import get_config
        from ..train.loop import forward_exports, train_step_exports

        cfg = get_config(spec.arch).scaled(attn_impl="chunked")

        def exports(mesh=None):
            if spec.mode == "train":
                return train_step_exports(cfg, spec.seq, spec.batch, mesh,
                                          opt_cfg=opt_cfg)
            return forward_exports(cfg, spec.seq, spec.batch, mesh)
    step, abs_args = exports()
    if spec.mesh is None:
        return export_workload(step, *abs_args, name=spec.name,
                               device=device)
    with traced_mesh(spec.mesh, device) as mesh:
        w = export_workload(step, *abs_args, name=spec.name, device=device,
                            per_rank=(*exports(mesh), mesh))
    w.meta["mesh"] = list(spec.mesh)
    return w
