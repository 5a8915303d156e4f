"""Training loop: the train step and the fault-tolerant outer loop.

The counterpart of the JAX package's ``train/loop.py`` on one device.  The
step is eager PyTorch: the forward through the model's kernels (K1 and K2 on
the card), ``torch.autograd.grad`` through their backward kernels (K1b and
K2b), then the optimizer on dicts of tensors.  With a mesh (``[data,
model]`` or ``[pod, data, model]``) the step is one rank's program: the
rank's shards in, its data-axis collectives around the loss, the gradients
and the clip (``distributed/data_parallel.py``), and, on a ``model`` axis
above 1, the layers of every family split over the model ranks
(``distributed/tensor_parallel.py``).  :func:`train_step_exports` and
:func:`forward_exports` (each with or without a mesh) give the step and the
forward with abstract arguments for
:func:`repro_torch.core.pipeline.export_workload`.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..device import resolve_device
from ..distributed import tensor_parallel
from ..distributed.data_parallel import DataParallel
from ..models.params import (abstract_params, init_params, shard_params,
                             trainable)
from ..models.registry import input_specs
from ..models.transformer import forward, model_specs
from .checkpoint import CheckpointManager
from .data import DataConfig, ShardedLoader, SyntheticSource
from .fault_tolerance import StragglerDetector
from .optimizer import (OptimizerConfig, make_optimizer, opt_state_abstract,
                        tree_leaves, tree_map)


def quantize_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization (gradient compression)."""
    gf = g.to(torch.float32)
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                    gather=None):
    """The loss (detached) and its gradient tree, each gradient in its
    parameter's dtype.  With ``gather`` (a mesh's
    :meth:`DataParallel.gather`) ``params`` are the rank's shards, made
    whole inside the differentiated function."""
    leaves = trainable(params)
    loss, _ = forward(cfg, gather(leaves) if gather else leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatch: int = 0, gradient_compression: bool = False,
                    mesh=None, rules=None, donate: bool = False):
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``.  The
    inputs are not modified; the new parameters and state are new
    tensors.  With ``donate`` (AdamW or Adafactor, on one device) the new
    parameters and state are written into the given ones and returned, as
    the reference's ``jax.jit(step, donate_argnums=(0, 1))`` reuses their
    buffers: a step then holds one copy of them, which a model near a
    card's memory needs.

    With a ``mesh`` the step is one rank's program: it takes the rank's
    shards of the parameters and the optimizer state and its rows of the
    batch, gathers the parameters along their data dims, runs the model
    split over the model ranks, all-reduces the loss and reduce-scatters
    the gradients as means over the pod and data ranks, and updates its
    shards with the clip's norm taken over all of them
    (``distributed/data_parallel.py``).  A ``model`` axis above 1 takes
    every family (``distributed/tensor_parallel.py``); an MoE then runs the
    reference's expert-parallel dispatch on the rank's tokens, a Mamba2
    layer its block of the SSM heads."""
    _, update_fn = make_optimizer(opt_cfg)
    if donate:
        if mesh is not None:
            raise NotImplementedError(
                "a donated step runs on one device; a mesh's update returns "
                "new shards (ROADMAP, Queue 1 item 10: a donated step on a "
                "mesh)")
        update_fn = functools.partial(update_fn, donate=True)
    dp = tp = None
    if mesh is not None:
        tp = tensor_parallel.for_mesh(cfg, mesh)
        if opt_cfg.name != "adamw" or gradient_compression:
            raise NotImplementedError(
                "a mesh's step takes AdamW without gradient compression; "
                "sharded Adafactor (whose factored moments reduce over "
                "sharded dims) and compression over shards are not ported "
                "yet (ROADMAP, Queue 1 item 10: Adafactor and gradient "
                "compression on shards)")
        dp = DataParallel(model_specs(cfg), mesh, rules)

    def compute_grads(params, batch, gather=None):
        if microbatch and microbatch > 1:
            # gradient accumulation over microbatches, in f32 as the
            # reference's scan carries it
            micro = {k: x.reshape(microbatch, x.shape[0] // microbatch,
                                  *x.shape[1:]) for k, x in batch.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatch):
                loss, g = _value_and_grad(
                    cfg, params, {k: x[i] for k, x in micro.items()}, gather)
                g_sum = tree_map(lambda a, b: a + b.to(a.dtype), g_sum, g)
                loss_sum = loss_sum + loss
            inv = 1.0 / microbatch
            return loss_sum * inv, tree_map(lambda g: g * inv, g_sum)
        return _value_and_grad(cfg, params, batch, gather)

    def rank_step(shards, opt_state, batch):
        with tensor_parallel.active(tp):
            loss, grads = compute_grads(shards, batch, dp.gather)
        loss, grads = dp.mean(loss), dp.reduce_grads(grads)
        new_params, new_opt, metrics = update_fn(
            shards, grads, opt_state, opt_cfg, global_norm=dp.global_norm)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        if gradient_compression:
            # int8 round-trip: models quantized gradient exchange (the
            # network simulator scales the all-reduce payload to match)
            def rt(g):
                q, s = quantize_int8(g)
                return dequantize_int8(q, s, g.dtype)
            grads = tree_map(rt, grads)
        new_params, new_opt, metrics = update_fn(
            params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step if dp is None else rank_step


def make_forward(cfg: ModelConfig, mesh=None, rules=None):
    """``forward(params, batch) -> (loss, logits)``.  With a ``mesh`` it
    is one rank's program: the rank's shards gathered along their data
    dims, the model split over the model ranks, the loss a mean over the
    pod and data ranks; the logits are the rank's rows and, where the
    model axis divides the vocab, its vocab block."""
    if mesh is None:
        def step(params, batch):
            return forward(cfg, params, batch)
        return step
    tp = tensor_parallel.for_mesh(cfg, mesh)
    dp = DataParallel(model_specs(cfg), mesh, rules)

    def rank_forward(shards, batch):
        with tensor_parallel.active(tp):
            loss, logits = forward(cfg, dp.gather(shards), batch)
        return dp.mean(loss), logits
    return rank_forward


def train_step_exports(cfg: ModelConfig, seq: int, batch: int, mesh=None, *,
                       rules=None, opt_cfg: OptimizerConfig | None = None):
    """The full train step (loss, gradient and optimizer update) and meta
    tensors standing for its arguments (parameters, optimizer state and the
    token batch), ready for :func:`repro_torch.core.pipeline.export_workload`:
    the counterpart of the reference's ``train_step_exports``.  Returns
    ``(step, (params_abs, opt_abs, batch_abs))``; nothing is allocated.

    With a ``mesh`` the step is one rank's program (:func:`make_train_step`)
    and the meta tensors are the rank's shards and rows: the per-rank
    (optimized) program of the reference's sharded ``jit``.  ``batch`` is
    the global batch either way."""
    opt_cfg = opt_cfg or OptimizerConfig()
    specs = model_specs(cfg)
    shape = ShapeConfig("bench", seq, batch, "train")
    return make_train_step(cfg, opt_cfg, mesh=mesh, rules=rules), (
        abstract_params(specs, mesh, rules),
        opt_state_abstract(specs, opt_cfg.name, mesh, rules),
        input_specs(cfg, shape, mesh, rules))


def forward_exports(cfg: ModelConfig, seq: int, batch: int, mesh=None, *,
                    rules=None):
    """The forward pass ``(params, batch) -> (loss, logits)`` and meta
    tensors standing for its arguments: what the reference's campaign
    exports for ``mode="forward"``.  With a ``mesh`` the forward is one
    rank's program (:func:`make_forward`) and the meta tensors are the
    rank's shards and rows; ``batch`` is the global batch either way."""
    shape = ShapeConfig("bench", seq, batch, "train")
    return make_forward(cfg, mesh, rules), (
        abstract_params(model_specs(cfg), mesh, rules),
        input_specs(cfg, shape, mesh, rules))


@dataclass
class TrainResult:
    steps: int
    final_loss: float
    losses: list
    step_times: list
    restarts: int = 0


def train(run: RunConfig, *, device=None, mesh=None, rules=None,
          num_steps: int = 20, checkpoint_dir: str | None = None,
          checkpoint_every: int = 0, resume: bool = False,
          log_every: int = 10,
          inject_failure_at: int | None = None) -> TrainResult:
    """End-to-end training with checkpoint/restart and straggler tracking,
    on ``device`` (None: the card).

    With a ``mesh`` (over a real process group that the caller has
    initialised: gloo is tested, NCCL is untested) each rank holds its
    shards of the parameters and the optimizer state, takes its rows of
    each batch (:class:`ShardedLoader`) and runs the per-rank step on the
    mesh's device type; a ``device`` of another type raises.  Checkpoints
    of shards are not ported yet.

    ``inject_failure_at``: raise a simulated node failure at that step;
    the loop restores from the last committed checkpoint and continues."""
    if mesh is not None:
        if checkpoint_dir:
            raise NotImplementedError(
                "train: checkpoints of a mesh's shards are not ported yet "
                "(ROADMAP, Queue 1 item 10: checkpoints of shards)")
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(
                f"train: device {device!r} is not the mesh's device type "
                f"{mesh.device_type!r}")
        device = mesh.device_type
    device = resolve_device(device)
    cfg = run.model
    opt_cfg = OptimizerConfig(
        name=run.optimizer, learning_rate=run.learning_rate,
        weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    init_fn, _ = make_optimizer(opt_cfg)

    gen = torch.Generator(device=device).manual_seed(run.seed)
    specs = model_specs(cfg)
    params = init_params(specs, gen, device)
    if mesh is not None:
        params = shard_params(specs, params, mesh, rules)
    opt_state = init_fn(params, opt_cfg)

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run.shape.seq_len,
        global_batch=run.shape.global_batch, seed=run.seed,
        frontend=cfg.frontend, d_model=cfg.d_model)
    source = SyntheticSource(data_cfg)

    loader = (ShardedLoader(source, mesh, rules) if mesh is not None else
              ({k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in source))

    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    restarts = 0
    if ckpt and resume:
        state, data_state, step = ckpt.restore_latest(device)
        if step >= 0:
            params, opt_state = state["params"], state["opt"]
            if data_state:
                source.restore(data_state)
            start_step = step + 1

    step_fn = make_train_step(
        cfg, opt_cfg, microbatch=run.microbatch,
        gradient_compression=run.gradient_compression, mesh=mesh,
        rules=rules)

    detector = StragglerDetector()
    losses: list[float] = []
    times: list[float] = []
    step = start_step
    failure_armed = inject_failure_at is not None
    while step < num_steps:
        try:
            batch = next(loader)
            t0 = time.perf_counter()
            if failure_armed and step == inject_failure_at:
                failure_armed = False
                raise RuntimeError("injected node failure")
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0
            detector.observe(step, dt)
            losses.append(loss)
            times.append(dt)
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms", flush=True)
            if ckpt and checkpoint_every and step % checkpoint_every == 0 \
                    and step > 0:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          source.state())
            step += 1
        except RuntimeError as e:
            if "injected node failure" not in str(e) or ckpt is None:
                raise
            restarts += 1
            ckpt.wait()
            state, data_state, last = ckpt.restore_latest(device)
            if last < 0:
                raise RuntimeError("failure before first checkpoint") from e
            params, opt_state = state["params"], state["opt"]
            if data_state:
                source.restore(data_state)
            step = last + 1
            print(f"[fault-tolerance] restored step {last}, resuming",
                  flush=True)
    if ckpt:
        ckpt.wait()
    return TrainResult(steps=step - start_step,
                       final_loss=losses[-1] if losses else float("nan"),
                       losses=losses, step_times=times, restarts=restarts)
