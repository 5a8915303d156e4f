"""Training loop: the train step and the fault-tolerant outer loop.

The counterpart of the JAX package's ``train/loop.py`` on one device.  The
step is eager PyTorch: the forward through the model's kernels (K1 and K2 on
the card), ``torch.autograd.grad`` through their backward kernels (K1b and
K2b), then the optimizer on dicts of tensors.  :func:`train_step_exports`
and :func:`forward_exports` give the step and the forward with abstract
arguments for :func:`repro_torch.core.pipeline.export_workload`; a mesh
waits for the distribution slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..device import resolve_device
from ..models.params import abstract_params, init_params, trainable
from ..models.registry import input_specs
from ..models.transformer import forward, model_specs
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticSource
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


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """The loss (detached) and its gradient tree, each gradient in its
    parameter's dtype."""
    leaves = trainable(params)
    loss, _ = forward(cfg, leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatch: int = 0, gradient_compression: bool = False):
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``.  The
    inputs are not modified; the new parameters and state are new
    tensors."""
    _, update_fn = make_optimizer(opt_cfg)

    def compute_grads(params, batch):
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
                    cfg, params, {k: x[i] for k, x in micro.items()})
                g_sum = tree_map(lambda a, b: a + b.to(a.dtype), g_sum, g)
                loss_sum = loss_sum + loss
            inv = 1.0 / microbatch
            return loss_sum * inv, tree_map(lambda g: g * inv, g_sum)
        return _value_and_grad(cfg, params, batch)

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

    return train_step


def train_step_exports(cfg: ModelConfig, seq: int, batch: int, mesh=None, *,
                       rules=None, opt_cfg: OptimizerConfig | None = None):
    """The full train step (loss, gradient and optimizer update) and meta
    tensors standing for its arguments (parameters, optimizer state and the
    token batch), ready for :func:`repro_torch.core.pipeline.export_workload`:
    the counterpart of the reference's ``train_step_exports``.  Returns
    ``(step, (params_abs, opt_abs, batch_abs))``; nothing is allocated."""
    opt_cfg = opt_cfg or OptimizerConfig()
    specs = model_specs(cfg)
    shape = ShapeConfig("bench", seq, batch, "train")
    return make_train_step(cfg, opt_cfg), (
        abstract_params(specs, mesh, rules),
        opt_state_abstract(specs, opt_cfg.name, mesh, rules),
        input_specs(cfg, shape, mesh, rules))


def forward_exports(cfg: ModelConfig, seq: int, batch: int):
    """The forward pass ``(params, batch) -> (loss, logits)`` and meta
    tensors standing for its arguments: what the reference's campaign
    exports for ``mode="forward"``."""
    def step(params, batch):
        return forward(cfg, params, batch)

    shape = ShapeConfig("bench", seq, batch, "train")
    return step, (abstract_params(model_specs(cfg)), input_specs(cfg, shape))


@dataclass
class TrainResult:
    steps: int
    final_loss: float
    losses: list
    step_times: list
    restarts: int = 0


def train(run: RunConfig, *, device=None, num_steps: int = 20,
          checkpoint_dir: str | None = None, checkpoint_every: int = 0,
          resume: bool = False, log_every: int = 10,
          inject_failure_at: int | None = None) -> TrainResult:
    """End-to-end training with checkpoint/restart and straggler tracking,
    on ``device`` (None: the card).

    ``inject_failure_at``: raise a simulated node failure at that step;
    the loop restores from the last committed checkpoint and continues."""
    device = resolve_device(device)
    cfg = run.model
    opt_cfg = OptimizerConfig(
        name=run.optimizer, learning_rate=run.learning_rate,
        weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    init_fn, _ = make_optimizer(opt_cfg)

    gen = torch.Generator(device=device).manual_seed(run.seed)
    params = init_params(model_specs(cfg), gen, device)
    opt_state = init_fn(params, opt_cfg)

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run.shape.seq_len,
        global_batch=run.shape.global_batch, seed=run.seed,
        frontend=cfg.frontend, d_model=cfg.d_model)
    source = SyntheticSource(data_cfg)

    def to_device(batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

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
        gradient_compression=run.gradient_compression)

    detector = StragglerDetector()
    losses: list[float] = []
    times: list[float] = []
    step = start_step
    failure_armed = inject_failure_at is not None
    while step < num_steps:
        try:
            batch = to_device(next(source))
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
