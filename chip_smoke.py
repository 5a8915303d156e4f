#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
   for sm_90a, one ``nvcc`` per source, all started together, timed, with
   each kernel's ptxas register and spill line and any ptxas warning that
   it serialised an entry's ``wgmma`` instructions;
3. each kernel (K1 flash attention, with and without its log-sum-exp; K2
   RMSNorm; K1b and K2b, their backwards; K3 the whole SSD scan) against
   its plain PyTorch version at the serving and training paths' shapes and
   in the layout the path hands it, in bf16 and f32, with its time, its
   bound, the plain version's time and, where one exists, one PyTorch
   library call's time as a yardstick (the port never calls that library
   function); K2 also beside the time of one copy of its input, which the
   card's memory sets;
4. two serving paths at full width in bf16 with seeded random weights,
   llama3-1b (K1, K2) and mamba2-370m (K3, K2): ``prefill`` on 4 prompts of
   2048 tokens and ``greedy_decode`` on 8 prompts of 64 tokens (32 new
   tokens, max_len 128), with the kernels' launch counts set to 0 just
   before each path and read just after; then the first layer's attention
   or Mamba2 output is held against ``attn_impl="chunked"`` row by row, and
   the logits of prefill and of prefill-by-decode against
   ``attn_impl="chunked"`` and an f32 run of the same weights;
5. where the time goes, for each path: ``torch.profiler`` over one prefill
   and over 8 decode steps (device time by kernel, the device's busy
   share);
6. the training path: ``make_train_step`` on llama3-1b at full width
   (AdamW, 4 x 2048, K1, K1b, K2 and K2b), 2 warm-up steps and 6 counted
   ones on one repeated batch: each step's time, the median, tokens/s, model
   FLOP/s and its share of the bf16 peak, peak memory, the launches a step
   and a falling loss; then one profiled step;
7. a gradient gate (full width, 2 layers: bf16 gradients through the
   kernels reach every parameter and stay within twice the plain bf16
   path's distance from an f32 run), and the training CLI for 3 steps.

The last lines are one JSON object ``{"kernels": [...]}``, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k1_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    bwd_kernel_error as k1b_error, flash_attention_bwd_ref,
    flash_attention_fwd_ref, flash_attention_ref, kernel_error, lse_error)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    bwd_kernel_error as k2b_error, kernel_error as rmsnorm_error,
    rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    kernel_error as ssd_error, ssd_scan_ref)
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models.attention import gqa_forward  # noqa: E402
from repro_torch.models.common import embed_lookup, rms_norm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.ssm import mamba2_forward  # noqa: E402
from repro_torch.models.transformer import (TransformerLM, _embed,  # noqa: E402
                                            decode_step, init_cache_specs,
                                            model_specs, prefill)
from repro_torch.models.params import init_params, param_count  # noqa: E402
from repro_torch.train.checkpoint import _flatten as flatten  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticSource  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    _value_and_grad as value_and_grad, make_train_step)
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig, adamw_init, adamw_update)

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores (the kernels here use f32 FMAs for f32 data),
# and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# exponentials a second of the H100's special-function units (16 a cycle on
# each of 132 SMs at 1.83 GHz): the floor of a softmax with one exp a score
EXP_RATE = 3.9e12
# K1, K2 and K3 against their plain versions: the tolerances are in each
# kernel's ref.py
# one layer's bf16 attention (or Mamba2) output, K1 (K3) path against the
# plain path on the same inputs: largest row error norm over the row's norm.
# K1 rounds P to bf16 where the plain path does not (K3 its decayed scores),
# and the bf16 ops after it round differently in the two paths once their
# inputs differ: about 2^-9 of a row for K1, 2^-7 for K3 (skip term, gate,
# norm and out_proj).
LAYER_ROW_TOL = 2.0 ** -6
# bf16 logits of the serving path against the plain path and f32: see hold()
LOGIT_FACTOR = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, batches: int = 5, per_batch: int = 10) -> float:
    """Median over ``batches`` of the device time of ``per_batch`` calls,
    per call.  The calls queue behind a device sleep, so the events time the
    device and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

K1_CASES = [  # name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, q_offset
    ("prefill", 4, 32, 8, 2048, 2048, 64, True, 0, 0.0, 0),
    # the layout gqa_forward passes: [B, S, H, D] projections seen as
    # [B, H, S, D] through .transpose(1, 2)
    ("prefill_bshd", 4, 32, 8, 2048, 2048, 64, True, 0, 0.0, 0),
    ("ragged", 2, 32, 8, 1000, 1000, 64, True, 0, 0.0, 0),
    ("window", 1, 32, 8, 2048, 2048, 64, True, 256, 0.0, 0),
    ("cap_offset", 2, 8, 2, 100, 612, 64, True, 0, 30.0, 512),
    ("bidir_d32", 2, 4, 4, 300, 333, 32, False, 0, 0.0, 0),
    ("d128", 1, 8, 2, 256, 256, 128, True, 0, 0.0, 0),
    # d=128 (two swizzled column blocks) in the strided layout, ragged
    # across 128-row and 128-key tiles, Sq < Skv
    ("d128_bshd", 1, 8, 2, 1000, 1111, 128, True, 0, 0.0, 111),
]


def k1_inputs(gen, name, b, hq, hkv, sq, skv, d, dtype):
    def randn(h, s):
        if name.endswith("_bshd"):
            return torch.randn(b, s, h, d, generator=gen, device="cuda"
                               ).to(dtype).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
    return randn(hq, sq), randn(hkv, skv), randn(hkv, skv)


def k1_visible_pairs(sq, skv, causal, window, q_offset) -> int:
    diff = (torch.arange(sq, device="cuda")[:, None] + q_offset
            - torch.arange(skv, device="cuda")[None, :])
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return int(mask.sum())


def check_k1(gen) -> dict:
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, sq, skv, d, causal, window, cap, off in K1_CASES:
            q, k, v = k1_inputs(gen, name, b, hq, hkv, sq, skv, d, dtype)
            kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off)
            out = flash_attention(q, k, v, **kw)
            # the same launch writing each row's log-sum-exp, as the
            # training path asks for it: the output must not move a bit
            out_lse, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
            torch.cuda.synchronize()
            err, elem, row = kernel_error(out, q, k, v, **kw)
            lse_err, lse_ratio = lse_error(lse, q, k, v, **kw)
            same = torch.equal(out, out_lse)
            ok = all(math.isfinite(x) for x in (err, elem, row)) and max(
                elem, row, lse_ratio) <= 1.0 and same
            log(f"  K1 {name:<12} {str(dtype)[6:]:<8} B={b} Hq={hq} Hkv={hkv} "
                f"Sq={sq} Skv={skv} d={d} max_abs_err={err:.3e}; in units of "
                f"the tolerance: element {elem:.3f}, row {row:.3f}; lse "
                f"{lse_err:.3e} ({lse_ratio:.3f} of LSE_ATOL), output with "
                f"lse {'identical' if same else 'DIFFERENT'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} {dtype}: max abs err {err}, "
                                     f"element {elem}, row {row} of tol, lse "
                                     f"{lse_ratio} of tol, same {same}")
            if name != "prefill":
                continue
            # null lse: the serving path's launch
            ms = device_ms(lambda: flash_attention(q, k, v, **kw))
            lse_ms = device_ms(lambda: k1_ops._forward(q, k, v, with_lse=True,
                                                       **kw))
            plain_ms = device_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                 batches=3, per_batch=2)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            scores = k1_visible_pairs(sq, skv, causal, window, off) * b * hq
            flops = 4 * d * scores
            nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K1 prefill {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
                f"exponential floor {scores / EXP_RATE * 1e3:.4f} ms "
                f"({scores / 1e6:.1f} M visible scores); writing lse "
                f"{lse_ms:.4f} ms")
            if dtype == torch.bfloat16:
                entry = {"name": "flash_attention", "route": "cuda",
                         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
    return entry


K2_CASES = [  # name, rows, d, offset
    ("prefill", 8192, 2048, 0.0),
    ("decode", 8, 2048, 0.0),
    ("mamba_ln", 8192, 1024, 0.0),   # mamba2-370m's ln and final_norm
    ("scalar_path", 37, 1001, 1.0),
]


def check_k2(gen) -> dict:
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, d, offset in K2_CASES:
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
                 ).to(dtype)
            out = rmsnorm(x, w, 1e-5, offset)
            torch.cuda.synchronize()
            err, elem = rmsnorm_error(out, x, w, 1e-5, offset)
            ok = math.isfinite(elem) and elem <= 1.0
            log(f"  K2 {name:<11} {str(dtype)[6:]:<8} {rows}x{d} "
                f"max_abs_err={err:.3e}; in units of the tolerance: element "
                f"{elem:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 {name} {dtype}: max abs err {err}, "
                                     f"element {elem} of tol")
            if name == "scalar_path":
                continue
            ms = device_ms(lambda: rmsnorm(x, w, 1e-5))
            plain_ms = device_ms(lambda: rmsnorm_ref(x, w, 1e-5))
            lib_ms = device_ms(lambda: F.rms_norm(x, (d,), w, 1e-5))
            # what the card moves in practice: one copy of the same bytes
            copy = torch.empty_like(x)
            copy_ms = device_ms(lambda: copy.copy_(x))
            flops = 4 * x.numel()
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K2 {name} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.2f} MB), a "
                f"copy of x {copy_ms:.4f} ms")
            if dtype == torch.bfloat16 and name == "prefill":
                entry = {"name": "rmsnorm", "route": "cuda",
                         "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                         "replaces": "src/repro/kernels/rmsnorm/kernel.py:23",
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
    return entry


K1B_CASES = [  # name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, q_offset
    # llama3-1b's training step: one card's share of fig6's 4 x 2048 cell
    ("train", 4, 32, 8, 2048, 2048, 64, True, 0, 0.0, 0),
    # the strided [B, S, H, D] layout gqa_forward passes, and its dO
    ("train_bshd", 2, 32, 8, 1024, 1024, 64, True, 0, 0.0, 0),
    ("window", 1, 8, 2, 700, 700, 64, True, 100, 0.0, 0),
    # a strong cap: its derivative 1 - tanh^2 is far from 1
    ("cap1", 2, 8, 2, 300, 300, 64, True, 0, 1.0, 0),
    ("ragged_offset", 1, 8, 2, 1000, 1111, 64, True, 0, 0.0, 111),
    ("bidir_d32", 2, 4, 4, 300, 333, 32, False, 0, 0.0, 0),
    ("d128_group8", 1, 8, 1, 520, 520, 128, True, 0, 0.0, 0),
    # q_offset past the window: no query sees a key (lse = -inf)
    ("no_visible_key", 1, 4, 2, 64, 64, 64, True, 8, 0.0, 100),
]


def check_k1b(gen) -> dict:
    """K1b against the plain backward in double, on K1's lse and the plain
    forward's output.  Times at ``train``: the kernel, the plain backward
    (f32), and SDPA's backward as the yardstick."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, sq, skv, d, causal, window, cap, off in \
                K1B_CASES:
            kw = dict(causal=causal, window=window, logit_cap=cap,
                      q_offset=off)
            layout = "x_bshd" if name.endswith("_bshd") else "x"
            q, k, v = k1_inputs(gen, layout, b, hq, hkv, sq, skv, d, dtype)
            do, _, _ = k1_inputs(gen, layout, b, hq, hkv, sq, skv, d, dtype)
            o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
            grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            errs = k1b_error(grads, q, k, v, o, lse, do, **kw)
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            worst = max(max(e[1], e[2]) for e in errs)
            ok = finite and math.isfinite(worst) and worst <= 1.0
            log(f"  K1b {name:<14} {str(dtype)[6:]:<8} B={b} Hq={hq} "
                f"Hkv={hkv} Sq={sq} Skv={skv} d={d}; max_abs_err, element "
                f"and row in units of the tolerance: " + "; ".join(
                    f"d{n} {e[0]:.3e} {e[1]:.3f} {e[2]:.3f}"
                    for n, e in zip("qkv", errs))
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1b {name} {dtype}: {errs}, finite "
                                     f"{finite}")
            if name != "train":
                continue
            ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw))
            plain_ms = device_ms(lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw), batches=3, per_batch=2)
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                  enable_gqa=True)
            lib_ms = device_ms(lambda: torch.autograd.grad(
                sdpa, (lq, lk, lv), do, retain_graph=True))
            del sdpa, lq, lk, lv
            pairs = k1_visible_pairs(sq, skv, causal, window, off) * b * hq
            # S and dP, recomputed, then dV, dK and dQ: 2 d flops a pair each
            flops = 5 * 2 * d * pairs
            nbytes = sum(t.numel() * t.element_size()
                         for t in (q, k, v, o, do, lse, *grads))
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K1b train {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"SDPA backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
                f"MB)")
            if dtype == torch.bfloat16:
                entry = {"name": "flash_attention_bwd", "route": "cuda",
                         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
                         "replaces": "none on the TPU (jax.grad of src/repro/kernels/flash_attention/ref.py:12)",
                         "launches": None, "max_abs_err": max(
                             e[0] for e in errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, o, lse, do, grads
            torch.cuda.empty_cache()
    return entry


K2B_CASES = [  # name, rows, d, offset
    ("train", 8192, 2048, 0.0),      # llama3-1b's norms at 4 x 2048
    ("mamba_ln", 8192, 1024, 0.0),
    ("decode", 8, 2048, 0.0),
    ("scalar_path", 37, 1001, 1.0),
    ("wide", 8, 4096, 0.0),          # llama2-7b's width: the block kernel
]
K2B_TIMED = ("train", "mamba_ln", "decode")


def check_k2b(gen) -> dict:
    """K2b against the plain backward in double; times for the cases in
    K2B_TIMED, with the backward of ``F.rms_norm`` as the yardstick."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, d, offset in K2B_CASES:
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
                 ).to(dtype)
            dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            dx, dw = rmsnorm_bwd(x, w, dy, 1e-5, offset)
            torch.cuda.synchronize()
            ex, rx, rrow, ew, rw = k2b_error(dx, dw, x, w, dy, 1e-5, offset)
            ok = all(math.isfinite(r) for r in (rx, rrow, rw)) and max(
                rx, rrow, rw) <= 1
            log(f"  K2b {name:<11} {str(dtype)[6:]:<8} {rows}x{d} dx "
                f"max_abs_err={ex:.3e} (element {rx:.3f}, row {rrow:.3f} of "
                f"the tolerances), dw {ew:.3e} ({rw:.3f}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2b {name} {dtype}: dx {ex} ({rx}, "
                                     f"{rrow} of tol), dw {ew} ({rw} of tol)")
            if name not in K2B_TIMED:
                continue
            ms = device_ms(lambda: rmsnorm_bwd(x, w, dy, 1e-5))
            plain_ms = device_ms(lambda: rmsnorm_bwd_ref(x, w, dy, 1e-5))
            lx, lw = (t.detach().requires_grad_(True) for t in (x, w))
            y = F.rms_norm(lx, (d,), lw, 1e-5)
            lib_ms = device_ms(lambda: torch.autograd.grad(
                y, (lx, lw), dy, retain_graph=True))
            flops = 8 * x.numel()
            nbytes = (3 * x.numel() * x.element_size()
                      + 2 * w.numel() * w.element_size())
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K2b {name} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, F.rms_norm backward {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}; "
                f"{nbytes / 1e6:.2f} MB)")
            if dtype == torch.bfloat16 and name == "train":
                entry = {"name": "rmsnorm_bwd", "route": "cuda",
                         "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
                         "replaces": "none on the TPU (jax.grad of src/repro/models/common.py:11)",
                         "launches": None, "max_abs_err": max(ex, ew),
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms}
    return entry


K3_CASES = [  # name, B, S, H, P, G, N, chunk, strided, initial state, decay
    ("prefill", 4, 2048, 32, 64, 1, 128, 256, False, False, "mamba"),
    # the layout mamba2_forward passes: x, B and C as column slices of the
    # conv output [B, S, H*P + 2*G*N] (row stride 2304)
    ("prefill_strided", 4, 2048, 32, 64, 1, 128, 256, True, False, "mamba"),
    ("groups2", 1, 256, 8, 64, 2, 32, 64, True, False, "mamba"),
    ("init_state", 2, 1024, 32, 64, 1, 128, 256, True, True, "mamba"),
    # dt ~ 5 and a = -16: dacs reaches about -20 000 in a chunk
    ("strong_decay", 2, 1024, 32, 64, 1, 128, 256, True, False, "strong"),
    # 64 chunks of recurrence on 32 blocks: the card under-filled
    ("long_init", 1, 16384, 32, 64, 1, 128, 256, True, True, "mamba"),
]
# the cases K3 is timed on (bf16; f32 at prefill only)
K3_TIMED = ("prefill", "long_init")


def k3_inputs(gen, b, s, h, p, g, n, chunk, strided, init, decay, dtype):
    """x, dt, a, B, C and the initial state of one case.  Strided cases
    slice one buffer with a spare batch row, so a kernel that reads past
    its group stays inside the allocation (as the mutants in PERF.md do)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    if strided:
        xbc = randn(b + 1, s, h * p + 2 * g * n).to(dtype)[:b]
        x, bm, cm = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        x = x.reshape(b, s, h, p)
        bm, cm = bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
    else:
        x = randn(b, s, h, p).to(dtype)
        bm, cm = randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)
    if decay == "strong":
        dt = 5.0 + 0.1 * randn(b, s, h)
        a = torch.full((h,), -16.0, device="cuda")
    else:
        dt = F.softplus(randn(b, s, h))
        a = -torch.exp(0.5 * randn(h))
    st0 = randn(b, h, p, n) if init else None
    return x, dt, a, bm, cm, st0


def k3_work(b, s, h, p, n, chunk) -> tuple[int, int]:
    """The scan's flops and exponentials: per (batch, head, chunk) the
    visible pairs of C B^T and P x, 2 pairs (N + P), the inbound state's
    term, 2 L N P, and the local state, 2 L P N; one exponential a pair."""
    pairs = chunk * (chunk + 1) // 2
    blocks = b * h * (s // chunk)
    return blocks * (2 * pairs * (n + p) + 4 * chunk * n * p), blocks * pairs


def check_k3(gen, names=None) -> dict:
    """K3, the whole scan, against its plain version on the cases named
    (all by default): y and the final state."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, h, p, g, n, chunk, strided, init, decay in K3_CASES:
            if names is not None and name not in names:
                continue
            x, dt, a, bm, cm, st0 = k3_inputs(gen, b, s, h, p, g, n, chunk,
                                              strided, init, decay, dtype)
            args = (x, dt, a, bm, cm)
            y, final = ssd_scan(*args, chunk=chunk, initial_state=st0)
            torch.cuda.synchronize()
            err, elem, row = ssd_error(y, final, *args, chunk, st0)
            ok = all(math.isfinite(v) for v in (err, elem, row)) and max(
                elem, row) <= 1.0
            min_dacs = (dt * a).reshape(b, s // chunk, chunk,
                                        h).cumsum(2).min()
            log(f"  K3 {name:<15} {str(dtype)[6:]:<8} B={b} S={s} H={h} "
                f"P={p} G={g} N={n} L={chunk} min dacs "
                f"{min_dacs.item():.0f} max_abs_err={err:.3e}; in units "
                f"of the tolerance: element {elem:.3f}, row {row:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 {name} {dtype}: max abs err {err}, "
                                     f"element {elem}, row {row} of tol")
            if name not in K3_TIMED or (dtype == torch.float32
                                        and name != "prefill"):
                continue
            kw = dict(chunk=chunk, initial_state=st0)
            ms = device_ms(lambda: ssd_scan(*args, **kw))
            plain_ms = device_ms(lambda: ssd_scan_ref(*args, **kw),
                                 batches=3, per_batch=2)
            flops, exps = k3_work(b, s, h, p, n, chunk)
            nbytes = sum(t.numel() * t.element_size() for t in (
                *args, y, final, *([] if st0 is None else [st0])))
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K3 {name} {str(dtype)[6:]}: kernel (the whole scan) "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, no library call; "
                f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} "
                f"GFLOP at {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{nbytes / 1e6:.2f} MB at {nbytes / ms / 1e6:.1f} GB/s); "
                f"exponential floor {exps / EXP_RATE * 1e3:.4f} ms "
                f"({exps / 1e6:.1f} M pairs)")
            if dtype == torch.bfloat16 and name == "prefill":
                entry = {"name": "ssd_scan", "route": "cuda",
                         "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                         "replaces": "src/repro/kernels/ssd_scan/kernel.py:60",
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
    return entry


# --------------------------------------------------------------------------
# phase 4: the serving paths at full width
# --------------------------------------------------------------------------

def max_rel_diff(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (a.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


COUNTERS = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "ssd_scan": ssd_scan, "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm_bwd": rmsnorm_bwd}


def serve(arch: str, gen) -> dict:
    """One serving path at full width: prefill and greedy decode with the
    launch counts read around them, then the checks and the profile.  The
    attention family runs K1 once a layer in prefill, the SSM family K3;
    both run K2 twice a layer and once at the end, in prefill and in each
    decode step."""
    cfg = get_config(arch)
    assert cfg.attn_impl == "kernel" and cfg.dtype == "bfloat16"
    model = TransformerLM(cfg, generator=gen)   # device None: the card
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e6:.1f} M parameters in {cfg.dtype}")
    v = cfg.vocab_size
    prompts = torch.randint(0, v, (4, 2048), generator=gen, device="cuda",
                            dtype=torch.int32)
    dprompts = torch.randint(0, v, (8, 64), generator=gen, device="cuda",
                             dtype=torch.int32)
    with torch.inference_mode():
        model.prefill({"tokens": prompts})   # warm-up: cuBLAS, caches
        torch.cuda.synchronize()

        # ---- the main path: counts at 0 just before, read just after ----
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = model.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        in_prefill = {k: fn.launches for k, fn in COUNTERS.items()}
        t0 = time.perf_counter()
        res = model.generate(dprompts, max_new_tokens=32, max_len=128)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in COUNTERS.items()}
        # ---- end of the main path ----

    steps = dprompts.shape[1] + 32
    per_norms = 2 * cfg.num_layers + 1
    mixer = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    expected = {k: 0 for k in COUNTERS}
    expected.update({mixer: cfg.num_layers, "rmsnorm": per_norms})
    log(f"  prefill 4x2048: {prefill_s * 1e3:.2f} ms, "
        f"{4 * 2048 / prefill_s:.0f} tokens/s; greedy_decode 8x(64+32): "
        f"{decode_s * 1e3:.2f} ms, {decode_s / steps * 1e3:.3f} ms/step")
    log(f"  launches: prefill {in_prefill}; whole run {launches}")
    if in_prefill != expected:
        raise AssertionError(f"prefill launches {in_prefill}, expected "
                             f"{expected}")
    expected["rmsnorm"] *= 1 + steps
    if launches != expected:
        raise AssertionError(f"main-path launches {launches}, expected "
                             f"{expected} ({per_norms} K2 and nothing else "
                             "per decode step)")
    if logits.shape != (4, v) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    toks = res.tokens
    if (toks.shape != (8, 32) or toks.dtype != torch.int32
            or int(toks.min()) < 0 or int(toks.max()) >= v):
        raise AssertionError(f"greedy tokens {tuple(toks.shape)} "
                             f"{toks.dtype} out of shape or range")

    with torch.inference_mode():
        check_logits(cfg, model.params, logits, prompts, dprompts)
        where_the_time_goes(model, prompts, dprompts)
    return launches


def check_logits(cfg, params, logits, prompts, dprompts) -> None:
    """Hold the kernel path's bf16 logits, and prefill-by-decode's, against
    the plain chunked path on the same weights and against an f32 run of
    those weights (see ``hold``)."""
    chunked = cfg.scaled(attn_impl="chunked")
    cfg32 = cfg.scaled(attn_impl="chunked", dtype="float32")
    params32 = tree_map(params, lambda t: t.float())
    if cfg.family == "ssm":
        check_ssm_layer(cfg, chunked, params, prompts)
    else:
        check_layer(cfg, chunked, params, prompts)
    kernel = "K3" if cfg.family == "ssm" else "K1"
    ref32 = prefill(cfg32, params32, {"tokens": prompts})
    hold(f"prefill 4x2048 ({kernel} path)", logits,
         prefill(chunked, params, {"tokens": prompts}), ref32)
    dl = decode_logits(cfg, params, dprompts)
    dref32 = prefill(cfg32, params32, {"tokens": dprompts})
    hold("prefill-by-decode 8x64", dl,
         prefill(chunked, params, {"tokens": dprompts}), dref32)
    if cfg.family == "ssm":
        # in bf16 the SSM paths end far apart (see PERF.md); their f32
        # distances are measured, not held: the plain path takes its
        # intra-chunk decays from a cumsum of its own, and the recurrent
        # decode without cumsums, where an f32 ulp of dacs (~6e4) is 0.4%
        k32 = cfg.scaled(dtype="float32")
        for name, x, ref in (
                ("prefill 4x2048, f32, K3 path against the plain path",
                 prefill(k32, params32, {"tokens": prompts}), ref32),
                ("prefill-by-decode 8x64, f32, against prefill",
                 decode_logits(k32, params32, dprompts), dref32)):
            log(f"  {name}: max |diff| / max |logit| "
                f"{max_rel_diff(x, ref)[1]:.3e} (measured, not held)")


def decode_logits(cfg, params, prompts):
    """The last prompt token's logits from feeding the prompt token by
    token through ``decode_step``."""
    cache = init_params(init_cache_specs(cfg, prompts.shape[0],
                                         prompts.shape[1]),
                        torch.Generator(device="cuda"), "cuda")
    for i in range(prompts.shape[1]):
        logits, cache = decode_step(cfg, params, cache,
                                    {"tokens": prompts[:, i:i + 1]})
    return logits


def check_layer(cfg, chunked, params, prompts) -> None:
    """The first layer's attention output (``gqa_forward``, which hands K1
    transposed views of its projections) from the K1 path against the plain
    chunked path on the same bf16 inputs, held row by row."""
    attn = {k: t[0] for k, t in params["layers"]["attn"].items()}
    x = rms_norm(embed_lookup(prompts, params["embed"]),
                 params["layers"]["ln1"][0], cfg.rms_eps)
    pos = torch.arange(prompts.shape[1], dtype=torch.int32,
                       device=prompts.device).expand(prompts.shape)
    out = gqa_forward(cfg, attn, x, pos).float()
    plain = gqa_forward(chunked, attn, x, pos).float()
    row = ((out - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
    log(f"  layer 0 attention output 4x2048, K1 path against the plain "
        f"path: largest row error {row:.3e} of the row's norm "
        f"(tol {LAYER_ROW_TOL:g})")
    if not row <= LAYER_ROW_TOL:
        raise AssertionError(f"layer 0 attention: row error {row}")


def check_ssm_layer(cfg, chunked, params, prompts) -> None:
    """The first layer's Mamba2 output (``mamba2_forward``, which hands K3
    column slices of its conv output) from the K3 path against the plain
    chunked path on the same bf16 inputs, held row by row."""
    lp = {k: t[0] for k, t in params["layers"]["ssm"].items()}
    x = rms_norm(_embed(cfg, params, {"tokens": prompts}),
                 params["layers"]["ln"][0], cfg.rms_eps)
    out = mamba2_forward(cfg, lp, x)[0].float()
    plain = mamba2_forward(chunked, lp, x)[0].float()
    row = ((out - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
    log(f"  layer 0 Mamba2 output 4x2048, K3 path against the plain path: "
        f"largest row error {row:.3e} of the row's norm "
        f"(tol {LAYER_ROW_TOL:g})")
    if not row <= LAYER_ROW_TOL:
        raise AssertionError(f"layer 0 Mamba2: row error {row}")


def hold(name: str, x, plain, ref32) -> None:
    """bf16 logits ``x`` must be within LOGIT_FACTOR times the plain bf16
    path's own distance from f32 (``ref32``) both from f32 and from the
    plain path.  A fixed tolerance would not do: with random weights, bf16
    rounding compounds over the layers (16 of llama3-1b) to a distance from
    f32 of the order of 20% of the largest logit."""
    _, base = max_rel_diff(plain, ref32)
    _, to_f32 = max_rel_diff(x, ref32)
    _, to_plain = max_rel_diff(x, plain)
    agree = (x.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"  {name}: max |diff| / max |logit|: to f32 {to_f32:.3e}, to the "
        f"plain bf16 path {to_plain:.3e}; plain bf16 to f32 {base:.3e} "
        f"(tol {LOGIT_FACTOR:g}x that); argmax agrees with plain {agree:.2f}")
    if not (to_f32 <= LOGIT_FACTOR * base and to_plain <= LOGIT_FACTOR * base):
        raise AssertionError(f"{name}: logits off the plain path")


def tree_map(tree: dict, fn) -> dict:
    return {k: tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# phase 6: training llama3-1b at full width
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 2048
# the train step's device time by group of kernels (torch.profiler names)
TRAIN_GROUPS = {
    "K1b": ["bwd_dkdv", "bwd_dq", "bwd_delta"],
    "K1": ["flash_fwd"],
    "K2b": ["rmsnorm_bwd"],
    "K2": ["rmsnorm_rows", "rmsnorm_kernel"],
    "f32 GEMMs (head)": ["gemm_f32f32", "sgemm"],
    "bf16 GEMMs": ["nvjet", "gemm"],
}
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# the gradient gate's model: full width, 2 layers
GATE_LAYERS, GATE_B = 2, 2


def train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """Model FLOPs of one train step: 6 N per token for the matrix
    products (N: every parameter but the embedding table, which is a
    lookup), plus attention's S and PV products over the causal pairs,
    forward (4 d a pair and head) and backward (twice that)."""
    pairs = s * (s + 1) // 2
    attn = 3 * 4 * cfg.resolved_head_dim * pairs * cfg.num_heads * b
    return 6 * n_params * b * s + cfg.num_layers * attn


def timed(fn) -> float:
    """Seconds of one synchronised call of ``fn``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def train_llama(gen) -> dict:
    """The training path: ``make_train_step`` on llama3-1b (remat none,
    AdamW, bf16 parameters, f32 moments) for TRAIN_WARMUP + TRAIN_STEPS
    steps on one repeated 4 x 2048 batch, with the launch counts set to 0
    after the warm-up and read after the last step; then one profiled
    step."""
    cfg = get_config("llama3-1b")
    assert cfg.attn_impl == "kernel" and cfg.remat == "none"
    specs = model_specs(cfg)
    params = init_params(specs, gen, "cuda")
    # the reference's AdamW with its warm-up cut to one step, so that six
    # steps move the loss
    opt_cfg = OptimizerConfig(warmup_steps=1)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    batch = {k: torch.from_numpy(x).cuda() for k, x in next(SyntheticSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                   global_batch=TRAIN_B, seed=0))).items()}
    n_params = param_count(specs)
    n_matmul = n_params - cfg.vocab_size * cfg.d_model
    log(f"  llama3-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e6:.1f} M parameters ({cfg.dtype}), AdamW with f32 "
        f"moments, batch {TRAIN_B}x{TRAIN_S}")
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path: counts at 0 just before, read after ----
            for fn in COUNTERS.values():
                fn.launches = 0
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss {loss:.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.3f}, {times[-1] * 1e3:.2f} ms")
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    expected = {k: 0 for k in COUNTERS}
    expected.update(flash_attention=cfg.num_layers,
                    flash_attention_bwd=cfg.num_layers,
                    rmsnorm=2 * cfg.num_layers + 1,
                    rmsnorm_bwd=2 * cfg.num_layers + 1)
    step_s = statistics.median(times[TRAIN_WARMUP:])
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, n_matmul, TRAIN_B, TRAIN_S)
    log(f"  train step 4x2048: median {step_s * 1e3:.2f} ms over steps "
        f"{TRAIN_WARMUP}..{TRAIN_WARMUP + TRAIN_STEPS - 1}, "
        f"{tokens / step_s:.0f} tokens/s, {flops / step_s / 1e12:.1f} "
        f"TFLOP/s of model FLOPs ({flops / 1e12:.2f} TFLOP a step), mfu "
        f"{flops / step_s / PEAK_FLOPS[torch.bfloat16]:.3f}, peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches a step: {per_step} (K1b runs its 3 kernels a launch, "
        f"K2b its 2)")
    if per_step != expected:
        raise AssertionError(f"train launches a step {per_step}, expected "
                             f"{expected}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"train losses {losses}: not finite, or not "
                             "falling on a repeated batch")
    # the step's two halves, each the median of 3 synchronised runs
    loss_grads = value_and_grad(cfg, params, batch)
    fwd_bwd_ms = 1e3 * statistics.median(
        timed(lambda: value_and_grad(cfg, params, batch)) for _ in range(3))
    opt_ms = 1e3 * statistics.median(
        timed(lambda: adamw_update(params, loss_grads[1], opt_state,
                                   opt_cfg)) for _ in range(3))
    del loss_grads
    log(f"  of a step: forward and backward {fwd_bwd_ms:.2f} ms, AdamW "
        f"(clip included) {opt_ms:.2f} ms")
    profile_window("train step 4x2048",
                   lambda: float(step_fn(params, opt_state, batch)[2]["loss"]),
                   top=20, groups=TRAIN_GROUPS)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_norms():
    """The models' RMSNorm through its plain version (autograd
    differentiates it) instead of K2/K2b, for the gate's reference runs
    only."""
    saved = model_common.rmsnorm
    model_common.rmsnorm = rmsnorm_ref
    try:
        yield
    finally:
        model_common.rmsnorm = saved


def gradient_gate(gen) -> None:
    """llama3-1b at full width cut to GATE_LAYERS layers: bf16 gradients
    through the kernels (K1, K1b, K2, K2b) must reach every parameter, and
    each parameter's distance from an f32 plain run must be within
    LOGIT_FACTOR times the bf16 plain path's distance from it."""
    cfg = get_config("llama3-1b").scaled(num_layers=GATE_LAYERS)
    params = init_params(model_specs(cfg), gen, "cuda")
    batch = {k: torch.from_numpy(x).cuda() for k, x in next(SyntheticSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                   global_batch=GATE_B, seed=1))).items()}
    grads_k = value_and_grad(cfg, params, batch)[1]
    plain = cfg.scaled(attn_impl="chunked")
    with plain_norms():
        grads_p = value_and_grad(plain, params, batch)[1]
        grads_32 = value_and_grad(plain.scaled(dtype="float32"),
                                  tree_map(params, lambda t: t.float()),
                                  batch)[1]
    flat_k, flat_p, flat_32 = (flatten(g) for g in
                               (grads_k, grads_p, grads_32))
    worst = 0.0
    for name, g32 in flat_32.items():
        gk, gp = flat_k[name].float(), flat_p[name].float()
        if not (torch.isfinite(gk).all() and gk.abs().max() > 0):
            raise AssertionError(f"gradient gate: {name} got no gradient "
                                 "through the kernels")
        dk = ((gk - g32).norm() / g32.norm()).item()
        dp = ((gp - g32).norm() / g32.norm()).item()
        worst = max(worst, dk / dp)
        log(f"    {name:<28} |g| {g32.norm().item():.3e}; to f32: kernels "
            f"{dk:.3e}, plain bf16 {dp:.3e} ({dk / dp:.2f}x)")
        if not dk <= LOGIT_FACTOR * dp:
            raise AssertionError(f"gradient gate: {name} kernels {dk} > "
                                 f"{LOGIT_FACTOR} x plain {dp}")
    log(f"  gradient gate ({GATE_LAYERS} layers, {GATE_B}x{TRAIN_S}): "
        f"every parameter has a gradient through the kernels; largest "
        f"kernel/plain distance ratio {worst:.2f} (tol {LOGIT_FACTOR:g})")


def train_cli() -> None:
    """The training CLI as a user runs it: 3 steps of llama3-1b at 4 x 2048
    on the card, in a process of its own (the kernels' library is built)."""
    torch.cuda.empty_cache()   # give the child the memory this one caches
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3-1b", "--steps", "3", "--seq", str(TRAIN_S), "--batch",
           str(TRAIN_B)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    out = proc.stdout.strip().splitlines()
    for line in out:
        log(f"    {line}")
    if proc.returncode != 0 or not out or not out[-1].startswith(
            "finished 3 steps") or not math.isfinite(
                float(out[-1].split()[-1])):
        raise AssertionError(f"train CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    log(f"  {' '.join(cmd[1:])}: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler)
# --------------------------------------------------------------------------

def where_the_time_goes(model, prompts, dprompts) -> None:
    """Device time by kernel and the device's busy share over one prefill
    and over 8 decode steps, from ``torch.profiler``."""
    cfg = model.cfg
    cache = init_params(init_cache_specs(cfg, 8, 128),
                        torch.Generator(device="cuda"), "cuda")
    windows = {
        "prefill 4x2048": lambda: model.prefill({"tokens": prompts}),
        "8 decode steps, B=8": lambda: [
            model.decode_step(cache, {"tokens": dprompts[:, i:i + 1]})
            for i in range(8)],
    }
    for name, fn in windows.items():
        profile_window(name, fn)


def profile_window(name: str, fn, top: int = 10, groups=None) -> None:
    """Device time by kernel (the ``top`` kernels) and the device's busy
    share over one call of ``fn``, from ``torch.profiler``; with ``groups``
    ({label: substrings of kernel names}) also the device time of each
    group, the first matching label taking a kernel, the rest as
    "other"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log(f"  {name}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler saw no device activity)")
        return
    log(f"  {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5} {e.key[:80]}")
    if groups:
        sums = dict.fromkeys([*groups, "other"], 0.0)
        for e in kernels:
            label = next((g for g, keys in groups.items()
                          if any(k in e.key for k in keys)), "other")
            sums[label] += e.self_device_time_total / 1e3
        log("  by group: " + "; ".join(f"{g} {ms:.2f} ms"
                                      for g, ms in sums.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    log("[1] card")
    smi = card()
    log(f"  {smi}; torch sees {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}")

    log("[2] build")
    t0 = time.perf_counter()
    path, diag = _build.build()
    build_s = time.perf_counter() - t0
    log(f"  {path.name} in {build_s:.1f} s")
    # ptxas -v: one "entry / registers / spills" line per instantiation, and
    # any warning that ptxas serialised an entry's wgmma instructions
    entry = ""
    for line in diag.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "wgmma" in line and "serializ" in line:
            log(f"  ptxas {entry[:90]}: {line.strip()[:300]}")
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            log(f"  ptxas {entry[:90]}: {line.split(':', 1)[1].strip()}; "
                f"{spills}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    log("[3] kernels against their plain versions")
    k1 = check_k1(gen)
    k2 = check_k2(gen)
    k1b = check_k1b(gen)
    k2b = check_k2b(gen)
    k3 = check_k3(gen)

    runs = []
    for arch in ("llama3-1b", "mamba2-370m"):
        log(f"[4] {arch} serving path; [5] where the time goes")
        runs.append(serve(arch, gen))
    log("[6] llama3-1b training path")
    runs.append(train_llama(gen))
    log("[7] gradient gate and the training CLI")
    gradient_gate(gen)
    train_cli()
    # launches on the three main paths: K1 and K2 run on two or three
    for entry in (k1, k2, k3, k1b, k2b):
        key = entry["name"]
        entry["launches"] = sum(run[key] for run in runs)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k1b, k2b]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
