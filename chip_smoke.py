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
   card's memory sets; K1b and K2b also launched twice at the training
   shape, their outputs bit-identical (they use no atomics);
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
   path's distance from an f32 run), once with the reference's init and
   once with every scaled weight drawn at std 1/sqrt(its input width), and
   the training CLI for 3 steps;
8. export on the card: llama3-1b's train step at 4 x 2048 traced on fake
   ``cuda`` tensors and emitted as StableHLO text, with the card's
   configuration and with ``attn_impl="chunked"``: the kernels' operator
   nodes equal phase 6's launches a step, no launch counter moves and no
   device memory is allocated, the port's two IR front ends give equal
   Programs, and the ``dot_general`` FLOPs are the JAX export's (chunked)
   or that plus K1's recomputed scores (kernel); the trace's and the
   emit's seconds and the text's size; then the host's time for one K2
   call at the decode shape through its operator (the route inside a
   trace) and directly (the route outside one, ``library.call``);
9. predict on the card: phase 8's kernel-configuration text through the
   port's ``PredictionJob`` (catalog system ``h100``, ``a2a`` over one
   device, the linear slicer) with fig6's two estimators, roofline by
   region and per-op with overheads, each beside phase 6's measured
   median step (the ratio is printed, not held); then the port's
   ``run_campaign`` on ``specs/fig10_gemm.json`` against its golden;
10. the per-rank step of a [4, 1] data mesh (llama3-1b, 4 x 2048 in all):
   (a) its export with the card's configuration on fake ``cuda`` tensors
   in a fake world of 4 (4 partitions, both front ends equal,
   ``dot_general`` FLOPs phase 8's over 4, each collective typed by its
   payload, no launch, no device memory), with the collectives' counts
   and bytes; (b) its prediction on ``h100``, ``auto`` over 4 devices,
   with fig6's two estimators; (c) the step itself eagerly on the card
   in that fake world (1 x 2048 a rank, 2 warm-up and 6 timed steps:
   median, peak memory, the launches a step, the predicted compute over
   the median); (d) ``specs/fig6_gpu.json`` (its 12 raw and 12 optimized
   rows ranking the four systems as the golden's rows of that fidelity
   do, Kendall tau 1.0 per workload), ``specs/fig11_tpu.json`` (tau 1.0
   per estimator, each mixed row below its roofline row) and
   ``specs/fig9_scaleout.json`` (printed beside the golden), all as
   checked in through the campaign's exports (the reference's chunked
   attention) on fake ``cuda`` tensors; fig6 and fig9 through the CLI in
   subprocesses while fig11 runs;
11. fig7, the data-parallel ResNet step: (a) its four workloads
   (resnet18/34/50/101 at 64 x 224, f16, [4, 1]) exported through
   ``build_workload`` on fake ``cuda`` tensors in a fake world of 4, each
   global and per-rank text's convolutions and their FLOPs (the per-rank
   ones x 4 equal to the global ones), the per-rank collectives, both front
   ends equal, no launch and no device memory; (b) each rank's step
   eagerly on the card in that fake world (16 x 224 a rank, AdamW, 2
   warm-up and 6 timed steps from the same shards, since the fake world's
   collectives move no data) and then trained on those 16 images as one
   card's step (each step on the last one's parameters), a finite loss on
   every step of both: median, images/s, peak memory, and the predicted
   compute on ``h100`` over the rank step's median; (c) ``specs/fig7_resnet.json`` as
   checked in over (a)'s exports, the four step times at Kendall tau 1.0
   against the golden's; (d) ``python -m repro_torch.campaign`` in
   subprocesses: ``validate`` and ``list``, and fig10's ``run`` and
   ``report --check`` against its golden;
12. profiling on the card: (a) llama3-1b's train step (4 x 2048, AdamW,
   the card's configuration with a barrier after each layer, so that the
   linear slicer cuts it a layer at a time) exported on fake ``cuda``
   tensors, every region re-emitted and run by the port's executor,
   captured into a CUDA graph and timed (the ``profiling`` estimator on
   ``host``, the card): the region count, the sum beside phase 6's
   measured median step, the largest region, the sum projected onto
   ``h100`` and ``a100``, ``emit_failures`` (held at 0) and the launches
   of K1, K1b, K2 and K2b that the regions' eager runs made (each held
   above 0 and equal to phase 6's launches a step; a graph's capture and
   replays are not wrapper launches);
   (b) resnet18's train step (16 x 224, f16, a barrier after each block)
   the same way, beside phase 11's one-card step; (c) fig10's GEMMs with a
   ``profiling`` estimator on ``host`` and ``h100`` through ``python -m
   repro_torch.campaign run --device cuda --cache``, twice: the rerun has
   100% cache hits and the first run's step times; (d) fig6's llama3-1b
   workload as checked in, profiled on ``host`` through the same CLI: the
   campaign's per-rank text, whose attention is the reference's chunked
   text (no K1 or K1b), its compute beside phase 10's measured per-rank
   step.

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
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.campaign import (CampaignSpec, check_rows,  # noqa: E402
                                  run_campaign)
from repro_torch.campaign.builders import (build_estimator,  # noqa: E402
                                           build_topology, build_workload)
from repro_torch.campaign.report import kendall_tau, load_json  # noqa: E402
from repro_torch.campaign.spec import (EstimatorSpec,  # noqa: E402
                                      TopologySpec)
from repro_torch.core import ir  # noqa: E402
from repro_torch.core.catalog import default_registry  # noqa: E402
from repro_torch.core.estimators.profiling import (  # noqa: E402
    ProfilingEstimator)
from repro_torch.core.ir.collectives import collect_collectives  # noqa: E402
from repro_torch.core.pipeline import (PredictionJob,  # noqa: E402
                                       build_plan, export_workload)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k1_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    bwd_kernel_error as k1b_error, flash_attention_bwd_ref,
    flash_attention_fwd_ref, flash_attention_ref, kernel_error, lse_error)
from repro_torch.kernels.rmsnorm import ops as k2_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    bwd_kernel_error as k2b_error, kernel_error as rmsnorm_error,
    rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.launch.mesh import traced_mesh  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    kernel_error as ssd_error, ssd_scan_ref)
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models.attention import gqa_forward  # noqa: E402
from repro_torch.models.common import embed_lookup, rms_norm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.resnet import (make_resnet_train_step,  # noqa: E402
                                       resnet_arch_config, resnet_specs,
                                       resnet_train_exports)
from repro_torch.models.ssm import mamba2_forward  # noqa: E402
from repro_torch.models.transformer import (TransformerLM, _embed,  # noqa: E402
                                            decode_step, init_cache_specs,
                                            model_specs, prefill)
from repro_torch.models.params import (abstract_params,  # noqa: E402
                                       init_params, param_count,
                                       shard_params, tree_paths)
from repro_torch.train.checkpoint import _flatten as flatten  # noqa: E402
from repro_torch.train.data import (DataConfig, ShardedLoader,  # noqa: E402
                                    SyntheticSource)
from repro_torch.train.loop import (  # noqa: E402
    _value_and_grad as value_and_grad, make_train_step, train_step_exports)
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


def kernel_name(mangled: str) -> str:
    """``bwd_dkdv_ws<64>`` or ``rmsnorm_bwd_groups<bf16>`` from the mangled
    entry name of one of K1b's or K2b's kernels; other names unchanged."""
    import re
    m = re.search(r"((?:rmsnorm_)?bwd_[a-z]+(?:_[a-z0-9]+)?)I(.*?)EEv",
                  mangled)
    if not m:
        return mangled
    return m[1] + "<" + ", ".join(
        a or ("bf16" if b else "f32")
        for a, b in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|f", m[2])) + ">"


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
    # phase 10's per-rank step: one rank's 1 x 2048 of llama3-1b on [4, 1]
    ("rank_bshd", 1, 32, 8, 2048, 2048, 64, True, 0, 0.0, 0),
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
    ("rank", 2048, 2048, 0.0),       # phase 10's per-rank step
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
    # phase 10's per-rank step (1 x 2048 of llama3-1b on [4, 1]): at B=1
    # the persistent dK/dV grid has 128 items, fewer than the 132 SMs
    ("rank_bshd", 1, 32, 8, 2048, 2048, 64, True, 0, 0.0, 0),
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
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"  K1b train {str(dtype)[6:]}: a second launch's dq, dk and "
                f"dv {'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"K1b train {dtype}: two launches "
                                     "differ")
            del again
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
    ("rank", 2048, 2048, 0.0),       # phase 10's per-rank step
    ("mamba_ln", 8192, 1024, 0.0),
    ("decode", 8, 2048, 0.0),
    ("scalar_path", 37, 1001, 1.0),
    ("wide", 8, 4096, 0.0),          # llama2-7b's width
    # gemma's (1 + w) through the groups kernel (scalar_path takes the
    # block kernel)
    ("offset", 1024, 2048, 1.0),
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
            if name == "train":
                again = rmsnorm_bwd(x, w, dy, 1e-5, offset)
                same = torch.equal(dx, again[0]) and torch.equal(dw, again[1])
                log(f"  K2b train {str(dtype)[6:]}: a second launch's dx and "
                    f"dw {'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    raise AssertionError(f"K2b train {dtype}: two launches "
                                         "differ")
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
    "K1b": ["bwd_dkdv_ws", "bwd_dq_ws", "bwd_delta"],
    "K1": ["flash_fwd"],
    "K2b": ["rmsnorm_bwd_groups", "rmsnorm_bwd_block", "rmsnorm_bwd_dw"],
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


def train_llama(gen) -> tuple[dict, float]:
    """The training path: ``make_train_step`` on llama3-1b (remat none,
    AdamW, bf16 parameters, f32 moments) for TRAIN_WARMUP + TRAIN_STEPS
    steps on one repeated 4 x 2048 batch, with the launch counts set to 0
    after the warm-up and read after the last step; then one profiled
    step.  Returns the launch counts and the median step's seconds."""
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
    return launches, step_s


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


def fan_in_init(specs: dict, params: dict, gen) -> None:
    """Redraw, in place, every weight that the reference's "scaled"
    initializer draws at std 1/sqrt(shape[0]) (for a layer-stacked weight
    shape[0] is the layer count) at std 1/sqrt(its input width): the
    model-width axes that the product contracts (two for ``wo``, whose
    input is heads x head_dim; one for the rest)."""
    for name, spec in tree_paths(specs).items():
        if spec.init != "scaled":
            continue
        first = 1 if spec.axes[0] == "layers" else 0
        width = math.prod(spec.shape[first:first + (
            2 if name.endswith("/wo") else 1)])
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node[key]
        node[leaf].copy_(torch.randn(spec.shape, generator=gen,
                                     device="cuda") / math.sqrt(width))


def gradient_gate(gen, fan_in: bool = False) -> None:
    """llama3-1b at full width cut to GATE_LAYERS layers: bf16 gradients
    through the kernels (K1, K1b, K2, K2b) must reach every parameter, and
    each parameter's distance from an f32 plain run must be within
    LOGIT_FACTOR times the bf16 plain path's distance from it.  With
    ``fan_in`` the weights are drawn by :func:`fan_in_init` instead of the
    reference's init."""
    cfg = get_config("llama3-1b").scaled(num_layers=GATE_LAYERS)
    specs = model_specs(cfg)
    params = init_params(specs, gen, "cuda")
    if fan_in:
        fan_in_init(specs, params, gen)
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
    log(f"  gradient gate ({GATE_LAYERS} layers, {GATE_B}x{TRAIN_S}, "
        f"{'fan-in' if fan_in else 'reference'} init): every parameter has "
        f"a gradient through the kernels; largest kernel/plain distance "
        f"ratio {worst:.2f} (tol {LOGIT_FACTOR:g})")


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
# phase 8: export on the card
# --------------------------------------------------------------------------

# dot_general FLOPs of llama3-1b's train step at 4 x 2048: the JAX raw
# export's (tests/test_torch_export.py holds the port's chunked export to
# it; the card's machine has no JAX), and the kernel path's, whose plain
# backward of K1 recomputes the scores: one more 2 B Hq S^2 D product a
# layer, 16 * 2 * 4 * 32 * 2048^2 * 64 in all
EXPORT_FLOPS = {"chunked": 57_724_360_458_240,
                "kernel": 57_724_360_458_240 + 16 * 2 * 4 * 32 * 2048**2 * 64}
# operator names in the export -> the launch counters of phase 6
EXPORT_OPS = {"flash_attention_lse": "flash_attention",
              "flash_attention_bwd": "flash_attention_bwd",
              "rmsnorm": "rmsnorm", "rmsnorm_bwd": "rmsnorm_bwd"}


def export_on_the_card(train_launches: dict):
    """Export llama3-1b's train step on fake ``cuda`` tensors with the
    card's configuration and with the chunked attention, and hold each
    text: kernel operators against phase 6's launches a step, no launch
    and no device memory, both front ends equal, the FLOPs.  Returns the
    card's configuration's workload."""
    per_step = {k: n / TRAIN_STEPS for k, n in train_launches.items()}
    exported = {}
    for impl in ("kernel", "chunked"):
        cfg = get_config("llama3-1b").scaled(attn_impl=impl)
        step, args = train_step_exports(cfg, TRAIN_S, TRAIN_B)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in COUNTERS.items()}
        mem = torch.cuda.memory_allocated()
        w = exported[impl] = export_workload(
            step, *args, name=f"llama3-1b-{impl}", device="cuda")
        if torch.cuda.memory_allocated() != mem:
            raise AssertionError(f"export {impl}: device memory "
                                 f"{mem} -> {torch.cuda.memory_allocated()}")
        if {k: fn.launches for k, fn in COUNTERS.items()} != counts:
            raise AssertionError(f"export {impl}: a launch counter moved")
        ops = w.meta["kernel_ops"]
        want = ({op: per_step[k] for op, k in EXPORT_OPS.items()}
                if impl == "kernel" else
                {"rmsnorm": per_step["rmsnorm"],
                 "rmsnorm_bwd": per_step["rmsnorm_bwd"]})
        if ops != want:
            raise AssertionError(f"export {impl}: operator nodes {ops}, "
                                 f"expected {want}")
        text = w.stablehlo_text
        t0 = time.perf_counter()
        legacy = ir.parse_stablehlo(text, frontend="legacy")
        streaming = ir.parse_stablehlo(text, frontend="streaming")
        parse_s = time.perf_counter() - t0
        ir.assert_programs_equal(legacy, streaming)
        flops = int(ir.program_cost(streaming).by_op["dot_general"])
        if flops != EXPORT_FLOPS[impl]:
            raise AssertionError(f"export {impl}: dot_general FLOPs {flops}"
                                 f", expected {EXPORT_FLOPS[impl]}")
        log(f"  {impl}: trace {w.meta['trace_s']:.2f} s, emit "
            f"{w.meta['emit_s']:.3f} s, text {w.meta['text_bytes']} bytes, "
            f"{streaming.num_ops} ops, both front ends {parse_s:.2f} s; "
            f"operator nodes {ops}; dot_general {flops} FLOPs")
    # the operator's dispatcher round trip against the direct call, in
    # turns: host µs a K2 call at 8 x 2048 bf16 (2000 calls, then a sync)
    x = torch.randn(8, 2048, device="cuda").bfloat16()
    w1 = torch.ones(2048, device="cuda").bfloat16()
    routes = {"operator": lambda: k2_ops._FWD(x, w1, 1e-5, 0.0),
              "direct": lambda: k2_ops._forward(x, w1, 1e-5, 0.0)}
    us = {k: [] for k in routes}
    for _ in range(5):
        for k, fn in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            us[k].append((time.perf_counter() - t0) / 2000 * 1e6)
    log("  host µs a K2 call at 8x2048: " + "; ".join(
        f"{k} {statistics.median(v):.2f} (runs "
        f"{', '.join(f'{t:.2f}' for t in v)})" for k, v in us.items()))
    return exported["kernel"]


# --------------------------------------------------------------------------
# phase 9: predict on the card
# --------------------------------------------------------------------------

# fig6's two estimators (specs/fig6_gpu.json): roofline by region, and per
# op with the per-kernel overheads
PREDICT_ESTIMATORS = {
    "roofline": {"kind": "roofline"},
    "roofline-per-op-ovh": {"kind": "roofline", "options": {
        "mode": "per-op", "include_overheads": True}},
}
FIG6_WORKLOADS = ("llama3-100m", "llama3-500m", "llama3-1b")


def predict_on_the_card(workload, step_s: float) -> None:
    """Predict phase 8's train step (one card: ``a2a`` over 1 device, no
    mesh) beside phase 6's measured median; then fig10 through the port's
    campaign runner, held against its golden (fig6 runs in phase 10)."""
    system = default_registry().get("h100")
    topology = build_topology(TopologySpec.from_dict(
        {"kind": "a2a", "params": {"num_devices": 1}}), system)
    program = workload.program("raw")
    for label, est in PREDICT_ESTIMATORS.items():
        t0 = time.perf_counter()
        p = PredictionJob(
            program=program, slicer="linear", name=workload.name,
            system_name="h100", topology=topology,
            estimator=build_estimator(EstimatorSpec.from_dict(est),
                                      system)).run()
        secs = time.perf_counter() - t0
        if not (math.isfinite(p.step_time_s) and p.step_time_s > 0):
            raise AssertionError(f"predict {label}: step {p.step_time_s}")
        log(f"  {workload.name} on h100, {label}: predicted "
            f"{p.step_time_s * 1e3:.2f} ms, measured (phase 6 median) "
            f"{step_s * 1e3:.2f} ms, predicted/measured "
            f"{p.step_time_s / step_s:.4f}; {p.num_segments} segments, "
            f"prediction {secs:.2f} s")

    t0 = time.perf_counter()
    result = run_campaign(CampaignSpec.from_json(
        str(ROOT / "specs" / "fig10_gemm.json")))
    check = check_rows(load_json(str(ROOT / "specs" / "golden" /
                                     "fig10-gemm.json")), result.rows)
    if check["failures"]:
        raise AssertionError(f"fig10 against its golden: "
                             f"{check['failures']}")
    log(f"  fig10: {check['rows_checked']} rows equal to the golden (max "
        f"drift {check['max_drift']}), {time.perf_counter() - t0:.2f} s")


# --------------------------------------------------------------------------
# phase 10: the per-rank step of a [4, 1] data mesh
# --------------------------------------------------------------------------

MESH = (4, 1)
# each rank takes one row of phase 6's 4 x 2048 batch: phase 8's kernel
# text's dot_general FLOPs over the mesh's 4 ranks, 14,705,968,021,504
RANK_FLOPS = EXPORT_FLOPS["kernel"] // MESH[0]


def allocations() -> int:
    """The card's allocator's count of allocations so far (a free does
    not lower it)."""
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def mesh_export():
    """(a) fig6's llama3-1b cell (4 x 2048 on [4, 1]) exported on fake
    ``cuda`` tensors with the card's configuration (the kernels, as the
    rank's step runs them; the campaign's builder exports the reference's
    chunked attention instead): the global step's raw text and the
    per-rank text, traced in a fake world of 4.  Holds the per-rank text:
    4 partitions, both front ends equal, the FLOPs, every collective typed
    by its payload (the gathers move the sharded leaves' bf16 bytes, the
    reduce-scatters their bf16 gradients'), no launch and no device
    memory."""
    cfg = get_config("llama3-1b")
    step, args = train_step_exports(cfg, TRAIN_S, TRAIN_B)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in COUNTERS.items()}
    allocs = allocations()
    with traced_mesh(MESH, "cuda") as mesh:
        w = export_workload(step, *args, name="llama3-1b", device="cuda",
                            per_rank=(*train_step_exports(
                                cfg, TRAIN_S, TRAIN_B, mesh), mesh))
    if allocations() != allocs:
        raise AssertionError(f"mesh export: {allocations() - allocs} "
                             "device allocations")
    if {k: fn.launches for k, fn in COUNTERS.items()} != counts:
        raise AssertionError("mesh export: a launch counter moved")
    legacy = ir.parse_stablehlo(w.hlo_text, frontend="legacy")
    streaming = ir.parse_stablehlo(w.hlo_text, frontend="streaming")
    ir.assert_programs_equal(legacy, streaming)
    if streaming.meta.get("num_partitions") != MESH[0]:
        raise AssertionError(f"mesh export: num_partitions "
                             f"{streaming.meta.get('num_partitions')}")
    flops = int(ir.program_cost(streaming).by_op["dot_general"])
    if flops != RANK_FLOPS:
        raise AssertionError(f"mesh export: dot_general FLOPs {flops}, "
                             f"expected {RANK_FLOPS}")
    specs = model_specs(get_config("llama3-1b"))
    whole = flatten(abstract_params(specs))
    with traced_mesh(MESH, "cuda") as mesh:
        shards = flatten(abstract_params(specs, mesh))
    sizes = {k: t.numel() * t.element_size() for k, t in whole.items()}
    sharded = sum(n for k, n in sizes.items()
                  if shards[k].shape != whole[k].shape)
    kinds: dict = {}
    for c, mult in collect_collectives(streaming):
        if not (c.bytes_in > 0 and c.group_size == MESH[0]):
            raise AssertionError(f"mesh export: collective {c} is not "
                                 "typed by its payload over 4 ranks")
        k = kinds.setdefault(c.kind, [0, 0.0])
        k[0] += mult
        k[1] += c.algo_bytes * mult
    # the gathers move the sharded leaves' bf16 bytes, the reduce-scatters
    # their gradients'; the all-reduces the replicated leaves' gradients
    # and two f32 scalars (the loss, the clip's sum of squares)
    want = {"all_gather": sharded, "reduce_scatter": sharded,
            "all_reduce": sum(sizes.values()) - sharded + 8}
    if {k: b for k, (_, b) in kinds.items()} != want:
        raise AssertionError(f"mesh export: collective bytes {kinds}, "
                             f"expected {want}")
    opt = w.meta["optimized"]
    log(f"  per-rank text: trace {opt['trace_s']:.2f} s, emit "
        f"{opt['emit_s']:.3f} s, {opt['text_bytes']} bytes, "
        f"{streaming.num_ops} ops, num_partitions 4, operator nodes "
        f"{opt['kernel_ops']}; dot_general {flops} FLOPs (phase 8's / 4); "
        f"global text: trace {w.meta['trace_s']:.2f} s")
    log("  collectives (count, algorithm bytes a rank): " + "; ".join(
        f"{k} {n}, {b:.0f}" for k, (n, b) in sorted(kinds.items()))
        + f"; the sharded leaves' bf16 bytes {sharded}")
    return w


def mesh_predict(w) -> dict:
    """(b) the per-rank text on ``h100``, ``auto`` over 4 devices, with
    fig6's two estimators."""
    system = default_registry().get("h100")
    topology = build_topology(TopologySpec.from_dict(
        {"kind": "auto", "params": {"num_devices": MESH[0]}}), system)
    program = w.program("optimized")
    out = {}
    for label, est in PREDICT_ESTIMATORS.items():
        t0 = time.perf_counter()
        p = out[label] = PredictionJob(
            program=program, slicer="linear", name=w.name,
            system_name="h100", topology=topology,
            estimator=build_estimator(EstimatorSpec.from_dict(est),
                                      system)).run()
        if not (math.isfinite(p.step_time_s) and p.compute_s > 0
                and p.comm_s > 0):
            raise AssertionError(f"mesh predict {label}: {p}")
        log(f"  per-rank llama3-1b on h100 (auto, 4 devices), {label}: "
            f"step {p.step_time_s * 1e3:.2f} ms, compute "
            f"{p.compute_s * 1e3:.2f} ms, communication "
            f"{p.comm_s * 1e3:.2f} ms; {p.num_segments} segments, "
            f"{p.num_comm} collectives, {time.perf_counter() - t0:.2f} s")
    return out


def rank_step(gen, predicted: dict) -> tuple[dict, float]:
    """(c) one rank's step of llama3-1b on [4, 1], eagerly on the card in
    a fake world of 4 (1 x 2048 a rank; AdamW on the shards), with the
    launch counts set to 0 after the warm-up and read after the last
    step.  Returns the launch counts and the median step."""
    cfg = get_config("llama3-1b")
    specs = model_specs(cfg)
    opt_cfg = OptimizerConfig(warmup_steps=1)
    times = []
    with traced_mesh(MESH, "cuda") as mesh:
        params = shard_params(specs, init_params(specs, gen, "cuda"), mesh)
        torch.cuda.empty_cache()
        opt_state = adamw_init(params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, mesh=mesh)
        batch = next(ShardedLoader(SyntheticSource(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
            global_batch=TRAIN_B, seed=0)), mesh))
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                # ---- the main path: counts at 0 just before, read after --
                for fn in COUNTERS.values():
                    fn.launches = 0
            # the same shards every step: the fake world fills no gather
            # buffer, so the values are not the point
            times.append(timed(lambda: step_fn(params, opt_state, batch)))
        launches = {k: fn.launches for k, fn in COUNTERS.items()}
        # ---- end of the main path ----
        peak = torch.cuda.max_memory_allocated()
    del params, opt_state
    torch.cuda.empty_cache()
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    expected = {k: 0 for k in COUNTERS}
    expected.update(flash_attention=cfg.num_layers,
                    flash_attention_bwd=cfg.num_layers,
                    rmsnorm=2 * cfg.num_layers + 1,
                    rmsnorm_bwd=2 * cfg.num_layers + 1)
    if per_step != expected:
        raise AssertionError(f"per-rank launches a step {per_step}, "
                             f"expected {expected}")
    step_s = statistics.median(times[TRAIN_WARMUP:])
    log(f"  per-rank step (rank 0 of a fake world of 4: its collectives "
        f"move no data, so this is the rank's compute; its values are not "
        f"checked here, the CPU tests hold the numerics): median "
        f"{step_s * 1e3:.2f} ms over steps {TRAIN_WARMUP}.."
        f"{TRAIN_WARMUP + TRAIN_STEPS - 1} (all: "
        + ", ".join(f"{t * 1e3:.2f}" for t in times)
        + f" ms), peak memory {peak / 2**30:.2f} GiB; launches a step "
        f"{per_step}")
    for label, p in predicted.items():
        log(f"  predicted compute / measured median, {label}: "
            f"{p.compute_s * 1e3:.2f} / {step_s * 1e3:.2f} = "
            f"{p.compute_s / step_s:.4f} (a finding, not held)")
    return launches, step_s


CLI_GRIDS = ("fig6_gpu.json", "fig9_scaleout.json")


def mesh_campaigns() -> None:
    """(d) fig6, fig11 and fig9 as checked in, exported by the campaign on
    fake ``cuda`` tensors: per fig6 workload and fidelity the four
    systems, and per fig11 estimator the four workloads, rank as the
    golden's rows of that fidelity do, and each fig11 mixed row lies below
    its roofline row; fig9's rows are printed beside the golden's.  fig6
    and fig9 run through the CLI in subprocesses while fig11 runs here:
    each is its exports' host work (llama2-7b's four traces take about
    four minutes), and nothing in any of them is timed."""
    def golden(name):
        return {(r["workload"], r["system"], r["estimator"], r["fidelity"]):
                r for r in load_json(str(ROOT / "specs" / "golden" /
                                         name.replace("_", "-")))["rows"]}

    def held(rows, gold, label):
        ours = [r["step_time_s"] for r in rows]
        theirs = [gold[(r["workload"], r["system"], r["estimator"],
                        r["fidelity"])]["step_time_s"] for r in rows]
        tau = kendall_tau(ours, theirs)
        log(f"  {label}: " + "; ".join(
            f"{r['workload']}/{r['system']} {a * 1e3:.2f} ms "
            f"({a / b:.4f} of golden)" for r, a, b in zip(rows, ours, theirs))
            + f"; tau {tau}")
        if tau != 1.0:
            raise AssertionError(f"{label}: Kendall tau {tau}")

    grids = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.campaign", "run",
             str(ROOT / "specs" / name), "--device", "cuda", "--executor",
             "serial", "--out", os.path.join(tmp, name), "--quiet"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in CLI_GRIDS}
        try:
            grids["fig11_tpu.json"] = run_campaign(CampaignSpec.from_json(
                str(ROOT / "specs" / "fig11_tpu.json")), device="cuda").rows
            log(f"  fig11: {time.perf_counter() - t0:.2f} s")
            for name, proc in procs.items():
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"{name} CLI: rc "
                                         f"{proc.returncode}\n{out}")
                grids[name] = [json.loads(line) for line in Path(
                    tmp, name, "results.jsonl").read_text().splitlines()]
                log(f"  {name} through the CLI: "
                    f"{time.perf_counter() - t0:.2f} s")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for name, rows in grids.items():
        errors = [r for r in rows if "error" in r]
        if errors:
            raise AssertionError(f"{name}: error rows {errors[:2]}")
    fig6 = grids["fig6_gpu.json"]
    if len(fig6) != 24:
        raise AssertionError(f"fig6: {len(fig6)} rows, expected 24")
    gold = golden("fig6_gpu.json")
    for fidelity in ("raw", "optimized"):
        for name in FIG6_WORKLOADS:
            held(sorted((r for r in fig6 if r["workload"] == name
                         and r["fidelity"] == fidelity),
                        key=lambda r: r["job_id"]), gold,
                 f"fig6 {name} {fidelity}")
    gold = golden("fig11_tpu.json")
    by_est = {}
    fig11 = grids["fig11_tpu.json"]
    for est in sorted({r["estimator"] for r in fig11}):
        by_est[est] = [r for r in fig11 if r["estimator"] == est]
        held(by_est[est], gold, f"fig11 {est}")
    # the campaign's chunked text keeps the attention's products inline,
    # where the systolic model sees them: each mixed row lies below its
    # roofline row (a second witness to the ranks)
    roof = {r["workload"]: r["step_time_s"] for r in by_est["roofline"]}
    for r in by_est["mixed-cocossim"]:
        ratio = r["step_time_s"] / roof[r["workload"]]
        log(f"  fig11 {r['workload']}: mixed / roofline {ratio:.4f}")
        if not ratio < 1.0:
            raise AssertionError(f"fig11 {r['workload']}: mixed "
                                 f"{ratio:.4f} of roofline")
    gold = golden("fig9_scaleout.json")
    for r in sorted(grids["fig9_scaleout.json"], key=lambda r: r["job_id"]):
        g = gold[(r["workload"], r["system"], r["estimator"],
                  r["fidelity"])]
        log(f"  fig9 {r['workload']} {r['estimator']} "
            f"({r['fidelity']}): {r['step_time_s']:.4f} s (compute "
            f"{r['compute_s']:.4f}, communication "
            f"{r['comm_s']:.4f}, {r['num_segments']} segments); "
            f"golden {g['step_time_s']:.4f} s (compute "
            f"{g['compute_s']:.4f}, communication "
            f"{g['comm_s']:.4f}, {g['num_segments']} segments); "
            f"{r['step_time_s'] / g['step_time_s']:.4f}")


# --------------------------------------------------------------------------
# phase 11: fig7, the data-parallel ResNet step
# --------------------------------------------------------------------------

FIG7_SPEC = ROOT / "specs" / "fig7_resnet.json"
# the rank's images (fig7: 64 x 224 on [4, 1])
RESNET_RANK_B, RESNET_IMG = 16, 224
RESNET_WARMUP, RESNET_STEPS = 2, 6


def _collective_kinds(program) -> dict:
    """kind -> [count, algorithm bytes a rank]; each collective must be
    typed by its payload over the mesh's 4 ranks."""
    kinds: dict = {}
    for c, mult in collect_collectives(program):
        if not (c.bytes_in > 0 and c.group_size == MESH[0]):
            raise AssertionError(f"fig7 export: collective {c} is not "
                                 "typed by its payload over 4 ranks")
        k = kinds.setdefault(c.kind, [0, 0.0])
        k[0] += mult
        k[1] += c.algo_bytes * mult
    return kinds


def fig7_export() -> dict:
    """(a) fig7's four workloads through the campaign's export, as checked
    in (64 x 224, f16, [4, 1]), on fake ``cuda`` tensors in a fake world of
    4: each global and per-rank text's convolutions, their FLOPs and the
    per-rank collectives.  Holds, for each text, equal Programs from both
    front ends; the per-rank convolution FLOPs x 4 equal to the global
    text's; no launch and no device memory."""
    spec = CampaignSpec.from_json(str(FIG7_SPEC))
    # the process's first fake cuda tensor initialises the device's context
    # with a real 4-byte tensor (FakeTensor's init_gpu_context): made here,
    # before the counting, when phase 8 has not made it already
    with FakeTensorMode():
        torch.empty(1, device="cuda")
    out = {}
    for wspec in spec.workloads:
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in COUNTERS.items()}
        allocs = allocations()
        w = build_workload(wspec, device="cuda")
        if allocations() != allocs:
            raise AssertionError(f"fig7 export {w.name}: "
                                 f"{allocations() - allocs} allocations")
        if {k: fn.launches for k, fn in COUNTERS.items()} != counts:
            raise AssertionError(f"fig7 export {w.name}: a launch counter "
                                 "moved")
        flops = {}
        for label, text in (("global", w.stablehlo_text),
                            ("per-rank", w.hlo_text)):
            legacy = ir.parse_stablehlo(text, frontend="legacy")
            streaming = ir.parse_stablehlo(text, frontend="streaming")
            ir.assert_programs_equal(legacy, streaming)
            flops[label] = int(ir.program_cost(streaming).by_op[
                "convolution"])
            log(f"  {w.name} {label} text: "
                f"{text.count('stablehlo.convolution(')} convolutions, "
                f"{flops[label]} FLOPs; {streaming.num_ops} ops, "
                f"{len(text.encode())} bytes")
        if flops["per-rank"] * MESH[0] != flops["global"]:
            raise AssertionError(f"fig7 export {w.name}: per-rank "
                                 f"convolution FLOPs {flops['per-rank']} "
                                 f"x 4 != {flops['global']}")
        kinds = _collective_kinds(streaming)
        opt = w.meta["optimized"]
        log(f"  {w.name}: trace {w.meta['trace_s']:.2f} s (global), "
            f"{opt['trace_s']:.2f} s (per rank); emit {w.meta['emit_s']:.3f}"
            f" s, {opt['emit_s']:.3f} s; per-rank collectives (count, "
            "algorithm bytes a rank): " + "; ".join(
                f"{k} {n}, {b:.0f}" for k, (n, b) in sorted(kinds.items())))
        out[w.name] = w
    return out


def _steps(step, params, opt, images, labels, feed_back: bool):
    """RESNET_WARMUP + RESNET_STEPS calls of a ResNet train step, the
    launch counts set to 0 after the warm-up and the peak memory reset
    there: (seconds, losses, peak bytes, launches)."""
    times, losses = [], []
    for i in range(RESNET_WARMUP + RESNET_STEPS):
        if i == RESNET_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- this path: counts at 0 just before, read after ----
            for fn in COUNTERS.values():
                fn.launches = 0
        out = []
        times.append(timed(lambda: out.append(step(params, opt, images,
                                                   labels))))
        if feed_back:
            params, opt = out[0][0], out[0][1]
        losses.append(float(out[0][2]))
        del out
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    # ---- end of this path ----
    return times, losses, torch.cuda.max_memory_allocated(), launches


def fig7_rank_steps(gen, workloads: dict) -> dict:
    """(b) each ResNet's rank step eagerly on the card in a fake world of 4
    (16 x 224 images a rank, f16, AdamW), RESNET_WARMUP + RESNET_STEPS
    steps: the median, images/s, peak memory, and the predicted compute on
    ``h100`` (phase 10's two estimators on the per-rank text) over the
    median, printed and not held.  The fake world's collectives move no
    data: its all-gather fills each rank's block with this rank's shard,
    but torch 2.11 leaves some reduce-scatter outputs unfilled (NaN
    gradients, seen on the card), so each step starts from the same shards
    and the values are not the point.  Then the same model trains on the
    rank's 16 images as one card's step (no mesh), each step on the last
    one's parameters.  Both hold a finite loss on every step.  Returns the
    launch counts of the port's kernels (neither path runs one) and each
    model's one-card median step."""
    system = default_registry().get("h100")
    topology = build_topology(TopologySpec.from_dict(
        {"kind": "auto", "params": {"num_devices": MESH[0]}}), system)
    launches = {k: 0 for k in COUNTERS}
    one_card = {}
    for name, w in workloads.items():
        cfg = resnet_arch_config(name)
        specs = resnet_specs(cfg)
        opt_cfg = OptimizerConfig(name="adamw")
        images = torch.randn(RESNET_RANK_B, RESNET_IMG, RESNET_IMG, 3,
                             generator=gen, device="cuda").to(torch.float16)
        labels = torch.randint(0, cfg.num_classes, (RESNET_RANK_B,),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        params = init_params(specs, gen, "cuda")
        runs = {}
        with traced_mesh(MESH, "cuda") as mesh:
            shards = shard_params(specs, params, mesh)
            runs["rank"] = _steps(
                make_resnet_train_step(cfg, opt_cfg, mesh=mesh), shards,
                adamw_init(shards, opt_cfg), images, labels, False)
            del shards
        runs["one card"] = _steps(
            make_resnet_train_step(cfg, opt_cfg), params,
            adamw_init(params, opt_cfg), images, labels, True)
        del params
        torch.cuda.empty_cache()
        for label, (times, losses, peak, counts) in runs.items():
            for k, n in counts.items():
                launches[k] += n
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{name} {label} step: losses {losses}")
            step_s = statistics.median(times[RESNET_WARMUP:])
            log(f"  {name} {label} step (16 x 224, f16): median "
                f"{step_s * 1e3:.2f} ms over steps {RESNET_WARMUP}.."
                f"{RESNET_WARMUP + RESNET_STEPS - 1} (all: "
                + ", ".join(f"{t * 1e3:.2f}" for t in times)
                + f" ms), {RESNET_RANK_B / step_s:.1f} images/s, peak "
                f"memory {peak / 2**30:.2f} GiB; losses "
                + ", ".join(f"{x:.4f}" for x in losses))
        one_card[name] = statistics.median(runs["one card"][0][
            RESNET_WARMUP:])
        step_s = statistics.median(runs["rank"][0][RESNET_WARMUP:])
        program = w.program("optimized")
        for label, est in PREDICT_ESTIMATORS.items():
            p = PredictionJob(
                program=program, slicer="linear", name=name,
                system_name="h100", topology=topology,
                estimator=build_estimator(EstimatorSpec.from_dict(est),
                                          system)).run()
            log(f"  {name} predicted compute on h100 ({label}) / the rank "
                f"step's median: {p.compute_s * 1e3:.2f} / "
                f"{step_s * 1e3:.2f} = {p.compute_s / step_s:.4f} (a "
                "finding, not held)")
    if any(launches.values()):
        raise AssertionError(f"fig7 rank steps launched {launches}: no "
                             "kernel of the port lies on this path")
    return launches, one_card


def fig7_campaign(workloads: dict) -> None:
    """(c) fig7 as checked in (``a100``, roofline, ``a2a`` over 4), with
    (a)'s exports: the four step times rank as the golden's (Kendall tau
    1.0); each row beside the golden's, comm segments included."""
    t0 = time.perf_counter()
    result = run_campaign(CampaignSpec.from_json(str(FIG7_SPEC)),
                          workloads=workloads, device="cuda")
    errors = [r for r in result.rows if "error" in r]
    if errors:
        raise AssertionError(f"fig7: error rows {errors[:2]}")
    gold = {r["workload"]: r for r in load_json(
        str(ROOT / "specs" / "golden" / "fig7-resnet.json"))["rows"]}
    rows = sorted(result.rows, key=lambda r: r["workload"])
    for r in rows:
        g = gold[r["workload"]]
        log(f"  fig7 {r['workload']}: step {r['step_time_s'] * 1e3:.3f} ms "
            f"(compute {r['compute_s'] * 1e3:.3f}, communication "
            f"{r['comm_s'] * 1e3:.3f}; {r['num_segments']} segments, "
            f"{r['num_comm']} comm); golden {g['step_time_s'] * 1e3:.3f} ms "
            f"({g['num_segments']} segments, {g['num_comm']} comm); "
            f"{r['step_time_s'] / g['step_time_s']:.4f} of golden")
    tau = kendall_tau([r["step_time_s"] for r in rows],
                      [gold[r["workload"]]["step_time_s"] for r in rows])
    log(f"  fig7: Kendall tau {tau} against the golden, "
        f"{time.perf_counter() - t0:.2f} s")
    if tau != 1.0:
        raise AssertionError(f"fig7: Kendall tau {tau}")


def campaign_cli() -> None:
    """(d) ``python -m repro_torch.campaign`` in subprocesses: ``validate``
    of the paper's suite and ``list`` exit 0; ``run`` of fig10 and then
    ``report --check`` of its rows give the golden's rows."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        runs = [["validate", "specs/paper_full.json"], ["list"],
                ["run", "specs/fig10_gemm.json", "--out", tmp, "--quiet"],
                ["report", "specs/fig10_gemm.json", "--results",
                 os.path.join(tmp, "results.jsonl"), "--check", "--out",
                 os.path.join(tmp, "report")]]
        for args in runs:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.campaign", *args],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            last = (proc.stdout.strip().splitlines() or [""])[-1]
            log(f"  repro_torch.campaign {' '.join(args[:2])}: rc "
                f"{proc.returncode}, {time.perf_counter() - t0:.1f} s; "
                f"{last[:160]}")
            if proc.returncode != 0:
                raise AssertionError(f"campaign CLI {args}: rc "
                                     f"{proc.returncode}\n{proc.stdout}"
                                     f"\n{proc.stderr}")
        if "golden OK" not in proc.stdout:
            raise AssertionError(f"fig10 report: {proc.stdout}")


def fig7_phase(gen) -> tuple[dict, dict]:
    """Phase 11, (a) to (d).  Returns (b)'s launch counts and one-card
    median steps."""
    t0 = time.perf_counter()
    workloads = fig7_export()
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    launches, one_card = fig7_rank_steps(gen, workloads)
    fig7_campaign(workloads)
    campaign_cli()
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    return launches, one_card


# --------------------------------------------------------------------------
# phase 12: profiling on the card
# --------------------------------------------------------------------------

PROFILE_RUNS = 3
PROFILE_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                   "rmsnorm_bwd")
# fig10's GEMMs, profiled on the card (host) and projected onto h100
PROFILE_FIG10 = {"name": "fig10-profiling", "systems": ["host", "h100"],
                 "estimators": [{"kind": "profiling"}]}
# fig6's llama3-1b workload as checked in, profiled on the card (host)
PROFILE_FIG6 = {"name": "fig6-profiling", "systems": ["host"],
                "estimators": [{"kind": "profiling"}]}


def profile_regions(label: str, w, measured_s: float, smi: str) -> tuple:
    """Profile every compute region of ``w``'s raw text on ``host`` (the
    card) with the port's profiling estimator: each region re-emitted,
    run by the port's executor, captured into a CUDA graph and timed over
    PROFILE_RUNS replays.  Prints the region count, the sum beside
    ``measured_s`` (the same run's measured step), the largest region, the
    sum projected onto ``h100`` and ``a100``, and the kernels' launches
    (those of each region's eager run: a capture records the kernels
    uncounted, and a replay relaunches them without the wrappers).  Holds
    ``emit_failures == 0``.  Returns the launch counts and the sum."""
    plan = build_plan(w.program("raw"), name=label, calls=w.calls("raw"))
    regions = plan.compute_regions
    est = ProfilingEstimator(program=plan.program, calls=plan.calls,
                             runs=PROFILE_RUNS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # ---- the main path: counts at 0 just before, read after ----
    for fn in COUNTERS.values():
        fn.launches = 0
    times = est.get_run_time_estimates(regions)
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    # ---- end of the main path ----
    secs = time.perf_counter() - t0
    if est.emit_failures:
        raise AssertionError(f"profile {label}: {est.emit_failures} "
                             "regions fell back to roofline")
    total = sum(times)
    big = max(range(len(times)), key=times.__getitem__)
    log(f"  {label}: {len(regions)} regions profiled on {est.system.name} "
        f"({smi}) in {secs:.1f} s, emit_failures {est.emit_failures}; sum "
        f"{total * 1e3:.3f} ms beside the measured step "
        f"{measured_s * 1e3:.3f} ms: {total / measured_s:.4f} (a finding, "
        f"not held); largest region {big} {times[big] * 1e3:.3f} ms "
        f"({len(regions[big].ops)} ops); launches {launches}")
    log(f"  {label} regions, ms in order: "
        + ", ".join(f"{t * 1e3:.3f}" for t in times))
    for sid in ("h100", "a100"):
        target = ProfilingEstimator(system=est.system, program=plan.program,
                                    target_system=default_registry().get(sid),
                                    device="cuda")
        projected = sum(target._project(r, t) for r, t in zip(regions, times))
        log(f"  {label} projected onto {sid}: {projected * 1e3:.3f} ms")
    return launches, total


def campaign_profiling(spec: dict, tmp: str, out: str,
                       cache: str | None = None) -> tuple[dict, dict]:
    """Run ``spec`` through ``python -m repro_torch.campaign run --device
    cuda`` (with ``--cache`` when given) into ``out``; returns its rows by
    job id and its summary, and raises on a non-zero exit or an error
    row."""
    path = os.path.join(tmp, f"{spec['name']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    args = [sys.executable, "-m", "repro_torch.campaign", "run", path,
            "--device", "cuda", "--executor", "serial", "--out", out,
            "--quiet"]
    if cache:
        args += ["--cache", cache]
    proc = subprocess.run(
        args, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{spec['name']}: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
    rows = {r["job_id"]: r for r in map(
        json.loads, Path(out, "results.jsonl").read_text().splitlines())}
    if any("error" in r for r in rows.values()):
        raise AssertionError(f"{spec['name']}: error rows {rows}")
    return rows, json.loads(Path(out, "summary.json").read_text())


def profile_fig10(smi: str) -> None:
    """(c) fig10's GEMMs with a ``profiling`` estimator on ``host`` and
    ``h100`` through ``python -m repro_torch.campaign run --device cuda
    --cache``, twice: the second run reads every latency from the cache
    (100% hits, no miss) and gives identical step times."""
    spec = json.loads((ROOT / "specs" / "fig10_gemm.json").read_text())
    spec.update(PROFILE_FIG10)
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i in range(2):
            t0 = time.perf_counter()
            rows, summary = campaign_profiling(
                spec, tmp, os.path.join(tmp, f"run{i}"),
                os.path.join(tmp, "hcr.jsonl"))
            cache = summary["cache"]
            runs.append(rows)
            log(f"  fig10 profiling run {i}: rc 0, "
                f"{time.perf_counter() - t0:.1f} s, {len(rows)} rows, cache "
                f"{cache['hits']} hits, {cache['misses']} misses; " + "; ".join(
                    f"{r['workload']}/{r['system']} "
                    f"{r['step_time_s'] * 1e3:.4f} ms"
                    for r in sorted(rows.values(),
                                    key=lambda r: r["job_id"])))
        if not (cache["misses"] == 0 and cache["hit_rate"] == 1.0):
            raise AssertionError(f"fig10 profiling rerun: cache {cache}")
        if {k: r["step_time_s"] for k, r in runs[0].items()} != \
                {k: r["step_time_s"] for k, r in runs[1].items()}:
            raise AssertionError("fig10 profiling rerun: step times differ")
    log(f"  fig10 profiling on {smi}: the rerun's rows are the first run's")


def profile_fig6(rank_s: float, kernel_ratio: float, smi: str) -> None:
    """(d) fig6's llama3-1b workload as checked in, with a ``profiling``
    estimator on ``host`` through ``python -m repro_torch.campaign run
    --device cuda``: the campaign's own export, at its default fidelity
    the per-rank text of [4, 1] (1 x 2048 a rank), whose attention is the
    reference's chunked text, with no K1 or K1b call.  Prints its profiled
    compute beside phase 10's measured per-rank step (which runs K1 and
    K1b) and beside (a)'s ratio for the kernel text."""
    spec = json.loads((ROOT / "specs" / "fig6_gpu.json").read_text())
    spec.update(PROFILE_FIG6)
    spec["workloads"] = [w for w in spec["workloads"]
                         if w["name"] == "llama3-1b"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rows, _ = campaign_profiling(spec, tmp, os.path.join(tmp, "out"))
    (row,) = rows.values()
    log(f"  fig6 llama3-1b profiled through the campaign on {smi} "
        f"({row['fidelity']} text, {row['toolchain']}, chunked attention): "
        f"{time.perf_counter() - t0:.1f} s, compute "
        f"{row['compute_s'] * 1e3:.3f} ms over {row['num_segments']} "
        f"segments, step {row['step_time_s'] * 1e3:.3f} ms; compute beside "
        f"phase 10's measured per-rank step {rank_s * 1e3:.3f} ms: "
        f"{row['compute_s'] / rank_s:.4f}, where (a)'s kernel text gave "
        f"{kernel_ratio:.4f} of phase 6's step (findings, not held)")


def profiling_phase(train_launches: dict, step_s: float, rank_s: float,
                    resnet_s: float, smi: str) -> dict:
    """Phase 12, (a) to (d).  Returns (a)'s launch counts, held equal to
    phase 6's launches a step: each region's eager run launches each
    operator of the text once."""
    t0 = time.perf_counter()
    cfg = get_config("llama3-1b").scaled(scan_layers=False,
                                         layer_barriers=True)
    step, args = train_step_exports(cfg, TRAIN_S, TRAIN_B)
    w = export_workload(step, *args, name="llama3-1b-barriers",
                        device="cuda")
    log(f"  (a) llama3-1b 4x2048 with a barrier after each layer: trace "
        f"{w.meta['trace_s']:.2f} s, operator nodes {w.meta['kernel_ops']}")
    launches, total = profile_regions("llama3-1b train step", w, step_s,
                                      smi)
    missing = [k for k in PROFILE_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"profile: the executor launched no {missing}")
    per_step = {k: n / TRAIN_STEPS for k, n in train_launches.items()}
    if launches != per_step:
        raise AssertionError(f"profile: launches {launches}, expected "
                             f"phase 6's a step {per_step}")
    rcfg = replace(resnet_arch_config("resnet18"), block_barriers=True)
    step, args = resnet_train_exports(rcfg, RESNET_RANK_B, RESNET_IMG)
    w = export_workload(step, *args, name="resnet18-barriers", device="cuda")
    log(f"  (b) resnet18 16x224 f16 with a barrier after each block: "
        f"trace {w.meta['trace_s']:.2f} s")
    profile_regions("resnet18 train step", w, resnet_s, smi)
    profile_fig10(smi)
    profile_fig6(rank_s, total / step_s, smi)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    return launches


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
    entry, backward = "", []
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
            name = kernel_name(entry)
            if name.startswith(("bwd_", "rmsnorm_bwd")):
                regs = line.split("Used")[1].split("registers")[0].strip()
                spill = sum(int(w) for w in spills.split()
                            if w.isdigit()) - int(spills.split()[0])
                backward.append(f"{name} {regs} registers, "
                                f"{'no spill' if not spill else spills}")
    # K1b's and K2b's entries by name (ptxas reports no register count for
    # an entry it did not rebuild: none when the library was cached)
    for line in backward:
        log(f"  K1b/K2b {line}")

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
    train_launches, step_s = train_llama(gen)
    runs.append(train_launches)
    log("[7] gradient gate and the training CLI")
    gradient_gate(gen)
    gradient_gate(gen, fan_in=True)
    train_cli()
    log("[8] export on the card")
    exported = export_on_the_card(train_launches)
    log("[9] predict on the card")
    predict_on_the_card(exported, step_s)
    log("[10] the per-rank step of a [4, 1] data mesh")
    predicted = mesh_predict(mesh_export())
    rank_launches, rank_s = rank_step(gen, predicted)
    runs.append(rank_launches)
    mesh_campaigns()
    log("[11] fig7: the data-parallel ResNet step")
    launches, one_card = fig7_phase(gen)
    runs.append(launches)
    log("[12] profiling on the card")
    runs.append(profiling_phase(train_launches, step_s, rank_s,
                                one_card["resnet18"], smi))
    # launches on the main paths: K1 and K2 run on two, three or four
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
