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
   RMSNorm; K1b and K2b, their backwards; K3 the whole SSD scan, with and
   without the chunk states it writes for its backward; K3b the scan's
   backward) against its plain PyTorch version at the serving and training
   paths' shapes and in the layout the path hands it, in bf16 and f32,
   with its time, its bound, the plain version's time and, where one
   exists, one PyTorch library call's time as a yardstick (the port never
   calls that library function); K2 also beside the time of one copy of
   its input, which the card's memory sets; K1b, K2b and K3b also launched
   twice at the training shapes, their outputs bit-identical (they use no
   atomics); K1b at phase 15's shapes (D 128, windows, gemma2's cap, GQA
   groups 2 to 8) and K2b at its widths; K1 at head_dim 80 and 160
   (phase 14's zamba2-2.7b and stablelm-12b prefills, ragged, windowed and
   capped, bidirectional) and K2 at 2560; K1 at MLA's query/key width 192
   beside a value width of 128 (phase 14's deepseek-v3-671b prefill,
   strided, and ragged with an offset), timed beside SDPA at the same
   widths (the backend torch picks named), and K2 at MLA's norms (q_norm
   1536, kv_norm 512) and at deepseek-v3's d_model 7168;
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
   attention) on fake ``cuda`` tensors, the three through the CLI in
   subprocesses started after the build (``HostWork``: host work only,
   beside phases 3 to 9);
11. fig7, the data-parallel ResNet step: (a) its four workloads
   (resnet18/34/50/101 at 64 x 224, f16, [4, 1]) exported through
   ``build_workload`` on fake ``cuda`` tensors in a fake world of 4 (in a
   subprocess started after the build with phase 10's grids; its lines
   are printed when phase 11 collects it), each
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
   step;
13. the learned estimator and the what-if search on the card: (a) the three
   checked-in grids through the port's CLIs in subprocesses started
   together (``python -m repro_torch.search run --check`` on
   ``specs/search_gemm.json`` and ``specs/search_serving.json``, ``python
   -m repro_torch.campaign report --check`` on
   ``specs/learned_fidelity.json``): each one's rc, seconds, frontier size
   and counters; then in this process, for each search spec, a brute-force
   run whose frontier equals the ladder's and a warm re-search through one
   ``Session`` with no cold miss and at least one hit; (b) a learned model
   fitted from the card: the reference tool's training GEMMs (256 to 4096,
   square, bf16) profiled on ``host`` with the profiling estimator (3
   runs), fitted, saved and loaded to the same digest, each family's
   coefficients, residual spread and samples; the held-out 8192 GEMM
   profiled and predicted (relative error, ``extrapolated`` held True);
   the six GEMMs' learned sum transferred to the catalog's ``h100`` beside
   the profiling estimator's projection of their measured times; no kernel
   launch (held); (c) (b)'s model on phase 12 (a)'s llama3-1b regions: the
   regions by family, the learned sum of those it supports beside their
   profiled times, and how many it does not (a finding, not held); (d) a
   model fitted on phase 12 (a)'s region times (which launched K1, K1b, K2
   and K2b): its families, the in-sample sum beside the profiled sum, and
   the sum transferred to ``h100`` beside phase 12 (a)'s projection;
14. other families serving, at their published widths with depth cut:
   mixtral-8x22b (4 of 56 layers; the sparse MoE, window 4096), gemma2-27b
   (8 of 46; local and global layers, tanh caps), qwen2.5-32b and
   deepseek-67b (2 layers each), and at full depth stablelm-12b (40
   layers, head_dim 160) and the hybrid zamba2-2.7b (54 Mamba2 layers in 9
   super-blocks, each closed by the shared attention block, head_dim 80;
   K3 once a Mamba2 layer, K1 once a super-block, K2 2 L + 2 n_super + 1):
   ``prefill`` on 2 prompts of 8192 tokens (K1 once a layer, K2 2L+1), and
   for mixtral, gemma2, stablelm and zamba2 ``generate`` on 8 prompts of
   64 tokens (32 new, max_len 128; K2 2L+1 a step), with the
   launch counts read around them, peak memory, the logits finite and
   shaped; each checked layer's attention output (K1 against the plain
   path on the same input) and, at each MoE layer, the share of tokens
   whose experts differ between the two (at most 1%); the logits gate of
   phase 4 on the last 64 positions of each prompt and on
   prefill-by-decode, an MoE's only on the rows that the K1, plain and f32
   runs routed alike at every layer; zamba2's first super-block held layer
   by layer (each Mamba2 output, K3 against the plain scan, then the shared
   attention's); a profile of the prefill by kernel and by op (expert
   GEMMs, other GEMMs, the MoE's data movement, K1, K2, K3); then
   deepseek-v3-671b (2 of 61 layers at its published width: MLA, K1 at
   query/key 192 and value 128, once a layer in prefill; 256 experts at
   top-8; K2 four times a layer, ln1, q_norm, kv_norm and ln2, and once at
   the end, in prefill and in each step of the absorbed-form decode over
   the compressed cache), with the same gates, its f32 walk casting the
   experts a group at a time.
   Phase 3 holds K1 at these prefills' shapes and K2 at their widths;
15. the families' training paths, each at its published width with its
   depth cut for one card (AdamW, bf16 parameters, f32 moments, updated in
   place as the reference's donated step, remat off, 2 warm-up steps and
   3 counted ones on one repeated batch): mamba2-370m (48 of 48 layers,
   4 x 2048, K3 and K3b), mixtral-8x22b (1 of 56, 1 x 8192), gemma2-27b (2
   of 46, one local and one global layer, 1 x 6144), qwen2.5-32b and
   deepseek-67b (1 layer each, 2 x 4096): step time, tokens/s, peak
   memory, the launches a step (K1 and K1b, or K3 and K3b, once a layer;
   K2 and K2b 2L + 1), a falling loss, a profile of one step by kernel
   group; the step's export on fake ``cuda`` tensors (no launch, no
   device memory, its operator nodes the launches a step) and its
   roofline prediction on ``h100`` beside the measured step; the gradient
   gate of phase 7 on the step's model with its weights redrawn at fan-in
   init (for mixtral after the share of tokens routed otherwise by the K1
   and the plain path, held at 1%, with the loss over the tokens all three
   runs routed alike).

Each check, phase and id draws its inputs and weights from a generator
seeded from its own name (``seeded``).  Each phase's seconds are printed
after it.  The last lines are one JSON
object ``{"kernels": [...]}``, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import replace
from pathlib import Path

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.campaign import (CampaignSpec, check_rows,  # noqa: E402
                                  run_campaign)
from repro_torch.campaign.builders import (  # noqa: E402
    _synthesize_gemm, build_estimator, build_topology, build_workload)
from repro_torch.campaign.report import kendall_tau, load_json  # noqa: E402
from repro_torch.campaign.spec import (EstimatorSpec,  # noqa: E402
                                      TopologySpec, WorkloadSpec)
from repro_torch.core import ir  # noqa: E402
from repro_torch.core.catalog import default_registry  # noqa: E402
from repro_torch.core.estimators import (  # noqa: E402
    LearnedEstimator, fit_model, load_model, record_profile, region_family,
    save_model)
from repro_torch.core.estimators.learned import (  # noqa: E402
    _dominant_dtype as learned_dominant_dtype)
from repro_torch.core.estimators.profiling import (  # noqa: E402
    ProfilingEstimator)
from repro_torch.core.systems import host_system  # noqa: E402
from repro_torch.core.ir.collectives import collect_collectives  # noqa: E402
from repro_torch.core.pipeline import (PredictionJob,  # noqa: E402
                                       build_plan, export_workload)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k1_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    bwd_kernel_error as k1b_error, by_kv_head, flash_attention_bwd_ref,
    flash_attention_fwd_ref, flash_attention_ref, kernel_error, lse_error)
from repro_torch.kernels.rmsnorm import ops as k2_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    bwd_kernel_error as k2b_error, kernel_error as rmsnorm_error,
    rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.ssd_scan import ops as k3_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_scan, ssd_scan_bwd)
from repro_torch.launch.mesh import traced_mesh  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    bwd_kernel_error as k3b_error, kernel_error as ssd_error,
    ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import mlp as model_mlp  # noqa: E402
from repro_torch.models.mlp import (_capacity as moe_capacity,  # noqa: E402
                                    moe_dispatch)
from repro_torch.models.attention import (gqa_forward,  # noqa: E402
                                          mla_forward)
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.resnet import (make_resnet_train_step,  # noqa: E402
                                       resnet_arch_config, resnet_specs,
                                       resnet_train_exports)
from repro_torch.models.ssm import mamba2_forward  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _layer_window, _logits, _positions, _scan_layers, _super_blocks,
    _unstack, attn_block, ffn, ssm_block)
from repro_torch.models.transformer import (TransformerLM, _embed,  # noqa: E402
                                            decode_step, init_cache_specs,
                                            model_specs, prefill)
from repro_torch.models.params import (abstract_params,  # noqa: E402
                                       init_params, param_count,
                                       shard_params, trainable, tree_paths)
from repro_torch.train.checkpoint import _flatten as flatten  # noqa: E402
from repro_torch.train.data import (DataConfig, ShardedLoader,  # noqa: E402
                                    SyntheticSource)
from repro_torch.train.loop import (  # noqa: E402
    _value_and_grad as value_and_grad, make_train_step, train_step_exports)
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig, adamw_init, adamw_update, tree_leaves)
from repro_torch.train.optimizer import tree_map as map_leaves  # noqa: E402

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
# MLA's absorbed-form decode in f32 against the plain prefill walk in f32,
# in units of the largest logit (measured 8.55e-5 to 1.03e-4 on the H100)
MLA_DECODE_TOL = 1e-3


def seeded(name: str) -> torch.Generator:
    """A CUDA generator seeded from ``name``: each check, phase and id
    draws its inputs and weights from its own, so that adding a case or an
    id moves no other check's or phase's draws."""
    return torch.Generator(device="cuda").manual_seed(
        zlib.crc32(name.encode()))


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
    """``bwd_dkdv_ws<64>``, ``rmsnorm_bwd_groups<bf16>`` or
    ``bwd_state_scan`` from the mangled entry name of one of the backward
    kernels (K1b, K2b, K3b), ``flash_fwd_bf16<192, 128>`` (its query/key
    and value widths) from one of K1's; other names unchanged."""
    import re
    fwd = re.search(r"(flash_fwd_(?:bf16|f32))ILi(\d+)ELi(\d+)E", mangled)
    if fwd:
        return f"{fwd[1]}<{fwd[2]}, {fwd[3]}>"
    m = re.search(r"((?:rmsnorm_)?bwd_[a-z]+(?:_[a-z0-9]+)?)I(.*?)EEv",
                  mangled)
    if not m:
        plain = re.search(r"\d((?:rmsnorm_)?bwd_[a-z0-9_]+)E", mangled)
        return plain[1] if plain else mangled
    return m[1] + "<" + ", ".join(
        a or ("bf16" if b else "f32")
        for a, b in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|f", m[2])) + ">"


def kernel_fn(key: str) -> str:
    """The function of a kernel from its ``torch.profiler`` key:
    ``rmsnorm_bwd_groups`` from ``void (anonymous namespace)::
    rmsnorm_bwd_groups<__nv_bfloat16>(...)``; other keys unchanged."""
    import re
    m = re.search(r"::(\w+)\s*[<(]", key)
    return m[1] if m else key


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

K1_CASES = [  # name, B, Hq, Hkv, Sq, Skv, D, Dv, causal, window, cap,
    #            q_offset
    ("prefill", 4, 32, 8, 2048, 2048, 64, 64, True, 0, 0.0, 0),
    # the layout gqa_forward passes: [B, S, H, D] projections seen as
    # [B, H, S, D] through .transpose(1, 2)
    ("prefill_bshd", 4, 32, 8, 2048, 2048, 64, 64, True, 0, 0.0, 0),
    # phase 10's per-rank step: one rank's 1 x 2048 of llama3-1b on [4, 1]
    ("rank_bshd", 1, 32, 8, 2048, 2048, 64, 64, True, 0, 0.0, 0),
    ("ragged", 2, 32, 8, 1000, 1000, 64, 64, True, 0, 0.0, 0),
    ("window", 1, 32, 8, 2048, 2048, 64, 64, True, 256, 0.0, 0),
    ("cap_offset", 2, 8, 2, 100, 612, 64, 64, True, 0, 30.0, 512),
    ("bidir_d32", 2, 4, 4, 300, 333, 32, 32, False, 0, 0.0, 0),
    ("d128", 1, 8, 2, 256, 256, 128, 128, True, 0, 0.0, 0),
    # d=128 (two swizzled column blocks) in the strided layout, ragged
    # across 128-row and 128-key tiles, Sq < Skv
    ("d128_bshd", 1, 8, 2, 1000, 1111, 128, 128, True, 0, 0.0, 111),
    # phase 14's prefills (one of their two prompts) at 8192 tokens and
    # D 128 in the strided layout: mixtral's window of 4096 (48/8 heads),
    # gemma2's local layer (window 4096) and global layer, both with the
    # tanh cap of 50 (32/16 heads)
    ("mixtral_bshd", 1, 48, 8, 8192, 8192, 128, 128, True, 4096, 0.0, 0),
    ("gemma2_local_bshd", 1, 32, 16, 8192, 8192, 128, 128, True, 4096, 50.0,
     0),
    ("gemma2_global_bshd", 1, 32, 16, 8192, 8192, 128, 128, True, 0, 50.0,
     0),
    # phase 14's full-depth prefills at the head widths that are not a
    # multiple of 64: stablelm-12b's 160 (32/8 heads; five 32-column blocks,
    # 64-key tiles) and zamba2-2.7b's shared block at 80 (32/32 heads; padded
    # to 96 inside the kernel), in the strided layout
    ("stablelm_bshd", 1, 32, 8, 8192, 8192, 160, 160, True, 0, 0.0, 0),
    ("zamba2_bshd", 1, 32, 32, 8192, 8192, 80, 80, True, 0, 0.0, 0),
    # both widths ragged across 128-row and key tiles, Sq < Skv, an offset
    ("d160_ragged_bshd", 1, 8, 2, 1000, 1111, 160, 160, True, 0, 0.0, 111),
    ("d80_ragged_bshd", 1, 8, 2, 1000, 1111, 80, 80, True, 0, 0.0, 111),
    # the masks' other branches at both widths: a window and a tanh cap,
    # and no causal mask
    ("d160_window_cap", 2, 8, 4, 700, 700, 160, 160, True, 200, 30.0, 0),
    ("d80_bidir", 2, 4, 4, 300, 333, 80, 80, False, 0, 0.0, 0),
    # phase 14's deepseek-v3-671b prefill (one of its two prompts): MLA's
    # query/key width 192 (three 64-column blocks, 64-key tiles) beside a
    # value width of 128, 128 heads, in the strided layout mla_forward
    # passes; and ragged across 128-row items and 64-key tiles, Sq < Skv,
    # an offset
    ("mla_bshd", 1, 128, 128, 8192, 8192, 192, 128, True, 0, 0.0, 0),
    ("mla_ragged_bshd", 1, 8, 8, 1000, 1111, 192, 128, True, 0, 0.0, 111),
]
# the cases at head_dim 80 and 160, and at MLA's pair (tools/mutate_k1.py
# runs these alone)
K1_NEW_WIDTHS = ("stablelm_bshd", "zamba2_bshd", "d160_ragged_bshd",
                 "d80_ragged_bshd", "d160_window_cap", "d80_bidir")
K1_MLA = ("mla_bshd", "mla_ragged_bshd")
# the rows timed beside their bound (bf16; "prefill" in f32 too)
K1_TIMED = ("prefill", "mixtral_bshd", "gemma2_local_bshd",
            "gemma2_global_bshd", "stablelm_bshd", "zamba2_bshd", "mla_bshd")


def k1_inputs(gen, name, b, hq, hkv, sq, skv, d, dtype, dv=None):
    """q, k ([..., d]) and v ([..., dv], d by default), [B, H, S, *] or, for
    a name ending in _bshd, [B, S, H, *] seen through .transpose(1, 2)."""
    def randn(h, s, w):
        if name.endswith("_bshd"):
            return torch.randn(b, s, h, w, generator=gen, device="cuda"
                               ).to(dtype).transpose(1, 2)
        return torch.randn(b, h, s, w, generator=gen, device="cuda").to(dtype)
    return randn(hq, sq, d), randn(hkv, skv, d), randn(hkv, skv, dv or d)


def k1_library_ms(q, k, v, causal, window, cap, q_offset):
    """One SDPA call computing what K1 computes, timed (a yardstick the
    port never calls): causal, or a boolean mask for a window (with K and
    V repeated over the query heads, outside the timing, so that the
    memory-efficient kernel takes the mask); None with a tanh cap, which
    no PyTorch call applies."""
    if cap > 0 or q_offset or not causal:
        return None
    if not window:
        gqa = q.shape[1] != k.shape[1]
        return device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=gqa))
    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (k, v))
    diff = (torch.arange(q.shape[2], device=q.device)[:, None]
            - torch.arange(k.shape[2], device=q.device)[None, :])
    mask = (diff >= 0) & (diff < window)
    ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask))
    del kr, vr, mask
    return ms


def sdpa_backend(q, k, v) -> str:
    """The backend one causal SDPA call takes on these inputs: the first of
    torch's priority order that runs when it is the only one allowed, as
    torch's own selection does.  (No profiler here: one more profiled call
    in phase 3 left a later one, K2b's route, without its kernel records.)"""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = q.shape[1] != k.shape[1]
    for code in torch._C._get_sdp_priority_order():
        backend = SDPBackend(code)
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=gqa)
        except RuntimeError:
            continue
        torch.cuda.synchronize()
        return backend.name
    return "none"


def k1_visible_pairs(sq, skv, causal, window, q_offset) -> int:
    diff = (torch.arange(sq, device="cuda")[:, None] + q_offset
            - torch.arange(skv, device="cuda")[None, :])
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return int(mask.sum())


def check_k1(gen, names=None) -> dict:
    """Each K1 case (those in ``names`` only, untimed, when given) in bf16
    and f32 against the plain version; the K1_TIMED rows timed."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for (name, b, hq, hkv, sq, skv, d, dv, causal, window, cap,
             off) in K1_CASES:
            if names is not None and name not in names:
                continue
            q, k, v = k1_inputs(gen, name, b, hq, hkv, sq, skv, d, dtype, dv)
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
                f"Sq={sq} Skv={skv} d={d} dv={dv} max_abs_err={err:.3e}; in "
                f"units of "
                f"the tolerance: element {elem:.3f}, row {row:.3f}; lse "
                f"{lse_err:.3e} ({lse_ratio:.3f} of LSE_ATOL), output with "
                f"lse {'identical' if same else 'DIFFERENT'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} {dtype}: max abs err {err}, "
                                     f"element {elem}, row {row} of tol, lse "
                                     f"{lse_ratio} of tol, same {same}")
            if names is not None or name not in K1_TIMED or (
                    name != "prefill" and dtype != torch.bfloat16):
                continue
            # null lse: the serving path's launch
            ms = device_ms(lambda: flash_attention(q, k, v, **kw))
            lse_ms = device_ms(lambda: k1_ops._forward(q, k, v, with_lse=True,
                                                       **kw))
            # the plain version; at 8192 tokens a KV head's group at a time
            # (the f32 scores of all heads at once would not fit)
            plain_ms = device_ms((lambda: flash_attention_ref(q, k, v, **kw))
                                 if name == "prefill" else (lambda: [
                                     flash_attention_ref(qh, kh, vh, **kw)
                                     for _, qh, kh, vh in by_kv_head(q, k, v)]),
                                 batches=3, per_batch=2)
            lib_ms = k1_library_ms(q, k, v, causal, window, cap, off)
            if dv != d and lib_ms is not None:
                log(f"  K1 {name}: SDPA at Ev={dv} takes the "
                    f"{sdpa_backend(q, k, v)} backend")
            scores = k1_visible_pairs(sq, skv, causal, window, off) * b * hq
            # Q K^T over d columns and P V over dv, 2 operations a product
            flops = 2 * (d + dv) * scores
            nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K1 {name} {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"SDPA {'none (a tanh cap)' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                f"bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
                f"exponential floor {scores / EXP_RATE * 1e3:.4f} ms "
                f"({scores / 1e6:.1f} M visible scores); writing lse "
                f"{lse_ms:.4f} ms")
            if dtype == torch.bfloat16 and name == "prefill":
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
    # phase 14's prefills (2 x 8192 tokens) and decode steps (8 rows)
    ("mixtral", 16384, 6144, 0.0),
    ("mixtral_decode", 8, 6144, 0.0),
    ("gemma2", 16384, 4608, 0.0),
    ("gemma2_decode", 8, 4608, 0.0),
    ("qwen2.5", 16384, 5120, 0.0),
    ("deepseek", 16384, 8192, 0.0),
    # zamba2-2.7b's d_model (its d_inner, 5120, is qwen2.5's width)
    ("zamba2", 16384, 2560, 0.0),
    ("zamba2_decode", 8, 2560, 0.0),
    # deepseek-v3-671b's d_model (ln1, ln2, the final norm) and its MLA
    # norms: q_norm over the 1536-wide query latent and kv_norm over the
    # 512-wide key/value latent (copied out of each 576-wide projection
    # row), at the prefill's 2 x 8192 rows
    ("deepseek-v3", 16384, 7168, 0.0),
    ("deepseek-v3_decode", 8, 7168, 0.0),
    ("mla_q_norm", 16384, 1536, 0.0),
    ("mla_kv_norm", 16384, 512, 0.0),
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
    # stablelm-12b's 160 (five 32-column blocks) and zamba2-2.7b's 80
    # (padded to 96 in shared memory): a window, no causal mask, a strong
    # cap, ragged across the 128-row and 128-key items with an offset
    ("window_d160", 1, 8, 2, 700, 700, 160, True, 100, 0.0, 0),
    ("bidir_d80", 2, 4, 4, 300, 333, 80, False, 0, 0.0, 0),
    ("cap_d80_bshd", 2, 8, 8, 300, 300, 80, True, 0, 1.0, 0),
    ("ragged_d160_bshd", 1, 8, 2, 1000, 1111, 160, True, 0, 0.0, 111),
    ("ragged_d80_bshd", 1, 8, 2, 1000, 1111, 80, True, 0, 0.0, 111),
]
# the cases at head_dim 80 and 160 (tools/mutate_k1b.py --widths runs these
# alone)
K1B_NEW_WIDTHS = ("window_d160", "bidir_d80", "cap_d80_bshd",
                  "ragged_d160_bshd", "ragged_d80_bshd")


def check_k1b(gen, names=None) -> dict:
    """K1b against the plain backward in double, on K1's lse and the plain
    forward's output (the cases in ``names`` only, untimed, when given).
    Times at ``train``: the kernel, the plain backward (f32), and SDPA's
    backward as the yardstick."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, sq, skv, d, causal, window, cap, off in \
                K1B_CASES:
            if names is not None and name not in names:
                continue
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
            if name != "train" or names is not None:
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


K1B_FAMILY_CASES = [  # name, B, Hq, Hkv, S, window, cap, D
    # phase 15's train steps, in the strided [B, S, H, D] layout the
    # training path hands K1b: mixtral-8x22b's window, gemma2-27b's local
    # and global layers with its tanh cap of 50, qwen2.5-32b's and
    # deepseek-67b's groups of 5 and 8 (D 128); stablelm-12b's D 160 (group
    # 4) and zamba2-2.7b's shared block at D 80 (group 1)
    ("mixtral", 1, 48, 8, 8192, 4096, 0.0, 128),
    ("gemma2_local", 1, 32, 16, 8192, 4096, 50.0, 128),
    ("gemma2_global", 1, 32, 16, 8192, 0, 50.0, 128),
    ("qwen2.5", 2, 40, 8, 4096, 0, 0.0, 128),
    ("deepseek", 2, 64, 8, 4096, 0, 0.0, 128),
    ("stablelm", 2, 32, 8, 4096, 0, 0.0, 160),
    ("zamba2", 2, 32, 32, 4096, 0, 0.0, 80),
]
# the family cases held in f32 too (untimed): the new head widths
K1B_FAMILY_F32 = ("stablelm", "zamba2")


def k1b_error_by_head(grads, q, k, v, o, lse, do, **kw):
    """``k1b_error`` one KV head's group at a time: at 8192 tokens the
    double scores of all heads at once would not fit."""
    dq, dk, dv = grads
    worst = [(0.0, 0.0, 0.0)] * 3
    for heads, qh, kh, vh in by_kv_head(q, k, v):
        h = heads.start // (heads.stop - heads.start)
        errs = k1b_error((dq[:, heads], dk[:, h:h + 1], dv[:, h:h + 1]),
                         qh, kh, vh, o[:, heads], lse[:, heads],
                         do[:, heads], **kw)
        worst = [tuple(max(a, b) for a, b in zip(w, e))
                 for w, e in zip(worst, errs)]
        torch.cuda.empty_cache()
    return worst


def k1b_library_ms(q, k, v, do, window, cap):
    """One SDPA call's backward computing what K1b computes (causal, or a
    boolean mask for a window with K and V repeated over the query heads),
    timed; None with a tanh cap."""
    if cap > 0:
        return None
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    if window:
        g = q.shape[1] // k.shape[1]
        kr, vr = (t.repeat_interleave(g, dim=1) for t in (lk, lv))
        diff = (torch.arange(q.shape[2], device=q.device)[:, None]
                - torch.arange(k.shape[2], device=q.device)[None, :])
        out = F.scaled_dot_product_attention(
            lq, kr, vr, attn_mask=(diff >= 0) & (diff < window))
    else:
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                             enable_gqa=True)
    ms = device_ms(lambda: torch.autograd.grad(out, (lq, lk, lv), do,
                                               retain_graph=True),
                   batches=3, per_batch=3)
    del out, lq, lk, lv
    torch.cuda.empty_cache()
    return ms


def check_k1b_families(gen) -> None:
    """K1b at phase 15's shapes (bf16): against the plain backward in
    double, a second launch's bits, its time beside its bound, the plain
    backward's (a KV head's group at a time) and SDPA's backward; the
    K1B_FAMILY_F32 cases then in f32 against the plain backward, untimed.
    Prints each case's seconds."""
    runs = [(case, torch.bfloat16) for case in K1B_FAMILY_CASES] + [
        (case, torch.float32) for case in K1B_FAMILY_CASES
        if case[0] in K1B_FAMILY_F32]
    for (name, b, hq, hkv, s, window, cap, d), dtype in runs:
        t0 = time.perf_counter()
        kw = dict(causal=True, window=window, logit_cap=cap, q_offset=0)
        q, k, v = k1_inputs(gen, "x_bshd", b, hq, hkv, s, s, d, dtype)
        do, _, _ = k1_inputs(gen, "x_bshd", b, hq, hkv, s, s, d, dtype)
        o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
        errs = k1b_error_by_head(grads, q, k, v, o, lse, do, **kw)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        worst = max(max(e[1], e[2]) for e in errs)
        ok = finite and same and math.isfinite(worst) and worst <= 1.0
        held = (f"  K1b {name:<13} {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} "
                f"S={s} d={d} window {window} cap {cap:g}; max_abs_err, "
                "element and row in units of the tolerance: " + "; ".join(
                    f"d{n} {e[0]:.3e} {e[1]:.3f} {e[2]:.3f}"
                    for n, e in zip("qkv", errs))
                + f"; a second launch "
                f"{'bit-identical' if same else 'DIFFERENT'}")
        if dtype != torch.bfloat16:
            log(f"{held} {'ok' if ok else 'FAIL'} "
                f"({time.perf_counter() - t0:.1f} s)")
            if not ok:
                raise AssertionError(f"K1b {name} {dtype}: {errs}, finite "
                                     f"{finite}, bit-identical {same}")
            del q, k, v, o, lse, do, grads
            torch.cuda.empty_cache()
            continue
        ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                       batches=3, per_batch=5)
        plain_ms = device_ms(lambda: [
            flash_attention_bwd_ref(qh, kh, vh, o[:, hs], lse[:, hs],
                                    do[:, hs], **kw)
            for hs, qh, kh, vh in by_kv_head(q, k, v)], batches=2,
            per_batch=1)
        lib_ms = k1b_library_ms(q, k, v, do, window, cap)
        pairs = k1_visible_pairs(s, s, True, window, 0) * b * hq
        flops = 5 * 2 * d * pairs
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, o, do, lse, *grads))
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        log(f"{held}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, SDPA backward "
            f"{'none (a tanh cap)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f", bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.2f} MB; {card()}) "
            f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"K1b {name}: {errs}, finite {finite}, "
                                 f"bit-identical {same}")
        del q, k, v, o, lse, do, grads
        torch.cuda.empty_cache()


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
    # phase 15's train steps (8192 tokens each): mixtral-8x22b, gemma2-27b
    # with its (1 + w), qwen2.5-32b, deepseek-67b
    ("mixtral", 8192, 6144, 0.0),
    ("gemma2", 8192, 4608, 1.0),
    ("qwen2.5", 8192, 5120, 0.0),
    ("deepseek", 8192, 8192, 0.0),
    # zamba2-2.7b's norms at 2 x 4096 (3 groups of 160 threads a block)
    ("zamba2", 8192, 2560, 0.0),
]
K2B_TIMED = ("train", "mamba_ln", "decode", "mixtral", "gemma2", "qwen2.5",
             "deepseek", "zamba2")


def k2b_route(fn) -> str:
    """The row kernel one call of ``fn`` launches (``torch.profiler``):
    rmsnorm_bwd_groups or rmsnorm_bwd_block."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {kernel_fn(e.key) for e in prof.key_averages()
             if e.device_type.name == "CUDA"}
    return "/".join(sorted(n for n in names if n != "rmsnorm_bwd_dw"))


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
            if name != "decode":
                again = rmsnorm_bwd(x, w, dy, 1e-5, offset)
                same = torch.equal(dx, again[0]) and torch.equal(dw, again[1])
                log(f"  K2b {name} {str(dtype)[6:]}: a second launch's dx "
                    f"and dw {'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    raise AssertionError(f"K2b {name} {dtype}: two launches "
                                         "differ")
            ms = device_ms(lambda: rmsnorm_bwd(x, w, dy, 1e-5, offset))
            plain_ms = device_ms(lambda: rmsnorm_bwd_ref(x, w, dy, 1e-5,
                                                         offset))
            lx, lw = (t.detach().requires_grad_(True) for t in (x, w))
            y = F.rms_norm(lx, (d,), lw, 1e-5)
            lib_ms = device_ms(lambda: torch.autograd.grad(
                y, (lx, lw), dy, retain_graph=True))
            flops = 8 * x.numel()
            nbytes = (3 * x.numel() * x.element_size()
                      + 2 * w.numel() * w.element_size())
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            route = k2b_route(lambda: rmsnorm_bwd(x, w, dy, 1e-5, offset))
            log(f"  K2b {name} {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({route}), plain {plain_ms:.4f} ms, F.rms_norm backward "
                f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{nbytes / 1e6:.2f} MB)")
            # bf16 rows of 1024 .. 8192 in steps of 512: 64 .. 512 threads
            if (dtype == torch.bfloat16 and d % 512 == 0 and 1024 <= d <= 8192
                    and route != "rmsnorm_bwd_groups"):
                raise AssertionError(f"K2b {name} {dtype}: {route}, not the "
                                     "groups kernel")
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
            # the launch of the training path, which also writes each
            # chunk's inbound state: y and the final state unchanged
            y2, final2, states = k3_ops._launch(*args, chunk, st0,
                                                with_states=True)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(final, final2)):
                raise AssertionError(f"K3 {name} {dtype}: writing the states "
                                     "changed y or the final state")
            err, elem, row = ssd_error(y, final, *args, chunk, st0, states)
            del y2, final2, states
            ok = all(math.isfinite(v) for v in (err, elem, row)) and max(
                elem, row) <= 1.0
            min_dacs = (dt * a).reshape(b, s // chunk, chunk,
                                        h).cumsum(2).min()
            log(f"  K3 {name:<15} {str(dtype)[6:]:<8} B={b} S={s} H={h} "
                f"P={p} G={g} N={n} L={chunk} min dacs "
                f"{min_dacs.item():.0f} max_abs_err={err:.3e} (y, final "
                f"state, inbound states); in units of the tolerance: element "
                f"{elem:.3f}, row {row:.3f} "
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


# K3b's bf16 kernels (torch.profiler and ptxas names), in launch order
K3B_KERNELS = ["bwd_states_wg", "bwd_chunk_ws", "bwd_reduce"]
K3B_CASES = [  # name, B, S, H, P, G, N, chunk, strided, init, dfinal, decay
    # mamba2-370m's train step at 4 x 2048, in the layout mamba2_forward
    # passes (x, B and C column slices of the conv output)
    ("train", 4, 2048, 32, 64, 1, 128, 256, True, False, False, "mamba"),
    ("train_contiguous", 4, 2048, 32, 64, 1, 128, 256, False, False, False,
     "mamba"),
    ("init_dfinal", 2, 1024, 32, 64, 1, 128, 256, True, True, True, "mamba"),
    ("groups2", 1, 256, 8, 64, 2, 32, 64, True, True, True, "mamba"),
    ("p32_n64", 2, 512, 8, 32, 2, 64, 128, True, False, True, "mamba"),
    ("strong_decay", 2, 1024, 32, 64, 1, 128, 256, True, False, False,
     "strong"),
    # zamba2-2.7b's train step at 2 x 4096: 80 heads, state 64
    ("zamba2", 2, 4096, 80, 64, 1, 64, 256, True, False, False, "mamba"),
]
# the cases timed and launched twice (bf16; "train" in f32 too)
K3B_TIMED = ("train", "zamba2")


def k3b_work(b, s, h, p, n, chunk) -> int:
    """K3b's flops: per (batch, head, chunk) the visible pairs of C B^T,
    dy x^T, the dx, dC and dB products, 2 pairs (3 N + 2 P), and the four
    state products (G B, G^T x, S^T dy and the chunk's dy (x) C), 8 L N P."""
    pairs = chunk * (chunk + 1) // 2
    return b * h * (s // chunk) * (2 * pairs * (3 * n + 2 * p)
                                   + 8 * chunk * n * p)


def k3b_split(fn, launches: int = 3) -> list[tuple[str, float]]:
    """The device time a launch of each of K3b's kernels, from
    ``torch.profiler`` over ``launches`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        name = next((k for k in K3B_KERNELS if k in e.key), None)
        if e.device_type.name == "CUDA" and name is not None:
            times[name] = (times.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / launches)
    return [(k, times[k]) for k in K3B_KERNELS if k in times]


def check_k3b(gen, names=None) -> dict:
    """K3b against ``ssd_scan_bwd_ref`` in double, on the inbound states K3
    wrote: dx, ddt, da, dB, dC and the initial state's gradient; at
    ``train`` also a second launch's bits and the times (no PyTorch call
    computes the scan's backward: library "none")."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for (name, b, s, h, p, g, n, chunk, strided, init, dfin,
             decay) in K3B_CASES:
            if names is not None and name not in names:
                continue
            x, dt, a, bm, cm, st0 = k3_inputs(gen, b, s, h, p, g, n, chunk,
                                              strided, init, decay, dtype)
            args = (x, dt, a, bm, cm)
            _, _, states = k3_ops._launch(*args, chunk, st0, with_states=True)
            dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
            dfinal = (torch.randn(b, h, p, n, generator=gen, device="cuda")
                      if dfin else None)
            kw = dict(chunk=chunk, initial_state=st0, dfinal=dfinal)
            grads = ssd_scan_bwd(*args, states, dy, **kw)
            torch.cuda.synchronize()
            errs = k3b_error(grads, *args, chunk, st0, dy, dfinal)
            finite = all(bool(torch.isfinite(t).all()) for t in grads)
            worst = max(max(e[1], e[2]) for e in errs)
            ok = finite and math.isfinite(worst) and worst <= 1.0
            log(f"  K3b {name:<16} {str(dtype)[6:]:<8} B={b} S={s} H={h} "
                f"P={p} G={g} N={n} L={chunk}; max_abs_err, element and row "
                "in units of the tolerance: " + "; ".join(
                    f"{k} {e[0]:.3e} {e[1]:.3f} {e[2]:.3f}" for k, e in zip(
                        ("dx", "ddt", "da", "dB", "dC", "dinit"), errs))
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3b {name} {dtype}: {errs}, finite "
                                     f"{finite}")
            if name not in K3B_TIMED or (name != "train"
                                         and dtype != torch.bfloat16):
                continue
            again = ssd_scan_bwd(*args, states, dy, **kw)
            same = all(torch.equal(u, v) for u, v in zip(grads, again))
            log(f"  K3b {name} {str(dtype)[6:]}: a second launch's six "
                f"gradients {'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"K3b {name} {dtype}: two launches "
                                     "differ")
            del again
            ms = device_ms(lambda: ssd_scan_bwd(*args, states, dy, **kw),
                           batches=3, per_batch=3)
            plain_ms = device_ms(lambda: ssd_scan_bwd_ref(
                *args, chunk, st0, states, dy, dfinal), batches=3,
                per_batch=1)
            flops = k3b_work(b, s, h, p, n, chunk)
            nbytes = sum(t.numel() * t.element_size() for t in (
                *args, states, dy, *grads))
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            log(f"  K3b {name} {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"no library call; bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
            if dtype == torch.bfloat16:
                log(f"  K3b {name} bfloat16 by kernel (torch.profiler, a "
                    "launch): " + "; ".join(
                        f"{k} {v:.4f} ms" for k, v in k3b_split(
                            lambda: ssd_scan_bwd(*args, states, dy, **kw))))
            if dtype == torch.bfloat16 and name == "train":
                entry = {"name": "ssd_scan_bwd", "route": "cuda",
                         "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
                         "replaces": "none on the TPU (jax.grad of src/repro/models/ssm.py:58, ssd_chunked)",
                         "launches": None,
                         "max_abs_err": max(e[0] for e in errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
            del grads, states, dy
            torch.cuda.empty_cache()
    return entry


# --------------------------------------------------------------------------
# phase 4: the serving paths at full width
# --------------------------------------------------------------------------

def max_rel_diff(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (a.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


COUNTERS = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "ssd_scan": ssd_scan, "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm_bwd": rmsnorm_bwd, "ssd_scan_bwd": ssd_scan_bwd}


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
        check_family_layers(cfg, chunked, params, prompts)
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


def check_ssm_layer(cfg, chunked, params, prompts) -> None:
    """The first layer's Mamba2 output (``mamba2_forward``, which hands K3
    column slices of its conv output) from the K3 path against the plain
    chunked path on the same bf16 inputs, held row by row."""
    lp = {k: t[0] for k, t in params["layers"]["ssm"].items()}
    x = rms_norm(_embed(cfg, params, {"tokens": prompts}),
                 params["layers"]["ln"][0], cfg.rms_eps)
    hold_rows("layer 0 Mamba2 output", mamba2_forward(cfg, lp, x)[0],
              mamba2_forward(chunked, lp, x)[0])


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


def hold_rows(name: str, out, plain) -> None:
    """One layer's output ``out`` against the plain path's ``plain`` on the
    same input: the largest row error norm, held at LAYER_ROW_TOL of the
    row's norm."""
    out, plain = out.float(), plain.float()
    row = ((out - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
    log(f"  {name} {out.shape[0]}x{out.shape[1]}, kernel path against the "
        f"plain path: largest row error {row:.3e} of the row's norm (tol "
        f"{LAYER_ROW_TOL:g})")
    if not row <= LAYER_ROW_TOL:
        raise AssertionError(f"{name}: row error {row}")


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
    model-width axes that the product contracts, after the layer and
    expert axes (two for ``wo``, whose input is heads x head_dim; one for
    the rest)."""
    for name, spec in tree_paths(specs).items():
        if spec.init != "scaled":
            continue
        first = 0
        while spec.axes[first] in ("layers", "experts"):
            first += 1
        width = math.prod(spec.shape[first:first + (
            2 if name.endswith("/wo") else 1)])
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node[key]
        with torch.no_grad():
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


CLI_GRIDS = ("fig6_gpu.json", "fig9_scaleout.json", "fig11_tpu.json")


class HostWork:
    """Phase 10 (d)'s three grids through the campaign CLI and phase 11
    (a)'s ResNet exports (``fig7_export_to``), each in a subprocess started
    right after the build: all four are host work (traces on fake ``cuda``
    tensors, 2.5 to 4.5 minutes each), nothing in them is timed or
    launches a kernel, and they run while phases 3 to 9 drive the card, at
    a lower scheduling priority than this process (``nice`` 10).  Use it
    as a context manager: the subprocesses still running on the way out
    are stopped."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory()
        self.tmp = self._tmp.name
        self.t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        run = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT, text=True,
                   preexec_fn=lambda: os.nice(10))
        self.procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.campaign", "run",
             str(ROOT / "specs" / name), "--device", "cuda", "--executor",
             "serial", "--out", os.path.join(self.tmp, name), "--quiet"],
            **run) for name in CLI_GRIDS}
        self.procs["fig7"] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke as c; c.fig7_export_to("
             "sys.argv[2])", str(ROOT), os.path.join(self.tmp, "fig7.pkl")],
            **run)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self._tmp.cleanup()

    def wait(self, name: str) -> str:
        """Waits for ``name``'s subprocess; its output (raises unless it
        exited 0)."""
        t1 = time.perf_counter()
        proc = self.procs[name]
        out, _ = proc.communicate(timeout=1200)
        log(f"  {name}: waited {time.perf_counter() - t1:.1f} s, done "
            f"{time.perf_counter() - self.t0:.1f} s after the start")
        if proc.returncode != 0:
            raise AssertionError(f"{name}: rc {proc.returncode}\n{out}")
        return out

    def rows(self, name: str) -> list:
        self.wait(name)
        return [json.loads(line) for line in Path(
            self.tmp, name, "results.jsonl").read_text().splitlines()]

    def fig7(self) -> dict:
        for line in self.wait("fig7").splitlines():
            log(line)
        with open(os.path.join(self.tmp, "fig7.pkl"), "rb") as f:
            return pickle.load(f)


def mesh_campaigns(host: HostWork) -> None:
    """(d) fig6, fig11 and fig9 as checked in, exported by the campaign on
    fake ``cuda`` tensors: per fig6 workload and fidelity the four
    systems, and per fig11 estimator the four workloads, rank as the
    golden's rows of that fidelity do, and each fig11 mixed row lies below
    its roofline row; fig9's rows are printed beside the golden's.  The
    three run through the CLI in ``host``'s subprocesses: each is its
    exports' host work (llama2-7b's four traces take about four minutes),
    and nothing in any of them is timed."""
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

    grids = {name: host.rows(name) for name in CLI_GRIDS}
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


def fig7_export_to(path: str) -> None:
    """(a) in a process of its own (``HostWork``): the four exports and
    their checks, the workloads pickled to ``path``."""
    t0 = time.perf_counter()
    workloads = fig7_export()
    with open(path, "wb") as f:
        pickle.dump(workloads, f)
    log(f"  (a) {time.perf_counter() - t0:.1f} s in its own process")


def fig7_phase(gen, workloads: dict) -> tuple[dict, dict]:
    """Phase 11, (b) to (d), on (a)'s workloads.  Returns (b)'s launch
    counts and one-card median steps."""
    t0 = time.perf_counter()
    launches, one_card = fig7_rank_steps(gen, workloads)
    log(f"  (b) {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    fig7_campaign(workloads)
    log(f"  (c) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    campaign_cli()
    log(f"  (d) {time.perf_counter() - t1:.1f} s")
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
    ``emit_failures == 0``.  Returns the launch counts, the sum, the
    regions, their times and the sum projected onto ``h100``."""
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
    projected = {}
    for sid in ("h100", "a100"):
        target = ProfilingEstimator(system=est.system, program=plan.program,
                                    target_system=default_registry().get(sid),
                                    device="cuda")
        projected[sid] = sum(target._project(r, t)
                             for r, t in zip(regions, times))
        log(f"  {label} projected onto {sid}: "
            f"{projected[sid] * 1e3:.3f} ms")
    return launches, total, regions, times, projected["h100"]


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
                    resnet_s: float, smi: str) -> tuple[dict, tuple]:
    """Phase 12, (a) to (d).  Returns (a)'s launch counts, held equal to
    phase 6's launches a step (each region's eager run launches each
    operator of the text once), and (a)'s regions, their times and their
    sum projected onto ``h100``, which phase 13 fits on."""
    cfg = get_config("llama3-1b").scaled(scan_layers=False,
                                         layer_barriers=True)
    step, args = train_step_exports(cfg, TRAIN_S, TRAIN_B)
    w = export_workload(step, *args, name="llama3-1b-barriers",
                        device="cuda")
    log(f"  (a) llama3-1b 4x2048 with a barrier after each layer: trace "
        f"{w.meta['trace_s']:.2f} s, operator nodes {w.meta['kernel_ops']}")
    launches, total, *profiled = profile_regions("llama3-1b train step", w,
                                                 step_s, smi)
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
    return launches, tuple(profiled)


# --------------------------------------------------------------------------
# phase 13: the learned estimator and the what-if search on the card
# --------------------------------------------------------------------------

# the reference tool's training GEMMs (square, bf16), and one held out
# above their range
LEARNED_GEMMS = (256, 512, 1024, 2048, 4096)
LEARNED_HELD_OUT = 8192
LEARNED_RUNS = 3
SEARCH_SPECS = ("search_gemm.json", "search_serving.json")


def grids_through_the_clis(tmp: str, smi: str) -> None:
    """(a) The three checked-in grids through the port's CLIs, in
    subprocesses started together, each held at rc 0 and ``golden OK``;
    then, in this process, each search spec's brute-force frontier against
    the ladder's and a warm re-search through one ``Session``."""
    commands = {name: ["repro_torch.search", "run", f"specs/{name}",
                       "--check", "--quiet"] for name in SEARCH_SPECS}
    commands["learned_fidelity.json"] = [
        "repro_torch.campaign", "report", "specs/learned_fidelity.json",
        "--check", "--quiet"]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *args, "--out", os.path.join(tmp, name)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in commands.items()}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            secs = time.perf_counter() - t0
            if proc.returncode != 0 or "golden OK" not in out:
                raise AssertionError(f"{name}: rc {proc.returncode}\n{out}\n"
                                     f"{err}")
            if name in SEARCH_SPECS:
                c = json.loads(Path(tmp, name, "frontier.json").read_text())[
                    "counters"]
                log(f"  {name}: rc 0 in {secs:.1f} s, golden OK, frontier "
                    f"{c['frontier_size']}, counters "
                    + json.dumps({k: v for k, v in c.items()
                                  if k != "evaluations"}))
            else:
                line = next(ln for ln in out.splitlines()
                            if ln.startswith("report "))
                log(f"  {name}: rc 0 in {secs:.1f} s, {line}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in SEARCH_SPECS:
        spec = str(ROOT / "specs" / name)
        session = api.Session()
        ladder = session.search(spec)
        brute = api.Session().search(spec, brute_force=True)
        if brute.frontier != ladder.frontier:
            raise AssertionError(f"{name}: ladder frontier {ladder.frontier}"
                                 f" != brute force {brute.frontier}")
        warm = session.search(spec)
        c = warm.counters
        if c["cache_misses"] != 0 or c["cache_hits"] < 1:
            raise AssertionError(f"{name}: warm re-search {c}")
        log(f"  {name} on {smi}: brute force scored "
            f"{brute.counters['top_rung_evaluations']} at the top rung, the "
            f"ladder {ladder.counters['top_rung_evaluations']}: frontiers "
            f"equal ({len(ladder.frontier)}); warm re-search "
            f"{c['cache_hits']} hits, 0 misses")


def profiled_gemms(sizes, device) -> tuple[list, dict]:
    """Each square bf16 GEMM of ``sizes`` synthesized as the reference tool
    does and profiled on ``host`` (``device``) with the profiling
    estimator: (its regions, their fingerprints' measured seconds).  Holds
    ``emit_failures == 0`` (a roofline fallback would not be a
    measurement)."""
    regions, profile = [], {}
    for m in sizes:
        w = _synthesize_gemm(WorkloadSpec(
            name=f"gemm-{m}", fidelity="raw",
            gemm={"m": m, "n": m, "k": m, "dtype": "bf16"}))
        plan = build_plan(w.program("raw"), name=w.name)
        est = ProfilingEstimator(program=plan.program, runs=LEARNED_RUNS,
                                 device=device)
        profile.update(record_profile(plan.compute_regions, est))
        if est.emit_failures:
            raise AssertionError(f"gemm-{m}: {est.emit_failures} regions "
                                 "fell back to roofline")
        regions += plan.compute_regions
    return regions, profile


def log_model(label: str, model) -> None:
    for fam, fm in sorted(model.families.items()):
        coef = ", ".join(f"{n} {c:.6g}" for n, c in
                         zip(("overhead", "compute", "bytes", "boundary",
                              "n_matmul", "n_elementwise", "n_movement"),
                             fm.coef))
        log(f"  {label} {fam}: n_samples {fm.n_samples}, rel_residual_std "
            f"{fm.rel_residual_std:.6g}, coefficients {coef}")


def fitted_on_the_card(device, smi: str):
    """(b) A learned model fitted from the card's own profile of the
    reference tool's training GEMMs; returns it and the host system."""
    host = host_system(device)
    regions, profile = profiled_gemms(LEARNED_GEMMS, device)
    model = fit_model(regions, profile, host, meta={
        "source_system": "host", "recorded_with": "profiling",
        "workloads": [f"gemm-{m}" for m in LEARNED_GEMMS]})
    with tempfile.TemporaryDirectory() as tmp:
        loaded = load_model(save_model(os.path.join(tmp, "m.json"), model))
    if loaded.digest() != model.digest():
        raise AssertionError(f"saved model {loaded.digest()} != fitted "
                             f"{model.digest()}")
    log(f"  GEMM model fitted on {host.name} ({smi}): digest "
        f"{model.digest()} (saved and loaded equal), measured ms "
        + ", ".join(f"{m} {profile[r.fingerprint] * 1e3:.6g}"
                    for m, r in zip(LEARNED_GEMMS, regions)))
    log_model("GEMM model", model)
    held, held_profile = profiled_gemms((LEARNED_HELD_OUT,), device)
    measured = held_profile[held[0].fingerprint]
    p = LearnedEstimator(host, model).predict_with_uncertainty(held[0])
    if p["extrapolated"] is not True:
        raise AssertionError(f"gemm-{LEARNED_HELD_OUT} lies outside the "
                             f"fitted flops, yet {p}")
    log(f"  held-out gemm-{LEARNED_HELD_OUT} on {host.name}: learned "
        f"{p['seconds'] * 1e3:.6g} ms [{p['low'] * 1e3:.6g}, "
        f"{p['high'] * 1e3:.6g}] beside measured {measured * 1e3:.6g} ms: "
        f"relative error {(p['seconds'] - measured) / measured:+.4f}, "
        f"extrapolated {p['extrapolated']}")
    six = regions + held
    times = [profile[r.fingerprint] for r in regions] + [measured]
    h100 = default_registry().get("h100")
    learned = sum(LearnedEstimator(h100, model).get_run_time_estimate(r)
                  for r in six)
    project = ProfilingEstimator(system=host, target_system=h100,
                                 device=device)
    projected = sum(project._project(r, t) for r, t in zip(six, times))
    log(f"  six GEMMs on the catalog's h100: learned (transferred) "
        f"{learned * 1e3:.6g} ms beside the profiling estimator's "
        f"projection {projected * 1e3:.6g} ms: {learned / projected:.4f}")
    return model, host


def gemm_model_on_a_train_step(model, host, regions, times) -> None:
    """(c) The GEMM model on phase 12 (a)'s llama3-1b regions (a finding,
    not held)."""
    fams = {}
    for r, t in zip(regions, times):
        fams.setdefault(region_family(r), []).append((r, t))
    est = LearnedEstimator(host, model)
    dtypes = {}
    for r in regions:
        dt = learned_dominant_dtype(r)
        dtypes[dt] = dtypes.get(dt, 0) + 1
    log("  llama3-1b regions by family: " + ", ".join(
        f"{f} {len(v)}" for f, v in sorted(fams.items()))
        + "; by the dtype whose peak the compute feature uses: " + ", ".join(
            f"{d} {n}" for d, n in sorted(dtypes.items()))
        + f"; host peaks bf16 {host.flops_for('bf16') / 1e12:.1f}, f32 "
        f"{host.flops_for('f32') / 1e12:.1f} TFLOP/s, memory "
        f"{host.mem_bw / 1e12:.3f} TB/s, kernel_overhead_s "
        f"{host.kernel_overhead_s:g}")
    unsupported = 0
    for fam, pairs in sorted(fams.items()):
        if not est.supports(pairs[0][0]):
            unsupported += len(pairs)
            continue
        learned = [est.get_run_time_estimate(r) for r, _ in pairs]
        profiled = sum(t for _, t in pairs)
        log(f"  GEMM model on the {fam} regions: learned "
            f"{sum(learned) * 1e3:.3f} ms beside profiled "
            f"{profiled * 1e3:.3f} ms: {sum(learned) / profiled:.4f}; "
            "learned over profiled by region: " + ", ".join(
                f"{lt / t:.3f}" for lt, (_, t) in zip(learned, pairs)))
    log(f"  regions the GEMM model does not support: {unsupported}")


def fitted_on_a_train_step(host, regions, times, projected_h100) -> None:
    """(d) A model fitted on phase 12 (a)'s region times: each distinct
    fingerprint's first region and time is one sample."""
    samples, count = {}, {}
    for r, t in zip(regions, times):
        samples.setdefault(r.fingerprint, (r, t))
        count[r.fingerprint] = count.get(r.fingerprint, 0) + 1
    model = fit_model(regions, {f: t for f, (_, t) in samples.items()}, host,
                      meta={"recorded_with": "profiling"})
    log(f"  train-step model on {host.name}: {len(regions)} regions, "
        f"{len(samples)} distinct fingerprints, digest {model.digest()}")
    log_model("train-step model", model)
    est = LearnedEstimator(host, model)
    in_sample = sum(est.get_run_time_estimate(r) for r in regions)
    total = sum(times)
    log(f"  in-sample sum {in_sample * 1e3:.3f} ms beside profiled "
        f"{total * 1e3:.3f} ms: {in_sample / total:.4f}; by sample "
        "(regions sharing it x learned ms / its time ms): " + ", ".join(
            f"{count[f]} x {est.get_run_time_estimate(r) * 1e3:.3f}/"
            f"{t * 1e3:.3f}" for f, (r, t) in samples.items()))
    h100 = default_registry().get("h100")
    learned = sum(LearnedEstimator(h100, model).get_run_time_estimate(r)
                  for r in regions)
    log(f"  on the catalog's h100: learned (transferred) "
        f"{learned * 1e3:.3f} ms beside phase 12 (a)'s projection "
        f"{projected_h100 * 1e3:.3f} ms: {learned / projected_h100:.4f}")


def learned_phase(profiled: tuple, smi: str) -> None:
    """Phase 13, (a) to (d); ``profiled`` is phase 12 (a)'s regions, their
    times and their sum projected onto ``h100``.  Launches no kernel of
    the port: (b)'s GEMMs are ``dot_general``s, which the executor runs
    with ``torch.matmul`` (held across (b))."""
    with tempfile.TemporaryDirectory() as tmp:
        grids_through_the_clis(tmp, smi)
    for fn in COUNTERS.values():
        fn.launches = 0
    model, host = fitted_on_the_card("cuda", smi)
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    if any(launches.values()):
        raise AssertionError(f"(b) launched kernels: {launches}")
    regions, times, projected_h100 = profiled
    gemm_model_on_a_train_step(model, host, regions, times)
    fitted_on_a_train_step(host, regions, times, projected_h100)
    log(f"  launches across (b) {launches}")


# --------------------------------------------------------------------------
# phase 14: the other families' serving paths at full width
# --------------------------------------------------------------------------

# (id, layers kept of the published depth, whether the run decodes too):
# each at its published width with random weights from the seed, its depth
# cut so that the phase fits the script's time (PERF.md section 4);
# stablelm-12b (head_dim 160) and the hybrid zamba2-2.7b (head_dim 80; 9
# super-blocks of 6 Mamba2 layers and the shared attention block) at their
# full depth
FAMILIES = [("mixtral-8x22b", 4, True), ("gemma2-27b", 8, True),
            ("qwen2.5-32b", 2, False), ("deepseek-67b", 2, False),
            ("stablelm-12b", 40, True), ("zamba2-2.7b", 54, True),
            ("deepseek-v3-671b", 2, True)]
# prefill: 2 prompts of 8192 tokens, longer than the 4096-token windows
FAMILY_B, FAMILY_S = 2, 8192
# greedy decode: 8 prompts of 64 tokens, 32 new tokens, max_len 128
DECODE_B, DECODE_S, DECODE_NEW, DECODE_MAX = 8, 64, 32, 128
# the logits gate holds the last FAMILY_ROWS positions of each prompt
FAMILY_ROWS = 64
# the share of tokens whose experts (after the capacity drops) may differ
# between the K1 path and the plain path at one MoE layer, both fed the
# same layer input: K1's bf16 rounding moves the router's input, and a
# token within that of a top-k tie flips
ROUTING_FLIP_TOL = 0.01
# the plain chunked path's chunk of keys where the query heads are many:
# its f32 scores are B x Hq x S x chunk, 8.6 GB a tensor at deepseek-v3's
# 128 heads of 2 x 8192 tokens and 1024 keys (1.1 GB at 128), and its f32
# walk runs beside the model's 49.7 GB of bf16 weights
PLAIN_CHUNK_MANY_HEADS = 128
# the f32 walk casts an MoE layer's experts this many bytes at a time (all
# 256 of one deepseek-v3 layer's would be 45 GB in f32)
EXPERT_GROUP_BYTES = 2 << 30
# device time of the prefill: K1's and K2's kernels (launched outside any
# PyTorch op), and by PyTorch op (the ops' own kernels) the MoE's grouped
# GEMMs, the other GEMMs and the MoE's data movement
FAMILY_KERNEL_GROUPS = {"K1": ["flash_fwd"], "K2": ["rmsnorm"],
                        "K3": ["ssd_scan_bf16", "ssd_scan_f32"]}
FAMILY_OP_GROUPS = {
    "expert GEMMs (bmm)": ["aten::bmm"],
    "other GEMMs (projections, router, head)": ["aten::mm", "aten::addmm"],
    "MoE dispatch and combine (top-k, sort, cumsum, gathers, scatter-adds, "
    "the combine's sum)": [
        "aten::topk", "aten::sort", "aten::cumsum", "aten::index",
        "aten::index_add", "aten::scatter_add", "aten::where",
        "aten::gather", "aten::sum"],
}


@contextlib.contextmanager
def routes_recorded():
    """Each ``moe_route`` call's top-k experts [T, k], in call order (layer
    by layer; in a decode, step by step)."""
    orig, seen = model_mlp.moe_route, []

    def route(cfg, p, xf):
        top_w, top_e = orig(cfg, p, xf)
        seen.append(top_e)
        return top_w, top_e
    model_mlp.moe_route = route
    try:
        yield seen
    finally:
        model_mlp.moe_route = orig


def routed(cfg, top_e) -> torch.Tensor:
    """[T, E]: which experts take each token of one routing call, after
    that call's capacity drops."""
    t, k = top_e.shape
    order, _, keep, _ = moe_dispatch(top_e, cfg.moe.num_experts,
                                     moe_capacity(t, cfg.moe))
    kept = torch.empty_like(keep).scatter_(0, order, keep).view(t, k)
    return torch.zeros(t, cfg.moe.num_experts, dtype=torch.bool,
                       device=top_e.device).scatter_(1, top_e, kept)


def plain_config(cfg):
    """The plain chunked path of ``cfg``: attn_impl "chunked", with chunks
    of PLAIN_CHUNK_MANY_HEADS keys at 128 query heads or more."""
    chunk = (PLAIN_CHUNK_MANY_HEADS if cfg.num_heads >= 128
             else cfg.attn_chunk)
    return cfg.scaled(attn_impl="chunked", attn_chunk=chunk)


EXPERT_KEYS = ("we_gate", "we_up", "we_down")


def cast_but_experts(tree: dict, cast) -> dict:
    """``tree`` cast leaf by leaf, the MoE's expert weights as they are:
    ``experts_cast_by_group`` casts those a group at a time."""
    return {k: cast_but_experts(v, cast) if isinstance(v, dict)
            else v if k in EXPERT_KEYS else cast(v) for k, v in tree.items()}


@contextlib.contextmanager
def experts_cast_by_group(cast):
    """``moe_forward``'s expert GEMMs (``expert_ffn``) on the weights of
    EXPERT_GROUP_BYTES of experts at a time, cast (``cast``) as each group
    runs.  Given one routing, no expert's rows depend on another's, so the
    groups give what one call on all the cast experts gives."""
    orig = model_mlp.expert_ffn

    def grouped(cfg, p, buf):
        e = buf.shape[0]
        per = max(1, EXPERT_GROUP_BYTES // (4 * sum(
            p[k][0].numel() for k in EXPERT_KEYS)))
        y = torch.empty_like(buf)
        for j in range(0, e, per):
            pj = {k: cast(p[k][j:j + per]) for k in EXPERT_KEYS}
            y[j:j + per] = orig(cfg, pj, buf[j:j + per])
        return y
    model_mlp.expert_ffn = grouped
    try:
        yield
    finally:
        model_mlp.expert_ffn = orig


def layer_walk(cfg, params, pos, cast):
    """``prefill``'s blocks in order, each a function of the hidden state
    whose weights are cast (``cast``) a layer at a time when it runs (an
    MoE's experts as ``expert_ffn`` takes them: see
    ``experts_cast_by_group``): the attention layers, or the hybrid's
    super-blocks (each Mamba2 layer, then the shared attention block as the
    layer of index 1)."""
    if cfg.family != "hybrid":
        for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
            yield lambda h, lp=lp, i=i: attn_block(
                cfg, cast_but_experts(lp, cast), h, pos, i)
        return
    shared = tree_map(params["shared_attn"], cast)
    for group in _super_blocks(cfg, params):
        for lp in group:
            yield lambda h, lp=lp: ssm_block(cfg, tree_map(lp, cast), h)
        yield lambda h: attn_block(cfg, shared, h, pos, 1)


def walk_logits(cfg, params, tokens, rows: int, f32: bool = False):
    """``prefill``'s layers one by one, with the head on the last ``rows``
    positions of each prompt: [B * rows, V] f32.  With ``f32`` on an f32
    copy of the weights made a layer at a time, an MoE's experts a group
    at a time (a copy of all of mixtral's cut layers would take 42 GB, and
    one deepseek-v3 layer's 46 GB)."""
    cast = (lambda t: t.float()) if f32 else (lambda t: t)
    if f32:
        cfg = cfg.scaled(dtype="float32")
    top = {k: v for k, v in params.items()
           if k not in ("layers", "shared_attn")}
    batch = {"tokens": tokens}
    # the cast embedding only for the lookup; the head casts its table
    # itself (``_logits`` multiplies in f32), so an f32 copy of the 3.7 GB
    # vocabularies is not kept beside the layers
    h = _embed(cfg, dict(top, embed=cast(top["embed"])), batch)
    pos = _positions(batch)
    with experts_cast_by_group(cast):
        for block in layer_walk(cfg, params, pos, cast):
            h = block(h)
    head = dict(top, final_norm=cast(top["final_norm"]))
    return _logits(cfg, head, h[:, -rows:].contiguous()).flatten(0, 1)


def check_super_block(cfg, chunked, params, prompts) -> None:
    """The hybrid's first super-block fed the kernel path's hidden state:
    each Mamba2 layer's output (K3 against the plain chunked scan) and then
    the shared attention block's (K1 against the plain chunked attention),
    each on the same input, row by row."""
    batch = {"tokens": prompts}
    h, pos = _embed(cfg, params, batch), _positions(batch)
    for i, lp in enumerate(_super_blocks(cfg, params)[0]):
        x = rms_norm(h, lp["ln"], cfg.rms_eps)
        y = mamba2_forward(cfg, lp["ssm"], x)[0]
        hold_rows(f"layer {i} Mamba2 output", y,
                  mamba2_forward(chunked, lp["ssm"], x)[0])
        h = h + y
    shared = params["shared_attn"]
    x = rms_norm(h, shared["ln1"], cfg.rms_eps)
    w = _layer_window(cfg, 1)
    hold_rows(f"shared attention (window {w})",
              gqa_forward(cfg, shared["attn"], x, pos, layer_window=w),
              gqa_forward(chunked, shared["attn"], x, pos, layer_window=w))


def attention_out(cfg, lp, x, pos, i):
    """Layer ``i``'s attention output on its normed input ``x``: MLA, or GQA
    with the layer's window."""
    if cfg.mla is not None:
        return mla_forward(cfg, lp["attn"], x, pos)
    return gqa_forward(cfg, lp["attn"], x, pos,
                       layer_window=_layer_window(cfg, i))


def check_family_layers(cfg, chunked, params, prompts) -> None:
    """Each checked layer fed the K1 path's hidden state: its attention
    output (K1 against the plain chunked path on the same input, row by
    row), and with an MoE the share of tokens whose experts differ between
    the two (held at ROUTING_FLIP_TOL) and the layer's output of the
    tokens whose experts agree (measured).  gemma2's first local and global
    layers; every layer of an MoE; the hybrid's first super-block; the
    first layer otherwise."""
    if cfg.family == "hybrid":
        check_super_block(cfg, chunked, params, prompts)
        return
    moe = cfg.moe is not None
    last = (cfg.num_layers if moe else max(cfg.local_global_pattern, 1))
    batch = {"tokens": prompts}
    h, pos = _embed(cfg, params, batch), _positions(batch)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)[:last]):
        x = rms_norm(h, lp["ln1"], cfg.rms_eps)
        a = attention_out(cfg, lp, x, pos, i)
        ap = attention_out(chunked, lp, x, pos, i)
        kind = ("MLA" if cfg.mla is not None
                else f"window {_layer_window(cfg, i)}")
        hold_rows(f"layer {i} ({kind}) attention output", a, ap)
        if moe:
            xs = [rms_norm(h + y, lp["ln2"], cfg.rms_eps) for y in (a, ap)]
            with routes_recorded() as seen:
                m, mp = (ffn(cfg, lp, x2) for x2 in xs)
            flip = (routed(cfg, seen[0]) != routed(cfg, seen[1])).any(-1)
            share = flip.float().mean().item()
            agree = ~flip.view(m.shape[:2])
            y, yp = (a + m).float()[agree], (ap + mp).float()[agree]
            mrow = ((y - yp).norm(dim=-1) / yp.norm(dim=-1)).max().item()
            # not held: under the reference's init the router's logits have
            # a spread of about 40, so a token near a tie of its first two
            # experts moves its two weights by up to a quarter of the change
            # of its logits (the logits gate holds the end result)
            log(f"  layer {i} MoE (top-{cfg.moe.top_k} of "
                f"{cfg.moe.num_experts}): experts differ between the K1 and "
                f"the plain path for {int(flip.sum())} of {flip.numel()} "
                f"tokens "
                f"({share:.4%}, tol {ROUTING_FLIP_TOL:.0%}); the layer's "
                f"output (attention + MoE) of the other tokens: largest row "
                f"error {mrow:.3e} of the row's norm (measured, not held)")
            if share > ROUTING_FLIP_TOL:
                raise AssertionError(f"layer {i} MoE: {share:.4%} of tokens "
                                     "flip")
        h = attn_block(cfg, lp, h, pos, i)


def agreeing_rows(name, per_layer, held=None) -> torch.Tensor:
    """``per_layer``: for each MoE layer, the [T, E] routings of the K1,
    plain and f32 runs.  Logs each layer's share of tokens routed otherwise
    by the plain and the f32 run than by the K1 run (not held: whole paths
    compound their rounding, and a flip moves the later layers' inputs);
    returns which of the ``held`` tokens (None: all) all three routed alike
    at every layer."""
    agree = None
    for layer, (r, rp, r32) in enumerate(per_layer):
        to_plain, to_f32 = ((r != x).any(-1) for x in (rp, r32))
        same = ~(to_plain | to_f32)
        same = same if held is None else same[held]
        agree = same if agree is None else agree & same
        log(f"  {name}, MoE layer {layer}: tokens routed otherwise than on "
            f"the K1 path: plain path {to_plain.float().mean().item():.4%}, "
            f"f32 {to_f32.float().mean().item():.4%} of {r.shape[0]}")
    log(f"  {name}: {int(agree.sum())} of {agree.numel()} held rows routed "
        "alike at every layer")
    if not agree.any():
        raise AssertionError(f"{name}: no held row routed alike")
    return agree


def check_family_logits(cfg, params, prompts, dprompts, logits) -> None:
    """The logits gate of phases 4 and 5: the K1 path's bf16 logits
    against the plain chunked path's and an f32 run's (``hold``), on the
    last FAMILY_ROWS positions of each 8192-token prompt (the walk of the
    layers that ``prefill`` takes, whose last rows the main path's logits
    must equal to f32 rounding) and, for a run that decodes, on
    prefill-by-decode's last logits; with an MoE only on the rows that all
    three routed alike at every layer."""
    chunked = plain_config(cfg)
    check_family_layers(cfg, chunked, params, prompts)
    runs, out = [], []
    for c, f32 in ((cfg, False), (chunked, False), (chunked, True)):
        with routes_recorded() as seen:
            out.append(walk_logits(c, params, prompts, FAMILY_ROWS, f32))
        runs.append(seen)
    last = torch.arange(1, FAMILY_B + 1, device="cuda") * FAMILY_ROWS - 1
    _, diff = max_rel_diff(logits, out[0][last])
    log(f"  the main path's prefill logits against the walk's last rows: "
        f"max |diff| / max |logit| {diff:.3e} (tol 2^-10)")
    if not diff <= 2.0 ** -10:
        raise AssertionError("the main path's prefill left the walk's path")
    rows = slice(None)
    if cfg.moe is not None:
        held = (torch.arange(FAMILY_B, device="cuda")[:, None] * FAMILY_S
                + torch.arange(FAMILY_S - FAMILY_ROWS, FAMILY_S,
                               device="cuda")).flatten()
        rows = agreeing_rows(
            f"prefill {FAMILY_B}x{FAMILY_S}",
            [[routed(cfg, run[i]) for run in runs]
             for i in range(cfg.num_layers)], held)
    hold(f"prefill {FAMILY_B}x{FAMILY_S}, last {FAMILY_ROWS} positions "
         "(K1 path)", out[0][rows], out[1][rows], out[2][rows])
    if dprompts is None:
        return
    # a decode step routes DECODE_B tokens, which every expert's capacity
    # (at least 8) takes whole; so the walks over the whole prompts give
    # each expert the capacity of all their tokens and drop none either (at
    # deepseek-v3's 8 x 64 tokens an expert takes 24 of the 4096
    # assignments, and the prompts' last tokens come last)
    walk = chunked
    if cfg.moe is not None:
        walk = chunked.scaled(moe=replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    if cfg.mla is not None:
        check_mla_decode(cfg, params, dprompts, walk)
        return
    runs, out = [], []
    with routes_recorded() as seen:
        out.append(decode_logits(cfg, params, dprompts))
    runs.append(seen)
    for f32 in (False, True):
        with routes_recorded() as seen:
            out.append(walk_logits(walk, params, dprompts, 1, f32))
        runs.append(seen)
    rows = slice(None)
    if cfg.moe is not None:
        top_e = runs[1][0]
        keep = moe_dispatch(top_e, cfg.moe.num_experts,
                            moe_capacity(top_e.shape[0], cfg.moe))[2]
        log(f"  prefill-by-decode's walk: {int((~keep).sum())} of "
            f"{keep.numel()} of layer 0's assignments past the experts' "
            "capacity at the published factor (none at the walk's)")
        # the last prompt token: decode's last step, the walks' last rows
        n, step = cfg.num_layers, DECODE_S - 1
        rows = agreeing_rows(
            f"prefill-by-decode {DECODE_B}x{DECODE_S}",
            [[routed(walk, runs[0][step * n + i]),
              *(routed(walk, run[i])[DECODE_S - 1::DECODE_S]
                for run in runs[1:])] for i in range(n)])
    hold(f"prefill-by-decode {DECODE_B}x{DECODE_S}", out[0][rows],
         out[1][rows], out[2][rows])


def check_mla_decode(cfg, params, dprompts, walk) -> None:
    """MLA decodes in the absorbed form over the compressed cache (W_uk
    folded into the query, W_uv into the output): other rounding points
    than prefill's materialised keys and values, which in f32 agree with it
    (tests/test_torch_mla.py).  So the main path's prefill-by-decode is
    held against the same decode with the norms' plain version (K2 is the
    one kernel a decode step launches) and against an f32 run of it (its
    experts cast a group at a time), on the rows all three routed alike.
    The f32 run is held against the plain prefill walk in f32 (``walk``,
    whose experts drop no token) at MLA_DECODE_TOL of its largest logit, on
    the rows both routed alike; the bf16 run's distance to the bf16 walk
    (0.18 to 0.21 of the largest logit) is measured, not held."""
    def f32(t):
        return t.float()
    cfg32 = cfg.scaled(dtype="float32")
    # the head casts its table itself (``_logits``); the experts are cast
    # a group at a time as they run
    p32 = dict(params, embed=f32(params["embed"]),
               final_norm=f32(params["final_norm"]),
               layers=cast_but_experts(params["layers"], f32))
    runs, out = [], []
    for c, p, plain in ((cfg, params, False), (cfg, params, True),
                        (cfg32, p32, True)):
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(routes_recorded())
            if plain:
                stack.enter_context(plain_norms())
            if c is cfg32:
                stack.enter_context(experts_cast_by_group(f32))
            out.append(decode_logits(c, p, dprompts))
        runs.append(seen)
    del p32
    name = f"prefill-by-decode {DECODE_B}x{DECODE_S} (absorbed form)"
    n, step = cfg.num_layers, DECODE_S - 1
    rows = agreeing_rows(name, [[routed(cfg, run[step * n + i])
                                 for run in runs] for i in range(n)])
    hold(f"{name}, K2 path against its plain norms and f32", out[0][rows],
         out[1][rows], out[2][rows])
    for label, x, f in (("bf16", out[0], False), ("f32", out[2], True)):
        with routes_recorded() as seen:
            ref = walk_logits(walk, params, dprompts, 1, f)
        alike = torch.ones(DECODE_B, dtype=torch.bool, device="cuda")
        if f:   # the last prompt token: decode's last step, the walk's rows
            for i in range(n):
                alike &= ~(routed(cfg, runs[2][step * n + i]) != routed(
                    walk, seen[i])[DECODE_S - 1::DECODE_S]).any(-1)
        _, diff = max_rel_diff(x[alike], ref[alike])
        agree = (x.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"  {name} in {label} against the plain prefill walk in "
            f"{label}: max |diff| / max |logit| {diff:.3e}, argmax agrees "
            f"{agree:.2f} " + (f"on the {int(alike.sum())} of {DECODE_B} "
                               "rows both routed alike at every layer (tol "
                               f"{MLA_DECODE_TOL:g})" if f else
                               "(measured, not held)"))
        if f and not (alike.any() and diff <= MLA_DECODE_TOL):
            raise AssertionError(f"{name}: f32 decode off the f32 prefill "
                                 f"walk by {diff} of the largest logit")


def serve_family(arch: str, layers: int, decodes: bool, gen) -> dict:
    """One family's serving path at full width, ``layers`` deep: prefill of
    2 x 8192 tokens and, for a run that decodes, ``generate`` 8 x (64 + 32)
    with the launch counts read around them; then the checks, the logits
    gate and the prefill's profile.  K1 runs once a layer in prefill and
    never in decode; K2 twice a layer and once at the end, in prefill and
    in each decode step.  The hybrid runs K3 once a Mamba2 layer and K1
    once a super-block in prefill, and K2 twice a Mamba2 layer (its norm
    and the gated norm), twice a super-block and once at the end, in
    prefill and in each decode step.  MLA runs K2 four times a layer (ln1,
    q_norm, kv_norm, ln2) and once at the end, in prefill and in each
    decode step, and K1 once a layer in prefill."""
    cfg = get_config(arch).scaled(num_layers=layers)
    assert cfg.attn_impl == "kernel" and cfg.dtype == "bfloat16"
    torch.cuda.empty_cache()
    model = TransformerLM(cfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    hybrid = cfg.family == "hybrid"
    ssm = (f", {layers // cfg.hybrid_attn_every} super-blocks of "
           f"{cfg.hybrid_attn_every} Mamba2 layers (SSD head_dim "
           f"{cfg.ssm.head_dim}, state {cfg.ssm.d_state}, chunk "
           f"{cfg.ssm.chunk_size}) and the shared attention block"
           if hybrid else "")
    m = cfg.mla
    widths = (f"MLA query/key {m.qk_nope_head_dim} + {m.qk_rope_head_dim}, "
              f"value {m.v_head_dim}, latents q {m.q_lora_rank} kv "
              f"{m.kv_lora_rank}" if m is not None
              else f"head_dim {cfg.resolved_head_dim}")
    log(f"  {arch}: {layers} of {get_config(arch).num_layers} layers{ssm}, "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"{widths}, window {cfg.sliding_window}"
        f"{' (even layers)' if cfg.local_global_pattern else ''}, cap "
        f"{cfg.attn_logit_softcap}, vocab {cfg.vocab_size}"
        f"{', experts %d top-%d' % (cfg.moe.num_experts, cfg.moe.top_k) if cfg.moe else ''}: "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}")
    v = cfg.vocab_size
    prompts = torch.randint(0, v, (FAMILY_B, FAMILY_S), generator=gen,
                            device="cuda", dtype=torch.int32)
    dprompts = (torch.randint(0, v, (DECODE_B, DECODE_S), generator=gen,
                              device="cuda", dtype=torch.int32)
                if decodes else None)
    with torch.inference_mode():
        model.prefill({"tokens": prompts})   # warm-up: cuBLAS, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counts at 0 just before, read just after ----
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = model.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        in_prefill = {k: fn.launches for k, fn in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated()
        decode_s = 0.0
        if decodes:
            t0 = time.perf_counter()
            res = model.generate(dprompts, max_new_tokens=DECODE_NEW,
                                 max_len=DECODE_MAX)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in COUNTERS.items()}
        # ---- end of the main path ----

    steps = DECODE_S + DECODE_NEW if decodes else 0
    expected = {k: 0 for k in COUNTERS}
    if hybrid:
        n_super = layers // cfg.hybrid_attn_every
        expected.update({"flash_attention": n_super, "ssd_scan": layers,
                         "rmsnorm": 2 * layers + 2 * n_super + 1})
    elif cfg.mla is not None:
        expected.update({"flash_attention": layers,
                         "rmsnorm": 4 * layers + 1})
    else:
        expected.update({"flash_attention": layers,
                         "rmsnorm": 2 * layers + 1})
    per_step = expected["rmsnorm"]
    tokens = FAMILY_B * FAMILY_S
    log(f"  prefill {FAMILY_B}x{FAMILY_S}: {prefill_s * 1e3:.2f} ms, "
        f"{tokens / prefill_s:.0f} tokens/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB ({card()})"
        + (f"; greedy_decode {DECODE_B}x({DECODE_S}+{DECODE_NEW}): "
           f"{decode_s * 1e3:.2f} ms, {decode_s / steps * 1e3:.3f} ms/step"
           if decodes else ""))
    log(f"  launches: prefill {in_prefill}; whole run {launches}")
    if in_prefill != expected:
        raise AssertionError(f"prefill launches {in_prefill}, expected "
                             f"{expected}")
    expected["rmsnorm"] *= 1 + steps
    if launches != expected:
        raise AssertionError(f"main-path launches {launches}, expected "
                             f"{expected} ({per_step} K2 and nothing "
                             "else per decode step)")
    if logits.shape != (FAMILY_B, v) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    if decodes:
        toks = res.tokens
        if (toks.shape != (DECODE_B, DECODE_NEW) or toks.dtype != torch.int32
                or int(toks.min()) < 0 or int(toks.max()) >= v):
            raise AssertionError(f"greedy tokens {tuple(toks.shape)} "
                                 f"{toks.dtype} out of shape or range")
    with torch.inference_mode():
        check_family_logits(cfg, model.params, prompts, dprompts, logits)
        profile_window(f"prefill {FAMILY_B}x{FAMILY_S}",
                       lambda: model.prefill({"tokens": prompts}), top=8,
                       groups=FAMILY_KERNEL_GROUPS,
                       op_groups=FAMILY_OP_GROUPS)
    del model
    torch.cuda.empty_cache()
    return launches


def families_phase() -> list:
    """Phase 14: the ids' serving paths, each id's weights drawn from a
    generator of its own; their launch counts."""
    runs = []
    for arch, layers, decodes in FAMILIES:
        t1 = time.perf_counter()
        runs.append(serve_family(arch, layers, decodes,
                                 seeded(f"serve {arch}")))
        log(f"  {arch}: {time.perf_counter() - t1:.1f} s")
    return runs


# --------------------------------------------------------------------------
# phase 15: the families' training paths
# --------------------------------------------------------------------------

# (id, layers kept of the published depth, batch, seq): each at its
# published width with random weights from the seed, AdamW with bf16
# parameters and gradients and f32 moments (12 bytes a parameter) updated
# in place (``donate=True``, the reference's donate_argnums), its depth cut
# for one card's memory (PERF.md section 4), remat off so that each
# kernel's forward runs once a step.  gemma2-27b takes 6144 tokens, still
# past its 4096-token window: its f32 logits over a 256000-token vocabulary
# are 8.4 GB at 8192 tokens, and the head's backward holds three such
# tensors beside the state (out of memory at 8192 on an 80 GB card)
FAMILY_TRAIN = [  # arch, layers, B, S, remat
    ("mamba2-370m", 48, 4, 2048, "none"),
    ("mixtral-8x22b", 1, 1, 8192, "none"),
    ("gemma2-27b", 2, 1, 6144, "none"),
    ("qwen2.5-32b", 1, 2, 4096, "none"),
    ("deepseek-67b", 1, 2, 4096, "none"),
    # K1 and K1b at head_dim 160: 4 of 40 layers (the untied 100352-token
    # head and embedding are 1.03 B parameters, the f32 logits 3.3 GB)
    ("stablelm-12b", 4, 2, 4096, "none"),
    # the hybrid at full depth with its published remat="full": 54 Mamba2
    # layers (K3, K3b) and 9 uses of the shared attention block (K1, K1b at
    # head_dim 80), each super-block recomputed in the backward
    ("zamba2-2.7b", 54, 2, 4096, "full"),
]
FAMILY_WARMUP, FAMILY_STEPS = 2, 3
# the hybrid's gradient gate runs on its first super-blocks and
# mamba2-370m's on its first layers: over 48 or 54 layers both bf16 paths
# are as far from f32 as unrelated vectors, at fan-in init too (PERF.md),
# and a gate there holds nothing
GATE_SUPER_BLOCKS = 2
GATE_SSM_LAYERS = 4
# the export's operators -> the launch counters
EXPORT_COUNTERS = dict(EXPORT_OPS, ssd_scan_states="ssd_scan",
                       ssd_scan_bwd="ssd_scan_bwd")
FAMILY_TRAIN_GROUPS = {
    "K3b": K3B_KERNELS,
    "K3": ["ssd_scan_bf16", "ssd_scan_f32"], **TRAIN_GROUPS}


def masked_grads(cfg, params, batch, keep=None):
    """The gradient tree of the mean cross entropy over the tokens in
    ``keep`` ([B, S] bool; all when None) through ``cfg``'s path, each
    gradient in its parameter's dtype."""
    leaves = trainable(params)
    h = _scan_layers(cfg, leaves, _embed(cfg, leaves, batch),
                     _positions(batch))
    logits = _logits(cfg, leaves, h).float()
    tok = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["targets"][..., None].long())[..., 0])
    del logits
    loss = tok.mean() if keep is None else (tok * keep).sum() / keep.sum()
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return map_leaves(lambda _: next(grads), params)


def gate_distances(cfg, params, batch) -> dict:
    """Each parameter's bf16 gradient through the kernels and through the
    plain bf16 path, as distances from an f32 plain run relative to its
    norm: {name: (kernels, plain)}; raises if a parameter got no gradient
    through the kernels.  With an MoE, first the share of tokens routed
    otherwise by the K1 and the plain path (held at ROUTING_FLIP_TOL),
    then the loss taken only over the tokens that all three runs routed
    alike at every layer."""
    plain = cfg.scaled(attn_impl="chunked", remat="full")
    cfg32 = plain.scaled(dtype="float32")
    keep = None
    if cfg.moe is not None:
        runs = []
        with torch.no_grad():
            for c, f32 in ((cfg, False), (plain, False), (cfg32, True)):
                with plain_norms() if c is not cfg else \
                        contextlib.nullcontext(), routes_recorded() as seen:
                    p = tree_map(params, lambda t: t.float()) if f32 else \
                        params
                    _scan_layers(c, p, _embed(c, p, batch), _positions(batch))
                    del p
                runs.append([routed(cfg, e) for e in seen])
        keep = torch.ones(batch["tokens"].numel(), dtype=torch.bool,
                          device="cuda")
        for layer, (r, rp, r32) in enumerate(zip(*runs)):
            flip = (r != rp).any(-1)
            share = flip.float().mean().item()
            keep &= ~(flip | (r != r32).any(-1))
            log(f"    MoE layer {layer}: experts differ between the K1 and "
                f"the plain path for {int(flip.sum())} of {flip.numel()} "
                f"tokens ({share:.4%}, tol {ROUTING_FLIP_TOL:.0%})")
            if share > ROUTING_FLIP_TOL:
                raise AssertionError(f"{cfg.name} MoE layer {layer}: "
                                     f"{share:.4%} of tokens flip")
        keep = keep.view(batch["tokens"].shape)
        log(f"    the gate's loss over the {int(keep.sum())} of "
            f"{keep.numel()} tokens routed alike by all three runs")
    flat_k = flatten(masked_grads(cfg, params, batch, keep))
    with plain_norms():
        flat_p = flatten(masked_grads(plain, params, batch, keep))
        flat_32 = flatten(masked_grads(cfg32, tree_map(
            params, lambda t: t.float()), batch, keep))
    rows = {}
    for name, g32 in flat_32.items():
        gk, gp = flat_k[name].float(), flat_p[name].float()
        if not (torch.isfinite(gk).all() and gk.abs().max() > 0):
            raise AssertionError(f"gradient gate: {name} got no gradient "
                                 "through the kernels")
        rows[name] = (((gk - g32).norm() / g32.norm()).item(),
                      ((gp - g32).norm() / g32.norm()).item())
    return rows


def family_gate(cfg, params, batch) -> None:
    """The gradient gate of phase 7 on the step's model: every parameter's
    bf16 gradient through the kernels within LOGIT_FACTOR times the plain
    bf16 path's distance from an f32 plain run (:func:`gate_distances`)."""
    rows = gate_distances(cfg, params, batch)
    name, (dk, dp) = max(rows.items(), key=lambda r: r[1][0] / r[1][1])
    failed = [f"{n} kernels {k} > {LOGIT_FACTOR} x plain {p}"
              for n, (k, p) in rows.items() if not k <= LOGIT_FACTOR * p]
    if failed:
        raise AssertionError("gradient gate: " + "; ".join(failed))
    log(f"    gradient gate: {len(rows)} parameters, each with a gradient "
        f"through the kernels; largest kernel/plain distance ratio "
        f"{dk / dp:.2f} at {name} (kernels {dk:.3e}, plain bf16 {dp:.3e}); "
        f"kernel distances {min(k for k, _ in rows.values()):.3e} to "
        f"{max(k for k, _ in rows.values()):.3e} (tol {LOGIT_FACTOR:g})")


def train_launches(cfg) -> dict:
    """The launches of one train step of ``cfg``: each layer's mixer (K1
    or K3) and norms (two a layer, and the hybrid's shared block two more a
    super-block), forward and backward; under remat="full" every block's
    forward runs again in the backward; the final norm once each way."""
    n = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = n // cfg.hybrid_attn_every
        mixers, norms = {"ssd_scan": n, "flash_attention": n_attn}, \
            2 * n + 2 * n_attn
    elif cfg.family == "ssm":
        mixers, norms = {"ssd_scan": n}, 2 * n
    else:
        mixers, norms = {"flash_attention": n}, 2 * n
    again = 2 if cfg.remat == "full" else 1
    expected = {k: 0 for k in COUNTERS}
    for k, m in mixers.items():
        expected[k], expected[f"{k}_bwd"] = again * m, m
    expected.update(rmsnorm=again * norms + 1, rmsnorm_bwd=norms + 1)
    return expected


def train_family(arch: str, layers: int, b: int, s: int, gen,
                 remat: str = "none") -> dict:
    """One id's train step at full width, ``layers`` deep: FAMILY_WARMUP +
    FAMILY_STEPS AdamW steps on one repeated batch, the launch counts read
    around the counted ones; then the step's export on fake ``cuda``
    tensors and its prediction on ``h100``, the gradient gate (the hybrid's
    on its first GATE_SUPER_BLOCKS super-blocks) and one profiled step.
    Returns the launch counts."""
    cfg = get_config(arch).scaled(num_layers=layers, remat=remat)
    assert cfg.attn_impl == "kernel" and cfg.dtype == "bfloat16"
    torch.cuda.empty_cache()
    specs = model_specs(cfg)
    params = init_params(specs, gen, "cuda")
    opt_cfg = OptimizerConfig(warmup_steps=1)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, donate=True)
    batch = {k: torch.from_numpy(x).cuda() for k, x in next(SyntheticSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                   seed=0))).items()}
    n_params = param_count(specs)
    log(f"  {arch}: {layers} of {get_config(arch).num_layers} layers, "
        f"d_model {cfg.d_model}, "
        + ("" if cfg.family == "ssm" else
           f"head_dim {cfg.resolved_head_dim}, ")
        + f"{n_params / 1e9:.3f} B parameters ({cfg.dtype}), AdamW with f32 "
        f"moments, remat {remat}, batch {b}x{s}; reduced: "
        + ("none" if layers == get_config(arch).num_layers else
           f"num_layers {get_config(arch).num_layers} -> {layers}"))
    losses, times = [], []
    for i in range(FAMILY_WARMUP + FAMILY_STEPS):
        if i == FAMILY_WARMUP:
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
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: n / FAMILY_STEPS for k, n in launches.items()}
    expected = train_launches(cfg)
    step_s = statistics.median(times[FAMILY_WARMUP:])
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; step "
        f"{b}x{s}: median {step_s * 1e3:.2f} ms over steps "
        f"{FAMILY_WARMUP}..{FAMILY_WARMUP + FAMILY_STEPS - 1} "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}), "
        f"{b * s / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
        f"({card()})")
    log(f"  launches a step: {per_step}")
    if per_step != expected:
        raise AssertionError(f"{arch} train launches a step {per_step}, "
                             f"expected {expected}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"{arch} losses {losses}: not finite, or not "
                             "falling on a repeated batch")
    profile_window(f"{arch} train step {b}x{s}",
                   lambda: float(step_fn(params, opt_state, batch)[2]["loss"]),
                   top=12, groups=FAMILY_TRAIN_GROUPS)
    del opt_state, step_fn
    torch.cuda.empty_cache()

    # the step's export on fake cuda tensors, and its prediction
    step, args = train_step_exports(cfg, s, b)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in COUNTERS.items()}
    mem = torch.cuda.memory_allocated()
    w = export_workload(step, *args, name=f"{arch}-{layers}", device="cuda")
    if torch.cuda.memory_allocated() != mem or {
            k: fn.launches for k, fn in COUNTERS.items()} != counts:
        raise AssertionError(f"{arch} export: device memory or a launch "
                             "counter moved")
    ops = w.meta["kernel_ops"]
    want = {op: per_step[k] for op, k in EXPORT_COUNTERS.items()
            if per_step[k]}
    if ops != want:
        raise AssertionError(f"{arch} export: operator nodes {ops}, expected "
                             f"{want}")
    flops = int(ir.program_cost(ir.parse_stablehlo(
        w.stablehlo_text, frontend="streaming")).by_op["dot_general"])
    system = default_registry().get("h100")
    p = PredictionJob(
        program=w.program("raw"), slicer="linear", name=w.name,
        system_name="h100", topology=build_topology(TopologySpec.from_dict(
            {"kind": "a2a", "params": {"num_devices": 1}}), system),
        estimator=build_estimator(EstimatorSpec.from_dict(
            PREDICT_ESTIMATORS["roofline"]), system)).run()
    log(f"  export on the card: trace {w.meta['trace_s']:.2f} s, emit "
        f"{w.meta['emit_s']:.3f} s, {w.meta['text_bytes']} bytes, operator "
        f"nodes {ops} (the launches a step), dot_general {flops} FLOPs; "
        f"roofline by region on h100 {p.step_time_s * 1e3:.2f} ms beside "
        f"the measured {step_s * 1e3:.2f} ms (predicted/measured "
        f"{p.step_time_s / step_s:.4f}, not held)")
    del w, step, args
    # at the reference's init each id's bf16 gradients, through the kernels
    # or the plain path, are about as far from f32 as unrelated vectors
    # (0.1 to 4.8 of the norm), so that a gate there holds nothing and
    # passes or fails with the draw (tools/gate_draws.py, PERF.md); at
    # fan-in init they are within 0.08 of it on the gates' models
    fan_in_init(specs, params, gen)
    log("    the gate's weights: the step's model redrawn at fan-in init")
    cut = None
    if cfg.family == "hybrid":
        cut = GATE_SUPER_BLOCKS * cfg.hybrid_attn_every
        log(f"    the gate's model: the first {GATE_SUPER_BLOCKS} "
            f"super-blocks ({cut} Mamba2 layers, the shared block "
            f"{GATE_SUPER_BLOCKS} times)")
    elif cfg.family == "ssm":
        cut = GATE_SSM_LAYERS
        log(f"    the gate's model: the first {cut} layers")
    if cut is None:
        family_gate(cfg, params, batch)
    else:
        family_gate(cfg.scaled(num_layers=cut), dict(params, layers=tree_map(
            params["layers"], lambda t: t[:cut])), batch)
    del params
    torch.cuda.empty_cache()
    return launches


def families_train_phase() -> list:
    """Phase 15: the seven ids' train steps, each id's weights drawn from a
    generator of its own; their launch counts."""
    runs = []
    for arch, layers, b, s, remat in FAMILY_TRAIN:
        t1 = time.perf_counter()
        runs.append(train_family(arch, layers, b, s, seeded(f"train {arch}"),
                                 remat))
        log(f"  {arch}: {time.perf_counter() - t1:.1f} s")
    return runs


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


# each launch counter's kernels (as ``kernel_fn`` names them) and how many
# of them one launch runs on the main paths (bf16)
PORT_KERNELS = {
    "flash_attention": (("flash_fwd_bf16", "flash_fwd_f32"), 1),
    "flash_attention_bwd": (("bwd_delta", "bwd_dkdv_ws", "bwd_dq_ws",
                             "bwd_dkdv_f32", "bwd_dq_f32"), 3),
    "rmsnorm": (("rmsnorm_rows", "rmsnorm_kernel"), 1),
    "rmsnorm_bwd": (("rmsnorm_bwd_groups", "rmsnorm_bwd_block",
                     "rmsnorm_bwd_dw"), 2),
    "ssd_scan": (("ssd_scan_bf16", "ssd_scan_f32"), 1),
    "ssd_scan_bwd": (tuple(K3B_KERNELS), 3),
}
# Late in this script a profiled window loses the device records of its
# first launches, while the runtime saw them: the first 3 or 4 kernels of
# every stablelm-12b step profiled after zamba2-2.7b's train step, however
# long the window idled first.  So a window opens with
# PROFILE_WARM_LAUNCHES small launches of its own, which take that loss;
# PORT_KERNELS' counts then show that the call lost nothing.  64 did not
# always do: a stablelm-12b step profiled after deepseek-67b's in a process
# of its own lost one K2 record too.
PROFILE_WARM_LAUNCHES = 256


def profile_window(name: str, fn, top: int = 10, groups=None,
                   op_groups=None) -> None:
    """Device time by kernel (the ``top`` kernels) and the device's busy
    share over one call of ``fn``, from ``torch.profiler``; with ``groups``
    ({label: substrings of kernel names}) also the device time of each
    group, the first matching label taking a kernel, and with
    ``op_groups`` ({label: PyTorch op names}) the device time of the
    kernels those ops launched themselves (and the top ops), the rest as
    "other".  The kernels the profiler saw of each of the port's must be
    those the launch counters counted in the call, times the kernels a
    launch runs (PORT_KERNELS), or the window raises: a profile that lost
    records splits nothing."""
    from torch.profiler import ProfilerActivity, profile

    saved = {k: f.launches for k, f in COUNTERS.items()}
    for f in COUNTERS.values():
        f.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARM_LAUNCHES):
            torch.cuda._sleep(1000)  # spin_kernel, left out below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: f.launches for k, f in COUNTERS.items()}
    for k, f in COUNTERS.items():
        f.launches = saved[k] + launched[k]
    events = prof.key_averages()
    spins = sum(e.count for e in events if e.device_type.name == "CUDA"
                and "spin_kernel" in e.key)
    on_device = [e for e in events if e.device_type.name == "CUDA"
                 and "spin_kernel" not in e.key]
    seen = {k: sum(e.count for e in on_device if kernel_fn(e.key) in names)
            for k, (names, _) in PORT_KERNELS.items()}
    want = {k: launched[k] * per for k, (_, per) in PORT_KERNELS.items()}
    log(f"  {name}: the port's kernels the profiler saw "
        f"{ {k: n for k, n in seen.items() if n or want[k]} }, the launch "
        f"counters times the kernels a launch runs "
        f"{ {k: n for k, n in want.items() if n or seen[k]} }; "
        f"{spins} of the {PROFILE_WARM_LAUNCHES} warm-up launches seen")
    if seen != want:
        raise AssertionError(f"{name}: the profiler saw {seen} of the "
                             f"port's kernels, the counters say {want}")
    kernels = [e for e in on_device if e.self_device_time_total > 0]
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
    if not (groups or op_groups):
        return
    sums = {}
    rest = list(kernels)
    for g, keys in (groups or {}).items():
        mine = [e for e in rest if any(k in e.key for k in keys)]
        rest = [e for e in rest if e not in mine]
        sums[g] = sum(e.self_device_time_total for e in mine) / 1e3
    ops = [e for e in events if e.device_type.name == "CPU"
           and e.self_device_time_total > 0]
    for g, names in (op_groups or {}).items():
        sums[g] = sum(e.self_device_time_total for e in ops
                      if e.key in names or e.key.rstrip("_") in names) / 1e3
    if op_groups:
        sums["other"] = busy_ms - sum(sums.values())
    else:
        sums["other"] = sum(e.self_device_time_total for e in rest) / 1e3
    log("  by group: " + "; ".join(f"{g} {ms:.2f} ms ({ms / busy_ms:.1%})"
                                  for g, ms in sums.items()))
    if op_groups:
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"    op {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<5} {e.key}")


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
    k3b_names = ("bwd_states_wg", "bwd_chunk", "bwd_reduce", "bwd_state_scan",
                 "bwd_state_local")
    for line in diag.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "wgmma" in line and "serializ" in line:
            log(f"  ptxas {entry[:90]}: {line.strip()[:300]}")
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            name = kernel_name(entry)
            log(f"  ptxas {(name if name != entry else entry)[:90]}: "
                f"{line.split(':', 1)[1].strip()}; {spills}")
            if name.startswith(("bwd_", "rmsnorm_bwd")):
                regs = line.split("Used")[1].split("registers")[0].strip()
                spill = sum(int(w) for w in spills.split()
                            if w.isdigit()) - int(spills.split()[0])
                label = ("K3b" if name.startswith(k3b_names) else
                         "K2b" if name.startswith("rmsnorm_bwd") else "K1b")
                backward.append(f"{label} {name} {regs} registers, "
                                f"{'no spill' if not spill else spills}")
    # the backwards' entries by name (ptxas reports no register count for
    # an entry it did not rebuild: none when the library was cached)
    for line in backward:
        log(f"  {line}")

    lap = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"  {name}: {now - lap[0]:.1f} s")
        lap[0] = now

    runs = []
    # phase 10 (d)'s grids and phase 11 (a)'s exports trace on the host
    # from here on, while phases 3 to 9 drive the card
    with HostWork() as host:
        log("[3] kernels against their plain versions")
        k1 = check_k1(seeded("K1"))
        k2 = check_k2(seeded("K2"))
        k1b = check_k1b(seeded("K1b"))
        check_k1b_families(seeded("K1b families"))
        k2b = check_k2b(seeded("K2b"))
        k3 = check_k3(seeded("K3"))
        k3b = check_k3b(seeded("K3b"))
        phase_done("phase 3")
        for arch in ("llama3-1b", "mamba2-370m"):
            log(f"[4] {arch} serving path; [5] where the time goes")
            runs.append(serve(arch, seeded(f"serve {arch}")))
        phase_done("phases 4 and 5")
        log("[6] llama3-1b training path")
        train_launches, step_s = train_llama(seeded("train llama3-1b"))
        runs.append(train_launches)
        phase_done("phase 6")
        log("[7] gradient gate and the training CLI")
        gradient_gate(seeded("gradient gate"))
        gradient_gate(seeded("gradient gate, fan-in"), fan_in=True)
        train_cli()
        phase_done("phase 7")
        log("[8] export on the card")
        exported = export_on_the_card(train_launches)
        phase_done("phase 8")
        log("[9] predict on the card")
        predict_on_the_card(exported, step_s)
        phase_done("phase 9")
        log("[10] the per-rank step of a [4, 1] data mesh")
        predicted = mesh_predict(mesh_export())
        rank_launches, rank_s = rank_step(seeded("rank step"), predicted)
        runs.append(rank_launches)
        mesh_campaigns(host)
        phase_done("phase 10")
        log("[11] fig7: the data-parallel ResNet step")
        launches, one_card = fig7_phase(seeded("fig7"), host.fig7())
        runs.append(launches)
        phase_done("phase 11")
    log("[12] profiling on the card")
    launches, profiled = profiling_phase(train_launches, step_s, rank_s,
                                         one_card["resnet18"], smi)
    runs.append(launches)
    phase_done("phase 12")
    log("[13] the learned estimator and the what-if search on the card")
    learned_phase(profiled, smi)
    phase_done("phase 13")
    log("[14] other families serving: mixtral-8x22b (sparse MoE), "
        "gemma2-27b, qwen2.5-32b, deepseek-67b, stablelm-12b (head_dim "
        "160), zamba2-2.7b (the hybrid, head_dim 80), deepseek-v3-671b "
        "(MLA, K1 at query/key 192 and value 128; 256 experts at top-8)")
    runs += families_phase()
    phase_done("phase 14")
    log("[15] the families' training paths: mamba2-370m (K3, K3b), "
        "mixtral-8x22b, gemma2-27b, qwen2.5-32b, deepseek-67b, stablelm-12b "
        "(K1b at head_dim 160), zamba2-2.7b (K3b, K1b at head_dim 80, "
        "remat full)")
    runs += families_train_phase()
    phase_done("phase 15")
    # launches on the main paths: K1 and K2 run on several
    for entry in (k1, k2, k3, k1b, k2b, k3b):
        key = entry["name"]
        entry["launches"] = sum(run[key] for run in runs)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k1b, k2b, k3b]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
