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
3. each kernel (K1 flash attention, K2 RMSNorm, K3 the whole SSD scan) against
   its plain PyTorch version at the serving paths' shapes and in the layout
   the path hands it, in bf16 and f32, with its time, its bound, the plain
   version's time and, where one exists, one PyTorch library call's time as
   a yardstick (the port never calls that library function); K2 also
   beside the time of one copy of its input, which the card's memory sets;
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
   share).

The last lines are one JSON object ``{"kernels": [...]}``, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, kernel_error)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    kernel_error as rmsnorm_error, rmsnorm_ref)
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    kernel_error as ssd_error, ssd_scan_ref)
from repro_torch.models.attention import gqa_forward  # noqa: E402
from repro_torch.models.common import embed_lookup, rms_norm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.ssm import mamba2_forward  # noqa: E402
from repro_torch.models.transformer import (TransformerLM, _embed,  # noqa: E402
                                            decode_step, init_cache_specs,
                                            prefill)
from repro_torch.models.params import init_params  # noqa: E402

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
            torch.cuda.synchronize()
            err, elem, row = kernel_error(out, q, k, v, **kw)
            ok = all(math.isfinite(x) for x in (err, elem, row)) and max(
                elem, row) <= 1.0
            log(f"  K1 {name:<12} {str(dtype)[6:]:<8} B={b} Hq={hq} Hkv={hkv} "
                f"Sq={sq} Skv={skv} d={d} max_abs_err={err:.3e}; in units of "
                f"the tolerance: element {elem:.3f}, row {row:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} {dtype}: max abs err {err}, "
                                     f"element {elem}, row {row} of tol")
            if name != "prefill":
                continue
            ms = device_ms(lambda: flash_attention(q, k, v, **kw))
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
                f"({scores / 1e6:.1f} M visible scores)")
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
            "ssd_scan": ssd_scan}


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
# phase 5: where the time goes (torch.profiler)
# --------------------------------------------------------------------------

def where_the_time_goes(model, prompts, dprompts) -> None:
    """Device time by kernel and the device's busy share over one prefill
    and over 8 decode steps, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

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
            continue
        log(f"  {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<5} {e.key[:80]}")


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

    k3 = check_k3(gen)

    runs = []
    for arch in ("llama3-1b", "mamba2-370m"):
        log(f"[4] {arch} serving path; [5] where the time goes")
        runs.append(serve(arch, gen))
    # launches on the two main paths: K2 runs on both
    for entry in (k1, k2, k3):
        key = entry["name"]
        entry["launches"] = sum(run[key] for run in runs)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
