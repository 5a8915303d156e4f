#!/usr/bin/env python3
"""Time an older tree of the port against this one on one H100, in turns
(old, new, new, old), each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    python3 tools/ab_k1b.py build/parent

For each tree: K1b (the flash-attention backward) and SDPA's backward at
llama3-1b's training case (B=4, 32/8 heads, S=2048, d=64, causal, bf16),
with K1b's device time split by kernel (``torch.profiler``: delta, dK/dV,
dQ); K2b (the RMSNorm backward) and ``F.rms_norm``'s backward at 8192x2048
and 8192x1024 in bf16; and the llama3-1b train step at 4x2048 (AdamW, the
median of 4 steps after 2 warm-ups).  Each tree builds its own kernels
under its own ``build/``.  Prints the card's name and power limit, then one
JSON line per run.
"""
import sys

from ab_k1 import run_ab

RUN = r'''
import json, statistics, sys, time, torch
import torch.nn.functional as F
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as k1_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import model_specs
from repro_torch.train.data import DataConfig, SyntheticSource
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
r = {}
kw = dict(causal=True, window=0, logit_cap=0.0, q_offset=0)
q, k, v = cs.k1_inputs(gen, "x", 4, 32, 8, 2048, 2048, 64, torch.bfloat16)
do, _, _ = cs.k1_inputs(gen, "x", 4, 32, 8, 2048, 2048, 64, torch.bfloat16)
o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)
r["k1b_ms"] = cs.device_ms(bwd)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(10):
        bwd()
    torch.cuda.synchronize()
for e in prof.key_averages():
    for part in ("bwd_delta", "bwd_dkdv", "bwd_dq"):
        if part in e.key and e.self_device_time_total > 0:
            r[part + "_ms"] = e.self_device_time_total / 1e3 / 10
lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
y = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                   enable_gqa=True)
r["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(
    y, (lq, lk, lv), do, retain_graph=True))
del q, k, v, do, o, lse, lq, lk, lv, y
for rows, d in ((8192, 2048), (8192, 1024)):
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    dy = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    r[f"k2b_{rows}x{d}_ms"] = cs.device_ms(lambda: rmsnorm_bwd(x, w, dy))
    lx, lw = (t.detach().requires_grad_(True) for t in (x, w))
    y = F.rms_norm(lx, (d,), lw, 1e-5)
    r[f"rms_norm_bwd_{rows}x{d}_ms"] = cs.device_ms(lambda: torch.autograd.grad(
        y, (lx, lw), dy, retain_graph=True))
    del x, w, dy, lx, lw, y
torch.cuda.empty_cache()
cfg = get_config("llama3-1b")
params = init_params(model_specs(cfg), gen, "cuda")
opt_cfg = OptimizerConfig(warmup_steps=1)
opt_state = adamw_init(params, opt_cfg)
step_fn = make_train_step(cfg, opt_cfg)
batch = {key: torch.from_numpy(a).cuda() for key, a in next(SyntheticSource(
    DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=4,
               seed=0))).items()}
times = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, metrics = step_fn(params, opt_state, batch)
    float(metrics["loss"])
    times.append((time.perf_counter() - t0) * 1e3)
r["train_step_ms_runs"] = times[2:]
r["train_step_ms"] = statistics.median(times[2:])
print("RESULT " + json.dumps(r), flush=True)
'''


if __name__ == "__main__":
    sys.exit(run_ab(RUN, __doc__))
