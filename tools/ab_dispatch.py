#!/usr/bin/env python3
"""Time an older tree of the port against this one on one H100 where the
host's dispatch of each kernel call sets the pace, in turns (old, new, new,
old), each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    python3 tools/ab_dispatch.py build/parent

For each tree: the host's time for one call of K2 (``rmsnorm``) at the
decode shape, 8x2048 bf16 (2000 calls back to back, then a synchronise;
the median of 5 such runs), and ``greedy_decode`` of llama3-1b and
mamba2-370m on 8 prompts of 64 tokens with 32 new tokens (ms a step over
its 96 steps, the median of 3 runs after a warm-up).  Each tree builds its
own kernels under its own ``build/``.  Prints the card's name and power
limit, then one JSON line per run.
"""
import sys

from ab_k1 import run_ab

RUN = r'''
import json, statistics, sys, time, torch
sys.path.insert(0, "src")
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import TransformerLM
_build.build()
gen = torch.Generator(device="cuda").manual_seed(0)
r = {}
x = torch.randn(8, 2048, generator=gen, device="cuda").bfloat16()
w = torch.ones(2048, device="cuda").bfloat16()
runs = []
with torch.inference_mode():
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            rmsnorm(x, w, 1e-5)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / 2000 * 1e6)
r["k2_call_us_runs"] = runs
r["k2_call_us"] = statistics.median(runs)
for arch in ("llama3-1b", "mamba2-370m"):
    cfg = get_config(arch)
    model = TransformerLM(cfg, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                            device="cuda", dtype=torch.int32)
    times = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(prompts, max_new_tokens=32, max_len=128)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 96 * 1e3)
    r[f"{arch}_decode_ms_runs"] = times[1:]
    r[f"{arch}_decode_ms"] = statistics.median(times[1:])
    del model
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(r), flush=True)
'''

if __name__ == "__main__":
    sys.exit(run_ab(RUN, __doc__))
