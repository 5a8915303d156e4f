#!/usr/bin/env python3
"""Time an older tree of the port against this one on one H100, in turns
(old, new, new, old), each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    python3 tools/ab_k1.py build/parent

For each tree: K1 (flash attention) and SDPA at the llama3-1b prefill case
(B=4, 32/8 heads, S=2048, d=64, causal), K2 (RMSNorm) and ``F.rms_norm``
at 8192x2048, 8192x1024 and 8x2048 in bf16, and llama3-1b ``prefill`` on
4 prompts of 2048 tokens (the median of 5 runs after 2 warm-ups).  Each
tree builds its own kernels under its own ``build/``.  Prints the card's
name and power limit, then one JSON line per run.
"""
import json
import os
import subprocess
import sys

RUN = r'''
import json, statistics, sys, time, torch
import torch.nn.functional as F
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import TransformerLM
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
r = {}
q, k, v = cs.k1_inputs(gen, "prefill", 4, 32, 8, 2048, 2048, 64,
                       torch.bfloat16)
r["k1_ms"] = cs.device_ms(lambda: flash_attention(q, k, v, causal=True))
r["sdpa_ms"] = cs.device_ms(lambda: F.scaled_dot_product_attention(
    q, k, v, is_causal=True, enable_gqa=True))
for rows, d in ((8192, 2048), (8192, 1024), (8, 2048)):
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    r[f"k2_{rows}x{d}_ms"] = cs.device_ms(lambda: rmsnorm(x, w, 1e-5))
    r[f"rms_norm_{rows}x{d}_ms"] = cs.device_ms(
        lambda: F.rms_norm(x, (d,), w, 1e-5))
del q, k, v
model = TransformerLM(get_config("llama3-1b"), generator=gen)
prompts = torch.randint(0, 32768, (4, 2048), generator=gen, device="cuda",
                        dtype=torch.int32)
times = []
with torch.inference_mode():
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
r["prefill_ms_runs"] = times[2:]
r["prefill_ms"] = statistics.median(times[2:])
print("RESULT " + json.dumps(r), flush=True)
'''


def run_ab(run: str, doc: str) -> int:
    """Runs the script ``run`` in the tree given on the command line and in
    this one, in turns (old, new, new, old), each in a process of its own,
    and prints its ``RESULT`` line for each; returns 1 when a run failed."""
    if len(sys.argv) != 2:
        print(doc, file=sys.stderr)
        return 2
    old = os.path.abspath(sys.argv[1])
    new = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    failed = 0
    for name, tree in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, "-c", run], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        lines = [line[7:] for line in proc.stdout.splitlines()
                 if line.startswith("RESULT ")]
        if lines:
            print(name, json.dumps(json.loads(lines[0])), flush=True)
        else:
            failed = 1
            print(f"{name} FAILED (exit {proc.returncode}): "
                  f"{proc.stderr[-1500:]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(run_ab(RUN, __doc__))
