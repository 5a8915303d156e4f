#!/usr/bin/env python3
"""Time an older tree's SSD scan against this one's on one H100, in turns
(old, new, new, old), each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    python3 tools/ab_k3.py build/parent

For each tree: the whole ``ssd_scan`` at the mamba2-370m prefill case
(B=4, S=2048, 32 heads of P=64, N=128, one group, chunk 256, in the strided
layout ``mamba2_forward`` passes, bf16) as the median of 5 batches of
CUDA-event-timed calls, and mamba2-370m ``prefill`` on 4 prompts of 2048
tokens (the median of 5 runs after 2 warm-ups).  Each tree builds its own
kernels under its own ``build/``.  Prints the card's name and power limit,
then one JSON line per run.
"""
import json
import os
import subprocess
import sys

RUN = r'''
import json, statistics, sys, time, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import TransformerLM
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
r = {}
x, dt, a, bm, cm, _ = cs.k3_inputs(gen, 4, 2048, 32, 64, 1, 128, 256, True,
                                   False, "mamba", torch.bfloat16)
r["ssd_scan_ms"] = cs.device_ms(lambda: ssd_scan(x, dt, a, bm, cm,
                                                 chunk=256))
del x, dt, a, bm, cm
cfg = get_config("mamba2-370m")
model = TransformerLM(cfg, generator=gen)
prompts = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                        device="cuda", dtype=torch.int32)
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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
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
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
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
    sys.exit(main())
