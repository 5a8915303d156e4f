#!/usr/bin/env python3
"""Time an older tree's K3b (the SSD scan's backward) against this one's on
one H100, in turns (old, new, new, old), each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    python3 tools/ab_k3b.py build/parent

For each tree: K3b in bf16 at mamba2-370m's train case (B=4, S=2048, 32
heads of P=64, N=128, one group, chunk 256, strided, on the inbound states
K3 writes) as the median of 3 batches of 3 CUDA-event-timed launches, and
mamba2-370m's train step at full depth (48 layers, 4 x 2048, AdamW donated,
remat off, as ``chip_smoke.py`` phase 15 runs it) as the median of 5 steps
after 2 warm-ups.  Each tree builds its own kernels under its own
``build/``.  Prints the card's name and power limit, then one JSON line per
run.
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
from repro_torch.kernels.ssd_scan import ops as k3_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
r = {}
x, dt, a, bm, cm, _ = cs.k3_inputs(gen, 4, 2048, 32, 64, 1, 128, 256, True,
                                   False, "mamba", torch.bfloat16)
args = (x, dt, a, bm, cm)
_, _, states = k3_ops._launch(*args, 256, None, with_states=True)
dy = torch.randn(4, 2048, 32, 64, generator=gen, device="cuda").to(x.dtype)
r["k3b_ms"] = cs.device_ms(lambda: ssd_scan_bwd(*args, states, dy,
                                                chunk=256),
                           batches=3, per_batch=3)
del x, dt, a, bm, cm, states, dy, args
torch.cuda.empty_cache()
cfg = cs.get_config("mamba2-370m").scaled(num_layers=48, remat="none")
params = cs.init_params(cs.model_specs(cfg), gen, "cuda")
opt_cfg = cs.OptimizerConfig(warmup_steps=1)
opt_state = cs.adamw_init(params, opt_cfg)
step_fn = cs.make_train_step(cfg, opt_cfg, donate=True)
batch = {k: torch.from_numpy(v).cuda() for k, v in next(cs.SyntheticSource(
    cs.DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=4,
                  seed=0))).items()}
times = []
for _ in range(7):
    t0 = time.perf_counter()
    params, opt_state, metrics = step_fn(params, opt_state, batch)
    float(metrics["loss"])
    times.append((time.perf_counter() - t0) * 1e3)
r["step_ms_runs"] = times[2:]
r["step_ms"] = statistics.median(times[2:])
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
