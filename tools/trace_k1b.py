#!/usr/bin/env python3
"""Where K1b's bf16 dK/dV and dQ blocks spend their cycles, on an H100:

    python3 tools/trace_k1b.py

Writes a copy of ``src/`` and ``chip_smoke.py`` into a temporary directory,
adds ``clock64()`` stamps to ``flash_attention_bwd.cu`` there (block 0, its
first work item, thread 0 of each consumer warpgroup), builds it, runs
llama3-1b's training case (B=4, 32/8 heads, S=2048, d=64, causal), and
prints for each kernel the mean cycles of each phase of a step, for both
consumers.  Block 0's first items are the longest: 128 steps of dK/dV (4
query heads x 32 query tiles) and 16 key tiles of dQ.  The repository's
files are never changed.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
STEPS = ["wait for the stage", "wait for the turn", "issue, pass the turn",
         "wait S (and last dV/dK/dQ)", "P (dK/dV) or nothing (dQ)",
         "wait dP", "dS and bf16 packing"]
KERNELS = ["dK/dV (bwd_dkdv_ws)", "dQ (bwd_dq_ws)"]


def stamp(kernel: int, s: int) -> str:
    return (f"if (blockIdx.x == 0 && j == 0 && t == 0 && i < 160) "
            f"g_trace[{kernel}][c][i][{s}] = clock64();")


def subs() -> list[tuple[str, str, int]]:
    """(old, new, which occurrence): 0 the dK/dV kernel's, 1 the dQ
    kernel's (the loops are alike)."""
    out = [('#include "../../common/csrc/hopper.cuh"\n\nnamespace {',
            '#include "../../common/csrc/hopper.cuh"\n'
            "__device__ long long g_trace[2][2][160][8];\nnamespace {", 0)]
    for k in (0, 1):
        out.append((
            "        const int cur = it + i;\n"
            "        mbar_wait(bar_f + 8 * (cur % kS), (cur / kS) & 1);\n"
            "        take_turn();\n",
            "        const int cur = it + i;\n"
            f"        {stamp(k, 0)}\n"
            "        mbar_wait(bar_f + 8 * (cur % kS), (cur / kS) & 1);\n"
            f"        {stamp(k, 1)}\n"
            "        take_turn();\n"
            f"        {stamp(k, 2)}\n", 0))
        out.append(("        pass_turn();\n        step(i);\n",
                    f"        pass_turn();\n        {stamp(k, 3)}\n"
                    "        step(i);\n", 0))
    # inside the step lambdas: the first of each comment is dK/dV's
    out += [
        ("      wgmma_wait<1>();  // S^T, and the previous step's dK and dV,"
         " are done\n",
         "      wgmma_wait<1>();\n" f"      {stamp(0, 4)}\n", 0),
        ("      wgmma_wait<0>();  // dP^T is done\n",
         f"      {stamp(0, 5)}\n      wgmma_wait<0>();\n"
         f"      {stamp(0, 6)}\n", 0),
        ("      to_frags<kRowsQ>(df, dp);\n    };\n",
         f"      to_frags<kRowsQ>(df, dp);\n      {stamp(0, 7)}\n    }};\n", 0),
        ("      wgmma_wait<1>();  // S, and the previous tile's dQ, are done\n",
         "      wgmma_wait<1>();\n" f"      {stamp(1, 4)}\n", 0),
        ("      wgmma_wait<0>();  // dP is done\n",
         f"      {stamp(1, 5)}\n      wgmma_wait<0>();\n"
         f"      {stamp(1, 6)}\n", 0),
        ("      to_frags<kKeys>(df, dp);\n    };\n",
         f"      to_frags<kKeys>(df, dp);\n      {stamp(1, 7)}\n    }};\n", 0),
    ]
    return out


TAIL = '''
extern "C" int repro_k1b_trace(long long* out) {
  cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  return cudaGetLastError();
}
'''
RUN = r'''
import ctypes, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as k1_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
lib = _build.library()
STEPS, KERNELS = %r, %r
gen = torch.Generator(device="cuda").manual_seed(0)
kw = dict(causal=True, window=0, logit_cap=0.0, q_offset=0)
q, k, v = cs.k1_inputs(gen, "x", 4, 32, 8, 2048, 2048, 64, torch.bfloat16)
do, _, _ = cs.k1_inputs(gen, "x", 4, 32, 8, 2048, 2048, 64, torch.bfloat16)
o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
for _ in range(3):
    flash_attention_bwd(q, k, v, o, lse, do, **kw)
torch.cuda.synchronize()
n = 2 * 2 * 160 * 8
buf = (ctypes.c_longlong * n)()
lib.repro_k1b_trace(buf)
tr = lambda kn, c, i, s: buf[((kn * 2 + c) * 160 + i) * 8 + s]
for kn, steps in ((0, 128), (1, 16)):
    print(f"{KERNELS[kn]}: mean cycles of each phase over steps 1..{steps - 2}"
          " of block 0's first item (consumer 0, consumer 1)")
    for s, name in enumerate(STEPS):
        means = [sum(tr(kn, c, i, s + 1) - tr(kn, c, i, s)
                     for i in range(1, steps - 1)) / (steps - 2)
                 for c in range(2)]
        print(f"  {name:<30} {means[0]:8.0f} {means[1]:8.0f}")
    whole = [sum(tr(kn, c, i + 1, 0) - tr(kn, c, i, 0)
                 for i in range(1, steps - 1)) / (steps - 2)
             for c in range(2)]
    print(f"  {'a whole step':<30} {whole[0]:8.0f} {whole[1]:8.0f}",
          flush=True)
'''


def main() -> int:
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    tmp = tempfile.mkdtemp(prefix="k1b_trace_")
    try:
        shutil.copytree("src", os.path.join(tmp, "src"))
        shutil.copy("chip_smoke.py", tmp)
        path = os.path.join(tmp, SRC)
        with open(path) as f:
            text = f.read()
        for old, new, _ in subs():
            if old not in text:
                raise RuntimeError(f"{old!r} not found")
            text = text.replace(old, new, 1)
        with open(path, "w") as f:
            f.write(text + TAIL)
        proc = subprocess.run(
            [sys.executable, "-c", RUN % (STEPS, KERNELS)], cwd=tmp,
            capture_output=True, text=True, timeout=300)
    finally:
        shutil.rmtree(tmp)
    print(proc.stdout, end="")
    if proc.returncode:
        print(proc.stderr[-2000:], file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
