#!/usr/bin/env python3
"""Where a K1 (bf16 flash attention) block spends its cycles, on an H100:

    python3 tools/trace_k1.py

Writes a copy of ``src/`` and ``chip_smoke.py`` into a temporary directory,
adds ``clock64()`` stamps to ``flash_attention.cu`` there (block 0, its
first work item, thread 0 of each consumer warpgroup), builds it, runs the
llama3-1b prefill case (B=4, 32/8 heads, S=2048, d=64) causal and not, and
prints the mean cycles of each step of a key tile for both consumers.
Block 0's first item is the heaviest (16 key tiles).  The repository's
files are never changed.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
STEPS = ["wait K", "take turn", "issue Q K^T", "wait V", "issue P V and "
         "hand over", "wait S", "softmax", "wait P V", "release, rescale, "
         "P to bf16"]


def stamp(i: str, s: int) -> str:
    return (f"if (blockIdx.x == 0 && j == 0 && t == 0) "
            f"g_trace[c][{i}][{s}] = clock64();")


SUBS = [
    ('#include "../../common/csrc/hopper.cuh"\n\nnamespace {',
     '#include "../../common/csrc/hopper.cuh"\n'
     "__device__ long long g_trace[2][64][12];\nnamespace {"),
    ("        const int cur = it + i;\n        wait_k(cur);\n"
     "        take_turn();\n        issue_qk(cur % kS);\n"
     "        wait_v(cur - 1);\n",
     f"        const int cur = it + i;\n        {stamp('i', 0)}\n"
     f"        wait_k(cur);\n        {stamp('i', 1)}\n"
     f"        take_turn();\n        {stamp('i', 2)}\n"
     f"        issue_qk(cur % kS);\n        {stamp('i', 3)}\n"
     f"        wait_v(cur - 1);\n        {stamp('i', 4)}\n"),
    ("        pass_turn();\n        wgmma_wait<1>();  "
     "// S_i is done; P_{i-1} V_{i-1} may still run\n",
     f"        pass_turn();\n        {stamp('i', 5)}\n"
     f"        wgmma_wait<1>();\n        {stamp('i', 6)}\n"),
    ("        softmax(i);\n",
     f"        softmax(i);\n        {stamp('i', 7)}\n"),
    ("        wgmma_wait<0>();  // P_{i-1} V_{i-1} is done\n",
     f"        wgmma_wait<0>();\n        {stamp('i', 8)}\n"),
    ("        rescale();\n        to_pf();\n      }\n",
     f"        rescale();\n        to_pf();\n        {stamp('i', 9)}\n"
     "      }\n"),
]
TAIL = '''
extern "C" int repro_flash_trace(long long* out) {
  cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  return cudaGetLastError();
}
'''
RUN = r'''
import ctypes, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
lib = _build.library()
STEPS = %r
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v = cs.k1_inputs(gen, "prefill", 4, 32, 8, 2048, 2048, 64,
                       torch.bfloat16)
for causal in (True, False):
    for _ in range(3):
        flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * 64 * 12))()
    lib.repro_flash_trace(buf)
    tr = [[[buf[(c * 64 + i) * 12 + s] for s in range(12)]
           for i in range(64)] for c in range(2)]
    print(f"causal={causal}: mean cycles of each step over key tiles "
          "1..15 of block 0's first item (consumer 0, consumer 1)")
    for s, name in enumerate(STEPS):
        means = [sum(tr[c][i][s + 1] - tr[c][i][s] for i in range(1, 16))
                 / 15 for c in range(2)]
        print(f"  {name:<28} {means[0]:8.0f} {means[1]:8.0f}")
    tile = [sum(tr[c][i + 1][0] - tr[c][i][0] for i in range(1, 15)) / 14
            for c in range(2)]
    print(f"  {'a whole key tile':<28} {tile[0]:8.0f} {tile[1]:8.0f}",
          flush=True)
'''


def main() -> int:
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    tmp = tempfile.mkdtemp(prefix="k1_trace_")
    try:
        shutil.copytree("src", os.path.join(tmp, "src"))
        shutil.copy("chip_smoke.py", tmp)
        path = os.path.join(tmp, SRC)
        with open(path) as f:
            text = f.read()
        for old, new in SUBS:
            if text.count(old) != 1:
                raise RuntimeError(f"{old!r} not found once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text + TAIL)
        proc = subprocess.run([sys.executable, "-c", RUN % (STEPS,)],
                              cwd=tmp, capture_output=True, text=True,
                              timeout=300)
    finally:
        shutil.rmtree(tmp)
    print(proc.stdout, end="")
    if proc.returncode:
        print(proc.stderr[-2000:], file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
