#!/usr/bin/env python3
"""Where a K3 (bf16 SSD scan) block spends its cycles, on an H100:

    python3 tools/trace_k3.py

Writes a copy of ``src/`` and ``chip_smoke.py`` into a temporary directory,
adds ``clock64()`` stamps to ``ssd_scan.cu`` there (block 0, thread 0 of
each consumer warpgroup, every chunk), builds it, runs the mamba2-370m
prefill case (B=4, S=2048, 32 heads, P=64, N=128, L=256, strided) and the
under-filled ``long_init`` case (B=1, S=16384, 64 chunks), and prints the
mean cycles of each step of a chunk for both consumers: the scan of dt a,
y (and, inside it, the waits for C, B and x tiles), the local state (and
its waits for B and x), the wait for the other consumer at the chunk's end,
and staging the new state.  The repository's files are never changed.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
STEPS = ["scan of dt a", "y (C S^T, C B^T, P x, store)", "local state",
         "wait for the other consumer", "stage the state"]
COND = "if (blockIdx.x == 0 && t == 0 && c < 64) "


def stamp(s: int) -> str:
    return f"{COND}g_trace[cw][c][{s}] = clock64();"


def timed_wait(call: str, acc: str) -> str:
    return (f"{{ const long long w0 = clock64(); {call} "
            f"{acc} += clock64() - w0; }}")


SUBS = [
    ('#include "../../common/csrc/hopper.cuh"\n\nnamespace {',
     '#include "../../common/csrc/hopper.cuh"\n'
     "__device__ long long g_trace[2][64][8];\nnamespace {"),
    ("    const uint32_t ph = c & 1;\n    const int s0 = c * L;\n",
     "    const uint32_t ph = c & 1;\n    const int s0 = c * L;\n"
     f"    long long wa = 0, wb = 0;\n    {stamp(0)}\n"),
    ('    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     "    named_sync(kBarAll, 256);\n",
     '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     f"    named_sync(kBarAll, 256);\n    {stamp(1)}\n"),
    ("      mbar_wait(bar_fc + 8 * it, ph);\n",
     f"      {timed_wait('mbar_wait(bar_fc + 8 * it, ph);', 'wa')}\n"),
    ("        mbar_wait(bar_fb + 8 * jt, ph);\n",
     f"        {timed_wait('mbar_wait(bar_fb + 8 * jt, ph);', 'wa')}\n"),
    ("    for (int i = 0; i < tiles; ++i) mbar_arrive(bar_ec + 8 * i);\n",
     "    for (int i = 0; i < tiles; ++i) mbar_arrive(bar_ec + 8 * i);\n"
     f"    {stamp(2)}\n"),
    ("        mbar_wait(bar_fb + 8 * tt, ph);\n",
     f"        {timed_wait('mbar_wait(bar_fb + 8 * tt, ph);', 'wb')}\n"),
    ("    named_sync(kBarAll, 256);\n    stage_state();\n",
     f"    {stamp(3)}\n    named_sync(kBarAll, 256);\n    {stamp(4)}\n"
     f"    stage_state();\n    {stamp(5)}\n"
     f"    {COND}{{ g_trace[cw][c][6] = wa; g_trace[cw][c][7] = wb; }}\n"),
]
TAIL = '''
extern "C" int repro_ssd_trace(long long* out) {
  cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  return cudaGetLastError();
}
'''
RUN = r'''
import ctypes, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ops import ssd_scan
lib = _build.library()
STEPS = %r
gen = torch.Generator(device="cuda").manual_seed(0)
for name, b, s in (("prefill_strided", 4, 2048), ("long_init", 1, 16384)):
    x, dt, a, bm, cm, st0 = cs.k3_inputs(gen, b, s, 32, 64, 1, 128, 256,
                                         True, name == "long_init", "mamba",
                                         torch.bfloat16)
    for _ in range(3):
        ssd_scan(x, dt, a, bm, cm, chunk=256, initial_state=st0)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * 64 * 8))()
    lib.repro_ssd_trace(buf)
    tr = [[[buf[(c * 64 + i) * 8 + k] for k in range(8)] for i in range(64)]
          for c in range(2)]
    nc = min(s // 256, 64)
    print(f"{name}: mean cycles of each step over chunks 1..{nc - 1} of "
          f"block 0 (consumer 0, consumer 1); chunk 0 in brackets")
    def mean(c, fn):
        return sum(fn(tr[c][i]) for i in range(1, nc)) / (nc - 1)
    for k, step in enumerate(STEPS):
        m = [mean(c, lambda r: r[k + 1] - r[k]) for c in range(2)]
        first = [tr[c][0][k + 1] - tr[c][0][k] for c in range(2)]
        print(f"  {step:<32} {m[0]:8.0f} {m[1]:8.0f}   "
              f"[{first[0]:.0f} {first[1]:.0f}]")
    for k, step in ((6, "  of y: waits for C, B, x"),
                    (7, "  of the state: waits for B, x")):
        m = [mean(c, lambda r: r[k]) for c in range(2)]
        print(f"  {step:<32} {m[0]:8.0f} {m[1]:8.0f}   "
              f"[{tr[0][0][k]:.0f} {tr[1][0][k]:.0f}]")
    whole = [sum(tr[c][i + 1][0] - tr[c][i][0] for i in range(1, nc - 1))
             / max(nc - 2, 1) for c in range(2)]
    print(f"  {'a whole chunk':<32} {whole[0]:8.0f} {whole[1]:8.0f}",
          flush=True)
'''


def main() -> int:
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    tmp = tempfile.mkdtemp(prefix="k3_trace_")
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
