#!/usr/bin/env python3
"""Where K3b (the SSD scan's backward) spends its time, on an H100:

    python3 tools/trace_k3b.py [TREE]

Copies ``TREE/src`` and ``TREE/chip_smoke.py`` (TREE defaults to this
repository) into a temporary directory, adds ``clock64()`` stamps to the
chunk kernel of ``ssd_scan_bwd.cu`` there, builds it, and runs K3b in bf16
at mamba2-370m's train case (B=4, S=2048, 32 heads of P=64, N=128, one
group, L=256, strided).  It prints each of K3b's kernels' device time a
launch (``torch.profiler`` over 5 launches) and, inside the chunk kernel,
the mean cycles a block spends in each step (blocks 0..131, the first
wave): for the wgmma kernel (``bwd_chunk_ws``) per consumer warpgroup, its
thread 0: the set-up (G and S staged, <G, S>, dacs), then in each phase
the waits for anchor and ring tiles, the state terms, the score tiles,
the exponentials, masks and M's sums, the products and the anchors'
writes, and the epilogue; for the scalar kernel (``bwd_chunk``, the f32
path, and the bf16 path of trees before the wgmma design) its thread 0.
The stamps go in whichever of the two kernels TREE's source has.  The
repository's files are never changed.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
# the wgmma kernel's steps: k + 8 ph for the phase's steps (ph 0 j-major,
# ph 1 i-major)
WS_STEPS = {0: "set-up: G_c, S_c staged, <G, S>, dacs",
            1: "j-major: waits for anchors (B_j, x_j)",
            2: "j-major: state terms B_j G^T, x_j G, q",
            3: "j-major: waits for ring tiles (C_i, dy_i)",
            4: "j-major: score tiles S^T, DX^T",
            5: "j-major: exponentials, masks, M's row sums",
            6: "j-major: hi/lo split, dx and dB products",
            7: "j-major: anchor's writes (dx, dB partial)",
            8: "wait for the other consumer at the end",
            9: "i-major: waits for anchors (C_i, dy_i)",
            10: "i-major: state term dy_i S, r",
            11: "i-major: waits for ring tiles (B_j, x_j)",
            12: "i-major: S, DX recomputed",
            13: "i-major: exponentials, masks, M's row sums",
            14: "i-major: hi/lo split, dC products",
            15: "i-major: anchor's writes (dC partial, d dacs)",
            16: "epilogue: scans, ddt, da (both consumers)"}
SCALAR_STEPS = {0: "set-up: S, G, <G, S>, dacs",
                1: "loads of x, B, C, dy (f32 in shared memory)",
                2: "state terms G B_j, G^T x_j, q",
                4: "score tiles C B^T, dy x^T",
                5: "exponentials, masks, M's sums",
                6: "dx and dB products",
                14: "dC products (with its state term) and partial",
                7: "j tile's writes (dx, dB partial)",
                16: "barrier before the epilogue",
                17: "epilogue: suffix sums, ddt, da (one thread)"}


def mark(k: str) -> str:
    return (f"if (tr_on) {{ s_tr[{k}] += clock64() - tr0; }} "
            "tr0 = clock64();")


WS_SUBS = [  # (old, new, how many times old appears)
    ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n"\n'
     '               ::"n"(Sm::kConsumerRegs));\n',
     '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n"\n'
     '               ::"n"(Sm::kConsumerRegs));\n'
     "  __shared__ long long s_trw[2][18];\n"
     "  long long* s_tr = s_trw[wg - 1];\n"
     "  const bool tr_on = blockIdx.x < 132 && threadIdx.x % 128 == 0;\n"
     "  int tr_ph = 0;\n"
     "  if (tr_on) for (int k = 0; k < 18; ++k) s_tr[k] = 0;\n"
     "  long long tr0 = clock64();\n", 1),
    ("  const float T_ = sDa[L - 1];\n\n  int n = 0, used = 0;",
     f"  const float T_ = sDa[L - 1];\n  {mark('0')}\n\n"
     "  int n = 0, used = 0;", 1),
    ("      mbar_wait(bar_af + 8 * cw, used & 1);\n",
     "      mbar_wait(bar_af + 8 * cw, used & 1);\n"
     f"      {mark('1 + 8 * tr_ph')}\n", 2),
    ("          adb[cb][e] *= f[(e >> 1) & 1] * dtj[(e >> 1) & 1];\n    }\n",
     "          adb[cb][e] *= f[(e >> 1) & 1] * dtj[(e >> 1) & 1];\n"
     f"      {mark('2')}\n    }}\n", 1),
    ("      for (int hf = 0; hf < 2; ++hf) rr[hf] = sum_quad(rr[hf]);\n"
     "    }\n",
     "      for (int hf = 0; hf < 2; ++hf) rr[hf] = sum_quad(rr[hf]);\n"
     f"      {mark('10')}\n    }}\n", 1),
    ("      mbar_wait(bar_rf + 8 * s, (n / kStages) & 1);\n",
     "      mbar_wait(bar_rf + 8 * s, (n / kStages) & 1);\n"
     f"      {mark('3 + 8 * tr_ph')}\n", 2),
    ("        fence_regs(sc);\n        fence_regs(dv);\n",
     "        fence_regs(sc);\n        fence_regs(dv);\n"
     f"        {mark('4 + 8 * tr_ph')}\n", 2),
    ("        for (int hf = 0; hf < 2; ++hf) rowacc[hf] += "
     "sum_quad(rowm[hf]);\n",
     "        for (int hf = 0; hf < 2; ++hf) rowacc[hf] += "
     f"sum_quad(rowm[hf]);\n        {mark('5')}\n", 1),
    ("        for (int hf = 0; hf < 2; ++hf) plus[hf] += sum_quad(rowm[hf]);\n",
     "        for (int hf = 0; hf < 2; ++hf) plus[hf] += sum_quad(rowm[hf]);\n"
     f"        {mark('13')}\n", 1),
    ("        fence_regs(wlo);\n        fence_regs(vhi);\n"
     "        fence_regs(vlo);\n",
     "        fence_regs(wlo);\n        fence_regs(vhi);\n"
     f"        fence_regs(vlo);\n        {mark('6')}\n", 1),
    ("        for (int cb = 0; cb < kCB; ++cb) fence_regs(adc[cb]);\n"
     "        fence_regs(vhi);\n        fence_regs(vlo);\n",
     "        for (int cb = 0; cb < kCB; ++cb) fence_regs(adc[cb]);\n"
     "        fence_regs(vhi);\n        fence_regs(vlo);\n"
     f"        {mark('14')}\n", 1),
    ("      mbar_arrive(bar_re + 8 * s);\n",
     f"      mbar_arrive(bar_re + 8 * s);\n      {mark('3 + 8 * tr_ph')}\n",
     2),
    ("adb[cb][e + 1]);\n        }\n    }\n  }\n\n  // ---- phase 1",
     f"adb[cb][e + 1]);\n        }}\n      {mark('7')}\n    }}\n  }}\n"
     "  tr_ph = 1;\n\n  // ---- phase 1", 1),
    ("adc[cb][e + 1]);\n        }\n    }\n  }\n  named_sync(kBarAll, 256);\n",
     f"adc[cb][e + 1]);\n        }}\n      {mark('15')}\n    }}\n  }}\n"
     f"  named_sync(kBarAll, 256);\n  {mark('8')}\n", 1),
    ("    for (int w = 1; w < 8; ++w) da += sRed[32 + w];\n"
     "    da_part[blockIdx.x] = da;\n  }\n}",
     "    for (int w = 1; w < 8; ++w) da += sRed[32 + w];\n"
     "    da_part[blockIdx.x] = da;\n  }\n"
     f"  {mark('16')}\n"
     "  if (tr_on) for (int k = 0; k < 17; ++k)\n"
     "    g_trace_ws[blockIdx.x][wg - 1][k] = s_tr[k];\n}", 1),
]
SCALAR_SUBS = [
    ("  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;\n",
     "  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;\n"
     "  __shared__ long long s_tr[18];\n"
     "  const bool tr_on = blockIdx.x < 132 && tid == 0;\n"
     "  if (tr_on) for (int k = 0; k < 18; ++k) s_tr[k] = 0;\n"
     "  long long tr0 = clock64();\n", 1),
    ("  const float T_ = sDa[L - 1];\n\n  for (int jt = 0; jt < tiles; ++jt) {",
     f"  const float T_ = sDa[L - 1];\n  {mark('0')}\n\n"
     "  for (int jt = 0; jt < tiles; ++jt) {", 1),
    ("    load_rows<N>(sB, bb + j0 * p.b_ss, p.b_ss);\n    __syncthreads();\n",
     "    load_rows<N>(sB, bb + j0 * p.b_ss, p.b_ss);\n    __syncthreads();\n"
     f"    {mark('1')}\n", 1),
    ("      for (int k = 0; k < JN; ++k) adb[i][k] *= f * sDt[j];\n    }\n",
     "      for (int k = 0; k < JN; ++k) adb[i][k] *= f * sDt[j];\n    }\n"
     f"    {mark('2')}\n", 1),
    ("      load_rows<P>(sDy, dyb + static_cast<long long>(i0) * hs * P, "
     "hs * P);\n      __syncthreads();\n",
     "      load_rows<P>(sDy, dyb + static_cast<long long>(i0) * hs * P, "
     f"hs * P);\n      __syncthreads();\n      {mark('1')}\n", 1),
    ("      mm<4, 4, false, false>(s2, sDy, RP, sX, RP, P);\n",
     "      mm<4, 4, false, false>(s2, sDy, RP, sX, RP, P);\n"
     f"      {mark('4')}\n", 1),
    ("        dda[j0 + tid] -= colsum;\n      }\n",
     f"        dda[j0 + tid] -= colsum;\n      }}\n      {mark('5')}\n", 1),
    ("      mm<4, JN, true, true>(adb, sV, kLd, sC, RN, kTile);\n",
     "      mm<4, JN, true, true>(adb, sV, kLd, sC, RN, kTile);\n"
     f"      {mark('6')}\n", 1),
    ("          row[n] = jt == 0 ? adc[r][k] : row[n] + adc[r][k];\n"
     "        }\n      }\n",
     "          row[n] = jt == 0 ? adc[r][k] : row[n] + adc[r][k];\n"
     f"        }}\n      }}\n      {mark('14')}\n", 1),
    ("      for (int k = 0; k < JN; ++k) brow[tx + 16 * k] = adb[i][k];\n"
     "    }\n",
     "      for (int k = 0; k < JN; ++k) brow[tx + 16 * k] = adb[i][k];\n"
     f"    }}\n    {mark('7')}\n", 1),
    ("  }\n  __syncthreads();\n\n  // g = d(dt a) at row k",
     f"  }}\n  __syncthreads();\n  {mark('16')}\n\n"
     "  // g = d(dt a) at row k", 1),
    ("      da += static_cast<double>(sDt[j]) * g;\n      left += sQ[j];\n"
     "    }\n    da_part[blockIdx.x] = da;\n  }\n}",
     "      da += static_cast<double>(sDt[j]) * g;\n      left += sQ[j];\n"
     "    }\n    da_part[blockIdx.x] = da;\n"
     f"  }}\n  {mark('17')}\n"
     "  if (tr_on) for (int k = 0; k < 18; ++k)\n"
     "    g_trace_scalar[blockIdx.x][k] = s_tr[k];\n}", 1),
]
HEAD = ("__device__ long long g_trace_ws[132][2][18];\n"
        "__device__ long long g_trace_scalar[132][18];\n")
TAIL = '''
extern "C" int repro_k3b_trace(long long* ws, long long* scalar) {
  cudaMemcpyFromSymbol(ws, g_trace_ws, sizeof(g_trace_ws));
  cudaMemcpyFromSymbol(scalar, g_trace_scalar, sizeof(g_trace_scalar));
  return cudaGetLastError();
}
'''
RUN = r'''
import ctypes, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ops as k3_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd
from torch.profiler import ProfilerActivity, profile
WS, SCALAR, HAS_WS = %r, %r, %r
lib = _build.library()
print(cs.card(), flush=True)
gen = torch.Generator(device="cuda").manual_seed(0)
x, dt, a, bm, cm, _ = cs.k3_inputs(gen, 4, 2048, 32, 64, 1, 128, 256, True,
                                   False, "mamba", torch.bfloat16)
args = (x, dt, a, bm, cm)
_, _, states = k3_ops._launch(*args, 256, None, with_states=True)
dy = torch.randn(4, 2048, 32, 64, generator=gen, device="cuda").to(x.dtype)
run = lambda: ssd_scan_bwd(*args, states, dy, chunk=256)
for _ in range(3):
    run()
torch.cuda.synchronize()
ws = (ctypes.c_longlong * (132 * 2 * 18))()
sc = (ctypes.c_longlong * (132 * 18))()
lib.repro_k3b_trace(ws, sc)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        run()
    torch.cuda.synchronize()
kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
        and e.self_device_time_total > 0]
total = sum(e.self_device_time_total for e in kern)
print(f"K3b bf16 at train, a launch: {total / 5e3:.4f} ms of device time "
      "(the stamps included), by kernel:")
for e in sorted(kern, key=lambda e: -e.self_device_time_total):
    print(f"  {e.self_device_time_total / 5e3:8.4f} ms "
          f"{e.self_device_time_total / total:6.1%%}  {e.key[:70]}")
if HAS_WS:
    rows = [[[ws[(b * 2 + c) * 18 + k] for k in range(18)] for c in range(2)]
            for b in range(132)]
    print("bwd_chunk_ws: mean cycles a block over blocks 0..131 "
          "(consumer 0, consumer 1; share of consumer 0's total)")
    tot = [sum(sum(r[c]) for r in rows) / 132 for c in range(2)]
    for k, step in WS.items():
        m = [sum(r[c][k] for r in rows) / 132 for c in range(2)]
        print(f"  {step:<46} {m[0]:9.0f} {m[1]:9.0f}  {m[0] / tot[0]:6.1%%}")
    print(f"  {'a whole block':<46} {tot[0]:9.0f} {tot[1]:9.0f}")
else:
    rows = [[sc[b * 18 + k] for k in range(18)] for b in range(132)]
    tot = sum(sum(r) for r in rows) / 132
    print("bwd_chunk (scalar): mean cycles a block over blocks 0..131, "
          "thread 0")
    for k, step in SCALAR.items():
        m = sum(r[k] for r in rows) / 132
        print(f"  {step:<46} {m:9.0f}  {m / tot:6.1%%}")
    print(f"  {'a whole block':<46} {tot:9.0f}")
'''


def patch(text: str, subs) -> str:
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{old[:60]!r} found {text.count(old)} "
                               f"times, not {count}")
        text = text.replace(old, new)
    return text


def main() -> int:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else root)
    tmp = tempfile.mkdtemp(prefix="k3b_trace_")
    try:
        shutil.copytree(os.path.join(tree, "src"), os.path.join(tmp, "src"))
        shutil.copy(os.path.join(tree, "chip_smoke.py"), tmp)
        path = os.path.join(tmp, SRC)
        with open(path) as f:
            text = f.read()
        has_ws = "bwd_chunk_ws" in text
        text = patch(text, SCALAR_SUBS + (WS_SUBS if has_ws else []))
        text = text.replace("\nnamespace {", "\n" + HEAD + "namespace {", 1)
        with open(path, "w") as f:
            f.write(text + TAIL)
        proc = subprocess.run(
            [sys.executable, "-c", RUN % (WS_STEPS, SCALAR_STEPS, has_ws)],
            cwd=tmp, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(tmp)
    print(proc.stdout, end="")
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
