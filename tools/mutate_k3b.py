#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k3b`` catches a wrong K3b, on an H100:

    python3 tools/mutate_k3b.py

Each of seven mutants of ``ssd_scan_bwd.cu`` is written into its own
temporary copy of ``src/`` and ``chip_smoke.py``, built there, and run
through ``check_k3b`` on ``groups2`` and ``init_dfinal`` (bf16, whose path
the mutants of the chunk kernel change, then f32); the repository's files
are never changed:

1. ``no_state_dx``: dx without the state's term exp(T - dacs_j) G B_j
   (and so q_j = 0 as well);
2. ``diagonal_masked``: W and V of the j-major phase lose their diagonal
   (i > j on the exponent's mask);
3. ``q_sign``: the q_j with - sign in the epilogue's prefix sums;
4. ``no_state_dc``: dC without its inbound state's term exp(dacs_i)
   S^T dy_i (and so r_i = 0);
5. ``one_head``: dB and dC summed over the group's first head only;
6. ``no_recurrence_decay``: the state's gradient not decayed by exp(T)
   from one chunk to the one before;
7. ``no_lo``: G_c and S_c go into the tensor cores as their bf16 hi parts
   alone (the lo parts staged as 0).

A mutant is caught when ``check_k3b`` raises.  Prints each mutant's
failing case with its ratios to the tolerances.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
MUTANTS = {
    "no_state_dx": [("        adx[e] *= f[hf];\n        adx[e + 1] *= f[hf];\n",
                     "        adx[e] *= 0.f;\n        adx[e + 1] *= 0.f;\n")],
    "diagonal_masked": [(
        "const float ex = __expf(i >= j ? sDa[i] - daj[hf] : -INFINITY);",
        "const float ex = __expf(i > j ? sDa[i] - daj[hf] : -INFINITY);")],
    "q_sign": [("if (t4 == 0) sQ[jr[hf]] = q * dtj[hf];",
                "if (t4 == 0) sQ[jr[hf]] = -q * dtj[hf];")],
    "no_state_dc": [("          adc[cb][e] *= f[hf];\n"
                     "          adc[cb][e + 1] *= f[hf];\n",
                     "          adc[cb][e] *= 0.f;\n"
                     "          adc[cb][e + 1] *= 0.f;\n")],
    "one_head": [("for (int k = 0; k < hpg; ++k) {",
                  "for (int k = 0; k < 1; ++k) {")],
    "no_recurrence_decay": [("const float decay = expf(sDa[L - 1]);",
                             "const float decay = 1.f;")],
    "no_lo": [('::"r"(sG + W::kState + off),\n                     "r"(lo)',
               '::"r"(sG + W::kState + off),\n                     "r"(0u)'),
              ('::"r"(sS + W::kState + off),\n                     "r"(lo)',
               '::"r"(sS + W::kState + off),\n                     "r"(0u)')],
}
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "cs._build.build(); "
       "cs.check_k3b(torch.Generator(device='cuda').manual_seed(0), "
       "['groups2', 'init_dfinal'])")


def main() -> int:
    """Returns 1 when a mutant passed ``check_k3b``, else 0."""
    missed = 0
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    for name, subs in MUTANTS.items():
        tmp = tempfile.mkdtemp(prefix=f"k3b_{name}_")
        try:
            shutil.copytree("src", os.path.join(tmp, "src"))
            shutil.copy("chip_smoke.py", tmp)
            path = os.path.join(tmp, SRC)
            with open(path) as f:
                text = f.read()
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} not found once")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            proc = subprocess.run(
                [sys.executable, "-c", RUN], cwd=tmp, capture_output=True,
                text=True, timeout=600)
        finally:
            shutil.rmtree(tmp)
        missed += proc.returncode == 0
        print(f"== mutant {name}: exit {proc.returncode} "
              f"({'caught' if proc.returncode else 'NOT CAUGHT'})")
        for line in proc.stdout.splitlines():
            if line.startswith("  K3b "):
                print(line)
        if proc.returncode:
            print("  " + proc.stderr.strip().splitlines()[-1][:300])
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
