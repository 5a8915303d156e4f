#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k3`` catches a wrong K3, on an H100:

    python3 tools/mutate_k3.py

Each of five mutants of ``ssd_scan.cu`` is written into its own temporary
copy of ``src/`` and ``chip_smoke.py``, built there, and run through
``check_k3``; the repository's files are never changed:

1. ``no_state_term``: y without the inbound state's term C S^T;
2. ``diagonal_masked``: the causal mask drops the diagonal (j < i);
3. ``b_from_head``: B read from head h instead of its group (run on
   ``groups2`` only, whose strided buffer keeps the f32 kernel's wrong
   reads in bounds; TMA reads past the groups as zeros);
4. ``no_recurrence_decay``: the state not decayed by exp(datot) between
   chunks;
5. ``no_local_lo``: the lo part of the local state's weighted x dropped,
   so w x goes into the tensor cores rounded to bf16 (the bf16 kernel only).

The first four change the bf16 and the f32 kernel alike.  A mutant is
caught when ``check_k3`` raises.  Prints each mutant's failing case with its
ratios to the tolerances.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
MUTANTS = {
    "no_state_term": ([
        ("y[e] *= fast_exp2(da_i[(e >> 1) & 1]);", "y[e] *= 0.f;"),
        ("const double f = exp(static_cast<double>(dai[r]));",
         "const double f = 0.0;")], None),
    "diagonal_masked": ([
        ("const float arg = jj <= ii ?", "const float arg = jj < ii ?"),
        ("const float arg = j <= i ?", "const float arg = j < i ?")], None),
    "b_from_head": ([
        ("bar_fb + 8 * i, cb * T::kColsN, row, grp, b);",
         "bar_fb + 8 * i, cb * T::kColsN, row, h, b);"),
        ("bm + b * p.b_sb + grp * p.b_sg", "bm + b * p.b_sb + h * p.b_sg")],
        ["groups2"]),
    "no_recurrence_decay": ([
        ("const float decay = expf(datot);", "const float decay = 1.f;"),
        ("const double decay = exp(static_cast<double>(datot));",
         "const double decay = 1.0;")], None),
    "no_local_lo": ([
        ("wgmma_rs<kSC>(st, lo[kk], bmn_desc(tt, kk));", "")], None),
}
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "cs._build.build(); "
       "cs.check_k3(torch.Generator(device='cuda').manual_seed(0), {names})")


def main() -> int:
    """Returns 1 when a mutant passed ``check_k3``, else 0."""
    missed = 0
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    for name, (subs, names) in MUTANTS.items():
        tmp = tempfile.mkdtemp(prefix=f"k3_{name}_")
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
                [sys.executable, "-c", RUN.format(names=names)], cwd=tmp,
                capture_output=True, text=True, timeout=600)
        finally:
            shutil.rmtree(tmp)
        missed += proc.returncode == 0
        print(f"== mutant {name}: exit {proc.returncode} "
              f"({'caught' if proc.returncode else 'NOT CAUGHT'})")
        for line in proc.stdout.splitlines():
            if line.startswith("  K3 "):
                print(line)
        if proc.returncode:
            print("  " + proc.stderr.strip().splitlines()[-1][:300])
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
