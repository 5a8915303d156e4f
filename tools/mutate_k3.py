#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k3`` catches a wrong K3, on an H100:

    python3 tools/mutate_k3.py

Each of three mutants of ``ssd_scan.cu`` (no inbound-state term, the
diagonal masked out, B read from head h instead of its group) is written
into its own temporary copy of ``src/`` and ``chip_smoke.py``, built there,
and run through ``check_k3``; the repository's files are never changed.
A mutant is caught when ``check_k3`` raises.  The B mutant runs on
``groups2`` only, whose strided buffer keeps the wrong reads in bounds.
Prints each mutant's failing case with its ratios to the tolerances.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
MUTANTS = {
    "no_state_term": ([("const float f0 = expf(dai[0]), f1 = expf(dai[1]);",
                        "const float f0 = 0.f, f1 = 0.f;"),
                       ("const double f = exp(static_cast<double>(dai[r]));",
                        "const double f = 0.0;")],
                      None),
    "diagonal_masked": ([("return j <= i ? dai - daj : -INFINITY;",
                          "return j < i ? dai - daj : -INFINITY;")], None),
    "b_from_head": ([("k.b_off = b * p.b_sb + grp * p.b_sg",
                      "k.b_off = b * p.b_sb + h * p.b_sg")], ["groups2"]),
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
                capture_output=True, text=True, timeout=300)
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
