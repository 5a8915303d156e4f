#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k1b`` catches a wrong K1b, on an H100:

    python3 tools/mutate_k1b.py

Each mutant of ``flash_attention_bwd.cu`` is written into its own temporary
copy of ``src/`` and ``chip_smoke.py``, built there, and run through
``check_k1b``; the repository's files are never changed.  A mutant is
caught when ``check_k1b`` raises (or its process fails).  The mutants:

* ``no_delta``: delta = rowsum(dO o) is written as 0, so dS = P dP;
* ``wrong_group_head``: the dK/dV kernel walks the group's query heads 1,
  1, 2, ... instead of 0, 1, 2, ... (the first head of each group is never
  read);
* ``causal_off_by_one``: the causal mask also lets each query see the key
  just after it;
* ``no_cap_derivative``: dS is not multiplied by the cap's derivative
  1 - tanh^2;
* ``dk_unscaled``: dK is written without the 1/sqrt(d) scale;
* ``dq_skips_last_tile``: the dQ kernel stops one key tile short of the
  last one its rows can see.

Prints each mutant's first failing case with its ratios to the tolerances.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
       "flash_attention_bwd.cu")
# (old, new, how many times old occurs: every occurrence is replaced)
MUTANTS = {
    "no_delta": [
        ("    row[p.sqp + i] = acc;", "    row[p.sqp + i] = 0.f * acc;", 1)],
    "wrong_group_head": [
        ("          const int h = x.hk * p.group + i / x.nq;",
         "          const int h = x.hk * p.group + max(i / x.nq, 1) % p.group;",
         1)],
    "causal_off_by_one": [
        ("(!p.causal || diff >= 0)", "(!p.causal || diff >= -1)", 1)],
    "no_cap_derivative": [
        ("          dc[e] = 1.f - th * th;", "          dc[e] = 1.f;", 1),
        (" * (1.f - th * th);", ";", 1),
        ("    *dcap = 1.f - t * t;", "    *dcap = 1.f;", 1)],
    "dk_unscaled": [
        ("p.skv, dk_acc, p.scale);", "p.skv, dk_acc, 1.f);", 1)],
    "dq_skips_last_tile": [
        ("  x.n = hi > x.lo ? (hi - x.lo + kKeys - 1) / kKeys : 0;",
         "  x.n = hi > x.lo ? (hi - x.lo - 1) / kKeys : 0;", 1)],
}
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "cs._build.build(); "
       "cs.{check}(torch.Generator(device='cuda').manual_seed(0))")


def run_mutants(src: str, mutants: dict, check: str, tag: str) -> int:
    """Builds each mutant of ``src`` in a temporary copy of the tree and
    runs ``chip_smoke.<check>`` there; prints the first failing lines (those
    that start with ``tag``).  Returns 1 when a mutant passed, else 0."""
    missed = 0
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    for name, subs in mutants.items():
        tmp = tempfile.mkdtemp(prefix=f"mutant_{name}_")
        try:
            shutil.copytree("src", os.path.join(tmp, "src"))
            shutil.copy("chip_smoke.py", tmp)
            path = os.path.join(tmp, src)
            with open(path) as f:
                text = f.read()
            for old, new, count in subs:
                if text.count(old) != count:
                    raise RuntimeError(f"{name}: {old!r} found "
                                       f"{text.count(old)} times, not {count}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            try:
                proc = subprocess.run(
                    [sys.executable, "-c", RUN.format(check=check)], cwd=tmp,
                    capture_output=True, text=True, timeout=600)
                rc, out, err = proc.returncode, proc.stdout, proc.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = "timeout", e.stdout or "", "timed out"
                out = out.decode() if isinstance(out, bytes) else out
        finally:
            shutil.rmtree(tmp)
        missed += rc == 0
        print(f"== mutant {name}: exit {rc} "
              f"({'caught' if rc else 'NOT CAUGHT'})", flush=True)
        lines = [line for line in out.splitlines() if line.startswith(tag)]
        failing = [line for line in lines if line.endswith("FAIL")]
        for line in (failing or lines)[:2]:
            print(line)
        if rc and err.strip() and not failing:
            errs = err.strip().splitlines()
            cuda = [line for line in errs if "CUDA error" in line]
            print("  " + (cuda[0] if cuda else errs[-1])[:300])
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(run_mutants(SRC, MUTANTS, "check_k1b", "  K1b "))
