#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k1b`` catches a wrong K1b, on an H100:

    python3 tools/mutate_k1b.py [--widths | --mla]

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

The last three are of the head widths that are not a multiple of 64 (80,
padded to 96, and 160), and run only the cases at those widths
(``chip_smoke.K1B_NEW_WIDTHS``); ``--widths`` runs these three alone:

* ``pad_columns_written``: dQ, dK and dV are written over the padded width
  (96 at d=80), so the pad's columns land on the next row's or head's;
* ``scale_of_padded_d``: the scale is 1/sqrt(96) at d=80;
* ``scores_drop_last_block``: S^T, dP^T, S and dP leave out the last
  32-column block of the head.

The last three are of MLA's pair, query/key 192 beside a value width of
128, and run only the cases at that pair (``chip_smoke.K1B_MLA``);
``--mla`` runs these three alone:

* ``scale_of_dv``: the scores are scaled by 1/sqrt(128), the value width,
  not the query/key width's 1/sqrt(192);
* ``delta_over_dqk``: delta = rowsum(dO o) runs over 192 columns of the
  128-wide o and dO rows (the next row's first 64 in their place);
* ``dk_written_dv_wide``: the dK/dV kernel writes only dK's first 128
  columns.

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
WIDTH_MUTANTS = {
    "pad_columns_written": [
        ("    for (int jd = 0; jd < D / 8; ++jd)",
         "    for (int jd = 0; jd < Dp / 8; ++jd)", 1)],
    "scale_of_padded_d": [
        ("              1.0f / sqrtf(static_cast<float>(d)),",
         "              1.0f / sqrtf(static_cast<float>(d == 80 ? 96 : d)),",
         1)],
    "scores_drop_last_block": [
        ("    for (int ks = 0; ks < DQK / 16; ++ks)",
         "    for (int ks = 0; ks < (DQK - 32) / 16; ++ks)", 2),
        ("    for (int ks = 0; ks < DV / 16; ++ks)",
         "    for (int ks = 0; ks < (DV - 32) / 16; ++ks)", 2)],
}
MLA_MUTANTS = {
    "scale_of_dv": [
        ("              1.0f / sqrtf(static_cast<float>(d)),",
         "              1.0f / sqrtf(static_cast<float>(dv_width)),", 1)],
    "delta_over_dqk": [
        ("  constexpr int kDeltaRows = DeltaShape<T, DV>::kRows;",
         "  constexpr int kDeltaRows = DeltaShape<T, DQK>::kRows;", 1),
        ("  bwd_delta<T, DV><<<grid, 256, 0, stream>>>(",
         "  bwd_delta<T, DQK><<<grid, 256, 0, stream>>>(", 1)],
    "dk_written_dv_wide": [
        ("    store_rows<DQK, kDqkp>(dk + x.b * p.dks.b",
         "    store_rows<DV, kDqkp>(dk + x.b * p.dks.b", 1)],
}
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "cs._build.build(); "
       "cs.{check}(torch.Generator(device='cuda').manual_seed(0){names})")


def run_mutants(src: str, mutants: dict, check: str, tag: str,
                names: str = "") -> int:
    """Builds each mutant of ``src`` in a temporary copy of the tree and
    runs ``chip_smoke.<check>`` there (given ``names``, an expression for
    the cases to run, on those alone); prints the first failing lines
    (those that start with ``tag``).  Returns 1 when a mutant passed, else
    0."""
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
                    [sys.executable, "-c", RUN.format(
                        check=check, names=f", {names}" if names else "")],
                    cwd=tmp, capture_output=True, text=True, timeout=600)
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
    args = sys.argv[1:]
    mla = 0 if "--widths" in args else run_mutants(
        SRC, MLA_MUTANTS, "check_k1b", "  K1b ", "cs.K1B_MLA")
    if "--mla" in args:
        sys.exit(mla)
    widths = run_mutants(SRC, WIDTH_MUTANTS, "check_k1b", "  K1b ",
                         "cs.K1B_NEW_WIDTHS")
    if "--widths" in args:
        sys.exit(widths)
    sys.exit(run_mutants(SRC, MUTANTS, "check_k1b", "  K1b ")
             or widths or mla)
