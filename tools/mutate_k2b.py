#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k2b`` catches a wrong K2b, on an H100:

    python3 tools/mutate_k2b.py

Each mutant of ``rmsnorm_bwd.cu`` is built in its own temporary copy of the
tree and run through ``check_k2b``, as ``tools/mutate_k1b.py`` does for K1b;
the repository's files are never changed.  The mutants:

* ``rstd_wrong_row``: the groups kernel takes the row's sum of squares, and
  so rstd, from the other slot of the row sums, which holds the group's
  previous row;
* ``dw_block_left_out``: the dw reduction leaves out the last block's
  partial row;
* ``no_offset``: the groups kernel forgets the offset in g = dy (offset +
  w).

Prints each mutant's first failing case with its ratios to the tolerances.
"""
import sys

from mutate_k1b import run_mutants

SRC = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu"
# (old, new, how many times old occurs: every occurrence is replaced)
MUTANTS = {
    "rstd_wrong_row": [
        ("      ss += sums[i];",
         "      ss += (red_g + (slot ^ 1) * 2 * kMaxGroupWarps)[i];", 1)],
    "dw_block_left_out": [
        ("for (int i = warp; i < blocks; i += kWarps)",
         "for (int i = warp; i < blocks - 1; i += kWarps)", 1)],
    "no_offset": [
        ("      wf[j][e] = to_f32(we[e]) + offset;",
         "      wf[j][e] = to_f32(we[e]);", 1)],
}

if __name__ == "__main__":
    sys.exit(run_mutants(SRC, MUTANTS, "check_k2b", "  K2b "))
