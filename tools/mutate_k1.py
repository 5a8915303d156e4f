#!/usr/bin/env python3
"""Show that ``chip_smoke.check_k1`` catches a wrong K1, on an H100:

    python3 tools/mutate_k1.py [--widths]

Each mutant of the bf16 path of ``flash_attention.cu`` is written into its
own temporary copy of ``src/`` and ``chip_smoke.py``, built there, and run
through ``check_k1``; the repository's files are never changed.  A mutant is
caught when ``check_k1`` raises (or its process fails).  The first five run
every case of ``check_k1``:

* ``consumer_skips_full_wait``: a consumer multiplies K without waiting for
  the TMA load of its stage to land;
* ``producer_skips_empty_wait``: the producer refills a stage without
  waiting for the consumers to free it;
* ``v_wrong_swizzle``: V's wgmma descriptor names the other swizzle mode;
* ``no_alpha_rescale``: O is not rescaled when the running max moves;
* ``tile_order_off_by_one``: the longest-first work order is shifted by
  one query tile, so the first tile is never computed.

The last four are of the head widths that are not a multiple of 64 (80,
padded to 96, and 160), and run only the cases at those widths
(``chip_smoke.K1_NEW_WIDTHS``); ``--widths`` runs these four alone:

* ``scale_of_padded_d``: the softmax scale is 1/sqrt(96) at d=80;
* ``qk_drops_last_block``: Q K^T leaves out the last column block;
* ``padded_columns_unzeroed``: Q K^T runs over the padded width while the
  Q and K maps are 96 wide, so that the padding holds the next head's
  columns instead of zeros;
* ``pv_block_stride_of_q``: V's descriptor steps between column blocks by
  the Q tile's 128 rows instead of the K tile's 64 (at d=160).

Prints each mutant's first failing case with its ratios to the tolerances.
"""
import os
import shutil
import subprocess
import sys
import tempfile

SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MUTANTS = {
    "consumer_skips_full_wait": [
        ("    mbar_wait(bar_k + 8 * (cur % kS), (cur / kS) & 1);\n", "")],
    "producer_skips_empty_wait": [
        ("          mbar_wait(bar_e + 8 * st, phase ^ 1);  "
         "// the stage is free\n", "")],
    "v_wrong_swizzle": [
        ("                     kTileK * T::kRowBytes, kSbo, T::kLayout);",
         "                     kTileK * T::kRowBytes, kSbo, T::kLayout ^ 3);")],
    "no_alpha_rescale": [
        ("    for (int e = 0; e < kDp / 2; ++e) o[e] *= alpha[(e >> 1) & 1];",
         "    for (int e = 0; e < kDp / 2; ++e) o[e] *= 1.f;")],
    "tile_order_off_by_one": [
        ("  x.q0 = (n_q_tiles - 1 - w / n_bh) * kTileQ;",
         "  x.q0 = (n_q_tiles - w / n_bh) * kTileQ;")],
}
WIDTH_MUTANTS = {
    "scale_of_padded_d": [
        ("  const float scale_log2 = p.scale * kLog2e;",
         "  const float scale_log2 = rsqrtf(static_cast<float>(T::kDp)) * "
         "kLog2e;")],
    "qk_drops_last_block": [
        ("    for (int ks = 0; ks < D / 16; ++ks)\n"
         "      wgmma_qk<kTileK>",
         "    for (int ks = 0; ks < (T::kColBlocks - 1) * T::kCols / 16; "
         "++ks)\n      wgmma_qk<kTileK>")],
    "padded_columns_unzeroed": [
        ("    for (int ks = 0; ks < D / 16; ++ks)\n"
         "      wgmma_qk<kTileK>",
         "    for (int ks = 0; ks < kDp / 16; ++ks)\n      wgmma_qk<kTileK>"),
        ("  if (!tensor_map(&tq, q, D, p.sq,",
         "  if (!tensor_map(&tq, q, T::kDp, p.sq,"),
        ("      !tensor_map(&tk, k, D, p.skv,",
         "      !tensor_map(&tk, k, T::kDp, p.skv,")],
    "pv_block_stride_of_q": [
        ("                     kTileK * T::kRowBytes, kSbo, T::kLayout);",
         "                     kTileQ * T::kRowBytes, kSbo, T::kLayout);")],
}
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "cs._build.build(); "
       "cs.check_k1(torch.Generator(device='cuda').manual_seed(0){names})")


def main() -> int:
    """Returns 1 when a mutant passed ``check_k1``, else 0."""
    missed = 0
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    runs = [(name, subs, "") for name, subs in MUTANTS.items()
            if "--widths" not in sys.argv[1:]]
    runs += [(name, subs, ", cs.K1_NEW_WIDTHS")
             for name, subs in WIDTH_MUTANTS.items()]
    for name, subs, names in runs:
        tmp = tempfile.mkdtemp(prefix=f"k1_{name}_")
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
            try:
                proc = subprocess.run(
                    [sys.executable, "-c", RUN.format(names=names)], cwd=tmp,
                    capture_output=True, text=True, timeout=300)
                rc, out, err = proc.returncode, proc.stdout, proc.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = "timeout", e.stdout or "", "timed out"
                out = out.decode() if isinstance(out, bytes) else out
        finally:
            shutil.rmtree(tmp)
        missed += rc == 0
        print(f"== mutant {name}: exit {rc} "
              f"({'caught' if rc else 'NOT CAUGHT'})")
        for line in out.splitlines():
            if line.startswith("  K1 "):
                print(line)
        if rc and err.strip():
            # a failed launch names its CUDA error on a line of its own
            lines = err.strip().splitlines()
            cuda = [line for line in lines if "CUDA error" in line]
            print("  " + (cuda[0] if cuda else lines[-1])[:300])
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
