#!/usr/bin/env python3
"""Show that the XLA test of the export catches a wrong lowering, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/mutate_emitter.py

Each mutant of ``src/repro_torch/core/stablehlo.py`` is written into its
own temporary copy of ``src/`` and ``tests/test_torch_export.py``, and
``test_xla_runs_the_text_to_the_eager_step`` (XLA on the CPU running the
emitted smoke-size train step against the eager step, chunked and kernel)
runs there; the repository's files are never changed.  A mutant is caught
when that test fails.  The mutants:

* ``sub_as_add``: ``aten.sub`` written as ``stablehlo.add``;
* ``rsqrt_as_sqrt``: ``aten.rsqrt`` written as ``stablehlo.sqrt``;
* ``mean_without_divide``: a mean left as a sum;
* ``bmm_wrong_contraction``: ``bmm`` contracts the rhs's last dim;
* ``slice_from_zero``: a slice taken from 0 instead of its start;
* ``slice_scatter_at_zero``: a slice written back at 0;
* ``index_put_wrong_window``: the embedding gradient's scatter inserts the
  wrong window dim;
* ``gather_off_by_one``: gathers read index + 1;
* ``scatter_takes_max``: scatters combine with maximum instead of add;
* ``square_as_identity``: ``x ** 2`` written as x;
* ``where_swapped``: ``where`` picks the other branch.

Prints one line a mutant: caught or missed.  Exits 1 when one is missed.
"""
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = "src/repro_torch/core/stablehlo.py"
TEST = "tests/test_torch_export.py"
MUTANTS = {
    "sub_as_add": ('aten.sub.Tensor: "subtract"', 'aten.sub.Tensor: "add"'),
    "rsqrt_as_sqrt": ('aten.rsqrt.default: "rsqrt"',
                      'aten.rsqrt.default: "sqrt"'),
    "mean_without_divide": (
        'return f.binary("divide", s, f.full(n, shape, dt))', "return s"),
    "bmm_wrong_contraction": ("([0], [0]), ([2], [1]), shape)",
                              "([0], [0]), ([2], [2]), shape)"),
    "slice_from_zero": (
        "starts[dim], limits[dim], strides[dim] = start, end, step",
        "starts[dim], limits[dim], strides[dim] = 0, end - start, step"),
    "slice_scatter_at_zero": ("    starts[dim] = start\n    return _update(",
                              "    starts[dim] = 0\n    return _update("),
    "index_put_wrong_window": ('"inserted_window_dims = [0], "',
                               '"inserted_window_dims = [1], "'),
    "gather_off_by_one": (
        'return f.reshape(f.convert(idx, "i32"), (*shape, 1))',
        'return f.reshape(f.binary("add", f.convert(idx, "i32"), '
        'f.full(1, idx.shape, "i32")), (*shape, 1))'),
    "scatter_takes_max": ('f"      %sum{name[1:]} = stablehlo.add',
                          'f"      %sum{name[1:]} = stablehlo.maximum'),
    "square_as_identity": ('        return f.binary("multiply", x, x)',
                           "        return x"),
    "where_swapped": (
        'f.select(f.operand(c, "i1", shape), f.operand(a, dt, shape),\n'
        "                    f.operand(b, dt, shape))",
        'f.select(f.operand(c, "i1", shape), f.operand(b, dt, shape),\n'
        "                    f.operand(a, dt, shape))"),
}


def main() -> int:
    with open(os.path.join(ROOT, SRC)) as fh:
        source = fh.read()
    missed = 0
    for name, (old, new) in MUTANTS.items():
        if old not in source:
            raise SystemExit(f"{name}: its pattern is not in {SRC}")
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(ROOT, "src"), os.path.join(tmp, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            os.makedirs(os.path.join(tmp, "tests"))
            shutil.copy(os.path.join(ROOT, TEST), os.path.join(tmp, TEST))
            with open(os.path.join(tmp, SRC), "w") as fh:
                fh.write(source.replace(old, new, 1))
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                 TEST, "-k", "xla_runs_the_text"], cwd=tmp,
                capture_output=True, text=True, timeout=600,
                env=dict(os.environ, PYTHONPATH=os.path.join(tmp, "src"),
                         JAX_PLATFORMS="cpu"))
        caught = proc.returncode != 0
        missed += not caught
        print(f"{name}: {'caught' if caught else 'MISSED'}", flush=True)
    return int(missed > 0)


if __name__ == "__main__":
    sys.exit(main())
