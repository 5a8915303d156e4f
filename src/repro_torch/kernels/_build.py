"""Build and bind the port's CUDA kernels.

At first use, every ``kernels/*/csrc/*.cu`` is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and one more
``nvcc`` call links the objects into a shared library with a plain C
interface under ``build/repro_torch/`` at the repository root, which is
loaded with ``ctypes``.
The library's name carries a hash of the sources and flags, so an edited
source rebuilds.  A failed build raises with nvcc's stderr.  Every C entry
point returns ``cudaGetLastError()`` after its launch; :func:`check` raises
when that is not ``cudaSuccess``.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_bound: dict[str, ctypes._CFuncPtr] = {}


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({cuda_home}); the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([*sources(), *KERNELS_DIR.glob("*/csrc/*.cuh")]):
        h.update(f.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless this exact build exists; returns the
    library's path and nvcc's diagnostics (ptxas register/shared-memory
    report; empty when the library was already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources(), objs))]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        errs = [proc.communicate()[1] for _, proc in procs]   # wait for all
        diag = [_finish(cmd, err, proc.returncode)
                for (cmd, proc), err in zip(procs, errs)]
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _finish(link, proc.stderr, proc.returncode)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, "".join(diag)


def _finish(cmd: list[str], stderr: str, returncode: int) -> str:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {returncode}: "
                           f"{' '.join(cmd)}\n{stderr}")
    return stderr


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = ctypes.CDLL(str(path))
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared
    (``c_void_p`` for every pointer and the stream)."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           "(cudaGetLastError)")
