"""Hardware system descriptions (paper Table IV + Fig 5, extended): the
port's copy of the reference's ``core/systems.py``.  Its calibrated host
(:func:`host_system`, the catalog id ``host``) is the machine the
profiling estimator measures on: the card, or the host CPU when asked.

Every estimator and the network simulator read from these records, so a
workload can be re-costed on a different system by swapping one object —
the paper's cross-architecture axis.

The records themselves are *data*, not code: the shipped catalog lives
in ``specs/systems/*.json`` (one file per system) and loads through
:class:`~repro_torch.core.catalog.SystemRegistry`, which also accepts user
catalogs (a campaign spec's ``system_catalog``).  This module keeps the
:class:`System`/:class:`Interconnect` dataclasses and — as a back-compat
shim — the historical module-level names (``A100`` … ``TPU_V5E``,
``SYSTEMS``, ``get_system``), all of which resolve from the catalog.
"""
from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Interconnect:
    kind: str                 # "all_to_all" | "dragonfly" | "torus2d" | "torus3d" | "host"
    link_bw: float            # bytes/s per link per direction
    link_latency: float = 1e-6
    links_per_device: int = 1
    params: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        """JSON-ready dict form (tuple params become lists)."""
        d = asdict(self)
        d["params"] = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in self.params.items()}
        if not d["params"]:
            del d["params"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Interconnect":
        """Inverse of :meth:`to_dict`; list params (e.g. torus ``dims``)
        become tuples so round-trips compare equal."""
        d = dict(d)
        params = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in (d.pop("params", None) or {}).items()}
        return cls(params=params, **d)


@dataclass(frozen=True)
class System:
    name: str
    peak_flops: dict          # dtype -> FLOP/s (dense)
    mem_bw: float             # bytes/s HBM
    mem_capacity: float       # bytes
    interconnect: Interconnect
    # systolic-array geometry (TPU-class; GPUs get tensor-core-equivalent)
    mxu_rows: int = 128
    mxu_cols: int = 128
    n_mxu: int = 2
    clock_hz: float = 940e6
    vmem_bytes: float = 128 * 2**20
    # fixed per-kernel launch/dispatch overhead observed on the platform
    kernel_overhead_s: float = 2e-6
    # TCO model (optional catalog fields, per device): None = unpriced —
    # cost/power report columns are simply absent for such systems
    cost_per_hour: float | None = None   # USD per device-hour (on-demand)
    tdp_watts: float | None = None       # board TDP, watts per device

    def flops_for(self, dtype: str) -> float:
        if dtype in self.peak_flops:
            return self.peak_flops[dtype]
        if dtype in ("f16", "bf16"):
            return self.peak_flops.get("bf16", self.peak_flops.get(
                "f16", self.peak_flops["f32"]))
        return self.peak_flops.get("f32", max(self.peak_flops.values()))

    def to_dict(self) -> dict:
        """JSON-ready dict form — the catalog record format (minus the
        catalog ``id``, which is the file stem / registration key)."""
        d = asdict(self)
        d["interconnect"] = self.interconnect.to_dict()
        # optional TCO fields stay absent (not null) when unpriced, so
        # pre-cost-model catalog records round-trip byte-identically
        for k in ("cost_per_hour", "tdp_watts"):
            if d[k] is None:
                del d[k]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "System":
        """Inverse of :meth:`to_dict`:
        ``System.from_dict(s.to_dict()) == s`` for any system, including
        after a JSON round-trip."""
        d = dict(d)
        d.pop("id", None)
        d["interconnect"] = Interconnect.from_dict(d["interconnect"])
        d["peak_flops"] = {k: float(v) for k, v in d["peak_flops"].items()}
        return cls(**d)


_G = 1e9

# ---- the calibrated host (ground-truth platform for profiling) ----
_HOST_CACHE: dict[str, System] = {}
#: held while the host is calibrated or a region profiled: one
#: measurement at a time in a process
MEASURE = threading.RLock()


def _best_rate(fn, work: float, reps: int, sync) -> float:
    """``work`` units a second over the best of three bursts of ``reps``
    calls of ``fn`` (after one warm call); ``sync`` waits for the device
    and returns the host's clock."""
    fn()
    best = float("inf")
    for _ in range(3):
        t0 = sync()
        for _ in range(reps):
            fn()
        best = min(best, sync() - t0)
    return work * reps / best


def _calibrate_cpu() -> float:
    """Host peak FLOP/s from a bf16 GEMM burst (the reference's JAX
    calibration, in torch): bf16 is what the workloads run in, and on a CPU
    it is emulated, so an f32 calibration would overstate the rate."""
    import torch
    n = 512
    a = torch.ones(n, n, dtype=torch.bfloat16)
    return _best_rate(lambda: a @ a, 2 * n ** 3, 1, time.perf_counter)


def _calibrate_card(device) -> tuple[float, float, float]:
    """The card's bf16 and f32 GEMM rates (FLOP/s; f32 with TF32 off, as
    the port's f32 products run) and its memory rate (bytes/s) from a
    device-to-device copy, each the best of three timed bursts."""
    import torch

    def sync():
        torch.cuda.synchronize(device)
        return time.perf_counter()

    n = 8192
    a = torch.randn(n, n, device=device, dtype=torch.bfloat16)
    bf16 = _best_rate(lambda: a @ a, 2 * n ** 3, 10, sync)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n = 4096
        a = torch.randn(n, n, device=device)
        f32 = _best_rate(lambda: a @ a, 2 * n ** 3, 5, sync)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    src = torch.empty(2 ** 28, device=device)      # 1 GiB of f32
    dst = torch.empty_like(src)
    bw = _best_rate(lambda: dst.copy_(src), 2 * src.nbytes, 10, sync)
    del a, src, dst
    torch.cuda.empty_cache()
    return bf16, f32, bw


def host_system(device=None) -> System:
    """The platform the profiling estimator measures on, as a System: the
    card (``device`` None or a CUDA device), or the host CPU when
    ``device="cpu"`` (the reference's ``host-cpu``).

    The card takes the name CUDA reports for it; its bf16 (and f16) peak is a
    bf16 GEMM burst's rate, its f32 peak an f32 GEMM's with TF32 off, its
    memory rate a device-to-device copy's and its capacity the device's
    memory.  Its interconnect and systolic geometry are not measured (the
    dataclass's defaults; the profiling estimator reads neither).  The
    CPU is calibrated as the reference calibrates it, by a bf16 GEMM, with
    the reference's constants for the rest.  Measured once a process and
    device."""
    from ..device import resolve_device
    dev = resolve_device(device)
    with MEASURE:
        if str(dev) not in _HOST_CACHE:
            _HOST_CACHE[str(dev)] = _host(dev)
    return _HOST_CACHE[str(dev)]


def _host(dev) -> System:
    if dev.type == "cuda":
        import torch
        props = torch.cuda.get_device_properties(dev)
        bf16, f32, bw = _calibrate_card(dev)
        return System(
            name=props.name,
            peak_flops={"f32": f32, "bf16": bf16, "f16": bf16},
            mem_bw=bw, mem_capacity=float(props.total_memory),
            interconnect=Interconnect("host", link_bw=10e9))
    if dev.type == "cpu":
        f = _calibrate_cpu()
        return System(
            name="host-cpu",
            peak_flops={"f32": f, "bf16": f, "f16": f, "f64": f / 2},
            mem_bw=20e9, mem_capacity=16 * _G,
            interconnect=Interconnect("host", link_bw=10e9),
            mxu_rows=8, mxu_cols=8, n_mxu=1, clock_hz=3e9,
            vmem_bytes=32 * 2**20, kernel_overhead_s=5e-6)
    raise ValueError(f"no host system for device {dev}")


def get_system(name: str) -> System:
    """Resolve a catalog id (or ``host``: the card) from the default
    catalog.

    Back-compat shim over
    :meth:`repro_torch.core.catalog.SystemRegistry.get`; sessions with their
    own catalogs resolve through ``session.systems.get`` instead."""
    from .catalog import default_registry
    return default_registry().get(name)


#: historical module-level constant -> catalog id (PEP 562 re-exports)
_CATALOG_NAMES = {
    "A100": "a100", "H100": "h100", "H200": "h200", "B200": "b200",
    "GH200": "gh200", "H100_PAPER": "h100-paper",
    "H200_PAPER": "h200-paper", "B200_PAPER": "b200-paper",
    "TPU_V3_CORE": "tpu-v3", "TPU_V5E": "tpu-v5e",
}


def __getattr__(name: str):
    """Back-compat: the Table-IV literals that used to live here resolve
    from the shipped catalog (``from repro_torch.core.systems import A100`` and
    ``SYSTEMS`` keep working, and agree with the catalog by construction).
    """
    if name != "SYSTEMS" and name not in _CATALOG_NAMES:
        # reject unknown names (incl. the import machinery's __path__
        # probe) *before* touching catalog — importing it from here on
        # such a probe would be circular
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from .catalog import default_registry
    if name == "SYSTEMS":
        return default_registry().as_dict()
    return default_registry().get(_CATALOG_NAMES[name])
