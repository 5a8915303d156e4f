"""Hardware system descriptions (paper Table IV + Fig 5, extended): the
port's copy of the reference's ``core/systems.py``, without the
calibrated host-CPU system (``HOST_PENDING`` says why).

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


#: why the special catalog id ``host`` does not resolve in the port: the
#: reference calibrates it with a JAX matmul
HOST_PENDING = (
    "system 'host' is not ported to repro_torch yet: the reference "
    "calibrates it with a JAX matmul, and its torch analog (calibrated by "
    "a bf16 GEMM) comes with the profiling slice (ROADMAP, Queue 1)")


def get_system(name: str) -> System:
    """Resolve a catalog id from the default catalog.

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
