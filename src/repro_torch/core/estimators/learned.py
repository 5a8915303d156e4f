"""Learned cross-system fidelity tier (the ``learned`` kind): the port's
copy of the reference's ``core/estimators/learned.py``.

The ``table`` estimator replays recorded per-fingerprint latencies on
the system that recorded them; this backend *generalizes* a recorded
profile in the spirit of Daydream-style offline profiling (arXiv
2002.06790) and the multi-GPU universal model of Lin et al. (arXiv
2404.12674): it fits one least-squares regression per **op family**
(matmul / elementwise / movement / other, classified from the region's
op mix) over region fingerprint features — flops, bytes moved, boundary
bytes, op-mix counts — and can then predict

* regions the profile never recorded (same family, new shapes), and
* **systems the profile never ran on**: every feature is expressed in
  time units on the *recording* system (flops / peak FLOP/s, bytes /
  memory bandwidth, counts x kernel overhead), so the fitted
  coefficients are dimensionless multipliers and transfer amounts to
  rescaling each feature by the target system's compute / bandwidth /
  overhead constants from the ``specs/systems/*.json`` catalog.

Every prediction carries an **uncertainty estimate**: a residual-based
relative interval widened when the region's raw features fall outside
the fitted range or when the target system differs from the recording
system, plus an ``extrapolated`` flag.  The campaign pipeline surfaces
these as per-prediction row fields (``uncertainty_s``,
``uncertainty_rel``, ``extrapolated``, ``extrapolated_regions``) via
the ``prediction_quality`` hook (see ``repro_torch.core.pipeline``).

Wire-up mirrors ``table``: record with :func:`record_profile` (any
estimator, or real hardware), fit with :func:`fit_model`, persist with
:func:`save_model` / :func:`load_model` (versioned model JSON), and
reach it from campaign specs with ``{"kind": "learned", "options":
{"model": "models/m.json"}}`` — relative paths resolve against the spec
file.  ``python -m repro_torch.tools.fit_learned_model`` is the
record -> fit -> save CLI.  The profiling estimator records on the card
itself (``record_profile(regions, ProfilingEstimator(...))``).

The fit stays in stdlib floats in the reference's loop order (no
vectorised Gram matrix, no library solver): the last bits of the
coefficients fix the model digest, and with it the cache keys
(``learned-<digest>``) and the golden rows, so a fit here equals the
reference's bit for bit.  Nothing in this module touches a device.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field

from ..ir.opcost import _MOVEMENT
from ..registry import register_estimator
from ..slicing.regions import ComputeRegion
from ..systems import System
from .base import ComputeEstimator

MODEL_VERSION = 1

#: op names whose flops dominate a region -> the ``matmul`` family
_MATMUL_OPS = ("dot_general", "dot", "convolution")

#: feature vector layout; every entry is time-shaped (seconds on the
#: system the features are computed against), so fitted coefficients
#: are dimensionless and transfer across systems by recomputing the
#: features with the target system's catalog constants
FEATURE_NAMES = ("overhead", "compute", "bytes", "boundary",
                 "n_matmul", "n_elementwise", "n_movement")

#: raw (system-independent) quantities whose fitted min/max define the
#: interpolation envelope; outside it predictions flag ``extrapolated``
RANGE_NAMES = ("flops", "bytes", "boundary_bytes")

#: relative-residual floor: a perfect fit (e.g. an exactly linear
#: recorder) still reports a non-degenerate interval
MIN_REL_STD = 0.005
#: half-width = Z * rel_std (~95% under a normal residual assumption)
INTERVAL_Z = 2.0
#: widening factor applied when raw features leave the fitted range
RANGE_WIDEN = 3.0
#: ridge term (relative to the Gram diagonal) keeping the normal
#: equations solvable for degenerate training sets (e.g. all-GEMM)
RIDGE = 1e-6


def region_family(region: ComputeRegion) -> str:
    """The op family a region's mix assigns it to.

    ``matmul`` when any contraction op contributes flops; else
    ``elementwise`` when any op contributes flops; else ``movement``
    when only data-movement bytes remain; else ``other``."""
    by_op = region.cost.by_op
    if any(by_op.get(op) for op in _MATMUL_OPS):
        return "matmul"
    if region.cost.flops > 0:
        return "elementwise"
    if region.cost.bytes > 0 or region.cost.by_op:
        return "movement"
    return "other"


def _op_mix_counts(region: ComputeRegion) -> tuple[float, float, float]:
    """(matmul, elementwise, movement-or-other) op counts — the op-mix
    portion of the feature vector, from the per-op cost breakdown."""
    n_mm = n_ew = n_mv = 0.0
    names = set(region.cost.by_op) | set(region.cost.bytes_by_op)
    for name in names:
        if name in _MATMUL_OPS:
            n_mm += 1.0
        elif name in _MOVEMENT:
            n_mv += 1.0
        elif region.cost.by_op.get(name):
            n_ew += 1.0
        else:
            n_mv += 1.0
    return n_mm, n_ew, n_mv


def _dominant_dtype(region: ComputeRegion) -> str:
    """Dominant dtype by result bytes (same rule as the roofline)."""
    best, best_bytes = "bf16", -1.0
    for op in region.ops:
        for t in op.result_types:
            if t.nbytes > best_bytes:
                best, best_bytes = t.dtype, t.nbytes
    return best


def region_features(region: ComputeRegion, system: System) -> list[float]:
    """The time-shaped feature vector of ``region`` on ``system``, in
    :data:`FEATURE_NAMES` order."""
    ovh = system.kernel_overhead_s
    compute = region.cost.flops / system.flops_for(_dominant_dtype(region))
    mem = region.cost.bytes / system.mem_bw
    boundary = (region.boundary_in_bytes
                + region.boundary_out_bytes) / system.mem_bw
    n_mm, n_ew, n_mv = _op_mix_counts(region)
    return [ovh, compute, mem, boundary,
            n_mm * ovh, n_ew * ovh, n_mv * ovh]


def _raw_ranges(region: ComputeRegion) -> tuple[float, float, float]:
    return (region.cost.flops, region.cost.bytes,
            region.boundary_in_bytes + region.boundary_out_bytes)


def _solve(a: list[list[float]], b: list[float]) -> list[float]:
    """Gaussian elimination with partial pivoting (stdlib-only)."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-300:
            continue                       # ridge keeps this unreachable
        m[col], m[piv] = m[piv], m[col]
        for r in range(n):
            if r == col:
                continue
            f = m[r][col] / m[col][col]
            for c in range(col, n + 1):
                m[r][c] -= f * m[col][c]
    out = []
    for i in range(n):
        out.append(m[i][n] / m[i][i] if abs(m[i][i]) > 1e-300 else 0.0)
    return out


@dataclass
class FamilyModel:
    """One op family's fitted regression: dimensionless coefficients
    over :data:`FEATURE_NAMES`, the relative residual spread, and the
    raw-feature envelope the fit covered."""
    coef: list[float]
    rel_residual_std: float
    n_samples: int
    ranges: dict = field(default_factory=dict)  # name -> [min, max]

    def in_range(self, raw: tuple[float, float, float]) -> bool:
        for name, v in zip(RANGE_NAMES, raw):
            lo, hi = self.ranges.get(name, (0.0, math.inf))
            if not lo <= v <= hi:
                return False
        return True


@dataclass
class LearnedModel:
    """A fitted, transferable latency model (the on-disk unit)."""
    families: dict                       # family -> FamilyModel
    source: dict                         # recording system's constants
    meta: dict = field(default_factory=dict)
    version: int = MODEL_VERSION

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "meta": self.meta,
            "source": self.source,
            "families": {
                fam: {
                    "coef": dict(zip(FEATURE_NAMES, fm.coef)),
                    "rel_residual_std": fm.rel_residual_std,
                    "n_samples": fm.n_samples,
                    "ranges": fm.ranges,
                } for fam, fm in sorted(self.families.items())
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LearnedModel":
        if not isinstance(d, dict) or "families" not in d:
            raise ValueError(
                "learned model JSON must carry a 'families' map "
                "(write one with save_model / python -m "
                "repro_torch.tools.fit_learned_model)")
        version = int(d.get("version", 0))
        if version != MODEL_VERSION:
            raise ValueError(
                f"learned model version {version} != supported "
                f"{MODEL_VERSION} — re-fit with python -m "
                "repro_torch.tools.fit_learned_model")
        fams = {}
        for fam, f in d["families"].items():
            coef = f["coef"]
            if isinstance(coef, dict):
                coef = [float(coef.get(n, 0.0)) for n in FEATURE_NAMES]
            fams[fam] = FamilyModel(
                coef=[float(c) for c in coef],
                rel_residual_std=float(f.get("rel_residual_std",
                                             MIN_REL_STD)),
                n_samples=int(f.get("n_samples", 0)),
                ranges={k: [float(v[0]), float(v[1])]
                        for k, v in f.get("ranges", {}).items()})
        return cls(families=fams, source=dict(d.get("source", {})),
                   meta=dict(d.get("meta", {})), version=version)

    def digest(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]


class _SourceConstants:
    """Duck-typed stand-in for :class:`System` built from the model's
    recorded catalog constants (enough for :func:`region_features`)."""

    def __init__(self, source: dict):
        self.peak_flops = {k: float(v)
                           for k, v in source.get("peak_flops", {}).items()}
        self.mem_bw = float(source.get("mem_bw", 1.0))
        self.kernel_overhead_s = float(source.get("kernel_overhead_s", 0.0))

    def flops_for(self, dtype: str) -> float:
        if dtype in self.peak_flops:
            return self.peak_flops[dtype]
        if dtype in ("bf16", "f16"):
            return self.peak_flops.get(
                "bf16", self.peak_flops.get(
                    "f16", self.peak_flops.get("f32", 1.0)))
        return self.peak_flops.get(
            "f32", max(self.peak_flops.values()) if self.peak_flops else 1.0)


def _system_constants(system: System) -> dict:
    return {
        "name": system.name,
        "peak_flops": {k: float(v) for k, v in system.peak_flops.items()},
        "mem_bw": float(system.mem_bw),
        "kernel_overhead_s": float(system.kernel_overhead_s),
    }


def fit_model(regions: list[ComputeRegion], profile: dict[str, float],
              system: System, *, meta: dict | None = None) -> LearnedModel:
    """Fit per-op-family regressions from a recorded profile.

    ``profile`` maps region fingerprints to measured seconds (the
    :func:`repro_torch.core.estimators.table.record_profile` form); ``regions``
    supply the fingerprint features and ``system`` the recording
    system's catalog constants the features are normalized by.  Each
    distinct fingerprint contributes one sample."""
    samples: dict[str, list[tuple[list[float], float,
                                  tuple[float, float, float]]]] = {}
    seen: set[str] = set()
    for r in regions:
        t = profile.get(r.fingerprint)
        if t is None or r.fingerprint in seen:
            continue
        seen.add(r.fingerprint)
        samples.setdefault(region_family(r), []).append(
            (region_features(r, system), float(t), _raw_ranges(r)))
    if not samples:
        raise ValueError(
            "fit_model: no profile entry matches any region fingerprint "
            "— record the profile from the same plan you fit on")
    families = {}
    for fam, rows in sorted(samples.items()):
        families[fam] = _fit_family(rows)
    return LearnedModel(
        families=families, source=_system_constants(system),
        meta={"entries_fitted": len(seen), **(meta or {})})


def _fit_family(rows: list) -> FamilyModel:
    """Ridge-regularized least squares over one family's samples."""
    k = len(FEATURE_NAMES)
    gram = [[0.0] * k for _ in range(k)]
    rhs = [0.0] * k
    for x, y, _ in rows:
        for i in range(k):
            rhs[i] += x[i] * y
            for j in range(k):
                gram[i][j] += x[i] * x[j]
    trace = sum(gram[i][i] for i in range(k))
    lam = RIDGE * (trace / k if trace > 0 else 1.0)
    for i in range(k):
        gram[i][i] += lam
    coef = _solve(gram, rhs)
    rel_sq = 0.0
    for x, y, _ in rows:
        pred = sum(c * v for c, v in zip(coef, x))
        rel_sq += ((pred - y) / y) ** 2 if y > 0 else 0.0
    rel_std = max(math.sqrt(rel_sq / len(rows)), MIN_REL_STD)
    ranges = {}
    for idx, name in enumerate(RANGE_NAMES):
        vals = [raw[idx] for _, _, raw in rows]
        ranges[name] = [min(vals), max(vals)]
    return FamilyModel(coef=coef, rel_residual_std=rel_std,
                       n_samples=len(rows), ranges=ranges)


def save_model(path: str, model: LearnedModel) -> str:
    """Write the versioned model JSON; inverse of :func:`load_model`."""
    with open(path, "w") as f:
        json.dump(model.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_model(path: str) -> LearnedModel:
    with open(path) as f:
        try:
            raw = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"learned model {path!r}: not JSON ({e})")
    try:
        return LearnedModel.from_dict(raw)
    except ValueError as e:
        raise ValueError(f"learned model {path!r}: {e}")


@register_estimator("learned")
class LearnedEstimator(ComputeEstimator):
    """Predict region latencies from a fitted :class:`LearnedModel`.

    The target system is ``self.system`` (the grid system the campaign
    builds the estimator for); the model remembers the system it was
    recorded on, and the prediction *transfers* by recomputing the
    time-shaped features with the target's catalog constants.  Every
    prediction carries a residual-based interval and an
    ``extrapolated`` flag (out-of-envelope features, or any cross-system
    transfer); :meth:`prediction_quality` aggregates them into the
    campaign row fields."""

    toolchain = "learned"

    def __init__(self, system: System, model: LearnedModel, *,
                 source: str = "<memory>"):
        super().__init__(system)
        self.model = model
        self.source = source
        self._src = _SourceConstants(model.source)
        # cross-system widening: how far the target's compute/bandwidth
        # ratios sit from the recording system's (1.0 = same system)
        rc = self._ratio(system.flops_for("bf16"),
                         self._src.flops_for("bf16"))
        rb = self._ratio(system.mem_bw, self._src.mem_bw)
        self._transfer_widen = math.sqrt(max(rc, 1.0 / rc)
                                         * max(rb, 1.0 / rb))
        self._transferred = (
            model.source.get("name") not in ("", None, system.name))

    @staticmethod
    def _ratio(a: float, b: float) -> float:
        return a / b if a > 0 and b > 0 else 1.0

    @classmethod
    def from_model(cls, system: System, path: str) -> "LearnedEstimator":
        return cls(system, load_model(path), source=path)

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "LearnedEstimator":
        path = options.get("model")
        if not path:
            raise ValueError(
                "learned estimator needs options.model — a fitted model "
                "JSON (record + fit one with python -m "
                "repro_torch.tools.fit_learned_model; see "
                "docs/extending.md)")
        if context is not None and getattr(context, "base_dir", None):
            path = context.resolve_path(path)
        return cls.from_model(system, path)

    # ------------------------------ predict ------------------------------

    def _family_model(self, region: ComputeRegion) -> tuple[str, FamilyModel]:
        fam = region_family(region)
        fm = self.model.families.get(fam)
        if fm is None:
            raise KeyError(
                f"learned estimator ({self.source}): no fitted model for "
                f"op family {fam!r} (have "
                f"{sorted(self.model.families)}) — re-fit on a profile "
                "covering this family, or compose with a fallback "
                "estimator (supports() returns False here)")
        return fam, fm

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        _, fm = self._family_model(region)
        x = region_features(region, self.system)
        return max(sum(c * v for c, v in zip(fm.coef, x)), 0.0)

    def predict_with_uncertainty(self, region: ComputeRegion) -> dict:
        """Point prediction plus the residual-based interval.

        ``low``/``high`` bound the prediction at ``INTERVAL_Z`` relative
        residual standard deviations, widened by :data:`RANGE_WIDEN`
        outside the fitted feature envelope and by the compute/bandwidth
        ratio distance on cross-system transfer."""
        fam, fm = self._family_model(region)
        t = self.get_run_time_estimate(region)
        out_of_range = not fm.in_range(_raw_ranges(region))
        widen = self._transfer_widen * (RANGE_WIDEN if out_of_range else 1.0)
        half = INTERVAL_Z * fm.rel_residual_std * widen
        return {
            "seconds": t,
            "low": max(t * (1.0 - half), 0.0),
            "high": t * (1.0 + half),
            "rel_half_width": half,
            "family": fam,
            "extrapolated": bool(out_of_range or self._transferred),
        }

    def prediction_quality(self, regions: list[ComputeRegion]) -> dict:
        """Aggregate per-prediction uncertainty into campaign row fields
        (the pipeline merges this dict into the result row)."""
        total = half_abs = 0.0
        extrapolated = 0
        for r in regions:
            if not self.supports(r):
                continue
            p = self.predict_with_uncertainty(r)
            total += p["seconds"]
            half_abs += p["seconds"] * p["rel_half_width"]
            extrapolated += bool(p["extrapolated"])
        return {
            "uncertainty_s": half_abs,
            "uncertainty_rel": half_abs / total if total > 0 else 0.0,
            "extrapolated": bool(extrapolated),
            "extrapolated_regions": extrapolated,
            "model_source_system": self.model.source.get("name", "?"),
        }

    def supports(self, region: ComputeRegion) -> bool:
        return region_family(region) in self.model.families

    @property
    def cache_config_key(self) -> str:
        """Content digest — two different fitted models must not share
        entries in one (H, C, R) store."""
        return f"learned-{self.model.digest()}"
