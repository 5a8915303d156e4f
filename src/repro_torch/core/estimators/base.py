"""The Compute API (paper §III-B(c)).

Every estimator implements the same minimal interface so they can be mixed
within one workload (e.g. systolic for GEMM regions + analytical for the
rest) while preserving a single point of latency collection:

  * ``get_run_time_estimate(region)`` -> seconds
  * ``get_compile_args()``  (optional) -> compiler flags/config
  * ``get_exec_args()``     (optional) -> runtime flags (#runs, ...)
"""
from __future__ import annotations

import abc

from ..registry import register_estimator
from ..slicing.regions import ComputeRegion
from ..systems import System


class ComputeEstimator(abc.ABC):
    """Base class of the Compute API."""

    #: identifies the 'compilation toolchain' C in the (H, C, R) cache key
    toolchain: str = "none"

    def __init__(self, system: System):
        self.system = system

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "ComputeEstimator":
        """Build from a campaign-spec options dict (the registry builder
        protocol — see :mod:`repro_torch.core.registry`).  The default assumes
        options map straight onto constructor keywords; backends with
        richer wiring (sub-estimators, source programs) override this."""
        return cls(system, **options)

    @abc.abstractmethod
    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        """Estimated latency of one execution of the region, in seconds."""

    def get_run_time_estimates(self, regions: list[ComputeRegion],
                               arrays=None) -> list[float]:
        """Batched form of :meth:`get_run_time_estimate`.

        The evaluate phase hands every compute region of a plan over in
        one call; plain estimators just loop, while
        :class:`~repro_torch.core.estimators.cache.CachedEstimator` overrides
        this to fetch all cached latencies in a single store round-trip.

        ``arrays`` is the plan's precomputed
        :class:`~repro_torch.core.ir.arrays.RegionArrays` for the same regions
        in the same order.  Estimators that implement
        ``evaluate_batch(arrays)`` (a vectorized pass producing values
        bit-identical to the per-region method) are dispatched through
        it; everything else ignores ``arrays`` and loops.  An
        ``evaluate_batch`` may return None to decline a batch its
        vector path cannot replay exactly (e.g. the systolic model on
        plans with GEMMs inside nested control flow) — declined batches
        fall back to the scalar loop.
        """
        if arrays is not None:
            batch = getattr(self, "evaluate_batch", None)
            if batch is not None:
                values = batch(arrays)
                if values is not None:
                    return values
        return [self.get_run_time_estimate(r) for r in regions]

    def get_compile_args(self) -> dict:
        return {}

    def get_exec_args(self) -> dict:
        return {}

    def supports(self, region: ComputeRegion) -> bool:
        """Whether this estimator can evaluate the region natively.

        Narrow estimators (e.g. systolic-array simulators that only model
        matrix multiplication) return False for regions outside their scope;
        the pipeline then falls back to a paired estimator — the paper's
        mixed-estimator mechanism.
        """
        return True

    @property
    def cache_hw_key(self) -> str:
        return self.system.name

    @property
    def cache_config_key(self) -> str:
        """Estimator configuration that can change the latency value.

        Folded into the cache key alongside (H, C, R): two differently
        configured instances of the same estimator class (e.g. roofline
        region vs per-op mode) must not serve each other's entries when
        they share one store."""
        return ""


@register_estimator("mixed")
class MixedEstimator(ComputeEstimator):
    """Primary estimator + fallback for unsupported regions (paper §III-B(c))."""

    def __init__(self, primary: ComputeEstimator, fallback: ComputeEstimator):
        super().__init__(primary.system)
        self.primary = primary
        self.fallback = fallback
        self.toolchain = f"{primary.toolchain}+{fallback.toolchain}"

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "MixedEstimator":
        """Spec form: systolic primary + roofline fallback (the paper's
        COCOSSim-plus-analytical pairing); ``preset`` configures the
        primary."""
        from .analytical import RooflineEstimator
        from .systolic import SystolicEstimator
        return cls(
            SystolicEstimator(system, options.get("preset", "cocossim")),
            RooflineEstimator(system))

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        if self.primary.supports(region):
            return self.primary.get_run_time_estimate(region)
        return self.fallback.get_run_time_estimate(region)

    def supports(self, region: ComputeRegion) -> bool:
        return True

    @property
    def cache_config_key(self) -> str:
        return f"{self.primary.cache_config_key}+{self.fallback.cache_config_key}"
