"""The port's copy of the reference's compute estimators
(``repro.core.estimators``): roofline, systolic (four presets), mixed,
profiling (each region run on the card by the port's executor), the
recorded-profile table, and the (H, C, R) latency cache.  The learned
estimator is not ported yet: its kind stays in the registry's vocabulary
and raises when built (``core/registry.py``)."""
from .analytical import RooflineEstimator
from .base import ComputeEstimator, MixedEstimator
from .cache import CachedEstimator, CacheStats
from .profiling import ProfilingEstimator
from .systolic import PRESETS, SystolicEstimator
from .table import TableEstimator, load_profile, record_profile, save_profile

__all__ = [
    "ComputeEstimator", "MixedEstimator", "RooflineEstimator",
    "CachedEstimator", "CacheStats", "ProfilingEstimator",
    "SystolicEstimator", "PRESETS",
    "TableEstimator", "load_profile", "record_profile", "save_profile",
]
