"""The port's copy of the reference's compute estimators
(``repro.core.estimators``): roofline, systolic (four presets), mixed,
the recorded-profile table, and the (H, C, R) latency cache.  The
profiling and learned estimators are not ported yet: their kinds stay in
the registry's vocabulary and raise when built (``core/registry.py``)."""
from .analytical import RooflineEstimator
from .base import ComputeEstimator, MixedEstimator
from .cache import CachedEstimator, CacheStats
from .systolic import PRESETS, SystolicEstimator
from .table import TableEstimator, load_profile, record_profile, save_profile

__all__ = [
    "ComputeEstimator", "MixedEstimator", "RooflineEstimator",
    "CachedEstimator", "CacheStats",
    "SystolicEstimator", "PRESETS",
    "TableEstimator", "load_profile", "record_profile", "save_profile",
]
