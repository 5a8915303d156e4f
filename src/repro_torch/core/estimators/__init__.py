"""The port's copy of the reference's compute estimators
(``repro.core.estimators``): roofline, systolic (four presets), mixed,
profiling (each region run on the card by the port's executor), the
recorded-profile table, the learned cross-system model, and the (H, C, R)
latency cache."""
from .analytical import RooflineEstimator
from .base import ComputeEstimator, MixedEstimator
from .cache import CachedEstimator, CacheStats
from .learned import (LearnedEstimator, LearnedModel, fit_model, load_model,
                      region_family, save_model)
from .profiling import ProfilingEstimator
from .systolic import PRESETS, SystolicEstimator
from .table import TableEstimator, load_profile, record_profile, save_profile

__all__ = [
    "ComputeEstimator", "MixedEstimator", "RooflineEstimator",
    "CachedEstimator", "CacheStats", "ProfilingEstimator",
    "SystolicEstimator", "PRESETS",
    "TableEstimator", "load_profile", "record_profile", "save_profile",
    "LearnedEstimator", "LearnedModel", "fit_model", "save_model",
    "load_model", "region_family",
]
