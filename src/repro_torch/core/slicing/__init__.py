"""The port's copy of the reference's slicers (``repro.core.slicing``):
linear and dependency-aware compute/communication splitting, and the
region re-emitter (``emit.py``) that the profiling estimator runs."""
from .regions import ComputeRegion, Segment, region_fingerprint
from .linear import linear_split
from .depaware import dependency_aware_split
from .emit import RegionEmitError, region_to_module

__all__ = [
    "ComputeRegion", "Segment", "region_fingerprint",
    "linear_split", "dependency_aware_split", "RegionEmitError",
    "region_to_module",
]
