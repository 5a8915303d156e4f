"""The port's copy of the reference's slicers (``repro.core.slicing``):
linear and dependency-aware compute/communication splitting.  The region
re-emitter (``emit.py``) waits for the profiling estimator, its only user
(ROADMAP, Queue 1)."""
from .regions import ComputeRegion, Segment, region_fingerprint
from .linear import linear_split
from .depaware import dependency_aware_split

__all__ = [
    "ComputeRegion", "Segment", "region_fingerprint",
    "linear_split", "dependency_aware_split",
]
