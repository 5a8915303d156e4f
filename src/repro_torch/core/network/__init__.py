from .collective_models import collective_time
from .scheduler import ScheduleResult, simulate
from .topology import AllToAllNode, Dragonfly, MultiPod, PathProfile, Topology, Torus

__all__ = [
    "collective_time", "ScheduleResult", "simulate",
    "AllToAllNode", "Dragonfly", "MultiPod", "PathProfile", "Topology", "Torus",
]
