from .chakra import COMM_TYPE, Trace, TraceNode

__all__ = ["COMM_TYPE", "Trace", "TraceNode"]
