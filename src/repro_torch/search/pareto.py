"""Deterministic ε-Pareto filtering over candidate objective vectors.

All objectives are *minimized* (the spec layer only admits
lower-is-better metrics; ``perf/$`` is reported as the inverse of
``$/step`` rather than searched on).  The filter is a pure function of
the (id, values) pairs: candidates are processed in sorted-id order and
ties survive together, so the result is independent of input order —
the property that makes search frontiers golden-pinnable.

ε is the *pruning slack* between fidelity tiers: a point is discarded
only when some other point beats it by at least a factor ``1 + eps`` on
**every** objective, so a cheap-tier ranking error smaller than ε can
never prune a point the expensive tier would have put on the frontier.
``eps=0`` is exact Pareto domination (used on the final tier).
"""
from __future__ import annotations

__all__ = ["dominates", "pareto_filter"]


def dominates(a: tuple, b: tuple, eps: float = 0.0) -> bool:
    """True when ``a`` ε-dominates ``b``: ``a_i * (1 + eps) <= b_i`` on
    every objective and ``a_i < b_i`` on at least one.  With ``eps=0``
    this is classic Pareto domination; equal vectors never dominate
    each other."""
    if len(a) != len(b):
        raise ValueError(f"objective arity mismatch: {len(a)} vs {len(b)}")
    return (all(ai * (1.0 + eps) <= bi for ai, bi in zip(a, b))
            and any(ai < bi for ai, bi in zip(a, b)))


def pareto_filter(points: dict[str, tuple], eps: float = 0.0) -> list[str]:
    """ids of the non-ε-dominated points of ``points`` (id -> objective
    vector), in sorted-id order.

    O(n²) pairwise sweep — candidate counts here are grid sizes
    (tens to low thousands), not populations.  Determinism: both loops
    run over the same sorted id list, and survival of ``b`` depends only
    on whether *any* ``a`` dominates it, so shuffling the input dict
    cannot change the result."""
    ids = sorted(points)
    out = []
    for b in ids:
        if not any(a != b and dominates(points[a], points[b], eps)
                   for a in ids):
            out.append(b)
    return out
