"""Recorded-profile replay estimator (the ``table`` kind).

The paper's profiling estimator pays a real execution per distinct
region; this backend replays latencies that were *already measured* —
per-fingerprint seconds recorded into a profile JSON — so a profiling
run done once (on real hardware, or by any other estimator) keeps its
fidelity forever without re-measurement, in the spirit of Daydream-style
offline profiling.

It is also the worked example of the open backend vocabulary: the class
registers itself through the same public ``@register_estimator``
decorator a third-party plugin would use, and campaign specs reach it
with ``{"kind": "table", "options": {"path": "profile.json"}}`` — no
``repro_torch`` internals edited (see ``docs/extending.md``).

Profile JSON is either a flat ``{fingerprint: seconds}`` map or the
richer ``{"version": 1, "meta": {...}, "entries": {fingerprint:
seconds}}`` form that :func:`save_profile` writes.
"""
from __future__ import annotations

import hashlib
import json

from ..registry import register_estimator
from ..slicing.regions import ComputeRegion
from ..systems import System
from .base import ComputeEstimator

PROFILE_VERSION = 1


def load_profile(path: str) -> dict[str, float]:
    """Read a profile JSON (flat or versioned) into fingerprint -> seconds."""
    with open(path) as f:
        raw = json.load(f)
    entries = raw.get("entries", raw) if isinstance(raw, dict) else None
    if not isinstance(entries, dict):
        raise ValueError(
            f"profile {path!r}: expected a fingerprint -> seconds map "
            "(optionally under an 'entries' key)")
    return {str(k): float(v) for k, v in entries.items()}


def save_profile(path: str, table: dict[str, float],
                 meta: dict | None = None) -> str:
    """Write a versioned profile JSON; inverse of :func:`load_profile`."""
    with open(path, "w") as f:
        json.dump({"version": PROFILE_VERSION, "meta": meta or {},
                   "entries": table}, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def record_profile(regions: list[ComputeRegion],
                   estimator: ComputeEstimator) -> dict[str, float]:
    """Measure every distinct region fingerprint once through
    ``estimator`` — the recording side of the replay loop (profile a
    plan's regions once, replay them on every later campaign)."""
    table: dict[str, float] = {}
    for r in regions:
        if r.fingerprint not in table:
            table[r.fingerprint] = estimator.get_run_time_estimate(r)
    return table


@register_estimator("table")
class TableEstimator(ComputeEstimator):
    """Replay per-fingerprint latencies from a recorded profile.

    ``scale`` rescales every entry (e.g. a clock-ratio projection onto a
    different system); ``default`` is the latency for fingerprints the
    profile does not cover — without it an uncovered region raises, or
    pair with a fallback through ``mixed``-style composition
    (:meth:`supports` returns False for uncovered regions)."""

    toolchain = "table"

    def __init__(self, system: System, table: dict[str, float], *,
                 source: str = "<memory>", scale: float = 1.0,
                 default: float | None = None):
        super().__init__(system)
        self.table = {str(k): float(v) for k, v in table.items()}
        self.source = source
        self.scale = float(scale)
        self.default = None if default is None else float(default)

    @classmethod
    def from_profile(cls, system: System, path: str,
                     **kw) -> "TableEstimator":
        return cls(system, load_profile(path), source=path, **kw)

    @classmethod
    def from_spec(cls, options: dict, system: System,
                  context) -> "TableEstimator":
        path = options.get("path")
        if not path:
            raise ValueError(
                "table estimator needs options.path — a profile JSON "
                "of fingerprint -> seconds (see docs/extending.md)")
        if context is not None and getattr(context, "base_dir", None):
            path = context.resolve_path(path)
        return cls.from_profile(
            system, path, scale=float(options.get("scale", 1.0)),
            default=options.get("default"))

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        t = self.table.get(region.fingerprint)
        if t is not None:
            return t * self.scale
        if self.default is not None:
            # scale applies to the default too ("scale rescales every
            # entry"): a scaled cross-system projection must not serve
            # unscaled latencies for uncovered fingerprints.  The cache
            # config digest already covers both fields, so fixed values
            # can never be served from entries cached under the old
            # behavior's identical key — the key was always correct.
            return self.default * self.scale
        raise KeyError(
            f"table estimator ({self.source}): no recorded latency for "
            f"region fingerprint {region.fingerprint!r} "
            f"({len(self.table)} entries) — re-record the profile or set "
            "options.default")

    def supports(self, region: ComputeRegion) -> bool:
        return region.fingerprint in self.table or self.default is not None

    @property
    def cache_config_key(self) -> str:
        """Content digest: two different profiles (or scales) must not
        serve each other's entries from a shared (H, C, R) store."""
        h = hashlib.sha256()
        for k in sorted(self.table):
            h.update(f"{k}={self.table[k]!r};".encode())
        h.update(f"scale={self.scale!r};default={self.default!r}".encode())
        return f"table-{h.hexdigest()[:12]}"
