"""Data-driven system catalog (paper Table IV as checked-in JSON).

Every :class:`~repro_torch.core.systems.System` the pipeline knows about is a
record in a catalog file — the shipped ones live in ``specs/systems/``
(one file per system, file stem = catalog id) and users point a
:class:`SystemRegistry` (or a spec's ``system_catalog``) at their own.  A
:class:`SystemRegistry` merges catalogs with later paths (and API
registrations) taking precedence, and remembers each entry's source file.
The special id ``host`` is reserved, as in the reference, and resolves
to the calibrated host (:func:`~repro_torch.core.systems.host_system`):
the card, where the reference's is the host CPU, unless
:meth:`SystemRegistry.get` is given ``device="cpu"``.

The port's copy of the reference's ``core/catalog.py``: it reads the
same ``specs/systems/*.json`` records by the same relative path (or
``REPRO_SYSTEMS_DIR``).  The module is stdlib-only — spec validation
loads the catalog without numpy.
"""
from __future__ import annotations

import difflib
import json
import os

from .systems import System, host_system

#: the shipped catalog, relative to the repo root (editable install /
#: PYTHONPATH=src layouts); resolved lazily so a relocated package
#: degrades to an empty default catalog instead of an import error.
#: A wheel install has no specs/ tree next to the package — point
#: REPRO_SYSTEMS_DIR at a catalog directory there (unknown-system errors
#: say so).
_DEFAULT_DIR = (os.environ.get("REPRO_SYSTEMS_DIR")
                or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", "specs", "systems"))

_REQUIRED_FIELDS = ("id", "name", "peak_flops", "mem_bw", "mem_capacity",
                    "interconnect")


def validate_system_dict(d: dict, *, source: str = "<dict>") -> None:
    """Schema check for one catalog record; raises ValueError with the
    offending source on malformed entries (CI runs this over every
    shipped ``specs/systems/*.json``).
    """
    if not isinstance(d, dict):
        raise ValueError(f"{source}: system record must be an object, "
                         f"got {type(d).__name__}")
    missing = [k for k in _REQUIRED_FIELDS if k not in d]
    if missing:
        raise ValueError(f"{source}: system record missing {missing}")
    known = set(_REQUIRED_FIELDS) | {
        "mxu_rows", "mxu_cols", "n_mxu", "clock_hz", "vmem_bytes",
        "kernel_overhead_s", "cost_per_hour", "tdp_watts"}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"{source}: unknown system fields {unknown}")
    for k in ("cost_per_hour", "tdp_watts"):
        if k in d and d[k] is not None and not (
                isinstance(d[k], (int, float)) and d[k] > 0):
            raise ValueError(f"{source}: {k} must be a positive number")
    pf = d["peak_flops"]
    if (not isinstance(pf, dict) or not pf
            or not all(isinstance(v, (int, float)) and v > 0
                       for v in pf.values())):
        raise ValueError(
            f"{source}: peak_flops must be a non-empty dtype -> FLOP/s map")
    for k in ("mem_bw", "mem_capacity"):
        if not (isinstance(d[k], (int, float)) and d[k] > 0):
            raise ValueError(f"{source}: {k} must be a positive number")
    ic = d["interconnect"]
    if not isinstance(ic, dict) or "kind" not in ic or "link_bw" not in ic:
        raise ValueError(
            f"{source}: interconnect needs at least kind and link_bw")
    ic_known = {"kind", "link_bw", "link_latency", "links_per_device",
                "params"}
    ic_unknown = sorted(set(ic) - ic_known)
    if ic_unknown:
        raise ValueError(
            f"{source}: unknown interconnect fields {ic_unknown}")
    if not (isinstance(ic["link_bw"], (int, float)) and ic["link_bw"] > 0):
        raise ValueError(f"{source}: interconnect.link_bw must be positive")
    if "params" in ic and not isinstance(ic["params"], dict):
        raise ValueError(f"{source}: interconnect.params must be an object")


class SystemRegistry:
    """id -> :class:`System` catalog with source tracking and scoping.

    ``parent`` lookups make a session registry an overlay over the
    shipped default catalog: local registrations and loaded catalogs
    shadow (or extend) the defaults without mutating them.
    """

    def __init__(self, paths: list[str] | tuple = (),
                 parent: "SystemRegistry | None" = None):
        self.parent = parent
        self._systems: dict[str, System] = {}
        self._sources: dict[str, str] = {}
        for p in paths:
            self.load_path(p)

    # ---------------------------- registration ----------------------------

    def register(self, sid: str, system: System | dict, *,
                 source: str = "<api>", replace: bool = False) -> System:
        """Add one system under catalog id ``sid`` (dicts are validated
        and converted).  Within one registry a duplicate id is an error
        unless ``replace=True``; shadowing a *parent* entry is allowed —
        that is how a user catalog overrides a shipped record."""
        sid = sid.lower()
        if isinstance(system, dict):
            d = dict(system)
            d.pop("id", None)
            validate_system_dict({"id": sid, **d}, source=source)
            system = System.from_dict(d)
        if sid in self._systems and not replace:
            raise ValueError(
                f"system {sid!r} already registered "
                f"(from {self._sources.get(sid, '<api>')}); pass "
                "replace=True to override it")
        if sid == "host":
            raise ValueError(
                "system id 'host' is reserved for the calibrated host (the "
                "card, or the CPU when asked)")
        self._systems[sid] = system
        self._sources[sid] = source
        return system

    def load_file(self, path: str, *, replace: bool = True) -> str:
        """Load one catalog record file; returns the registered id."""
        with open(path) as f:
            try:
                d = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: not valid JSON: {e}") from None
        validate_system_dict(d, source=path)
        sid = str(d.pop("id"))
        self.register(sid, System.from_dict(d), source=path,
                      replace=replace)
        return sid

    def load_path(self, path: str) -> list[str]:
        """Load a catalog file, or every ``*.json`` in a directory
        (sorted, so later files win deterministically on duplicate ids);
        returns the registered ids."""
        if os.path.isdir(path):
            ids = []
            for name in sorted(os.listdir(path)):
                if name.endswith(".json"):
                    ids.append(self.load_file(os.path.join(path, name)))
            return ids
        return [self.load_file(path)]

    # ------------------------------ queries ------------------------------

    def names(self) -> list[str]:
        """Every known catalog id (parents included), sorted; the special
        id ``host`` is not listed — it is computed, not cataloged."""
        seen = set(self._systems)
        if self.parent is not None:
            seen.update(self.parent.names())
        return sorted(seen)

    def __contains__(self, name: str) -> bool:
        n = name.lower()
        return (n == "host" or n in self._systems
                or (self.parent is not None and name in self.parent))

    def get(self, name: str, device=None) -> System:
        """The system for a catalog id (``host`` -> the calibrated host on
        ``device``, :func:`~repro_torch.core.systems.host_system`; None:
        the card); unknown ids raise with the live catalog and a
        did-you-mean."""
        n = name.lower()
        if n == "host":
            return host_system(device)
        if n in self._systems:
            return self._systems[n]
        if self.parent is not None and name in self.parent:
            return self.parent.get(name)
        raise KeyError(self.unknown_message(name))

    def unknown_message(self, name) -> str:
        have = ["host", *self.names()]
        msg = f"unknown system {name!r}; have {have}"
        close = difflib.get_close_matches(str(name).lower(), have, n=1)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        elif len(have) == 1 and not os.path.isdir(_DEFAULT_DIR):
            # empty default catalog: the package is installed without the
            # repo's specs/ tree next to it
            msg += (f" (no system catalog found at {_DEFAULT_DIR!r} — "
                    "set REPRO_SYSTEMS_DIR, pass a catalog, or run from "
                    "the repo checkout)")
        return msg

    def source(self, sid: str) -> str:
        """Where a catalog entry came from (file path or ``<api>``)."""
        n = sid.lower()
        if n in self._sources:
            return self._sources[n]
        if self.parent is not None:
            return self.parent.source(sid)
        raise KeyError(self.unknown_message(sid))

    def as_dict(self) -> dict[str, System]:
        """id -> System snapshot of the whole catalog (parents merged,
        local entries winning) — the back-compat ``SYSTEMS`` surface."""
        out = self.parent.as_dict() if self.parent is not None else {}
        out.update(self._systems)
        return out

    def local_systems(self) -> dict[str, System]:
        """This registry's own (non-inherited) entries — what a session
        ships to process-pool campaign workers."""
        return dict(self._systems)

    def scope(self) -> "SystemRegistry":
        """A child registry: local catalogs/registrations, parent fallback."""
        return SystemRegistry(parent=self)


_DEFAULT: SystemRegistry | None = None


def default_registry() -> SystemRegistry:
    """The shipped catalog (``specs/systems/``), loaded once per process."""
    global _DEFAULT
    if _DEFAULT is None:
        reg = SystemRegistry()
        if os.path.isdir(_DEFAULT_DIR):
            reg.load_path(_DEFAULT_DIR)
        _DEFAULT = reg
    return _DEFAULT
