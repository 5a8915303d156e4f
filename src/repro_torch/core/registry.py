"""Open extension registries for estimator and topology kinds: the
port's copy of the reference's ``core/registry.py``.

The paper's central claim is that one StableHLO representation fans out
to *many* performance models across *many* architectures — so the
estimator and topology vocabularies must be open, not if/elif chains.
A :class:`Registry` maps a kind name (the string a campaign spec uses)
to a *backend class* carrying a ``from_spec(options, system, context)``
classmethod; ``repro_torch.campaign.builders`` materializes grid points by
registry lookup and ``CampaignSpec.validate`` queries the same registry,
so the validator and the runner can never disagree about what exists.

Built-in kinds are registered *lazily*: the registry knows their names
and home modules up front (so a spec validates without numpy), but only
imports the module — whose ``@register_estimator`` /
``@register_topology`` decorators then fire — when a class is actually
requested.

Third-party backends register through the same decorators::

    from repro_torch.core.registry import register_estimator

    @register_estimator("my-sim")
    class MySimEstimator(ComputeEstimator):
        @classmethod
        def from_spec(cls, options, system, context):
            return cls(system, **options)

or into a scoped child registry (``ESTIMATORS.scope()``) passed as
``registry=`` — scoped registries overlay the global ones without
mutating them.

A pip-installed package can skip the explicit import entirely by
declaring an ``importlib.metadata`` entry point in the port's own
``repro_torch.backends`` group (a plugin written for the reference
imports ``repro``, which the port never does)::

    [project.entry-points."repro_torch.backends"]
    my-sim = "mypkg.repro_torch_backend"

The named module is imported (its decorators then fire) the first time
a kind lookup misses the known vocabulary or the vocabulary is listed —
once per process, never at ``import repro_torch`` time, so minimal
environments stay import-light.  A plugin that fails to import (or
collides with an existing kind) is reported as a warning and recorded
in :func:`plugin_status`; it never takes down the host process.
"""
from __future__ import annotations

import difflib
import importlib
import sys
import threading
import warnings
from dataclasses import dataclass


@dataclass
class BuildContext:
    """What a backend's ``from_spec`` may need beyond (options, system).

    ``system_name`` is the campaign-spec system id (``"host"`` is how the
    profiling estimator detects ground-truth mode); ``program`` is the
    parsed source program when the caller has one (profiling re-emits
    regions from it), and ``calls`` its text's ``call`` table (the
    operator each private function stands for, which the profiling
    estimator's executor runs); ``device`` is where a measuring backend
    runs (None: the card); the three registries let composite backends
    build sub-backends through the same open vocabulary that built them.
    """
    system_name: str = ""
    program: object | None = None
    calls: dict | None = None
    device: object | None = None
    estimators: "Registry | None" = None
    topologies: "Registry | None" = None
    systems: object | None = None   # repro_torch.core.catalog.SystemRegistry
    base_dir: str | None = None     # spec file's directory, for relative paths

    def resolve_path(self, path: str) -> str:
        """Resolve a spec-relative path against the spec file's dir."""
        import os
        if self.base_dir and not os.path.isabs(path):
            return os.path.join(self.base_dir, path)
        return path


#: the importlib.metadata entry-point group third-party distributions
#: use to expose backend modules for auto-discovery
PLUGIN_GROUP = "repro_torch.backends"

_plugins_scanned = False
_plugins_lock = threading.Lock()
_plugin_modules: dict[str, str] = {}    # entry-point name -> module loaded
_plugin_errors: dict[str, str] = {}     # entry-point name -> why it failed


def discover_plugins(*, force: bool = False) -> dict[str, str]:
    """Import every ``repro_torch.backends`` entry point, once per process.

    Each entry point names a module whose import self-registers its
    kinds through the usual decorators.  Returns the successfully loaded
    ``{entry-point name: module}`` mapping.  A plugin that raises on
    import — or whose registration collides with an existing kind — is
    skipped with a :class:`RuntimeWarning` and recorded in
    :func:`plugin_status`; one bad distribution must not break every
    other backend on the machine.  ``force=True`` rescans (tests and
    long-lived processes that just installed a package)."""
    global _plugins_scanned
    if _plugins_scanned and not force:
        return dict(_plugin_modules)
    # the multithreaded serve daemon hits this from concurrent lookups:
    # mark scanned only after the scan, under a lock, so a racing
    # Registry.get/__contains__ blocks here instead of observing a
    # half-populated vocabulary and raising unknown-kind
    with _plugins_lock:
        if _plugins_scanned and not force:
            return dict(_plugin_modules)
        import importlib.metadata as _md
        try:
            eps = _md.entry_points(group=PLUGIN_GROUP)
        except TypeError:   # pragma: no cover — legacy dict API (<3.10)
            eps = _md.entry_points().get(PLUGIN_GROUP, [])
        for ep in eps:
            if ep.name in _plugin_modules:
                continue
            try:
                ep.load()
            except Exception as e:  # noqa: BLE001 — isolate broken plugins
                _plugin_errors[ep.name] = f"{type(e).__name__}: {e}"
                warnings.warn(
                    f"repro_torch backend plugin {ep.name!r} ({ep.value}) failed "
                    f"to load and was skipped: {_plugin_errors[ep.name]}",
                    RuntimeWarning, stacklevel=2)
            else:
                _plugin_modules[ep.name] = ep.value
                _plugin_errors.pop(ep.name, None)
        _plugins_scanned = True
        return dict(_plugin_modules)


def plugin_status() -> dict:
    """What entry-point discovery has done so far in this process."""
    return {"scanned": _plugins_scanned,
            "loaded": dict(_plugin_modules),
            "errors": dict(_plugin_errors)}


class Registry:
    """Name -> backend-class registry with lazy builtins and scoping.

    * ``kinds()`` / ``in`` work without importing any backend module —
      validation stays usable in minimal environments;
    * ``get(kind)`` resolves lazily registered builtins by importing
      their home module (the module's own decorator registers the class);
    * ``scope()`` returns a child registry that falls back to this one
      for lookups but keeps its own registrations local — the mechanism
      behind session-scoped backends;
    * unknown kinds raise with the live vocabulary and a did-you-mean
      suggestion derived from it.
    """

    def __init__(self, label: str, builtins: dict[str, str] | None = None,
                 parent: "Registry | None" = None):
        self.label = label
        self.parent = parent
        self._entries: dict[str, type] = {}
        self._builtins: dict[str, str] = dict(builtins or {})

    # ------------------------------ queries ------------------------------

    def kinds(self) -> tuple[str, ...]:
        """Every known kind name (registered + lazy builtins + parents),
        builtins first in declaration order, then extensions by name.
        Listing the vocabulary triggers entry-point discovery, so
        pip-installed plugin kinds show up without an import."""
        discover_plugins()
        seen: dict[str, None] = {}
        root: Registry | None = self
        chain = []
        while root is not None:
            chain.append(root)
            root = root.parent
        for reg in reversed(chain):          # globals first, scopes after
            for k in reg._builtins:
                seen.setdefault(k)
        extras = set()
        for reg in chain:
            extras.update(k for k in reg._entries if k not in seen)
        for k in sorted(extras):
            seen.setdefault(k)
        return tuple(seen)

    def __contains__(self, kind: str) -> bool:
        if (kind in self._entries or kind in self._builtins
                or (self.parent is not None and kind in self.parent)):
            return True
        # unknown so far: maybe an installed-but-unimported plugin
        discover_plugins()
        return (kind in self._entries or kind in self._builtins
                or (self.parent is not None and kind in self.parent))

    def unknown_message(self, kind) -> str:
        """The error text for an unknown kind: live vocabulary plus a
        did-you-mean derived from it."""
        have = self.kinds()
        msg = f"unknown {self.label} kind {kind!r}; have {have}"
        close = difflib.get_close_matches(str(kind), have, n=1)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        return msg

    # ---------------------------- registration ----------------------------

    def register(self, kind: str, obj: type | None = None, *,
                 replace: bool = False):
        """Register ``obj`` under ``kind``; usable as a decorator.

        Duplicate kinds are an error unless ``replace=True`` — except the
        self-registration a lazy builtin's home module performs when it
        is first imported, which *fulfils* the pending entry."""
        def _do(cls: type) -> type:
            if not replace:
                owner = self._builtin_owner(kind)
                fulfils = (owner is not None
                           and getattr(cls, "__module__", None) == owner)
                if (kind in self._entries
                        or (owner is not None and not fulfils)
                        or (owner is None and self.parent is not None
                            and kind in self.parent)):
                    raise ValueError(
                        f"{self.label} kind {kind!r} is already registered "
                        f"(by {self._describe(kind)}); pass replace=True to "
                        "override it")
            if not callable(getattr(cls, "from_spec", None)):
                raise TypeError(
                    f"{self.label} backend for {kind!r} needs a "
                    "from_spec(options, system, context) classmethod "
                    f"(got {cls!r})")
            self._entries[kind] = cls
            return cls

        return _do if obj is None else _do(obj)

    def _builtin_owner(self, kind: str) -> str | None:
        reg: Registry | None = self
        while reg is not None:
            if kind in reg._builtins:
                return reg._builtins[kind]
            reg = reg.parent
        return None

    def _describe(self, kind: str) -> str:
        reg: Registry | None = self
        while reg is not None:
            if kind in reg._entries:
                cls = reg._entries[kind]
                return f"{cls.__module__}.{cls.__qualname__}"
            if kind in reg._builtins:
                return reg._builtins[kind]
            reg = reg.parent
        return "<unknown>"

    # ------------------------------ lookups ------------------------------

    def get(self, kind: str) -> type:
        """The backend class for ``kind`` (resolving lazy builtins and,
        on a miss, rescanning installed entry-point plugins once)."""
        cls = self._resolve(kind)
        if cls is None:
            discover_plugins()
            cls = self._resolve(kind)
        if cls is None:
            raise ValueError(self.unknown_message(kind))
        return cls

    def _resolve(self, kind: str) -> type | None:
        """One lookup pass: local entries, lazy builtins, then parents."""
        cls = self._entries.get(kind)
        if cls is not None:
            return cls
        module = self._builtins.get(kind)
        if module is not None:
            importlib.import_module(module)
            cls = self._entries.get(kind)
            if cls is None:
                raise ImportError(
                    f"module {module!r} did not register {self.label} "
                    f"kind {kind!r} on import")
            return cls
        if self.parent is not None:
            return self.parent._resolve(kind)
        return None

    # ------------------------------ scoping ------------------------------

    def scope(self) -> "Registry":
        """A child registry: local registrations, parent fallback."""
        return Registry(self.label, parent=self)

    def local_entries(self) -> dict[str, type]:
        """This registry's own (non-inherited) resolved entries — what a
        session ships to process-pool campaign workers."""
        return dict(self._entries)

    def portability_errors(self) -> list[str]:
        """Why this scope's classes could NOT cross a process boundary.

        Backend *classes* pickle by reference (``module.QualName``), so
        shipping a session's scoped registrations to worker processes —
        the campaign process executor, a serve fleet — requires each
        class to be importable at module level from the worker.  Returns
        one actionable message per offending class ([] when all are
        portable).  Systems ship by value and are never checked."""
        errs = []
        for kind, cls in self._entries.items():
            where = f"{getattr(cls, '__module__', '?')}." \
                    f"{getattr(cls, '__qualname__', '?')}"
            fix = (f"define the class at the top level of an importable "
                   f"module, or keep the work in-process (executor="
                   f"'serial'/'thread', a single-worker daemon)")
            if "<locals>" in getattr(cls, "__qualname__", ""):
                errs.append(
                    f"{self.label} kind {kind!r} is registered with "
                    f"{where}, a class defined inside a function — it "
                    f"cannot be pickled by reference into a worker "
                    f"process; {fix}")
                continue
            mod = sys.modules.get(getattr(cls, "__module__", ""))
            obj = mod
            for part in getattr(cls, "__qualname__", "?").split("."):
                obj = getattr(obj, part, None)
            if obj is not cls:
                errs.append(
                    f"{self.label} kind {kind!r} is registered with "
                    f"{where}, which is not reachable as a module "
                    f"attribute — a worker process cannot re-import it "
                    f"(did you register a dynamically created or "
                    f"shadowed class?); {fix}")
        return errs


#: the global estimator vocabulary; builtin kinds resolve lazily from
#: their home modules (each module self-registers via the decorator)
ESTIMATORS = Registry("estimator", builtins={
    "roofline": "repro_torch.core.estimators.analytical",
    "systolic": "repro_torch.core.estimators.systolic",
    "mixed": "repro_torch.core.estimators.base",
    "profiling": "repro_torch.core.estimators.profiling",
    "table": "repro_torch.core.estimators.table",
    "learned": "repro_torch.core.estimators.learned",
})

#: the global topology vocabulary
TOPOLOGIES = Registry("topology", builtins={
    "auto": "repro_torch.core.network.topology",
    "a2a": "repro_torch.core.network.topology",
    "dragonfly": "repro_torch.core.network.topology",
    "torus": "repro_torch.core.network.topology",
    "multipod": "repro_torch.core.network.topology",
})


def register_estimator(kind: str, cls: type | None = None, *,
                       registry: Registry | None = None,
                       replace: bool = False):
    """Register an estimator backend class under ``kind`` (decorator).

    The class must carry ``from_spec(options, system, context)``
    returning a :class:`~repro_torch.core.estimators.base.ComputeEstimator`.
    Without ``registry`` the global vocabulary is extended."""
    return (registry or ESTIMATORS).register(kind, cls, replace=replace)


def register_topology(kind: str, cls: type | None = None, *,
                      registry: Registry | None = None,
                      replace: bool = False):
    """Register a topology backend class under ``kind`` (decorator).

    The class must carry ``from_spec(params, system, context)`` returning
    a :class:`~repro_torch.core.network.topology.Topology`."""
    return (registry or TOPOLOGIES).register(kind, cls, replace=replace)
