"""Deterministic fault injection for robustness testing (test-only).

A *fault plan* is a small JSON document describing exactly where and
when the system should fail::

    {"seed": 7,
     "faults": [
       {"site": "campaign_row", "op": "kill", "at": 5, "worker": 0},
       {"site": "evaluate", "op": "error", "at": 3, "times": 1},
       {"site": "evaluate", "op": "hang", "at": [2, 6], "seconds": 120},
       {"site": "stream", "op": "reset", "at": 4},
       {"site": "cache_append", "op": "torn", "at": 2}]}

Sites (each keeps its own 1-based per-process call counter):

``evaluate``
    start of a campaign job's evaluate phase (``runner._execute``).
    Ops: ``error`` (raise :class:`FaultInjected`), ``hang``
    (sleep ``seconds``), ``kill`` (``os._exit(137)`` — a SIGKILL
    stand-in: no cleanup, no atexit, torn file state left as-is).
``campaign_row``
    after a campaign row is flushed to ``results.jsonl``/streamed.
    Ops: ``kill``, ``hang``, ``error``.
``stream``
    after a row is written to an NDJSON campaign response.  Op:
    ``reset`` (the server hard-closes the connection mid-stream).
``cache_append``
    after a cache batch is written but *before* the offset-index
    sidecar is maintained.  Ops: ``torn`` (truncate mid-record and
    skip the index append — the torn-writer crash the sidecar's
    coverage invariant exists for — then carry on), ``kill`` (truncate
    mid-record and die).

Matching knobs per fault: ``at`` (1-based counter value; a two-element
list is resolved to one value from the plan ``seed`` — deterministic
per plan), ``times`` (max fires, default 1), ``worker`` (only in the
process whose ``REPRO_FAULT_WORKER`` matches), ``generation`` (only in
the process whose ``REPRO_FAULT_GENERATION`` matches, default 0 — so a
restarted fleet worker, booted at generation 1, does *not* replay its
predecessor's faults), plus free-form context filters (``workload``,
``system``, ...) compared against the ``fire()`` call's keyword
context.

The plan travels through the environment (``REPRO_FAULT_PLAN`` holds a
path or inline JSON) so it crosses every process boundary we care
about: fleet supervisor -> daemon workers -> process-pool campaign
workers.  ``active()`` re-reads the environment when it changes, which
is what lets tests flip plans on and off with ``monkeypatch.setenv``.

Nothing here runs unless a plan is installed: the hot-path guard is a
single module-level boolean.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field

ENV_PLAN = "REPRO_FAULT_PLAN"
ENV_WORKER = "REPRO_FAULT_WORKER"
ENV_GENERATION = "REPRO_FAULT_GENERATION"

SITES = ("evaluate", "campaign_row", "stream", "cache_append")
OPS = ("error", "hang", "kill", "reset", "torn")

#: exit status used by ``op: kill`` — matches the shell's SIGKILL
#: convention so supervisors can't tell it from the real thing.
KILL_STATUS = 137

#: bytes chopped off the final record by ``op: torn`` — enough to
#: leave invalid JSON with no trailing newline, the classic torn tail.
TORN_TAIL_BYTES = 7


class FaultInjected(RuntimeError):
    """Raised by ``op: error`` faults (and carried on error rows)."""


@dataclass
class Fault:
    site: str
    op: str
    at: int
    times: int = 1
    worker: int | None = None
    generation: int | None = 0
    seconds: float = 3600.0
    match: dict = field(default_factory=dict)
    fired: int = 0

    @classmethod
    def parse(cls, raw: dict, rng: random.Random) -> "Fault":
        raw = dict(raw)
        site = raw.pop("site", None)
        if site not in SITES:
            raise ValueError(
                f"fault plan: unknown site {site!r} (one of {SITES})")
        op = raw.pop("op", None)
        if op not in OPS:
            raise ValueError(
                f"fault plan: unknown op {op!r} (one of {OPS})")
        at = raw.pop("at", 1)
        if isinstance(at, (list, tuple)):
            if len(at) != 2:
                raise ValueError("fault plan: 'at' range must be [lo, hi]")
            at = rng.randint(int(at[0]), int(at[1]))
        gen = raw.pop("generation", 0)
        worker = raw.pop("worker", None)
        return cls(site=site, op=op, at=int(at),
                   times=int(raw.pop("times", 1)),
                   worker=None if worker is None else int(worker),
                   generation=None if gen is None else int(gen),
                   seconds=float(raw.pop("seconds", 3600.0)),
                   match=raw)


class FaultPlan:
    """A parsed plan: the fault list plus this process's identity."""

    def __init__(self, doc: dict, *, worker: int | None = None,
                 generation: int = 0):
        if not isinstance(doc, dict):
            raise ValueError("fault plan: top level must be an object")
        self.seed = int(doc.get("seed", 0))
        rng = random.Random(self.seed)
        self.faults = [Fault.parse(f, rng) for f in doc.get("faults", [])]
        self.worker = worker
        self.generation = generation
        self.counters: dict[str, int] = {}
        self.fired: list[dict] = []
        self._lock = threading.Lock()

    def fire(self, site: str, **ctx) -> Fault | None:
        """Advance ``site``'s counter; return the matching fault, if any."""
        with self._lock:
            n = self.counters.get(site, 0) + 1
            self.counters[site] = n
            for f in self.faults:
                if f.site != site or f.fired >= f.times or f.at != n:
                    continue
                if f.worker is not None and f.worker != self.worker:
                    continue
                if (f.generation is not None
                        and f.generation != self.generation):
                    continue
                if any(ctx.get(k) != v for k, v in f.match.items()):
                    continue
                f.fired += 1
                self.fired.append(
                    {"site": site, "op": f.op, "at": n, **ctx})
                return f
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "fired": [dict(f) for f in self.fired]}


# ---------------------------------------------------------------------------
# process-global injector, resolved lazily from the environment

ENABLED = False
_PLAN: FaultPlan | None = None
_ENV_SIG: tuple | None = ()  # () = never resolved; None-able 3-tuple after
_RESOLVE_LOCK = threading.Lock()


def _env_sig() -> tuple | None:
    raw = os.environ.get(ENV_PLAN)
    if not raw:
        return None
    return (raw, os.environ.get(ENV_WORKER), os.environ.get(ENV_GENERATION))


def _install_from_sig(sig: tuple | None) -> None:
    global ENABLED, _PLAN, _ENV_SIG
    if sig is None:
        _PLAN, ENABLED, _ENV_SIG = None, False, None
        _set_cache_hook(False)
        return
    raw, worker, gen = sig
    text = raw if raw.lstrip().startswith("{") else open(raw).read()
    plan = FaultPlan(json.loads(text),
                     worker=None if worker is None else int(worker),
                     generation=int(gen or 0))
    _PLAN, ENABLED, _ENV_SIG = plan, True, sig
    _set_cache_hook(any(f.site == "cache_append" for f in plan.faults))


def install(doc: dict | None, *, worker: int | None = None,
            generation: int = 0) -> FaultPlan | None:
    """Install a plan directly (in-process; tests).  ``None`` uninstalls."""
    global ENABLED, _PLAN, _ENV_SIG
    with _RESOLVE_LOCK:
        if doc is None:
            _PLAN, ENABLED, _ENV_SIG = None, False, _env_sig()
            _set_cache_hook(False)
            return None
        _PLAN = FaultPlan(doc, worker=worker, generation=generation)
        ENABLED, _ENV_SIG = True, _env_sig()
        _set_cache_hook(
            any(f.site == "cache_append" for f in _PLAN.faults))
        return _PLAN


def active() -> bool:
    """Cheap hot-path guard; re-resolves when the environment changed."""
    global _ENV_SIG
    sig = _env_sig()
    if sig != _ENV_SIG:
        with _RESOLVE_LOCK:
            if sig != _ENV_SIG:  # double-checked under the lock
                _install_from_sig(sig)
    return ENABLED


def plan() -> FaultPlan | None:
    active()
    return _PLAN


def stats() -> dict | None:
    p = plan()
    return p.stats() if p is not None else None


def fire(site: str, **ctx) -> Fault | None:
    """Count a pass through ``site``; return the matching fault or None.

    Callers with site-specific ops (``reset``, ``torn``) interpret the
    returned fault themselves; everything generic goes through
    :func:`trip`.
    """
    p = plan()
    return p.fire(site, **ctx) if p is not None else None


def trip(site: str, **ctx) -> Fault | None:
    """Fire ``site`` and carry out the generic ops.

    ``error`` raises :class:`FaultInjected`; ``hang`` sleeps the
    fault's ``seconds`` (relying on a supervisor deadline to cut it
    short); ``kill`` exits the process abruptly via ``os._exit`` —
    the closest in-process stand-in for SIGKILL (no cleanup handlers,
    buffers and locks dropped on the floor).  Other ops are returned
    to the caller.
    """
    f = fire(site, **ctx)
    if f is None:
        return None
    if f.op == "error":
        raise FaultInjected(
            f"injected fault: site={site} at={f.at} ctx={ctx}")
    if f.op == "hang":
        time.sleep(f.seconds)
        return f
    if f.op == "kill":
        os._exit(KILL_STATUS)
    return f


# ---------------------------------------------------------------------------
# cache_append wiring: a class-level hook on PersistentCache, installed
# only while a plan with cache_append faults is live, so the cache has
# zero fault-plan coupling on the normal path.

def _cache_append_hook(cache, f) -> bool:
    """Called by ``PersistentCache.put_many`` after the batch is flushed,
    before index maintenance.  Returns True to skip index maintenance
    (simulating a writer that died between the two)."""
    fault = fire("cache_append", path=cache.path)
    if fault is None:
        return False
    end = f.tell()
    torn = max(0, end - TORN_TAIL_BYTES)
    f.truncate(torn)
    if fault.op == "kill":
        os._exit(KILL_STATUS)
    # op == "torn": leave the torn tail for the next reader/writer to
    # heal, and bring this process's view in line with the file so it
    # keeps running (its in-memory entries still cover the lost batch).
    cache._offset = torn
    st = os.fstat(f.fileno())
    cache._stat = (st.st_ino, st.st_size, st.st_mtime_ns)
    return True


def _set_cache_hook(on: bool) -> None:
    from ..core.estimators.cache import PersistentCache
    # plain function, always reached via class attribute access (no
    # instance binding), so no staticmethod wrapper needed
    PersistentCache.fault_hook = _cache_append_hook if on else None
