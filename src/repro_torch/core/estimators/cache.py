"""(H × C × R) latency cache (paper §III-B(c)).

Key = (target hardware H, compilation toolchain C, compute region R);
changing any of the three can change latency, nothing else can.  Stacked
transformer blocks produce identical region fingerprints, so an L-layer
model pays for one evaluation per distinct block — the mechanism behind
the paper's 89.7 % (Llama-3) / 26.8 % (ResNet) evaluation-time savings.

Two layers:

  * :class:`CachedEstimator` — the in-run memo wrapping any estimator.
  * :class:`PersistentCache`  — an on-disk store of the same keyed entries
    that campaigns, benchmarks, and repeated runs share across processes,
    extending the within-run savings to across-run savings.

The on-disk format is a *file-locked append log* (JSONL): line 1 is a
version header, every further line is one ``{"k": key, "v": seconds,
"c": eval_cost_seconds}`` record.  Appends take an exclusive ``flock``
(batched: :meth:`PersistentCache.put_many` writes a whole evaluate
phase's fresh entries under one lock); readers take a shared one and
:meth:`PersistentCache.refresh` absorbs only the log tail written since
the last read, skipping the lock entirely while a cheap ``stat`` shows
the file unchanged — which is what lets
process-pool campaign workers sharing one cache path observe each
other's freshly computed entries *mid-campaign* instead of a startup
snapshot.  Each entry also carries the wall-clock cost of the estimator
evaluation that produced it, so a later run (or another process) that
hits the entry can account the time it *avoided* — making
``CacheStats.time_saving_fraction`` meaningful across runs, not just
within one.

Alongside the log lives an *offset index* sidecar (``<path>.idx``):
``{"k": key, "o": byte_offset}`` lines mapping each key to its latest
log record, plus ``{"c": offset}`` coverage markers recording how far
into the log the index is complete.  The sidecar is written under the
**same** flock round-trip as the log lines it describes (the log file's
lock is the single synchronization point for both files), so it costs no
extra lock traffic and can never get ahead of the log.  It buys point
lookups: :meth:`get_many` resolves keys absent from memory by seeking
straight to their records — O(1) per key, ``scan_bytes`` counts only the
record lines actually read — instead of absorbing the whole unread log
tail; only keys the index does not cover fall back to tailing the
uncovered suffix.  A stale, torn, or missing index is never trusted
blindly — coverage markers bound what it may be believed about, the
header generation ties it to one log compaction, and
:meth:`rebuild_index` (called automatically by the next ``put_many``)
regenerates it from the log, which remains the single source of truth.
``lazy=True`` construction reads just the header and the index, deferring
all record I/O to lookups — the cold-start mode for processes that touch
a handful of keys from a large shared store.

The format is versioned: ``SCHEMA_VERSION`` guards the file layout and
``FINGERPRINT_VERSION`` guards the region-fingerprint algorithm (the R
of the key).  Bumping either invalidates stale files on load instead of
silently serving latencies keyed by an incompatible fingerprint.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import MutableMapping

from ..slicing.regions import ComputeRegion
from .base import ComputeEstimator

#: bump when the on-disk layout changes (2 = JSONL append log + costs)
SCHEMA_VERSION = 2
#: bump when slicing.regions.region_fingerprint changes what it hashes
FINGERPRINT_VERSION = 1

try:
    import fcntl

    def _lock_sh(f):
        fcntl.flock(f.fileno(), fcntl.LOCK_SH)

    def _lock_ex(f):
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)

    def _unlock(f):
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)
except ImportError:  # non-POSIX: degrade to unlocked (single-process) use
    def _lock_sh(f):
        pass

    def _lock_ex(f):
        pass

    def _unlock(f):
        pass


@dataclass
class CacheStats:
    """Hit/miss counters plus the paper's evaluation-time accounting.

    ``saved_seconds`` is the estimator wall time *avoided* by hits: for a
    key this run computed itself it is the measured cost of that first
    evaluation; for a key served from a shared/persistent store it is the
    cost persisted by whichever run computed it."""
    hits: int = 0
    misses: int = 0
    saved_seconds: float = 0.0     # estimator wall-time avoided (measured)
    miss_cost_seconds: float = 0.0  # wall-time actually spent on misses
    per_key_cost: dict = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def time_saving_fraction(self) -> float:
        """Fraction of evaluation time avoided by caching (paper's metric)."""
        would_be = self.saved_seconds + self.miss_cost_seconds
        return self.saved_seconds / would_be if would_be > 0 else 0.0


class PersistentCache:
    """On-disk (H, C, R) -> (seconds, eval cost) store shared across runs
    *and live processes*.

    Thread-safe within one process.  Across processes the backing file is
    an append log guarded by ``flock``: :meth:`append` writes through
    immediately (absorbing any lines other processes appended first) and
    :meth:`refresh` tails the log, so two workers pointed at one path see
    each other's fresh entries mid-run.  :meth:`save` compacts the log
    (atomic tmp + rename).  Entries are deterministic per key for a given
    estimator, so last-writer-wins races are harmless.
    """

    #: test-only crash-simulation hook (``repro_torch.serve.faults``): called
    #: after a batch is flushed but before index maintenance; returning
    #: True skips the index step (a writer that died between the two).
    fault_hook = None

    def __init__(self, path: str | None = None, lazy: bool = False):
        self.path = path
        self.entries: dict[str, float] = {}
        self.costs: dict[str, float] = {}
        self.loaded_entries = 0
        self.lock_roundtrips = 0  # flock acquisitions (I/O cost accounting)
        self.scan_bytes = 0       # log bytes actually read (records only)
        self.point_reads = 0      # single-record reads served by the index
        self._lock = threading.Lock()
        self._offset = 0          # bytes of the log already absorbed
        self._header_ok = False   # file exists with a matching header
        self._gen: str | None = None  # header generation id last seen
        self._stat: tuple | None = None  # (ino, size, mtime_ns) last synced
        self._idx: dict[str, int] = {}  # key -> log offset of latest record
        self._idx_cover = 0       # log bytes the index fully describes
        self._idx_offset = 0      # sidecar bytes already absorbed
        self._idx_bad = False     # sidecar torn/foreign: rebuild before use
        if path:
            self.load(path, lazy=lazy)

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def __getitem__(self, key: str) -> float:
        return self.entries[key]

    def __setitem__(self, key: str, value: float) -> None:
        with self._lock:
            self.entries[key] = value

    def get(self, key: str, default=None):
        return self.entries.get(key, default)

    def cost(self, key: str) -> float:
        """Persisted estimator wall cost of the evaluation behind ``key``
        (0.0 when the producing run predates cost persistence)."""
        return self.costs.get(key, 0.0)

    def stats_dict(self) -> dict:
        """The store's live accounting, JSON-ready — what long-lived
        holders (the serve daemon's ``/stats``, campaign summaries)
        surface without reaching into internals."""
        with self._lock:
            return {
                "path": self.path,
                "entries": len(self.entries),
                "loaded_entries": self.loaded_entries,
                "persisted_cost_seconds": round(
                    sum(self.costs.values()), 6),
                "lock_roundtrips": self.lock_roundtrips,
                "scan_bytes": self.scan_bytes,
                "point_reads": self.point_reads,
                "index_keys": len(self._idx),
            }

    # ------------------------------ log I/O ------------------------------

    def _absorb_line(self, line: str) -> int:
        """Parse one log line into memory; returns 1 for a new entry."""
        line = line.strip()
        if not line:
            return 0
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return 0  # torn tail of a crashed writer — ignorable
        if not isinstance(rec, dict) or "k" not in rec:
            return 0
        key = str(rec["k"])
        new = key not in self.entries
        self.entries[key] = float(rec.get("v", 0.0))
        if rec.get("c"):
            self.costs[key] = float(rec["c"])
        return 1 if new else 0

    @staticmethod
    def _parse_header_gen(line: str) -> str | None:
        """The generation id of a valid v2 header, None for foreign/stale."""
        try:
            h = json.loads(line)
        except json.JSONDecodeError:
            return None
        if not (isinstance(h, dict)
                and h.get("schema") == SCHEMA_VERSION
                and h.get("fingerprint") == FINGERPRINT_VERSION):
            return None
        return str(h.get("gen", ""))

    def _sync_locked(self, f) -> tuple[bool, int]:
        """With the flock *and* ``self._lock`` held: validate the header,
        detect compaction, absorb every unread record.

        Compaction by another process is detected via the header's
        generation id (every :meth:`save` writes a fresh one), not file
        size — a compacted log that regrew past the old offset would
        otherwise be tailed from a stale mid-record position.  Returns
        ``(valid_file, newly_seen_keys)``.
        """
        st = os.fstat(f.fileno())
        size = st.st_size
        self._stat = (st.st_ino, st.st_size, st.st_mtime_ns)
        if size == 0:
            self._offset = 0
            self._header_ok = False
            return True, 0
        f.seek(0)
        gen = self._parse_header_gen(f.readline())
        if gen is None:
            self._header_ok = False
            return False, 0
        header_end = f.tell()
        if gen != self._gen:
            # compaction rewrote the log: every indexed byte offset is
            # stale; drop the index and re-absorb the sidecar (or rebuild)
            self._reset_index_locked()
        if (gen != self._gen or not self._header_ok
                or self._offset < header_end or self._offset > size):
            self._gen = gen
            self._header_ok = True
            self._offset = header_end
        f.seek(self._offset)
        new = 0
        for line in f:
            self.scan_bytes += len(line)
            new += self._absorb_line(line)
        self._offset = f.tell()
        return True, new

    # ----------------------------- offset index -----------------------------

    def _reset_index_locked(self) -> None:
        self._idx.clear()
        self._idx_cover = 0
        self._idx_offset = 0
        self._idx_bad = False

    def _read_index_locked(self, gen: str) -> None:
        """Absorb unread sidecar lines (``self._lock`` held; caller holds
        the log flock, which also guards the sidecar).

        The header must tie the sidecar to the log generation ``gen``;
        a foreign/torn sidecar is flagged for rebuild, never trusted.
        Garbled lines (a torn batch from a crashed writer) are skipped —
        coverage markers only advance on intact batches, so whatever the
        crash left unindexed stays inside the uncovered suffix."""
        if self._idx_bad or not self.path:
            return
        try:
            with open(self.path + ".idx") as fi:
                fi.seek(self._idx_offset)
                if self._idx_offset == 0:
                    first = fi.readline()
                    if not first:
                        return
                    try:
                        h = json.loads(first)
                    except json.JSONDecodeError:
                        h = None
                    if not (isinstance(h, dict)
                            and h.get("schema") == SCHEMA_VERSION
                            and h.get("fingerprint") == FINGERPRINT_VERSION
                            and str(h.get("gen", "")) == gen):
                        self._idx_bad = True
                        return
                for line in fi:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if not isinstance(rec, dict):
                        continue
                    if "k" in rec and "o" in rec:
                        self._idx[str(rec["k"])] = int(rec["o"])
                    elif "c" in rec:
                        self._idx_cover = max(self._idx_cover, int(rec["c"]))
                self._idx_offset = fi.tell()
        except (OSError, ValueError, TypeError):
            return

    def _append_index_locked(self, offs: dict[str, int], cover: int) -> None:
        """Append fresh key->offset lines plus a coverage marker (under
        the log flock — the sidecar shares the log's lock)."""
        try:
            with open(self.path + ".idx", "a") as fi:
                for k, o in offs.items():
                    fi.write(json.dumps({"k": k, "o": o},
                                        separators=(",", ":")) + "\n")
                fi.write(json.dumps({"c": cover},
                                    separators=(",", ":")) + "\n")
                fi.flush()
                self._idx_offset = fi.tell()
        except OSError:
            return
        self._idx.update(offs)
        self._idx_cover = max(self._idx_cover, cover)

    def _write_index_locked(self, gen: str, offs: dict[str, int],
                            cover: int) -> None:
        """Atomically replace the sidecar (tmp + rename) with a fresh
        header tied to ``gen`` plus the full key->offset map."""
        ip = self.path + ".idx"
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(ip) or ".",
                                   prefix=".cacheidx-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fi:
                fi.write(json.dumps(
                    {"schema": SCHEMA_VERSION,
                     "fingerprint": FINGERPRINT_VERSION, "gen": gen}) + "\n")
                for k, o in offs.items():
                    fi.write(json.dumps({"k": k, "o": o},
                                        separators=(",", ":")) + "\n")
                fi.write(json.dumps({"c": cover},
                                    separators=(",", ":")) + "\n")
                size = fi.tell()
            os.replace(tmp, ip)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._idx = dict(offs)
        self._idx_cover = cover
        self._idx_offset = size
        self._idx_bad = False

    def _rebuild_index_locked(self, f) -> int:
        """Regenerate the sidecar from the log — the single source of
        truth.  Returns the number of indexed keys.  Caller holds the log
        flock and ``self._lock``."""
        f.seek(0)
        gen = self._parse_header_gen(f.readline())
        if gen is None:
            return 0
        self._reset_index_locked()
        offs: dict[str, int] = {}
        pos = f.tell()
        for line in iter(f.readline, ""):
            self.scan_bytes += len(line)
            s = line.strip()
            if s:
                try:
                    rec = json.loads(s)
                    if isinstance(rec, dict) and "k" in rec:
                        offs[str(rec["k"])] = pos
                except json.JSONDecodeError:
                    pass
            pos = f.tell()
        self._write_index_locked(gen, offs, pos)
        return len(offs)

    def rebuild_index(self) -> int:
        """Regenerate ``<path>.idx`` from the log (crash recovery / manual
        repair); also happens automatically on the next :meth:`put_many`
        that finds the sidecar missing, torn, or trailing the log.
        Returns #indexed keys."""
        if not self.path or not os.path.exists(self.path):
            return 0
        with open(self.path, "a+") as f:
            _lock_ex(f)
            self.lock_roundtrips += 1
            try:
                with self._lock:
                    return self._rebuild_index_locked(f)
            finally:
                _unlock(f)

    def _lookup_missing(self, keys: list[str]) -> int:
        """Resolve keys absent from memory via index point-reads.

        One shared-flock round-trip for the whole batch: validate the log
        header, absorb any fresh sidecar lines, then seek straight to each
        indexed key's record — ``scan_bytes`` grows by just those record
        lines.  Keys the index does not know fall back to tailing only the
        log suffix past the index's coverage marker.  A point-read of a
        record another process since superseded is harmless: entries are
        deterministic per key, and full absorption stays idempotent
        (``self._offset`` is never advanced here).  Skipped entirely —
        zero I/O, zero locks — while a ``stat`` shows the log unchanged
        since the last *full* sync, because then absent-in-memory means
        absent-on-disk.  Returns the number of newly resolved keys."""
        if not self.path or not os.path.exists(self.path):
            return 0
        try:
            st = os.stat(self.path)
            if (self._header_ok and self._stat is not None
                    and (st.st_ino, st.st_size, st.st_mtime_ns)
                    == self._stat):
                return 0
        except OSError:
            return 0
        new = 0
        try:
            with open(self.path) as f:
                _lock_sh(f)
                self.lock_roundtrips += 1
                try:
                    with self._lock:
                        f.seek(0)
                        gen = self._parse_header_gen(f.readline())
                        if gen is None:
                            return 0
                        header_end = f.tell()
                        if gen != self._gen:
                            self._reset_index_locked()
                            self._gen = gen
                            self._offset = header_end
                        self._header_ok = True
                        self._read_index_locked(gen)
                        unresolved = []
                        for k in keys:
                            if k in self.entries:
                                continue
                            o = self._idx.get(k)
                            if o is None:
                                unresolved.append(k)
                                continue
                            f.seek(o)
                            line = f.readline()
                            self.scan_bytes += len(line)
                            self.point_reads += 1
                            new += self._absorb_line(line)
                            if k not in self.entries:
                                unresolved.append(k)
                        if unresolved:
                            # tail only the suffix the index does not
                            # cover; don't advance _offset — this is not
                            # a contiguous absorb from it
                            start = max(self._idx_cover, header_end,
                                        self._offset)
                            f.seek(start)
                            for line in f:
                                self.scan_bytes += len(line)
                                new += self._absorb_line(line)
                finally:
                    _unlock(f)
        except OSError:
            return new
        return new

    def load(self, path: str, lazy: bool = False) -> int:
        """Load a cache log; stale/foreign files are discarded, not errors.

        ``lazy=True`` reads only the header and the offset-index sidecar —
        no records — leaving all entry I/O to later :meth:`get_many` point
        lookups (or a full :meth:`refresh`)."""
        self.path = path
        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                _lock_sh(f)
                self.lock_roundtrips += 1
                try:
                    with self._lock:
                        if lazy:
                            f.seek(0)
                            gen = self._parse_header_gen(f.readline())
                            if gen is not None:
                                if gen != self._gen:
                                    self._gen = gen
                                    self._offset = f.tell()
                                self._header_ok = True
                                self._read_index_locked(gen)
                            return 0
                        ok, new = self._sync_locked(f)
                        if ok:
                            self.loaded_entries = new
                finally:
                    _unlock(f)
        except OSError:
            return 0
        return self.loaded_entries

    def refresh(self) -> int:
        """Absorb log records other processes wrote since the last read.

        Cheap when nothing changed: one ``stat`` — the locked tail-read is
        skipped entirely while the log's (inode, size, mtime) triple
        matches the state last synced, so hot lookup paths pay no flock
        when no other process has written.  Compaction by another process
        is detected via the header generation id and triggers a full
        re-read (in-memory entries are kept — absorption only
        adds/overwrites).  Returns the number of previously unseen keys.
        """
        if not self.path or not os.path.exists(self.path):
            return 0
        try:
            st = os.stat(self.path)
            if (self._header_ok and self._stat is not None
                    and (st.st_ino, st.st_size, st.st_mtime_ns)
                    == self._stat):
                return 0
        except OSError:
            return 0
        try:
            with open(self.path) as f:
                _lock_sh(f)
                self.lock_roundtrips += 1
                try:
                    with self._lock:
                        ok, new = self._sync_locked(f)
                finally:
                    _unlock(f)
        except OSError:
            return 0
        return new if ok else 0

    def append(self, key: str, value: float, cost: float = 0.0) -> None:
        """Record one entry and write it through to the shared log."""
        self.put_many({key: (value, cost)})

    def get_many(self, keys: list[str]) -> dict[str, float]:
        """Look up a batch of keys in one store round-trip.

        A path-backed store touches the shared log at most *once* for the
        whole batch (and only when some key is absent in memory) instead
        of once per key — the lock-amortized lookup the evaluate phase
        uses.  Inside that single round-trip, indexed keys are resolved
        by seeking straight to their records (:meth:`_lookup_missing`)
        rather than absorbing the whole unread tail.  Returns only the
        keys present."""
        if self.path:
            missing = [k for k in keys if k not in self.entries]
            if missing:
                self._lookup_missing(missing)
        with self._lock:
            return {k: self.entries[k] for k in keys if k in self.entries}

    def put_many(self, records: MutableMapping) -> None:
        """Record a batch of entries and write them through to the shared
        log under a *single* exclusive lock round-trip.

        ``records`` maps key -> seconds or key -> (seconds, cost).  Holds
        the lock across (absorb others' records, write own lines), so
        concurrent appenders interleave cleanly and this process's offset
        stays coherent with the file."""
        norm: dict[str, tuple[float, float]] = {}
        for key, v in records.items():
            if isinstance(v, (tuple, list)):
                norm[key] = (float(v[0]), float(v[1]) if len(v) > 1 else 0.0)
            else:
                norm[key] = (float(v), 0.0)
        with self._lock:
            for key, (value, cost) in norm.items():
                self.entries[key] = value
                if cost:
                    self.costs[key] = cost
        if not self.path or not norm:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a+") as f:
            _lock_ex(f)
            self.lock_roundtrips += 1
            try:
                with self._lock:
                    ok, _ = self._sync_locked(f)
                    if not ok:
                        return  # foreign/stale file: leave it alone
                    if not self._header_ok:  # empty file: initialize it
                        import uuid
                        self._gen = uuid.uuid4().hex
                        f.write(json.dumps(
                            {"schema": SCHEMA_VERSION,
                             "fingerprint": FINGERPRINT_VERSION,
                             "gen": self._gen}) + "\n")
                        self._header_ok = True
                    batch_start = f.tell()
                    offs: dict[str, int] = {}
                    for key, (value, cost) in norm.items():
                        offs[key] = f.tell()
                        f.write(json.dumps(
                            {"k": key, "v": value, "c": cost or 0.0},
                            separators=(",", ":")) + "\n")
                    f.flush()
                    self._offset = f.tell()
                    st = os.fstat(f.fileno())
                    self._stat = (st.st_ino, st.st_size, st.st_mtime_ns)
                    if (PersistentCache.fault_hook is not None
                            and PersistentCache.fault_hook(self, f)):
                        return  # simulated writer crash: no index step
                    # index maintenance, same flock: append when the
                    # sidecar provably covers everything before this
                    # batch, else regenerate it from the log.  The
                    # coverage check is what keeps a crashed writer's
                    # unindexed records from ever being overclaimed.
                    self._read_index_locked(self._gen)
                    if self._idx_bad or self._idx_cover != batch_start:
                        self._rebuild_index_locked(f)
                    else:
                        self._append_index_locked(offs, self._offset)
            finally:
                _unlock(f)

    def merge(self, entries: MutableMapping) -> int:
        """Fold in entries computed elsewhere; returns #new keys.

        Values may be plain seconds or ``(seconds, cost)`` pairs (the
        form campaign workers ship back)."""
        with self._lock:
            new = sum(1 for k in entries if k not in self.entries)
            for k, v in entries.items():
                if isinstance(v, (tuple, list)):
                    self.entries[k] = float(v[0])
                    if len(v) > 1 and v[1]:
                        self.costs[k] = float(v[1])
                else:
                    self.entries[k] = float(v)
        return new

    def save(self, path: str | None = None) -> str:
        """Compact the log: absorb any concurrent records, then atomically
        rewrite header + one line per entry (tmp + rename), so readers
        never see a torn file.  The rewritten header carries a fresh
        generation id; other live processes notice it on their next
        refresh/append and re-read instead of tailing a stale offset.

        Compaction is meant for run *end* (the campaign runner saves
        once, after workers exit).  A line another process appends in
        the instant between the absorb and the rename lands in the
        replaced inode — that process still holds the entry in memory
        and re-adds it at its own save."""
        import uuid

        path = path or self.path
        if not path:
            raise ValueError("PersistentCache.save: no path configured")
        if self.path == path:
            self.refresh()
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".cache-", suffix=".tmp")
        try:
            with self._lock:
                self._gen = uuid.uuid4().hex
                offs: dict[str, int] = {}
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(
                        {"schema": SCHEMA_VERSION,
                         "fingerprint": FINGERPRINT_VERSION,
                         "gen": self._gen}) + "\n")
                    for k, v in self.entries.items():
                        offs[k] = f.tell()
                        f.write(json.dumps(
                            {"k": k, "v": v, "c": self.costs.get(k, 0.0)},
                            separators=(",", ":")) + "\n")
                os.replace(tmp, path)
                st = os.stat(path)
                self._offset = st.st_size
                self._stat = (st.st_ino, st.st_size, st.st_mtime_ns)
                self._header_ok = True
                # the compacted log gets a matching sidecar: offsets were
                # recorded during the rewrite, so no second log scan
                self._write_index_locked(self._gen, offs, st.st_size)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path


class CachedEstimator(ComputeEstimator):
    """Memoizing wrapper; optionally backed by a shared/persistent store.

    ``store`` may be a plain dict shared between several CachedEstimator
    instances (the campaign runner's in-process mode) or a
    :class:`PersistentCache` (cross-run / cross-process mode).  With a
    path-backed PersistentCache, misses are written through to the shared
    log immediately and lookups that miss in memory first tail the log —
    so a concurrent process's fresh entries become hits here mid-run.
    ``new_entries`` records ``key -> (value, cost)`` for the keys this
    instance computed itself, so a parallel worker can ship only its
    fresh results back to the coordinating process.
    """

    def __init__(self, inner: ComputeEstimator,
                 persist_path: str | None = None,
                 store: MutableMapping[str, float] | PersistentCache | None = None):
        super().__init__(inner.system)
        self.inner = inner
        self.toolchain = inner.toolchain
        self.persist_path = persist_path
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self.new_entries: dict[str, tuple[float, float]] = {}
        if store is not None:
            self._mem = store
        elif persist_path:
            self._mem = PersistentCache(persist_path)
        else:
            self._mem = {}

    @property
    def _key_prefix(self) -> str:
        """The (H, C, config) part of the cache key, fingerprint-ready."""
        return (f"{self.inner.cache_hw_key}|{self.inner.toolchain}"
                f"|{self.inner.cache_config_key}|")

    def _key(self, region: ComputeRegion) -> str:
        """The (H, C, config, R) cache key for ``region``."""
        return self._key_prefix + region.fingerprint

    def _hit_cost(self, key: str) -> float:
        """Evaluation cost avoided by a hit on ``key``: measured locally
        if this instance computed it, else the store's persisted cost."""
        local = self.stats.per_key_cost.get(key)
        if local is not None:
            return local
        if isinstance(self._mem, PersistentCache):
            return self._mem.cost(key)
        return 0.0

    def get_run_time_estimate(self, region: ComputeRegion) -> float:
        import time
        key = self._key(region)
        with self._lock:
            if key in self._mem:
                self.stats.hits += 1
                self.stats.saved_seconds += self._hit_cost(key)
                return self._mem[key]
        # miss in memory: a concurrent process may have evaluated the key
        # since our last look at the shared log — one indexed point read
        # (or an uncovered-suffix tail) before paying for an evaluation
        if isinstance(self._mem, PersistentCache) and self._mem.path:
            self._mem.get_many([key])
            with self._lock:
                if key in self._mem:
                    self.stats.hits += 1
                    self.stats.saved_seconds += self._hit_cost(key)
                    return self._mem[key]
        t0 = time.perf_counter()
        value = self.inner.get_run_time_estimate(region)
        dt = time.perf_counter() - t0
        with self._lock:
            if isinstance(self._mem, PersistentCache):
                self._mem.append(key, value, cost=dt)
            else:
                self._mem[key] = value
            self.new_entries[key] = (value, dt)
            self.stats.misses += 1
            self.stats.miss_cost_seconds += dt
            self.stats.per_key_cost[key] = dt
        return value

    def get_run_time_estimates(self, regions: list[ComputeRegion],
                               arrays=None) -> list[float]:
        """Batched lookup: all regions of one evaluate phase in a single
        store round-trip.

        Per-region counters (hits, misses, saved/miss cost, per-key cost,
        ``new_entries``) are updated exactly as the equivalent sequence of
        :meth:`get_run_time_estimate` calls would — a duplicate
        fingerprint later in the batch is a hit on the earlier miss — but
        a path-backed :class:`PersistentCache` is tailed at most once for
        the whole batch and all fresh entries are written through in one
        exclusive-lock round-trip (:meth:`PersistentCache.put_many`)
        instead of one per miss.

        With the plan's :class:`~repro_torch.core.ir.arrays.RegionArrays` (same
        regions, same order), keys come from the memoized per-prefix key
        table instead of per-region string formatting, and the two common
        grid shapes skip per-region work entirely while producing the
        same values and hit/miss counts as the loop below:

        * **warm** — every key already cached: one pass over the key list;
        * **cold** — no key cached and no in-batch duplicates, with an
          inner ``evaluate_batch``: one vectorized inner evaluation (the
          measured wall cost is attributed uniformly across the batch's
          per-key cost accounting).

        Mixed batches (and inner estimators without ``evaluate_batch``)
        take the per-region loop."""
        import time
        keys = (arrays.keys_for(self._key_prefix) if arrays is not None
                else [self._key(r) for r in regions])
        if isinstance(self._mem, PersistentCache) and self._mem.path:
            # one get_many tails the log at most once for the whole
            # batch; absorbed entries serve the per-key loop below
            self._mem.get_many(keys)
        if arrays is not None:
            fast = self._estimates_from_arrays(keys, arrays)
            if fast is not None:
                return fast
        out: list[float] = []
        pending: dict[str, tuple[float, float]] = {}
        try:
            for key, region in zip(keys, regions):
                with self._lock:
                    if key in self._mem:
                        self.stats.hits += 1
                        self.stats.saved_seconds += self._hit_cost(key)
                        out.append(self._mem[key])
                        continue
                t0 = time.perf_counter()
                value = self.inner.get_run_time_estimate(region)
                dt = time.perf_counter() - t0
                with self._lock:
                    if isinstance(self._mem, PersistentCache):
                        # memory-only for now: in-batch duplicates must
                        # hit; the log write is one put_many at the end
                        self._mem.merge({key: (value, dt)})
                        pending[key] = (value, dt)
                    else:
                        self._mem[key] = value
                    self.new_entries[key] = (value, dt)
                    self.stats.misses += 1
                    self.stats.miss_cost_seconds += dt
                    self.stats.per_key_cost[key] = dt
                out.append(value)
        finally:
            # flush even when the estimator raises mid-batch: entries
            # already computed must reach the shared log (the per-region
            # path wrote each through immediately)
            if pending and isinstance(self._mem, PersistentCache) \
                    and self._mem.path:
                self._mem.put_many(pending)
        return out

    def _estimates_from_arrays(self, keys: list[str],
                               arrays) -> list[float] | None:
        """The warm / cold vector paths; None means 'take the loop'."""
        import time
        with self._lock:
            n_cached = sum(1 for k in set(keys) if k in self._mem)
        if n_cached == len(set(keys)):            # warm: all keys present
            out = []
            with self._lock:
                for key in keys:
                    self.stats.hits += 1
                    self.stats.saved_seconds += self._hit_cost(key)
                    out.append(self._mem[key])
            return out
        batch = getattr(self.inner, "evaluate_batch", None)
        if n_cached == 0 and batch is not None \
                and len(set(keys)) == len(keys):  # cold, all distinct
            t0 = time.perf_counter()
            values = batch(arrays)
            dt = time.perf_counter() - t0
            if values is None:
                # inner estimator declined the batch (its vector path
                # cannot replay these regions exactly): take the loop
                return None
            each = dt / len(keys) if keys else 0.0
            records = {k: (v, each) for k, v in zip(keys, values)}
            with self._lock:
                if isinstance(self._mem, PersistentCache):
                    self._mem.merge(records)
                else:
                    for k, (v, _) in records.items():
                        self._mem[k] = v
                self.new_entries.update(records)
                self.stats.misses += len(keys)
                self.stats.miss_cost_seconds += dt
                for k in keys:
                    self.stats.per_key_cost[k] = each
            if isinstance(self._mem, PersistentCache) and self._mem.path:
                self._mem.put_many(records)
            return list(values)
        return None

    def supports(self, region: ComputeRegion) -> bool:
        return self.inner.supports(region)

    def flush(self) -> None:
        """Persist the store to ``persist_path`` (no-op without one)."""
        if not self.persist_path:
            return
        if isinstance(self._mem, PersistentCache):
            self._mem.save(self.persist_path)
        else:
            pc = PersistentCache()
            pc.merge(self._mem)
            pc.save(self.persist_path)
