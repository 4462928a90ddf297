"""Parquet columnar event-store driver — the scalable EVENTDATA backend.

Counterpart of ``predictionio_tpu/data/storage/parquet.py`` on the port's
own Parquet codec (``parquet_format``, no pyarrow). The directory layout
and the WAL lines are the JAX driver's byte for byte, so a store that
either package wrote, wholly or partly, is read by the other:

    <path>/app_<id>_ch_<cid>/events-<seq>.parquet   immutable sorted parts
    <path>/app_<id>_ch_<cid>/wal-<writer>.jsonl     per-writer append logs
    <path>/.app_<id>_ch_<cid>.lock                  the parts lock (flock)

Writes append to the calling process's own WAL file (cheap, durable, and
safe for concurrent writer processes sharing the directory — appends never
interleave across files); reads merge parts + all WALs with delete
tombstones applied; ``compact()`` folds the WALs into a new part
(auto-triggered past a threshold), serialized across processes by an
``flock`` on the lock file (outside the namespace dir so a wipe cannot
delete it from under a holder) and deleting exactly the files it folded.
``PEvents.find`` materializes the :class:`EventBatch` straight from the
columns — no per-row Event objects on the bulk path — and
``PEvents.find_interactions`` reads only the columns training consumes,
turning the id columns into codes without a Python string per row.

Time-ordered scans map to the parts' statistics: parts are written sorted
by ``event_time``, and time-ranged reads prune whole part files whose
[min, max] event_time lies outside the requested window before any of
their pages are read.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import os
import threading
import uuid
from typing import Iterable, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.batch import EventBatch, LazyJsonProperties
from predictionio_tpu_torch.data.event import DataMap, Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage import parquet_format as pqf

UTC = _dt.timezone.utc

# one WAL file per writer process: concurrent event servers / importers on a
# shared filesystem never interleave within a file. Derived lazily and
# re-derived after fork() — a forked worker must not inherit its parent's
# WAL filename or the no-interleave invariant breaks.
_WRITER_TOKEN: Optional[tuple[int, str]] = None


def _writer_token() -> str:
    global _WRITER_TOKEN
    pid = os.getpid()
    if _WRITER_TOKEN is None or _WRITER_TOKEN[0] != pid:
        _WRITER_TOKEN = (pid, f"{pid}-{uuid.uuid4().hex[:6]}")
    return _WRITER_TOKEN[1]


def _ts(d: _dt.datetime) -> float:
    """Epoch seconds; naive datetimes are interpreted as UTC."""
    if d.tzinfo is None:
        d = d.replace(tzinfo=UTC)
    return d.timestamp()


WAL_COMPACT_BYTES = 4_000_000  # size-based trigger, stat()-checked per write

_SCHEMA_COLS = [
    "id",
    "event",
    "entity_type",
    "entity_id",
    "target_entity_type",
    "target_entity_id",
    "properties",
    "event_time",
    "tags",
    "pr_id",
    "creation_time",
]
_TIME_COLS = ("event_time", "creation_time")

_LOCKS: dict[str, threading.RLock] = {}
_LOCKS_GUARD = threading.Lock()
# flock reentrancy depth per namespace dir; guarded by the namespace RLock
_FLOCK_DEPTH: dict[str, int] = {}


def _lock_for(path: str) -> threading.RLock:
    with _LOCKS_GUARD:
        if path not in _LOCKS:
            _LOCKS[path] = threading.RLock()
        return _LOCKS[path]


def _default_path(source_name: str) -> str:
    from predictionio_tpu_torch.utils.fs import pio_base_dir

    return os.path.join(pio_base_dir(), "parquet", source_name.lower())


def _coerce_numeric(v) -> float:
    """The ONE numeric coercion rule shared by WAL fill and part promotion —
    mirrors the JSON fallback ``float(p[key])`` (strings coerce, bools → 1.0);
    uncoercible values yield NaN."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _value_coercible(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _event_to_row(event: Event, eid: str) -> dict:
    return {
        "id": eid,
        "event": event.event,
        "entity_type": event.entity_type,
        "entity_id": event.entity_id,
        "target_entity_type": event.target_entity_type,
        "target_entity_id": event.target_entity_id,
        "properties": json.dumps(event.properties.to_dict()),
        "event_time": event.event_time.timestamp(),
        "tags": json.dumps(list(event.tags)),
        "pr_id": event.pr_id,
        "creation_time": event.creation_time.timestamp(),
    }


def _event_columns(events: Sequence[Event]) -> dict[str, np.ndarray]:
    """The schema columns of ``events``, each value what ``_event_to_row``
    gives it, built a column at a time (the bulk write's shape)."""
    n = len(events)

    def col(values) -> np.ndarray:
        arr = np.empty(n, dtype=object)
        arr[:] = values
        return arr

    dumps = json.dumps
    return {
        "id": col([e.event_id or new_event_id() for e in events]),
        "event": col([e.event for e in events]),
        "entity_type": col([e.entity_type for e in events]),
        "entity_id": col([e.entity_id for e in events]),
        "target_entity_type": col([e.target_entity_type for e in events]),
        "target_entity_id": col([e.target_entity_id for e in events]),
        "properties": col([dumps(e.properties.to_dict()) for e in events]),
        "event_time": np.fromiter((e.event_time.timestamp() for e in events), np.float64, n),
        # json.dumps([]) for the common empty tuple without the encoder call
        "tags": col([dumps(list(e.tags)) if e.tags else "[]" for e in events]),
        "pr_id": col([e.pr_id for e in events]),
        "creation_time": np.fromiter((e.creation_time.timestamp() for e in events),
                                     np.float64, n),
    }


def _row_to_event(r: dict) -> Event:
    return Event(
        event=r["event"],
        entity_type=r["entity_type"],
        entity_id=r["entity_id"],
        target_entity_type=r["target_entity_type"],
        target_entity_id=r["target_entity_id"],
        properties=DataMap(json.loads(r["properties"])),
        event_time=_dt.datetime.fromtimestamp(r["event_time"], tz=UTC),
        tags=tuple(json.loads(r["tags"])),
        pr_id=r["pr_id"],
        event_id=r["id"],
        creation_time=_dt.datetime.fromtimestamp(r["creation_time"], tz=UTC),
    )


def _empty_column(c: str) -> np.ndarray:
    return np.empty(0, np.float64) if c in _TIME_COLS else np.empty(0, object)


_PART_TIME_RANGES: dict[tuple, tuple[float, float]] = {}
_PART_TIME_RANGES_MAX = 8192


def _part_time_range(path: str) -> Optional[tuple[float, float]]:
    """[min, max] event_time of a part from its footer (no page read).

    Part FILES are immutable but paths are reused (wipe() restarts the
    sequence at events-000000), so the cache keys on (path, mtime_ns,
    size) — a recreated file at the same path never serves the previous
    generation's statistics. Returns None when statistics are unavailable
    (never skip what we cannot prove stale).
    """
    try:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        got = _PART_TIME_RANGES.get(key)
        if got is not None:
            return got
        stats = pqf.ParquetFile(path).statistics("event_time")
        if not stats or any(s is None for s in stats):
            return None
        lo = min(s[0] for s in stats)
        hi = max(s[1] for s in stats)
    except (OSError, KeyError, pqf.ParquetError):
        return None
    if len(_PART_TIME_RANGES) >= _PART_TIME_RANGES_MAX:
        _PART_TIME_RANGES.clear()  # entries for deleted parts never age out
    _PART_TIME_RANGES[key] = (float(lo), float(hi))
    return _PART_TIME_RANGES[key]


class _Namespace:
    """One (app, channel) directory of parts + per-writer WALs."""

    def __init__(self, root: str, app_id: int, channel_id: Optional[int]):
        self.root = root
        cid = 0 if channel_id is None else channel_id
        self.name = f"app_{app_id}_ch_{cid}"
        self.dir = os.path.join(root, self.name)
        self.lock = _lock_for(self.dir)

    @property
    def wal_path(self) -> str:
        """This process's own WAL; readers merge every wal*.jsonl here.

        A property (not set in __init__) so a forked child resolves to its
        OWN file the first time it writes.
        """
        return os.path.join(self.dir, f"wal-{_writer_token()}.jsonl")

    def ensure(self):
        os.makedirs(self.dir, exist_ok=True)

    def exists(self) -> bool:
        return os.path.isdir(self.dir)

    @contextlib.contextmanager
    def parts_lock(self, shared: bool = False):
        """Cross-process file lock (flock) + the in-process lock.

        The multi-process protocol: anything that rewrites or deletes
        part/WAL files (compaction, bulk part writes) holds this
        EXCLUSIVE; appends and reads hold it SHARED. So a compaction in
        one process can neither fold away a WAL mid-append in another,
        nor delete part files out from under a reader's listing. Reentrant
        within a process: the RLock serializes threads, and a depth counter
        skips the (non-reentrant) flock on nested entry — compact() calling
        write_part() and read_columns() must not deadlock on its own lock.
        """
        import fcntl

        self.ensure()
        with self.lock:
            depth = _FLOCK_DEPTH.get(self.dir, 0)
            if depth:
                # nested under this process's own lock (any mode): the
                # outer hold already provides the needed exclusion
                _FLOCK_DEPTH[self.dir] = depth + 1
                try:
                    yield
                finally:
                    _FLOCK_DEPTH[self.dir] = depth
                return
            # the lock file lives OUTSIDE the namespace dir so wipe()'s
            # rmtree cannot delete it out from under a concurrent holder
            with open(os.path.join(self.root, f".{self.name}.lock"), "a") as lf:
                fcntl.flock(lf, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
                _FLOCK_DEPTH[self.dir] = 1
                try:
                    yield
                finally:
                    _FLOCK_DEPTH[self.dir] = 0
                    fcntl.flock(lf, fcntl.LOCK_UN)

    # -- WAL ---------------------------------------------------------------
    def wal_paths(self) -> list[str]:
        if not self.exists():
            return []
        return sorted(
            os.path.join(self.dir, p)
            for p in os.listdir(self.dir)
            if p.startswith("wal") and p.endswith(".jsonl")
        )

    def append_wal(self, ops: Sequence[dict]):
        # shared lock: a concurrent compaction (exclusive) cannot snapshot
        # this WAL file mid-append and then delete rows it never read
        with self.parts_lock(shared=True), open(self.wal_path, "a") as f:
            for op in ops:
                f.write(json.dumps(op) + "\n")

    def read_wal(self, paths: Optional[Sequence[str]] = None) -> list[dict]:
        """Merge WAL files; ops keep per-file order, files in sorted order."""
        out: list[dict] = []
        with self.lock:
            for path in paths if paths is not None else self.wal_paths():
                try:
                    with open(path) as f:
                        out.extend(json.loads(line) for line in f if line.strip())
                except FileNotFoundError:
                    continue  # folded away by a concurrent compaction
        return out

    # -- parts -------------------------------------------------------------
    def part_paths(self) -> list[str]:
        if not self.exists():
            return []
        return sorted(
            os.path.join(self.dir, p)
            for p in os.listdir(self.dir)
            if p.startswith("events-") and p.endswith(".parquet")
        )

    def read_columns(
        self,
        start_ts: Optional[float] = None,
        until_ts: Optional[float] = None,
    ) -> dict[str, np.ndarray]:
        """All rows (parts + WAL inserts − deletes) as column arrays.

        Promoted numeric property columns (``pnum_<key>``) ride along under
        the ``numeric:<key>`` keys with WAL rows filled from their JSON.

        ``start_ts``/``until_ts`` prune whole part files by their
        event_time statistics before reading a page. Pruning is file-level
        only: surviving rows still need the caller's row-level time mask.
        """
        with self.parts_lock(shared=True):
            paths = self.part_paths()
            if start_ts is not None or until_ts is not None:
                kept = []
                for p in paths:
                    rng = _part_time_range(p)
                    if rng is not None:
                        lo, hi = rng
                        if start_ts is not None and hi < start_ts:
                            continue
                        if until_ts is not None and lo >= until_ts:
                            continue
                    kept.append(p)
                paths = kept
            files = [pqf.ParquetFile(p) for p in paths]
            # a promoted key is trustworthy only if EVERY part carries it —
            # a part written without promotion would otherwise shadow real
            # JSON values with nulls
            per_part_keys = [{n[5:] for n in f.names if n.startswith("pnum_")} for f in files]
            numeric_keys = set.intersection(*per_part_keys) if per_part_keys else set()
            tables = [
                {c: f.read_column(c) for c in
                 _SCHEMA_COLS + [f"pnum_{k}" for k in sorted(numeric_keys)]}
                for f in files
            ]
            wal = self.read_wal()
        if tables:
            cols: dict[str, np.ndarray] = {}
            for c in _SCHEMA_COLS:
                merged = np.concatenate([t[c] for t in tables])
                cols[c] = merged.astype(np.float64 if c in _TIME_COLS else object)
            numeric = {
                k: np.concatenate([t[f"pnum_{k}"] for t in tables]).astype(np.float64)
                for k in sorted(numeric_keys)
            }
        else:
            cols = {c: _empty_column(c) for c in _SCHEMA_COLS}
            numeric = {}

        deletes = set()
        wal_rows = []
        for op in wal:
            if op.get("op") == "delete":
                deletes.add(op["id"])
            else:
                wal_rows.append(op["row"])
        if wal_rows:
            for c in _SCHEMA_COLS:
                extra = np.empty(len(wal_rows), dtype=object)
                for j, r in enumerate(wal_rows):
                    extra[j] = r[c]
                if c in _TIME_COLS:
                    extra = extra.astype(np.float64)
                cols[c] = np.concatenate([cols[c], extra])
            if numeric:
                parsed = [json.loads(r["properties"]) for r in wal_rows]
                for k in numeric:
                    extra = np.array(
                        [
                            _coerce_numeric(p[k]) if k in p else np.nan
                            for p in parsed
                        ],
                        dtype=np.float64,
                    )
                    numeric[k] = np.concatenate([numeric[k], extra])
        if deletes:
            keep = ~np.isin(cols["id"], np.array(list(deletes), dtype=object))
            for c in _SCHEMA_COLS:
                cols[c] = cols[c][keep]
            numeric = {k: v[keep] for k, v in numeric.items()}
        for k, v in numeric.items():
            cols[f"numeric:{k}"] = v
        return cols

    def wal_bytes(self) -> int:
        total = 0
        for p in self.wal_paths():
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
        return total

    def _next_seq(self) -> int:
        parts = self.part_paths()
        if not parts:
            return 0
        last = os.path.basename(parts[-1])
        return int(last[len("events-"): -len(".parquet")]) + 1

    def write_part(
        self,
        cols: dict[str, np.ndarray],
        replaces: Optional[Sequence[str]] = None,
    ):
        """Write an immutable sorted part from column arrays.

        ``cols`` holds the schema columns plus optional ``numeric:<key>``
        promoted columns; rows are sorted by event_time. ``replaces`` names
        exactly the part/WAL files this new part supersedes (compaction
        deletes only what it folded — files written concurrently by other
        processes survive); None appends a fresh part (bulk write). Either
        way the mutation holds the cross-process parts lock.
        """
        with self.parts_lock():
            order = np.argsort(cols["event_time"], kind="stable")
            data = {c: np.asarray(cols[c])[order] for c in _SCHEMA_COLS}
            for c in _TIME_COLS:
                data[c] = data[c].astype(np.float64)
            for c in _SCHEMA_COLS:
                if c not in _TIME_COLS:
                    data[c] = data[c].astype(object)
            for k in cols:
                if k.startswith("numeric:"):
                    data[f"pnum_{k[8:]}"] = np.asarray(cols[k], np.float64)[order]
            seq = self._next_seq()
            tmp = os.path.join(self.dir, f".tmp-events-{seq:06d}.parquet")
            pqf.write_table(tmp, data)
            # new part lands atomically BEFORE the folded files go away: a
            # crash mid-delete leaves transient duplicates (benign, folded
            # by the next compaction), never data loss
            os.replace(tmp, os.path.join(self.dir, f"events-{seq:06d}.parquet"))
            for p in replaces or ():
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    @staticmethod
    def promote_numeric(cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Parse properties JSON once and add numeric:<key> columns.

        A key is promoted only when EVERY present value coerces with
        ``float`` — so the promoted column reproduces the JSON fallback
        exactly (uncoercible values keep the key on the JSON path, matching
        other backends' behavior including its errors).

        The host scanner (``csrc/host/jsonprops.cpp``) handles the common
        case (values are JSON numbers/booleans) in one C pass; it declines
        batches containing string-typed numerics or malformed rows, which
        then take this exact-semantics Python path."""
        from predictionio_tpu_torch import native

        scanned = native.scan_numeric_props(cols["properties"])
        if scanned is not None:
            out = dict(cols)
            for k, col in scanned.items():
                out[f"numeric:{k}"] = col
            return out
        parsed = [json.loads(p) if p else {} for p in cols["properties"]]
        candidates: set = set()
        rejected: set = set()
        for p in parsed:
            for k, v in p.items():
                if _value_coercible(v):
                    candidates.add(k)
                else:
                    rejected.add(k)
        out = dict(cols)
        for k in candidates - rejected:
            out[f"numeric:{k}"] = np.array(
                [_coerce_numeric(p[k]) if k in p else np.nan for p in parsed],
                dtype=np.float64,
            )
        return out

    def compact(self, force: bool = False):
        """Fold WALs + parts into one immutable part (numeric keys promoted).

        The threshold check is a stat() on the WAL files — callers can
        invoke this after every write without paying a parse. Runs under
        the cross-process parts lock and deletes exactly the files it
        folded, so writers appending (own WALs, lock-free) or bulk-writing
        parts (locked) concurrently never lose rows.
        """
        if not force and self.wal_bytes() < WAL_COMPACT_BYTES:
            return
        with self.parts_lock():
            wal_snapshot = self.wal_paths()
            part_snapshot = self.part_paths()
            wal = self.read_wal(wal_snapshot)
            if not wal:
                return
            cols = self.read_columns()  # parts + wal merged, deletes applied
            cols = {k: v for k, v in cols.items() if not k.startswith("numeric:")}
            # crash-recovery dedup: keep the LAST row per id (a part that
            # survived a half-finished delete pass may duplicate rows)
            ids = cols["id"]
            if len(ids) != len(set(ids)):
                last = {eid: i for i, eid in enumerate(ids)}
                keep = np.zeros(len(ids), bool)
                keep[list(last.values())] = True
                cols = {k: v[keep] for k, v in cols.items()}
            cols = self.promote_numeric(cols)
            self.write_part(cols, replaces=part_snapshot + wal_snapshot)

    def all_ids(self) -> set:
        """Live event ids only — id-column scans, no full materialization."""
        with self.parts_lock(shared=True):
            ids: set = set()
            for p in self.part_paths():
                ids.update(pqf.ParquetFile(p).read_codes("id")[1])
            for op in self.read_wal():
                if op.get("op") == "delete":
                    ids.discard(op["id"])
                else:
                    ids.add(op["id"])
        return ids

    def wipe(self):
        import shutil

        # exclusive: a concurrent compactor/writer must finish (and then
        # fail cleanly on the vanished dir) rather than race the rmtree
        with self.parts_lock():
            if self.exists():
                shutil.rmtree(self.dir)


class _LazyJsonTags(Sequence):
    """Row-aligned tag tuples decoded from JSON strings on access."""

    __slots__ = ("_raw",)

    def __init__(self, raw: np.ndarray):
        self._raw = raw

    def __len__(self) -> int:
        return len(self._raw)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        raw = self._raw[int(i)]
        return tuple(json.loads(raw)) if raw else ()


def _filter_mask(cols, start_time, until_time, entity_type, entity_id, event_names,
                 target_entity_type, target_entity_id) -> np.ndarray:
    """The row filter ``find`` of both DAOs applies to merged columns."""
    n = len(cols["id"])
    mask = np.ones(n, dtype=bool)
    if start_time is not None:
        mask &= cols["event_time"] >= _ts(start_time)
    if until_time is not None:
        mask &= cols["event_time"] < _ts(until_time)
    if entity_type is not None:
        mask &= cols["entity_type"] == entity_type
    if entity_id is not None:
        mask &= cols["entity_id"] == entity_id
    if event_names is not None:
        allowed = set(event_names)
        mask &= np.fromiter((e in allowed for e in cols["event"]), dtype=bool, count=n)
    for key, val in (
        ("target_entity_type", target_entity_type),
        ("target_entity_id", target_entity_id),
    ):
        if val is not None:
            want = None if val == "None" else val
            mask &= np.fromiter((v == want for v in cols[key]), dtype=bool, count=n)
    return mask


class ParquetLEvents(base.LEvents):
    def __init__(self, source_name: str = "default", path: Optional[str] = None, **_):
        self.root = path or _default_path(source_name)

    def _ns(self, app_id, channel_id) -> _Namespace:
        return _Namespace(self.root, app_id, channel_id)

    def init(self, app_id, channel_id=None) -> bool:
        self._ns(app_id, channel_id).ensure()
        return True

    def remove(self, app_id, channel_id=None) -> bool:
        self._ns(app_id, channel_id).wipe()
        return True

    def close(self):
        pass

    def insert(self, event, app_id, channel_id=None) -> str:
        eid = event.event_id or new_event_id()
        ns = self._ns(app_id, channel_id)
        ns.append_wal([{"op": "insert", "id": eid, "row": _event_to_row(event, eid)}])
        ns.compact()  # stat()-gated; folds the WAL once it crosses the size trigger
        return eid

    def insert_batch(self, events, app_id, channel_id=None):
        ids = []
        ops = []
        for event in events:
            eid = event.event_id or new_event_id()
            ids.append(eid)
            ops.append({"op": "insert", "id": eid, "row": _event_to_row(event, eid)})
        ns = self._ns(app_id, channel_id)
        ns.append_wal(ops)
        ns.compact()  # threshold-gated
        return ids

    def get(self, event_id, app_id, channel_id=None):
        ns = self._ns(app_id, channel_id)
        with ns.parts_lock(shared=True):
            wal = ns.read_wal()
            row = None
            for op in wal:  # WAL wins over parts; later ops win over earlier
                if op["id"] == event_id:
                    row = None if op.get("op") == "delete" else op["row"]
            if row is not None:
                return _row_to_event(row)
            if any(op.get("op") == "delete" and op["id"] == event_id for op in wal):
                return None
            for p in ns.part_paths():
                pf = pqf.ParquetFile(p)
                codes, values = pf.read_codes("id")
                if event_id not in values:
                    continue
                hit = int(np.flatnonzero(codes == values.index(event_id))[0])
                return _row_to_event({c: pf.read_column(c)[hit] for c in _SCHEMA_COLS})
        return None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        ns = self._ns(app_id, channel_id)
        if event_id not in ns.all_ids():
            return False
        ns.append_wal([{"op": "delete", "id": event_id}])
        return True

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        limit=None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        # filter on COLUMNS (vectorized), materialize only matching rows —
        # serving-time lookups touch a handful of rows, not the whole store;
        # a time range also prunes whole part files via their statistics
        cols = self._ns(app_id, channel_id).read_columns(
            start_ts=None if start_time is None else _ts(start_time),
            until_ts=None if until_time is None else _ts(until_time),
        )
        mask = _filter_mask(cols, start_time, until_time, entity_type, entity_id,
                            event_names, target_entity_type, target_entity_id)
        idx = np.nonzero(mask)[0]
        order = np.lexsort(
            (cols["creation_time"][idx], cols["event_time"][idx])
        )
        if reversed:
            order = order[::-1]
        idx = idx[order]
        if limit is not None and limit >= 0:
            idx = idx[:limit]
        return [
            _row_to_event({c: cols[c][i] for c in _SCHEMA_COLS}) for i in idx
        ]


def _first_occurrence(codes: np.ndarray, values: list) -> tuple[np.ndarray, list]:
    """Renumber provisional codes by first occurrence in row order (what
    dictionary-encoding the concatenated column gives): (codes int32,
    values in the new order). Only the (small) distinct codes are
    touched in Python."""
    if not len(codes):
        return codes.astype(np.int32), []
    uniq, first = np.unique(codes, return_index=True)
    order = uniq[np.argsort(first, kind="stable")]
    rank = np.empty(int(uniq.max()) + 1, np.int64)
    rank[order] = np.arange(len(order))
    return rank[codes].astype(np.int32), [values[c] for c in order]


class ParquetPEvents(base.PEvents):
    """Bulk path: columns → EventBatch without row materialization."""

    def __init__(self, source_name: str = "default", path: Optional[str] = None, **_):
        self.root = path or _default_path(source_name)
        self._l = ParquetLEvents(source_name=source_name, path=path)

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        shard=None,
        shard_key="row",
    ) -> EventBatch:
        cols = _Namespace(self.root, app_id, channel_id).read_columns(
            start_ts=None if start_time is None else _ts(start_time),
            until_ts=None if until_time is None else _ts(until_time),
        )
        mask = _filter_mask(cols, start_time, until_time, entity_type, entity_id,
                            event_names, target_entity_type, target_entity_id)
        idx = np.nonzero(mask)[0]
        order = idx[np.argsort(cols["event_time"][idx], kind="stable")]
        if shard is not None and int(shard[1]) > 1:
            index, count = int(shard[0]), int(shard[1])
            if shard_key == "row":
                order = order[(np.arange(len(order)) % count) == index]
            elif shard_key in ("entity", "target"):
                col = cols[
                    "entity_id" if shard_key == "entity" else "target_entity_id"
                ][order]
                order = order[self._entity_shard_of(col, count) == index]
            else:
                raise ValueError(f"unknown shard_key {shard_key!r}")
        numeric = {
            k[8:]: cols[k][order]
            for k in cols
            if k.startswith("numeric:")
        }
        return EventBatch(
            event=cols["event"][order],
            entity_type=cols["entity_type"][order],
            entity_id=cols["entity_id"][order],
            target_entity_type=cols["target_entity_type"][order],
            target_entity_id=cols["target_entity_id"][order],
            event_time=cols["event_time"][order],
            # JSON decoded lazily per row; numeric keys served columnar
            properties=LazyJsonProperties(cols["properties"][order]),
            event_id=cols["id"][order],
            tags=_LazyJsonTags(cols["tags"][order]),
            pr_id=cols["pr_id"][order],
            creation_time=cols["creation_time"][order],
            numeric_properties=numeric or None,
        )

    def find_interactions(
        self,
        app_id,
        channel_id=None,
        entity_type=None,
        event_names=None,
        target_entity_type=None,
        rating_key=None,
        default_rating: float = 1.0,
        shard=None,
        shard_key="row",
    ):
        """Columnar bulk read straight to Interactions.

        The training hot path: only the columns it consumes are read; the
        string columns arrive as codes over a dictionary, so the filters
        compare the (small) dictionaries and the entity/target ids become
        indices without a Python string per row. The indices are numbered
        by first occurrence over the parts in order, as the JAX driver's
        ``dictionary_encode`` numbers them. Requires compacted parts (a
        WAL is folded first).
        """
        from predictionio_tpu_torch.data.batch import Interactions
        from predictionio_tpu_torch.data.bimap import BiMap

        ns = _Namespace(self.root, app_id, channel_id)
        if ns.wal_bytes() > 0 or not ns.part_paths():
            ns.compact(force=True)
        if not ns.part_paths():
            return super().find_interactions(
                app_id,
                channel_id=channel_id,
                entity_type=entity_type,
                event_names=event_names,
                target_entity_type=target_entity_type,
                rating_key=rating_key,
                default_rating=default_rating,
                shard=shard,
                shard_key=shard_key,
            )
        string_cols = ("event", "entity_type", "entity_id", "target_entity_type",
                       "target_entity_id")
        with ns.parts_lock(shared=True):
            files = [pqf.ParquetFile(p) for p in ns.part_paths()]
            # a pnum column is trustworthy only if EVERY part carries it
            # (the same intersection rule as read_columns)
            pnum_ok = rating_key is not None and all(
                f"pnum_{rating_key}" in f.names for f in files
            )
            # one dictionary per string column across the parts: each
            # part's codes are shifted into it through its own values
            merged = {c: ([], {}) for c in string_cols}
            for f in files:
                for c in string_cols:
                    codes, values = f.read_codes(c)
                    parts, index = merged[c]
                    lut = np.fromiter((index.setdefault(v, len(index)) for v in values),
                                      np.int64, len(values))
                    parts.append(np.where(codes >= 0, lut[np.maximum(codes, 0)], -1)
                                 if len(lut) else codes)
            t = np.concatenate([f.read_column("event_time") for f in files])
            if pnum_ok:
                rating_col = np.concatenate([f.read_column(f"pnum_{rating_key}")
                                             for f in files])
            elif rating_key is not None:
                # read ONLY when needed: the properties JSON dominates bytes
                rating_col = np.concatenate([f.read_column("properties") for f in files])
        cols = {c: (np.concatenate(merged[c][0]), list(merged[c][1])) for c in string_cols}

        def equals(c, want) -> np.ndarray:
            codes, values = cols[c]
            hit = np.array([v == want for v in values] + [False], bool)
            return hit[codes]  # code -1 (null) reads the trailing False

        mask = cols["target_entity_id"][0] >= 0  # the target must be present
        if entity_type is not None:
            mask &= equals("entity_type", entity_type)
        if target_entity_type is not None:
            mask &= equals("target_entity_type", target_entity_type)
        if event_names is not None:
            allowed = set(event_names)
            codes, values = cols["event"]
            mask &= np.array([v in allowed for v in values] + [False], bool)[codes]
        keep = np.flatnonzero(mask)
        if shard is not None and int(shard[1]) > 1:
            index, count = int(shard[0]), int(shard[1])
            if shard_key == "row":
                keep = keep[(np.arange(len(keep)) % count) == index]
            elif shard_key in ("entity", "target"):
                # hash the distinct ids (|entities|, not |rows|) and spread
                # the shards through the codes; a null target goes to 0
                codes, values = cols["entity_id" if shard_key == "entity"
                                      else "target_entity_id"]
                ushard = np.fromiter(
                    (self.shard_hash(s) % count for s in values), np.int64, len(values))
                row_shard = np.where(codes[keep] >= 0,
                                     ushard[np.maximum(codes[keep], 0)] if len(values)
                                     else 0, 0)
                keep = keep[row_shard == index]
            else:
                raise ValueError(f"unknown shard_key {shard_key!r}")
        if len(keep) == 0:
            # nothing matched (e.g. a store of only $set events)
            return Interactions(
                user=np.empty(0, np.int32),
                item=np.empty(0, np.int32),
                rating=np.empty(0, np.float32),
                t=np.empty(0, np.float64),
                user_map=BiMap({}),
                item_map=BiMap({}),
            )
        users, user_ids = _first_occurrence(cols["entity_id"][0][keep], cols["entity_id"][1])
        items, item_ids = _first_occurrence(cols["target_entity_id"][0][keep],
                                            cols["target_entity_id"][1])
        if pnum_ok:
            col = rating_col[keep].astype(np.float32)
            ratings = np.where(np.isnan(col), default_rating, col).astype(np.float32)
        elif rating_key is not None:
            # exact generic semantics: float() coercion, errors included
            ratings = np.array(
                [
                    float(json.loads(p).get(rating_key, default_rating))
                    for p in rating_col[keep]
                ],
                dtype=np.float32,
            )
        else:
            ratings = np.full(len(keep), default_rating, dtype=np.float32)
        return Interactions(
            user=users,
            item=items,
            rating=ratings,
            t=t[keep].astype(np.float64),
            user_map=BiMap(dict(zip(user_ids, range(len(user_ids))))),
            item_map=BiMap(dict(zip(item_ids, range(len(item_ids))))),
        )

    # events per write() call above which a part is written directly —
    # bulk imports skip the WAL entirely
    DIRECT_PART_THRESHOLD = 10_000

    def write(self, events, app_id, channel_id=None) -> None:
        events = list(events)
        if len(events) < self.DIRECT_PART_THRESHOLD:
            self._l.batch_insert(events, app_id, channel_id)
            return
        cols = _event_columns(events)
        ns = _Namespace(self.root, app_id, channel_id)
        ns.write_part(ns.promote_numeric(cols))

    def delete(self, event_ids, app_id, channel_id=None) -> None:
        ns = _Namespace(self.root, app_id, channel_id)
        ns.append_wal([{"op": "delete", "id": eid} for eid in event_ids])
