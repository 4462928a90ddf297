"""Append-only write-ahead log for fast-ack ingest durability.

Counterpart of ``predictionio_tpu/data/api/wal.py``, byte for byte in its
on-disk format: a segment either package wrote replays in the other.

The write-behind ingest buffer acks fast-mode events (HTTP 202) before
they reach storage; without a journal a crash loses up to a buffer of
acked events. This WAL closes that window: an event is journaled here
*before* the 202 goes out, and on event-server startup any records that
never reached a flush commit are replayed into ``insert_batch``. Event
ids are assigned at submit time, so replay after a crash that raced a
flush is idempotent on id-keyed stores (INSERT OR REPLACE).

On-disk format — a directory of segment files ``wal-<seq>.log``, each a
run of self-delimiting records::

    [4B LE payload length][4B LE crc32(payload)][payload bytes]

A record is trusted only if its full frame reads back and the crc
matches; the first short or corrupt frame ends the segment — everything
before it is real, everything after is a torn tail from a mid-append
death and is physically truncated away on replay (the torn-tail
tolerance a length-prefixed log needs to survive ``kill -9``).

Durability knob (``PIO_WAL_FSYNC`` / ``fsync=``):

* ``always`` — fsync after every append. Zero acked-event loss on power
  failure; every 202 pays a disk flush.
* ``group`` (default) — fsync at most once per ``group_interval_ms``,
  amortized across appends (group commit). Loss window on *power* loss
  is one interval; a mere process crash loses nothing (the OS owns the
  written pages).
* ``off`` — never fsync. Process-crash-safe, power-loss-unsafe.

Segments rotate at ``segment_max_bytes``; a segment whose records have
all been flush-committed (and which is no longer the append head) is
unlinked — the reclaim that keeps a healthy server's WAL directory at
one small file.

Single-writer by design: one ``WriteAheadLog`` instance owns a
directory. Appends are thread-safe within the instance.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
import zlib
from typing import Optional

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_SEGMENT_RE = re.compile(r"^wal-(\d{8})\.log$")

FSYNC_POLICIES = ("always", "group", "off")
DEFAULT_SEGMENT_MAX_BYTES = 4 * 1024 * 1024
DEFAULT_GROUP_INTERVAL_MS = 5.0
# Refuse frames beyond this: a corrupt length prefix must not convince
# replay to allocate gigabytes.
MAX_RECORD_BYTES = 16 * 1024 * 1024


def _segment_name(seq: int) -> str:
    return f"wal-{seq:08d}.log"


class WriteAheadLog:
    def __init__(
        self,
        directory: str,
        fsync: Optional[str] = None,
        segment_max_bytes: int = None,
        group_interval_ms: float = None,
    ):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        policy = fsync or os.environ.get("PIO_WAL_FSYNC", "group")
        if policy not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown WAL fsync policy {policy!r}; one of {FSYNC_POLICIES}"
            )
        self.fsync_policy = policy
        self.segment_max_bytes = int(
            segment_max_bytes
            if segment_max_bytes is not None
            else os.environ.get("PIO_WAL_SEGMENT_BYTES", DEFAULT_SEGMENT_MAX_BYTES)
        )
        self.group_interval_s = (
            group_interval_ms
            if group_interval_ms is not None
            else float(os.environ.get("PIO_WAL_GROUP_MS", DEFAULT_GROUP_INTERVAL_MS))
        ) / 1e3

        self._lock = threading.Lock()
        self._fh = None  # append head file handle
        self._seq = 0  # seq of the append head (0 = none open yet)
        self._pending: dict[int, int] = {}  # segment seq -> uncommitted records
        self._dirty = False  # bytes written since last fsync (group mode)
        self._last_sync = 0.0
        self._replayed_segments: list[str] = []
        self._counts = {
            "appended": 0,
            "committed": 0,
            "synced": 0,
            "rotations": 0,
            "reclaimed_segments": 0,
            "replayed": 0,
            "truncated_tails": 0,
        }
        # Existing segments (a previous incarnation's leftovers) stay on
        # disk for replay(); new appends start strictly after them.
        self._next_seq = max(self._existing_seqs(), default=0) + 1

    # -- append path --------------------------------------------------------

    def append(self, payload: bytes) -> int:
        """Journal one record; returns the segment seq to :meth:`commit`
        against once the record's event is flush-committed.

        Under ``always`` the record is on stable storage when this
        returns; under ``group`` it is at worst one group interval away.
        """
        if len(payload) > MAX_RECORD_BYTES:
            raise ValueError(f"WAL record too large: {len(payload)} bytes")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        with self._lock:
            fh = self._ensure_segment_locked()
            seq = self._seq
            fh.write(frame)
            fh.write(payload)
            fh.flush()
            self._pending[seq] = self._pending.get(seq, 0) + 1
            self._counts["appended"] += 1
            if self.fsync_policy == "always":
                os.fsync(fh.fileno())
                self._counts["synced"] += 1
            elif self.fsync_policy == "group":
                now = time.monotonic()
                if now - self._last_sync >= self.group_interval_s:
                    os.fsync(fh.fileno())
                    self._counts["synced"] += 1
                    self._last_sync = now
                    self._dirty = False
                else:
                    self._dirty = True
            if fh.tell() >= self.segment_max_bytes:
                self._rotate_locked()
        return seq

    def commit(self, seq: int) -> None:
        """Mark one record of segment ``seq`` flush-committed; a sealed
        segment whose last record commits is unlinked (reclaim)."""
        with self._lock:
            left = self._pending.get(seq, 0) - 1
            self._counts["committed"] += 1
            if left > 0:
                self._pending[seq] = left
                return
            self._pending.pop(seq, None)
            if seq != self._seq:  # never unlink the append head
                self._unlink_locked(seq)

    def sync(self) -> None:
        """Flush pending group-commit bytes to stable storage."""
        with self._lock:
            if self._fh is not None and self._dirty and self.fsync_policy != "off":
                os.fsync(self._fh.fileno())
                self._counts["synced"] += 1
                self._last_sync = time.monotonic()
                self._dirty = False

    # -- recovery path ------------------------------------------------------

    def replay(self) -> list[bytes]:
        """Read every record a previous incarnation left behind, oldest
        first, truncating torn tails in place. Call before first append;
        follow a successful re-insert with :meth:`reclaim_replayed`."""
        records: list[bytes] = []
        with self._lock:
            self._replayed_segments = []
            for seq in sorted(self._existing_seqs()):
                if seq == self._seq:
                    continue  # our own append head is not history
                path = os.path.join(self.dir, _segment_name(seq))
                records.extend(self._read_segment_locked(path))
                self._replayed_segments.append(path)
            self._counts["replayed"] += len(records)
        return records

    def reclaim_replayed(self) -> int:
        """Unlink the segments the last :meth:`replay` read — call only
        after their records are safely re-inserted. Returns count."""
        with self._lock:
            n = 0
            for path in self._replayed_segments:
                try:
                    os.unlink(path)
                    n += 1
                    self._counts["reclaimed_segments"] += 1
                except OSError:
                    pass
            self._replayed_segments = []
            return n

    def _read_segment_locked(self, path: str) -> list[bytes]:
        records: list[bytes] = []
        try:
            f = open(path, "rb")
        except OSError:
            return records
        with f:
            good_end = 0
            while True:
                header = f.read(_FRAME.size)
                if len(header) < _FRAME.size:
                    torn = len(header) > 0
                    break
                length, crc = _FRAME.unpack(header)
                if length > MAX_RECORD_BYTES:
                    torn = True
                    break
                payload = f.read(length)
                if len(payload) < length or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    torn = True
                    break
                records.append(payload)
                good_end = f.tell()
            file_size = os.fstat(f.fileno()).st_size
            torn = torn or file_size > good_end
        if torn:
            self._counts["truncated_tails"] += 1
            try:
                with open(path, "r+b") as tf:
                    tf.truncate(good_end)
            except OSError:
                pass
        return records

    # -- lifecycle / introspection -------------------------------------------

    def depth(self) -> int:
        """Records journaled but not yet flush-committed."""
        with self._lock:
            return sum(self._pending.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "fsync": self.fsync_policy,
                "depth": sum(self._pending.values()),
                "segments": len(self._existing_seqs()),
                **dict(self._counts),
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                if self._dirty and self.fsync_policy != "off":
                    try:
                        os.fsync(self._fh.fileno())
                        self._counts["synced"] += 1
                    except OSError:
                        pass
                try:
                    self._fh.close()
                finally:
                    self._fh = None
                # a cleanly-closed empty head is noise, not history
                if self._pending.get(self._seq, 0) == 0:
                    self._pending.pop(self._seq, None)
                    self._unlink_locked(self._seq)

    # -- internals -----------------------------------------------------------

    def _existing_seqs(self) -> list[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return [int(m.group(1)) for n in names if (m := _SEGMENT_RE.match(n))]

    def _ensure_segment_locked(self):
        if self._fh is None:
            self._seq = self._next_seq
            self._next_seq += 1
            path = os.path.join(self.dir, _segment_name(self._seq))
            self._fh = open(path, "ab")
        return self._fh

    def _rotate_locked(self) -> None:
        old_seq = self._seq
        self._fh.close()
        self._fh = None
        self._counts["rotations"] += 1
        if self._pending.get(old_seq, 0) == 0:
            self._pending.pop(old_seq, None)
            self._unlink_locked(old_seq)

    def _unlink_locked(self, seq: int) -> None:
        try:
            os.unlink(os.path.join(self.dir, _segment_name(seq)))
            self._counts["reclaimed_segments"] += 1
        except OSError:
            pass
