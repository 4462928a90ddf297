"""Group-commit write-behind buffer for single-event ingestion.

Counterpart of ``predictionio_tpu/data/api/ingest_buffer.py``;
:func:`wal_encode` writes the same bytes as the JAX package's, so the two
packages replay each other's WAL records.

The event server's ``POST /events.json`` pays one DAO transaction — on
sqlite, one fsync — per HTTP request, which caps single-event ingest at
commit rate no matter how fast the endpoint itself is.  This buffer
absorbs those single-event inserts and flushes them as ONE
:meth:`~predictionio_tpu_torch.data.storage.base.LEvents.insert_batch` call per
(app, channel) group every few milliseconds (or sooner when a size
threshold trips), amortizing the commit the way group-commit databases
and streaming ingest pipelines do.

Durability contract (two ack modes):

* **durable-ack** — the caller blocks on its :class:`Ticket` until the
  flush that contains its event commits; a 201 answer means the event is
  on storage. Latency is bounded by one flush interval + commit time,
  throughput by events-per-flush.
* **fast-ack** — the caller is acked as soon as the event is buffered
  (202 at the HTTP layer). With a :class:`~predictionio_tpu_torch.data.api.wal
  .WriteAheadLog` attached the event is journaled *before* the ack and
  replayed on the next startup, so a crash between ack and flush loses
  nothing (modulo the WAL's fsync policy); without one, a crash can lose
  up to one buffer of events. Opt-in, for firehose ingestion.

Exactly-once under retry: event ids are assigned at ``submit`` time, so a
flush retried under the resilience policy re-writes the SAME rows
on id-keyed stores instead of duplicating them, and an acked id never
changes.

Backpressure is visible, never silent: a full buffer raises
:class:`BufferFull` and the HTTP layer turns that into the platform's
standard 503 + ``Retry-After`` shedding contract.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from predictionio_tpu_torch.common import faults, resilience
from predictionio_tpu_torch.data.event import Event, new_event_id

DEFAULT_FLUSH_MS = 5.0
DEFAULT_BUFFER_MAX = 10_000
DEFAULT_MAX_BATCH = 500

# flush batch-size histogram buckets: (label, inclusive upper bound)
_HIST_BUCKETS = (
    ("1", 1), ("2-4", 4), ("5-16", 16), ("17-64", 64),
    ("65-256", 256), ("257+", float("inf")),
)


def _flush_retryable(exc: BaseException) -> bool:
    """A flush failure is presumed transient (locked database, storage
    blip) unless the backend said "client error": 4xx statuses mean the
    batch itself is bad and retrying can't fix it."""
    status = getattr(exc, "status", None)
    if status is not None:
        return status >= 500
    return True


def wal_encode(event: Event, app_id: int, channel_id: Optional[int]) -> bytes:
    """One WAL record payload: routing key + the full event JSON (the
    event id is already pinned, making replay idempotent)."""
    return json.dumps({
        "appId": app_id,
        "channelId": channel_id,
        "event": event.to_dict(),
    }, separators=(",", ":")).encode("utf-8")


def wal_decode(payload: bytes) -> tuple[Event, int, Optional[int]]:
    """Inverse of :func:`wal_encode`; raises on malformed payloads (the
    WAL's crc already rejects torn records, this guards logic bugs)."""
    d = json.loads(payload.decode("utf-8"))
    return Event.from_dict(d["event"]), d["appId"], d.get("channelId")


class BufferFull(Exception):
    """The bounded buffer is at capacity; callers should shed (503)."""

    def __init__(self, capacity: int, retry_after_s: float):
        super().__init__(f"ingest buffer full ({capacity} events)")
        self.capacity = capacity
        self.retry_after_s = retry_after_s


class Ticket:
    """One submitted event's ack handle; ``event_id`` is final at submit."""

    __slots__ = ("event_id", "error", "wal_seq", "_done")

    def __init__(self, event_id: str):
        self.event_id = event_id
        self.error: Optional[BaseException] = None
        self.wal_seq: Optional[int] = None  # journal handle, commit on flush
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once the event's flush resolved (check :attr:`error`)."""
        return self._done.wait(timeout)

    def resolve(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self._done.set()


class IngestBuffer:
    """Bounded coalescing buffer in front of an :class:`LEvents` DAO."""

    def __init__(
        self,
        le,
        flush_ms: float = DEFAULT_FLUSH_MS,
        buffer_max: int = DEFAULT_BUFFER_MAX,
        max_batch: int = DEFAULT_MAX_BATCH,
        durable_ack: bool = True,
        retry_policy: Optional[resilience.RetryPolicy] = None,
        name: str = "ingest",
        wal=None,
        on_commit=None,
    ):
        self._le = le
        self.wal = wal  # WriteAheadLog, journals fast-acked events
        # called with each flushed batch's events AFTER the storage write
        # lands (serving-cache invalidation hook).  Commit time, not ack
        # time: an answer recomputed between a fast ack and its flush reads
        # pre-flush storage, so only the flush-commit bump can stop it from
        # re-caching the stale value.
        self.on_commit = on_commit
        self.flush_interval_s = max(0.0, float(flush_ms)) / 1e3
        self.buffer_max = int(buffer_max)
        self.max_batch = max(1, int(max_batch))
        self.durable_ack = bool(durable_ack)
        # flush failures retry under the shared resilience policy (jittered backoff +
        # budget) before the waiting tickets are failed
        self.policy = retry_policy or resilience.RetryPolicy(
            max_attempts=4,
            base_backoff_s=0.02,
            budget=resilience.RetryBudget(ratio=0.2),
        )
        self._cv = threading.Condition()
        self._queue: list[tuple[tuple, Event, Ticket]] = []
        self._inited: set[tuple] = set()
        self._closed = False
        self._counts = {
            "accepted": 0, "flushed": 0, "flushes": 0,
            "overflows": 0, "retries": 0, "flush_errors": 0,
        }
        self._hist = {label: 0 for label, _ in _HIST_BUCKETS}
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-flush", daemon=True
        )
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def submit(
        self, event: Event, app_id: int, channel_id: Optional[int] = None
    ) -> Ticket:
        """Enqueue one event; returns its :class:`Ticket` (id is final).

        Raises :class:`BufferFull` when the bound is hit — the caller
        sheds instead of queueing unbounded memory.
        """
        with self._cv:
            if self._closed:
                raise RuntimeError("ingest buffer is closed")
            if len(self._queue) >= self.buffer_max:
                self._counts["overflows"] += 1
                raise BufferFull(self.buffer_max, self.flush_interval_s)
            eid = event.event_id or new_event_id()
            ticket = Ticket(eid)
            pinned = event.with_id(eid)
            # journal BEFORE the ack can leave this call and BEFORE the
            # flusher can commit the ticket — the id is already pinned, so
            # replay after a crash that raced a flush is idempotent
            if self.wal is not None and not self.durable_ack:
                ticket.wal_seq = self.wal.append(wal_encode(
                    pinned, app_id, channel_id
                ))
            self._queue.append(((app_id, channel_id), pinned, ticket))
            self._counts["accepted"] += 1
            # wake the flusher when a coalescing window should start (first
            # event in) or when the size threshold says "flush now"
            if len(self._queue) == 1 or len(self._queue) >= self.max_batch:
                self._cv.notify()
        return ticket

    # -- flusher -------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:  # closed and drained
                    return
                if len(self._queue) < self.max_batch and not self._closed:
                    # the group-commit window: let a few ms of traffic
                    # coalesce behind the first event before committing
                    self._cv.wait(timeout=self.flush_interval_s)
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
            self._flush(batch)

    def _flush(self, batch: list[tuple[tuple, Event, Ticket]]) -> None:
        # events here are acked (fast mode) but not yet on storage — dying
        # now is the exact loss the WAL exists to repair via replay
        faults.crash_point("crash:ingest:before_flush")
        groups: dict[tuple, list[tuple[Event, Ticket]]] = {}
        for key, event, ticket in batch:
            groups.setdefault(key, []).append((event, ticket))
        for (app_id, channel_id), items in groups.items():
            events = [e for e, _ in items]
            try:
                if (app_id, channel_id) not in self._inited:
                    self._le.init(app_id, channel_id)
                    self._inited.add((app_id, channel_id))
                resilience.call_with_resilience(
                    lambda: self._le.insert_batch(events, app_id, channel_id),
                    self.policy,
                    retryable=_flush_retryable,
                    on_retry=self._note_retry,
                )
            except BaseException as e:
                # journaled records are NOT committed: the next startup
                # replays them, which is the durability promise
                with self._cv:
                    self._counts["flush_errors"] += 1
                for _, ticket in items:
                    ticket.resolve(e)
                continue
            if self.on_commit is not None:
                try:
                    self.on_commit(events)
                except Exception:
                    # invalidation must never fail a landed flush; the
                    # result cache's TTL backstop bounds the damage
                    pass
            # the storage write landed but the journal still holds the
            # records — the window the kill-9 chaos test aims at (replay
            # re-writes the same ids, so dying here duplicates nothing)
            faults.crash_point("crash:ingest:before_flush_commit")
            if self.wal is not None:
                for _, ticket in items:
                    if ticket.wal_seq is not None:
                        self.wal.commit(ticket.wal_seq)
            with self._cv:
                self._counts["flushes"] += 1
                self._counts["flushed"] += len(items)
                for label, bound in _HIST_BUCKETS:
                    if len(items) <= bound:
                        self._hist[label] += 1
                        break
            for _, ticket in items:
                ticket.resolve()

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        with self._cv:
            self._counts["retries"] += 1

    # -- lifecycle / observability -------------------------------------------
    def close(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop accepting, flush everything buffered, join the flusher.

        Returns True when the flusher drained and exited inside the
        timeout — the drain path's "nothing abandoned" signal. The WAL,
        if any, is synced but left open; its owner closes it (replay of a
        synced-but-uncommitted record is harmless).
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        drained = not self._thread.is_alive()
        if self.wal is not None:
            self.wal.sync()
        return drained

    def stats(self) -> dict:
        with self._cv:
            flushes = self._counts["flushes"]
            out = {
                "mode": "durable" if self.durable_ack else "fast",
                "flush_ms": round(self.flush_interval_s * 1e3, 3),
                "buffer_max": self.buffer_max,
                "buffered": len(self._queue),
                **self._counts,
                "avg_flush_batch": (
                    round(self._counts["flushed"] / flushes, 2)
                    if flushes else None
                ),
                "flush_batch_hist": dict(self._hist),
            }
        if self.wal is not None:
            out["wal"] = self.wal.stats()
        return out
