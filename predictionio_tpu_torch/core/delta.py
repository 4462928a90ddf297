"""Crash-safe streaming micro-generations: the sealed delta log.

Counterpart of ``predictionio_tpu/core/delta.py``, whole. A delta seals
through the port's :mod:`core.persistence` envelope and decodes through a
restricted unpickler that admits only the payload's own types (dicts,
tuples, strings, numbers and numpy arrays): the port reads every delta the
JAX package seals and the JAX package every delta the port seals, and any
other pickle is the same ``integrity`` refusal a torn blob gets. The
fingerprint of a base generation is the JAX package's hex for equal
factors, so a publisher and a replica of either package share one log.

Full retrains publish *generations*; this module fills the gap between
them with *micro-generations*: small, sealed, epoch-numbered deltas that
fold freshly committed events into the live serving factors without a
recompile and without a generation swap.  The pipeline is hardened at
every hop:

* **Sealed envelope** — every delta is written as ``delta-<epoch>.blob``
  through the :mod:`core.persistence` checksum envelope (atomic
  tmp+fsync+rename).  A torn or bit-flipped blob surfaces as
  :class:`~predictionio_tpu_torch.core.persistence.ModelIntegrityError`, never
  as silently corrupt factors.
* **Epoch fencing** — epochs are monotonic per base generation and every
  delta carries the ``base_fingerprint`` of the generation it was folded
  against.  A replica refuses any delta whose fingerprint does not match
  its live generation (stale publisher, split-brain, mid-roll mixups),
  and re-applying an already-applied epoch is an idempotent no-op —
  exactly-once by construction, kill -9 anywhere in the apply path
  included.  On the fold side, sealed deltas carry the durable ids of
  the events they folded, and the publisher skips replayed events that
  already sealed — WAL/ring replay after a clean restart never
  double-folds (see :class:`DeltaPublisher`).
* **Quality gate** — fold-in rows are gated on top-k overlap against a
  full-fidelity reference solve on sampled users
  (``PIO_DELTA_MIN_OVERLAP``, the streaming analogue of the
  ``PIO_QUANT_MIN_OVERLAP`` / ``PIO_IVF_MIN_RECALL`` publish gates).  A
  below-threshold micro-generation is quarantined: no blob is sealed,
  a refusal receipt is recorded, and serving continues on the last-good
  epoch.
* **Catch-up** — a replica that missed deltas (crash-restart, fresh
  autoscaled replica, mid-roll) replays the sealed log from its applied
  high-water mark before readmission; the fencing rules above make the
  replay safe to repeat from any point.

Chaos sites compiled in: ``crash:delta:before_seal`` (publisher dies
after the WAL ack but before the delta is sealed — replay must regrow
it) and ``crash:delta:mid_apply`` (replica dies between receiving a
delta and recording it applied — restart must catch up).

``PIO_STREAMING=0`` (the default) disables every code path here; the
platform behaves bit-identically to full-retrain-only serving.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import logging
import os
import pickle
import re
import threading
import time
from typing import Callable, Optional

import numpy as np

from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.core.persistence import (
    ModelIntegrityError, open_blob_file, seal_blob_file,
)

log = logging.getLogger("pio.delta")

DELTA_PAYLOAD_VERSION = 1
_DELTA_RE = re.compile(r"^delta-(\d{8})\.blob$")

# Bound on the publisher's folded-event-id dedupe window.  WAL replay
# and the committed-event ring only ever re-deliver *recent* events, so
# the window needs to cover a few retention-worths of folds, not history.
_DEDUP_KEEP = 65536


def streaming_enabled() -> bool:
    """One-env kill switch: ``PIO_STREAMING=0`` (default) → no streaming."""
    return os.environ.get("PIO_STREAMING", "0") == "1"


def default_delta_dir() -> str:
    """Where sealed ``delta-<epoch>.blob`` files live.

    ``PIO_DELTA_DIR`` overrides; otherwise ``<base>/deltas`` so the
    delta log survives process restarts alongside model checkpoints.
    """
    configured = os.environ.get("PIO_DELTA_DIR", "")
    if configured:
        return configured
    from predictionio_tpu_torch.utils.fs import pio_base_dir
    return os.path.join(pio_base_dir(), "deltas")


def delta_dir_for(base_fingerprint: str,
                  base_dir: Optional[str] = None) -> str:
    """Per-base-generation delta log directory.

    Each base generation keeps its own epoch sequence under
    ``<delta_dir>/<fingerprint>/`` — a replica rolling onto a new base
    starts from an empty log instead of wading through (and refusing)
    every stale epoch sealed against the previous generation.  The
    per-delta fingerprint fence still guards split-brain within a
    directory.
    """
    return os.path.join(base_dir or default_delta_dir(), base_fingerprint)


def model_fingerprint(user_factors: np.ndarray,
                      item_factors: np.ndarray) -> str:
    """Stable identity of a base generation's factor matrices.

    Deltas are fenced against this: the publisher stamps the fingerprint
    of the generation it folded against, and a replica refuses deltas
    whose stamp does not match its own live generation.  Computed over
    shapes + bytes of the float32 host factors, so publisher and replica
    agree whenever they loaded the same sealed artifacts.
    """
    h = hashlib.sha256()
    for a in (user_factors, item_factors):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
        h.update(repr(a.shape).encode("ascii"))
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# The globals a delta payload's pickle names, under numpy 1 and 2: numpy
# arrays (protocols 2-5), their dtypes and numpy scalars.
_PAYLOAD_GLOBALS = frozenset({
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
    *((m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
      for n in ("_reconstruct", "scalar")),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
})


class _PayloadUnpickler(pickle.Unpickler):
    """Admits only :data:`_PAYLOAD_GLOBALS`: a payload that names any other
    class or function is refused before it is called."""

    def find_class(self, module: str, name: str):
        if (module, name) not in _PAYLOAD_GLOBALS:
            raise ModelIntegrityError(
                f"delta payload names {module}.{name}, which a delta never holds")
        return super().find_class(module, name)


@dataclasses.dataclass
class Delta:
    """One micro-generation: fold-in rows + cooccurrence count updates.

    ``user_idx``/``user_rows`` are replacement rows for the (replicated)
    user-factor matrix; ``item_idx``/``item_rows`` — normally empty for
    user-side fold-in — are written to their rows by the fastpath apply
    (the port has the replicated placement only).  ``cooc_updates`` is an (m, 3)
    int64 array of ``(item_a, item_b, +count)`` pair increments.
    ``event_ids`` records the durable ids of the committed events folded
    in — the sealed log doubles as the publisher's folded-event
    high-water record, so a restarted publisher skips WAL/ring-replayed
    events that already sealed into a prior epoch instead of folding
    them twice.
    """

    epoch: int
    base_fingerprint: str
    user_ids: tuple  # external entity ids, for targeted cache invalidation
    user_idx: np.ndarray  # (n,) int32 rows into user_factors
    user_rows: np.ndarray  # (n, rank) float32 replacement rows
    item_idx: np.ndarray  # (k,) int32 rows into item_factors (may be empty)
    item_rows: np.ndarray  # (k, rank) float32
    cooc_updates: np.ndarray  # (m, 3) int64 (item_a, item_b, +count)
    events: int  # committed events folded into this delta
    created_unix: float
    quality: dict  # gate receipt: {"overlap": .., "threshold": ..}
    event_ids: tuple = ()  # durable ids of the folded events (dedupe fence)

    def to_payload(self) -> bytes:
        return pickle.dumps({
            "version": DELTA_PAYLOAD_VERSION,
            "epoch": int(self.epoch),
            "base_fingerprint": self.base_fingerprint,
            "user_ids": tuple(self.user_ids),
            "user_idx": np.asarray(self.user_idx, dtype=np.int32),
            "user_rows": np.asarray(self.user_rows, dtype=np.float32),
            "item_idx": np.asarray(self.item_idx, dtype=np.int32),
            "item_rows": np.asarray(self.item_rows, dtype=np.float32),
            "cooc_updates": np.asarray(self.cooc_updates, dtype=np.int64),
            "events": int(self.events),
            "created_unix": float(self.created_unix),
            "quality": dict(self.quality),
            "event_ids": tuple(self.event_ids),
        })

    @classmethod
    def from_payload(cls, payload: bytes) -> "Delta":
        """Decode a sealed payload; anything but a delta's own types raises
        :class:`ModelIntegrityError` (see :class:`_PayloadUnpickler`)."""
        try:
            d = _PayloadUnpickler(io.BytesIO(payload)).load()
        except ModelIntegrityError:
            raise
        except Exception as e:
            raise ModelIntegrityError(f"undecodable delta payload: {e}") from None
        if not isinstance(d, dict):
            raise ModelIntegrityError(f"delta payload is a {type(d).__name__}, not a dict")
        if d.get("version") != DELTA_PAYLOAD_VERSION:
            raise ModelIntegrityError(
                f"unsupported delta payload version {d.get('version')!r}")
        return cls(
            epoch=int(d["epoch"]),
            base_fingerprint=d["base_fingerprint"],
            user_ids=tuple(d["user_ids"]),
            user_idx=d["user_idx"],
            user_rows=d["user_rows"],
            item_idx=d["item_idx"],
            item_rows=d["item_rows"],
            cooc_updates=d["cooc_updates"],
            events=int(d["events"]),
            created_unix=float(d["created_unix"]),
            quality=d.get("quality", {}),
            event_ids=tuple(d.get("event_ids", ())),
        )


def empty_delta(epoch: int, base_fingerprint: str, **kw) -> Delta:
    """A structurally valid delta with no rows (testing + catch-up probes)."""
    rank = int(kw.pop("rank", 0))
    defaults = dict(
        user_ids=(), user_idx=np.zeros((0,), np.int32),
        user_rows=np.zeros((0, rank), np.float32),
        item_idx=np.zeros((0,), np.int32),
        item_rows=np.zeros((0, rank), np.float32),
        cooc_updates=np.zeros((0, 3), np.int64),
        events=0, created_unix=0.0, quality={},
    )
    defaults.update(kw)
    return Delta(epoch=epoch, base_fingerprint=base_fingerprint, **defaults)


class DeltaLog:
    """Epoch-ordered directory of sealed ``delta-<epoch>.blob`` files.

    The log is the single source of truth for catch-up: a replica that
    crashed, restarted, or just autoscaled into the fleet replays every
    epoch past its applied high-water mark before it rejoins.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"delta-{epoch:08d}.blob")

    def epochs(self) -> list:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _DELTA_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        out.sort()
        return out

    def last_epoch(self) -> int:
        eps = self.epochs()
        return eps[-1] if eps else 0

    def seal(self, delta: Delta) -> str:
        """Seal one delta through the checksum envelope (atomic publish).

        ``crash:delta:before_seal`` sits between the committed-event ack
        and the seal — the exact window WAL replay must repair: the
        events are durable, the delta is not, and a restarted publisher
        regrows it from replayed commits.
        """
        _faults.crash_point("crash:delta:before_seal")
        p = self.path(delta.epoch)
        seal_blob_file(p, delta.to_payload())
        return p

    def read(self, epoch: int) -> Delta:
        """Open + verify one sealed epoch; raises ModelIntegrityError on
        a torn blob, FileNotFoundError on a missing one."""
        return Delta.from_payload(open_blob_file(self.path(epoch)))

    def read_since(self, epoch: int) -> list:
        """All sealed deltas with epoch > ``epoch``, in order (catch-up)."""
        return [self.read(e) for e in self.epochs() if e > epoch]

    def oldest_unapplied_age_s(self, applied_epoch: int) -> float:
        """Age of the oldest sealed-but-unapplied delta (0.0 if caught up).

        Uses file mtime so staleness costs one stat, not a blob read."""
        pending = [e for e in self.epochs() if e > applied_epoch]
        if not pending:
            return 0.0
        try:
            return max(0.0, time.time() - os.path.getmtime(
                self.path(pending[0])))
        except OSError:
            return 0.0

    def prune(self, keep: Optional[int] = None) -> int:
        """Drop the oldest sealed epochs beyond the retention window."""
        if keep is None:
            keep = int(os.environ.get("PIO_DELTA_LOG_KEEP", "64"))
        eps = self.epochs()
        drop = eps[:-keep] if keep > 0 else eps
        removed = 0
        for e in drop:
            try:
                os.remove(self.path(e))
                removed += 1
            except OSError:
                pass
        return removed


def instance_receipt_recorder(storage, instance_id: str,
                              max_keep: int = 16) -> Callable[[dict], None]:
    """``on_receipt`` hook that lands publish receipts — refusals
    especially — in the deployed EngineInstance's free-form ``env``
    metadata, so ``pio status`` / the registry shows WHY a
    micro-generation was quarantined without grepping logs."""

    def record(receipt: dict) -> None:
        try:
            ei = storage.get_meta_data_engine_instances()
            inst = ei.get(instance_id)
            if inst is None:
                return
            kept = list(inst.env.get("delta_receipts", []))
            kept.append(receipt)
            del kept[:-max_keep]
            inst.env["delta_receipts"] = kept
            ei.update(inst)
        except Exception:
            log.exception("could not record delta receipt on instance %s",
                          instance_id)

    return record


class DeltaApplier:
    """Replica-side fencing + exactly-once application of deltas.

    ``apply_fn(delta)`` performs the actual in-place work (device factor
    patch, cooccurrence counts, cache invalidation); this class owns the
    decision of *whether* it runs: fingerprint fence, idempotent replay
    of old epochs, and in-order application with log catch-up across
    gaps.  All receipts are plain dicts so they serialize straight into
    HTTP acks and instance metadata.
    """

    def __init__(self, base_fingerprint: str,
                 apply_fn: Callable[[Delta], None],
                 delta_log: Optional[DeltaLog] = None):
        self.base_fingerprint = base_fingerprint
        self._apply_fn = apply_fn
        self.log = delta_log
        self.applied_epoch = 0
        self.last_apply_unix = 0.0
        self._lock = threading.Lock()
        self._applied = 0
        self._noops = 0
        self._refused = {}  # reason -> count
        self._visible_ms = []  # rolling event->visible latencies

    # -- receipts ----------------------------------------------------------

    def refuse(self, reason: str, **extra) -> dict:
        """Record + shape a refusal receipt (also used by the transport
        layer for torn-in-transit payloads that never reach apply())."""
        self._refused[reason] = self._refused.get(reason, 0) + 1
        r = {"refused": True, "reason": reason,
             "applied_epoch": self.applied_epoch}
        r.update(extra)
        return r

    # -- apply -------------------------------------------------------------

    def apply(self, delta: Delta) -> dict:
        """Fence + apply one delta; returns the ack receipt."""
        with self._lock:
            return self._apply_locked(delta)

    def _apply_locked(self, delta: Delta) -> dict:
        if delta.base_fingerprint != self.base_fingerprint:
            return self.refuse(
                "fingerprint", epoch=delta.epoch,
                want=self.base_fingerprint, got=delta.base_fingerprint)
        if delta.epoch <= self.applied_epoch:
            # exactly-once: replay of an applied epoch is a no-op ack
            self._noops += 1
            return {"noop": True, "epoch": delta.epoch,
                    "applied_epoch": self.applied_epoch}
        if delta.epoch != self.applied_epoch + 1:
            # a gap means missed epochs: catch up from the sealed log
            # first, then retry this delta in order
            if self.log is not None:
                rc = self._catch_up_locked(upto=delta.epoch - 1)
                if rc.get("refused"):
                    return rc
            if delta.epoch != self.applied_epoch + 1:
                return self.refuse("gap", epoch=delta.epoch)
        return self._apply_one(delta)

    def _apply_one(self, delta: Delta) -> dict:
        # the mid-apply crash window: factors may be half-patched in this
        # process, but applied_epoch has NOT advanced — a restarted
        # replica reloads clean base factors and replays from the log
        _faults.crash_point("crash:delta:mid_apply")
        self._apply_fn(delta)
        self.applied_epoch = delta.epoch
        self.last_apply_unix = time.time()
        self._applied += 1
        if delta.created_unix:
            vis = max(0.0, self.last_apply_unix - delta.created_unix)
            self._visible_ms.append(vis * 1000.0)
            del self._visible_ms[:-512]
        return {"applied": True, "epoch": delta.epoch,
                "applied_epoch": self.applied_epoch,
                "rows": int(np.asarray(delta.user_idx).shape[0])}

    # -- catch-up ----------------------------------------------------------

    def catch_up(self, upto: Optional[int] = None) -> dict:
        """Replay every sealed epoch past the applied high-water mark.

        Run before readmission (restart, autoscale-in, post-roll).  A
        torn blob stops the replay at the last good epoch and reports a
        refusal — the replica serves degraded rather than crashing.
        """
        with self._lock:
            return self._catch_up_locked(upto=upto)

    def _catch_up_locked(self, upto: Optional[int] = None) -> dict:
        if self.log is None:
            return {"caught_up": 0, "applied_epoch": self.applied_epoch}
        applied = 0
        for epoch in self.log.epochs():
            if epoch <= self.applied_epoch:
                continue
            if upto is not None and epoch > upto:
                break
            if epoch != self.applied_epoch + 1:
                rc = self.refuse("gap", epoch=epoch)
                rc["caught_up"] = applied
                return rc
            try:
                delta = self.log.read(epoch)
            except (ModelIntegrityError, OSError) as exc:
                log.warning("delta catch-up stopped at epoch %d: %s",
                            epoch, exc)
                rc = self.refuse("integrity", epoch=epoch, error=str(exc))
                rc["caught_up"] = applied
                return rc
            rc = self._apply_locked(delta)
            if rc.get("refused"):
                rc["caught_up"] = applied
                return rc
            applied += 1
        return {"caught_up": applied, "applied_epoch": self.applied_epoch}

    def stats(self) -> dict:
        with self._lock:
            vis = sorted(self._visible_ms)
            p99 = vis[min(len(vis) - 1, int(len(vis) * 0.99))] if vis else 0.0
            return {
                "applied_epoch": self.applied_epoch,
                "applied": self._applied,
                "noops": self._noops,
                "refused": dict(self._refused),
                "last_apply_unix": self.last_apply_unix,
                "visible_p99_ms": p99,
            }


class DeltaPublisher:
    """Event-plane side: folds committed events into sealed deltas.

    Subscribes to the event server's committed-event notifications
    (``attach_delta_sink``), buffers them, and on flush solves ALS
    user-side fold-in rows against the base generation's item factors,
    gates them on top-k overlap vs a full-fidelity reference solve, and
    seals the surviving micro-generation into the :class:`DeltaLog`.

    ``history_fn(user_id)`` (optional) returns the user's full
    ``[(item_id, rating), ...]`` history so fold-in recomputes the row
    from everything known about the user, not just this delta's events —
    the property the exact-equality test pins down.  Refused deltas
    never seal: the epoch is not burned, a ``refusal-<epoch>.json``
    receipt lands next to the log, and ``on_receipt`` (when wired)
    records it in instance metadata.

    Exactly-once on the fold side rests on two mechanisms:

    * **One flush at a time** — ``_seal_lock`` serializes every flush
      (the paced worker, size-triggered inline flushes on commit
      threads, and the drain-time final fold) across epoch allocation,
      the seal, and the publisher-side factor update, so two concurrent
      flushes can never mint the same epoch or overwrite each other's
      sealed blob.
    * **Folded-event dedupe** — each sealed delta carries the durable
      ids of the events it folded; a publisher primes its dedupe window
      from the sealed log at construction and ``on_committed`` skips
      events already folded (or already pending), so WAL replay and
      committed-ring replay after a clean restart never double-fold.
    """

    def __init__(self, model, delta_log: DeltaLog, *,
                 history_fn: Optional[Callable] = None,
                 on_receipt: Optional[Callable[[dict], None]] = None,
                 max_events: Optional[int] = None,
                 min_overlap: Optional[float] = None,
                 gate_sample: Optional[int] = None,
                 gate_k: int = 10):
        self.model = model
        self.log = delta_log
        self.history_fn = history_fn
        self.on_receipt = on_receipt
        self.max_events = int(
            os.environ.get("PIO_DELTA_MAX_EVENTS", "512")
            if max_events is None else max_events)
        self.min_overlap = float(
            os.environ.get("PIO_DELTA_MIN_OVERLAP", "0.6")
            if min_overlap is None else min_overlap)
        self.gate_sample = int(
            os.environ.get("PIO_DELTA_GATE_SAMPLE", "8")
            if gate_sample is None else gate_sample)
        self.gate_k = gate_k
        self.base_fingerprint = model_fingerprint(
            model.user_factors, model.item_factors)
        self._lock = threading.Lock()  # buffers, counters, dedupe window
        self._seal_lock = threading.Lock()  # serializes whole flushes
        self._pending = []  # [(user_id, item_id, rating, event_id|None)]
        self._pending_ids: set = set()  # durable ids buffered in _pending
        self._folded_ids: set = set()  # recently folded durable ids
        self._folded_order: collections.deque = collections.deque()
        self._sealed = 0
        self._seal_refused = 0
        self._events_folded = 0
        self._unknown_users = 0
        self._dedup_skipped = 0
        self._last_receipt: Optional[dict] = None
        # prime the dedupe window from the sealed log: after a clean
        # restart, WAL/ring replay re-delivers events that already
        # sealed into prior epochs — they must not fold twice
        for epoch in delta_log.epochs():
            try:
                self._remember_folded(delta_log.read(epoch).event_ids)
            except (ModelIntegrityError, OSError) as exc:
                log.warning("dedupe prime skipped epoch %d: %s", epoch, exc)

    def _remember_folded(self, event_ids) -> None:
        """Record durable event ids as folded (bounded window).
        Caller holds neither lock at __init__ time; every other caller
        takes ``self._lock`` here."""
        with self._lock:
            for eid in event_ids:
                if eid is None or eid in self._folded_ids:
                    continue
                self._folded_ids.add(eid)
                self._folded_order.append(eid)
            while len(self._folded_order) > _DEDUP_KEEP:
                self._folded_ids.discard(self._folded_order.popleft())

    # -- ingestion hook ----------------------------------------------------

    def on_committed(self, events) -> None:
        """Committed-event sink (fires on the storage-commit path AND on
        WAL/ring replay).  Replayed events whose durable id already
        folded into a sealed epoch — or is already buffered — are
        skipped, so a delta lost to a pre-seal crash is regrown from the
        same durable events while a clean restart never folds twice."""
        batch = []
        for ev in events:
            ent = getattr(ev, "entity_id", None)
            tgt = getattr(ev, "target_entity_id", None)
            if ent is None or tgt is None:
                continue
            props = getattr(ev, "properties", None) or {}
            try:
                rating = float(props.get("rating", 1.0))
            except (TypeError, ValueError):
                rating = 1.0
            eid = getattr(ev, "event_id", None)
            batch.append((str(ent), str(tgt), rating, eid))
        if not batch:
            return
        flush_now = False
        with self._lock:
            for item in batch:
                eid = item[3]
                if eid is not None and (eid in self._folded_ids
                                        or eid in self._pending_ids):
                    self._dedup_skipped += 1
                    continue
                if eid is not None:
                    self._pending_ids.add(eid)
                self._pending.append(item)
            flush_now = len(self._pending) >= self.max_events
        if flush_now:
            self.flush()

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- build + gate + seal ----------------------------------------------

    def flush(self) -> Optional[dict]:
        """Fold the pending buffer into one sealed micro-generation.

        Returns the publish receipt (or None when there was nothing to
        fold).  A below-threshold fold-in is quarantined: nothing seals,
        the receipt says why, serving stays on the last-good epoch.

        ``_seal_lock`` is held across the pending swap, epoch
        allocation, gate, seal, and publisher-side factor update:
        concurrent flushes (size-triggered on commit threads, the paced
        worker, drain) serialize here, so epochs are allocated once and
        a sealed blob is never silently overwritten by a racing seal.
        """
        with self._seal_lock:
            with self._lock:
                pending, self._pending = self._pending, []
                self._pending_ids = set()
            if not pending:
                return None
            receipt = self._build_and_seal(pending)
            # every flushed event is now accounted for (sealed, or
            # dropped by a refusal receipt): never re-fold its replay
            self._remember_folded(eid for _, _, _, eid in pending)
        with self._lock:
            self._last_receipt = receipt
        if self.on_receipt is not None:
            try:
                self.on_receipt(receipt)
            except Exception:
                log.exception("delta receipt callback failed")
        return receipt

    def _build_and_seal(self, pending) -> dict:
        from predictionio_tpu_torch.models.als import fold_in_users
        from predictionio_tpu_torch.models.cooccurrence import (
            cooccurrence_increments,
        )

        by_user = {}
        event_ids = []
        for user_id, item_id, rating, eid in pending:
            by_user.setdefault(user_id, []).append((item_id, rating))
            if eid is not None:
                event_ids.append(eid)
        model = self.model
        interactions = {}
        new_items = {}  # uidx -> item indices of THIS batch's events
        prior_items = {}  # uidx -> items already counted by base/deltas
        user_ids = []
        unknown = 0
        for user_id, batch_pairs in by_user.items():
            uidx = model.user_map.get(user_id)
            if uidx is None:
                # fold-in updates existing rows in place; brand-new users
                # wait for the next full retrain (bucket shapes and the
                # factor matrix never change mid-generation)
                unknown += 1
                continue
            pairs = batch_pairs
            if self.history_fn is not None:
                try:
                    pairs = list(self.history_fn(user_id)) or batch_pairs
                except Exception:
                    log.exception("history_fn failed for %r", user_id)
            items = []
            for item_id, rating in pairs:
                iidx = model.item_map.get(str(item_id))
                if iidx is not None:
                    items.append((iidx, float(rating)))
            if items:
                interactions[uidx] = items
                user_ids.append(user_id)
                # cooc increments count only THIS batch's events — the
                # history expansion above recomputes the fold-in row but
                # its historical pairs were already counted by the base
                # Gram and earlier deltas (multiset-subtracting the
                # batch from the full history leaves the prior items,
                # so cross pairs new×prior still count exactly once)
                raw = collections.Counter(
                    model.item_map.get(str(i)) for i, _ in batch_pairs)
                raw.pop(None, None)
                new_items[uidx] = list(raw)
                if pairs is not batch_pairs:
                    full = collections.Counter(
                        model.item_map.get(str(i)) for i, _ in pairs)
                    full.pop(None, None)
                    prior_items[uidx] = list(full - raw)
        epoch = self.log.last_epoch() + 1
        if not interactions:
            receipt = {"refused": True, "reason": "empty", "epoch": epoch,
                       "events": len(pending), "unknown_users": unknown}
            with self._lock:
                self._unknown_users += unknown
                self._seal_refused += 1
            return receipt

        cfg = model.config
        user_idx = np.array(sorted(interactions), dtype=np.int32)
        rows = fold_in_users(
            model.item_factors, {u: interactions[u] for u in user_idx},
            rank=cfg.rank, reg=cfg.reg, implicit=cfg.implicit,
            alpha=cfg.alpha, compute_dtype=cfg.compute_dtype)
        overlap = self._gate_overlap(user_idx, interactions, rows)
        quality = {"overlap": round(float(overlap), 6),
                   "threshold": self.min_overlap,
                   "sampled_users": min(self.gate_sample, len(user_idx)),
                   "k": self.gate_k}
        if overlap < self.min_overlap:
            # quarantine: nothing seals, epoch not burned, serving stays
            # on last-good; the refusal receipt is durable next to the log
            with self._lock:
                self._unknown_users += unknown
                self._seal_refused += 1
            receipt = {"refused": True, "reason": "quality", "epoch": epoch,
                       "events": len(pending), "users": len(user_idx),
                       "rolled_back_to": self.log.last_epoch(), **quality}
            self._write_refusal(epoch, receipt)
            log.warning(
                "delta epoch %d REFUSED: fold-in top-%d overlap %.4f < "
                "%.4f (PIO_DELTA_MIN_OVERLAP); serving stays on epoch %d",
                epoch, self.gate_k, overlap, self.min_overlap,
                self.log.last_epoch())
            return receipt

        cooc = cooccurrence_increments(new_items, prior_by_user=prior_items)
        delta = Delta(
            epoch=epoch, base_fingerprint=self.base_fingerprint,
            user_ids=tuple(user_ids), user_idx=user_idx,
            user_rows=rows,
            item_idx=np.zeros((0,), np.int32),
            item_rows=np.zeros((0, cfg.rank), np.float32),
            cooc_updates=cooc, events=len(pending),
            created_unix=time.time(), quality=quality,
            event_ids=tuple(event_ids))
        path = self.log.seal(delta)
        # keep the publisher's own base factors current so the NEXT
        # fold-in gate references the updated rows too (the caller's
        # _seal_lock makes this write race-free against other flushes)
        model.user_factors[user_idx] = rows
        with self._lock:
            self._unknown_users += unknown
            self._sealed += 1
            self._events_folded += len(pending)
        return {"sealed": True, "epoch": epoch, "path": path,
                "events": len(pending), "users": len(user_idx),
                "unknown_users": unknown, **quality}

    def _gate_overlap(self, user_idx, interactions, rows) -> float:
        """Top-k overlap of candidate fold-in rows vs a float64 reference
        solve on sampled users (the fold-in analogue of the quantization
        publish gate)."""
        from predictionio_tpu_torch.models.als import fold_in_users

        n = len(user_idx)
        if n == 0:
            return 1.0
        sample = user_idx[:: max(1, n // max(1, self.gate_sample))]
        sample = sample[: self.gate_sample]
        cfg = self.model.config
        ref = fold_in_users(
            self.model.item_factors,
            {u: interactions[u] for u in sample},
            rank=cfg.rank, reg=cfg.reg, implicit=cfg.implicit,
            alpha=cfg.alpha, compute_dtype="f64")
        pos = {int(u): i for i, u in enumerate(user_idx)}
        V = np.asarray(self.model.item_factors, dtype=np.float32)
        k = min(self.gate_k, V.shape[0])
        if k == 0:
            return 1.0
        hits = 0
        for j, u in enumerate(sample):
            cand = rows[pos[int(u)]] @ V.T
            want = ref[j] @ V.T
            top_c = set(np.argsort(-cand)[:k].tolist())
            top_w = set(np.argsort(-want)[:k].tolist())
            hits += len(top_c & top_w) / float(k)
        return hits / float(len(sample))

    def _write_refusal(self, epoch: int, receipt: dict) -> None:
        p = os.path.join(self.log.directory, f"refusal-{epoch:08d}.json")
        try:
            with open(p, "w") as f:
                json.dump(receipt, f, sort_keys=True)
        except OSError:
            log.exception("could not persist refusal receipt %s", p)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sealed": self._sealed,
                "seal_refused": self._seal_refused,
                "events_folded": self._events_folded,
                "unknown_users": self._unknown_users,
                "dedup_skipped": self._dedup_skipped,
                "pending": len(self._pending),
                "log_epoch": self.log.last_epoch(),
                "base_fingerprint": self.base_fingerprint,
                "last_receipt": self._last_receipt,
            }
