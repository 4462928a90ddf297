"""Self-cleaning data source: sliding-window event compaction.

Counterpart of ``predictionio_tpu/core/self_cleaning.py`` (parity:
``core/.../core/SelfCleaningDataSource.scala:42-324``), on the host as
there:

* :class:`EventWindow` (``:320``) — ``duration`` (seconds here; the reference
  parses "1 day"-style strings, accepted too), ``remove_duplicates``,
  ``compress_properties``.
* :func:`clean_persisted_events` (``cleanPersistedPEvents:160``) — compacts
  each entity's ``$set``/``$unset`` stream into ONE ``$set`` snapshot
  (``compressPProperties:106``), optionally dedups identical regular events,
  drops events older than the window, and rewrites the store in place.
* :class:`SelfCleaningDataSource` — mixin giving any DataSource a
  ``clean_persisted_events`` hook to call before reading.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
import re
from typing import Optional

from predictionio_tpu_torch.data.event import Event, EventValidation, utcnow
from predictionio_tpu_torch.data.storage.registry import Storage

logger = logging.getLogger(__name__)

_DURATION_RE = re.compile(r"(\d+)\s*(second|minute|hour|day|week)s?")
_UNIT_SECONDS = {
    "second": 1,
    "minute": 60,
    "hour": 3600,
    "day": 86400,
    "week": 604800,
}


def parse_duration(d) -> float:
    """Seconds from a number or a reference-style '2 days' string."""
    if isinstance(d, (int, float)):
        return float(d)
    m = _DURATION_RE.fullmatch(str(d).strip().lower())
    if not m:
        raise ValueError(f"cannot parse duration {d!r}")
    return int(m.group(1)) * _UNIT_SECONDS[m.group(2)]


@dataclasses.dataclass
class EventWindow:
    """Parity: SelfCleaningDataSource.scala:320 EventWindow."""

    duration: Optional[object] = None  # seconds or "N days"
    remove_duplicates: bool = False
    compress_properties: bool = False


def clean_persisted_events(
    storage: Storage,
    app_id: int,
    window: EventWindow,
    channel_id: Optional[int] = None,
    now: Optional[_dt.datetime] = None,
) -> dict:
    """Compact the event store in place; returns {'before': n, 'after': m}."""
    le = storage.get_l_events()
    events = list(le.find(app_id, channel_id=channel_id))
    before = len(events)
    now = now or utcnow()

    cutoff = None
    if window.duration is not None:
        cutoff = now - _dt.timedelta(seconds=parse_duration(window.duration))

    # 1. window: drop REGULAR events older than the cutoff; property events
    # are exempt — dropping them would destroy entity state (parity:
    # SelfCleaningDataSource.scala:83,101 `isAfter(cutoff) || isSetEvent(e)`)
    special = [e for e in events if e.event in EventValidation.SPECIAL_EVENTS]
    regular = [
        e
        for e in events
        if e.event not in EventValidation.SPECIAL_EVENTS
        and (cutoff is None or e.event_time >= cutoff)
    ]

    # 2. compress properties: one $set snapshot per (entityType, entityId)
    if window.compress_properties:
        from predictionio_tpu_torch.data.aggregator import aggregate_properties

        compressed: list[Event] = []
        by_type: dict[str, list[Event]] = {}
        for e in special:
            by_type.setdefault(e.entity_type, []).append(e)
        for entity_type, evs in by_type.items():
            snapshots = aggregate_properties(evs)
            for entity_id, pm in snapshots.items():
                compressed.append(
                    Event(
                        event="$set",
                        entity_type=entity_type,
                        entity_id=entity_id,
                        properties=pm.to_dict(),
                        event_time=pm.last_updated,
                    )
                )
        special = compressed

    # 3. dedup identical regular events (same signature, keep earliest)
    if window.remove_duplicates:
        seen: set = set()
        deduped = []
        for e in sorted(regular, key=lambda e: (e.event_time, e.creation_time)):
            sig = (
                e.event,
                e.entity_type,
                e.entity_id,
                e.target_entity_type,
                e.target_entity_id,
                tuple(sorted(e.properties.to_dict().items())),
            )
            if sig in seen:
                continue
            seen.add(sig)
            deduped.append(e)
        regular = deduped

    new_events = special + regular
    # rewrite in place (parity: removePEvents + wipe + write)
    le.remove(app_id, channel_id)
    le.init(app_id, channel_id)
    le.batch_insert(new_events, app_id, channel_id)
    logger.info(
        "cleaned app %s channel %s: %d -> %d events", app_id, channel_id,
        before, len(new_events),
    )
    return {"before": before, "after": len(new_events)}


class SelfCleaningDataSource:
    """Mixin: DataSources with an ``event_window`` get pre-read compaction.

    Subclass declares ``app_name``/``event_window`` (usually from params) and
    calls :meth:`clean_persisted_events` at the top of ``read_training``.
    """

    @property
    def event_window(self) -> Optional[EventWindow]:
        p = getattr(self, "params", None)
        w = getattr(p, "eventWindow", None) if p else None
        if w is None:
            return None
        if isinstance(w, EventWindow):
            return w
        return EventWindow(
            duration=w.get("duration"),
            remove_duplicates=bool(w.get("removeDuplicates", False)),
            compress_properties=bool(w.get("compressProperties", False)),
        )

    def clean_persisted_events(self, storage: Optional[Storage] = None) -> Optional[dict]:
        window = self.event_window
        if window is None:
            return None
        from predictionio_tpu_torch.data.store import get_storage, resolve_app

        # one process trains on one card: the rewrite runs exactly once (the
        # JAX package's coordinator-only rule comes with ROADMAP §1 item 10)
        storage = storage or get_storage()
        app_id, channel_id = resolve_app(self.params.appName)
        return clean_persisted_events(storage, app_id, window, channel_id)
