"""Event-server ingestion counts behind ``/stats.json``.

Copy of ``predictionio_tpu/data/api/stats.py`` (parity:
``data/.../api/Stats.scala:28-80`` and ``StatsActor.scala:30-76``): per-app
counts keyed by (event name, status code) since the server started, under
a lock in place of the actor mailbox.

Event names come off the wire, so past ``PIO_STATS_MAX_KEYS`` distinct
(event, status) keys an app's new event names count in the
``__overflow__`` bucket of their status: totals stay true at fixed memory.
:meth:`Stats.get_all` is the cross-app readout (``/stats.json`` without
an access key).
"""

from __future__ import annotations

import datetime as _dt
import os
import threading
from collections import Counter

OVERFLOW_EVENT = "__overflow__"


def _max_keys_default() -> int:
    return int(os.environ.get("PIO_STATS_MAX_KEYS", "1000"))


class Stats:
    def __init__(self, max_keys: int | None = None):
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        self.max_keys = max_keys if max_keys is not None else _max_keys_default()
        self._lock = threading.Lock()
        self._counts: dict[int, Counter] = {}

    def update(self, app_id: int, event_name: str, status_code: int) -> None:
        with self._lock:
            counts = self._counts.setdefault(app_id, Counter())
            key = (event_name, status_code)
            if key not in counts and len(counts) >= self.max_keys:
                key = (OVERFLOW_EVENT, status_code)
            counts[key] += 1

    @staticmethod
    def _status_count(counts: Counter) -> list[dict]:
        return [
            {"event": ev, "status": status, "count": n}
            for (ev, status), n in sorted(counts.items())
        ]

    def get(self, app_id: int) -> dict:
        with self._lock:
            counts = self._counts.get(app_id, Counter())
            return {
                "startTime": self.start_time.isoformat(),
                "statusCount": self._status_count(counts),
            }

    def get_all(self) -> dict:
        with self._lock:
            return {
                "startTime": self.start_time.isoformat(),
                "apps": {
                    str(app_id): self._status_count(counts)
                    for app_id, counts in sorted(self._counts.items())
                },
            }
