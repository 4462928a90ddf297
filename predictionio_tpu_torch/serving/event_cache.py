"""In-process TTL cache with async refresh for serving-time event lookups.

Counterpart of ``predictionio_tpu/serving/event_cache.py``, pure Python as
there. Why this exists: the e-commerce template's
predict path consults the live event store per query — the user's seen-item
set and the ``unavailableItems`` constraint entity (reference parity:
``examples/scala-parallel-ecommercerecommendation/adjust-score/src/main/
scala/ECommAlgorithm.scala:332-360``, which does a timed
``LEventStore.findByEntity`` on every request).  A storage round-trip in
the <10 ms REST predict path makes filtered-query latency storage-bound;
with a remote (network-backed) event store it dominates outright.

:class:`ServingEventCache` keeps the hot path in process memory:

* **miss** → load synchronously (first query for a user pays one read);
* **hit** → return the cached value immediately, never touching storage;
* **stale hit** (older than ``refresh_interval``) → still returns the
  cached value with zero storage reads, and schedules a refresh on a
  single background worker thread (deduplicated per key), so new events
  appear within one refresh interval without a query ever blocking.

Steady state therefore makes ZERO storage round-trips on the request path.
Thread-safe; the query server handles requests on multiple threads.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Hashable, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    refreshes: int = 0
    evictions: int = 0
    invalidated: int = 0  # entries dropped by an invalidation-token change

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServingEventCache:
    """Key → value cache with background refresh after ``refresh_interval``.

    ``loader`` callables are supplied per ``get`` so one cache can serve
    heterogeneous lookups (seen-sets keyed by user, constraint entities,
    item properties...).  A failed refresh keeps the previous value and
    logs — serving stays up on a flaky store (matching the template's
    existing degrade-gracefully behavior on lookup errors).
    """

    def __init__(
        self,
        refresh_interval: float = 5.0,
        max_entries: int = 100_000,
        clock: Callable[[], float] = time.monotonic,
        refresh_timeout: float = 30.0,
        refresh_workers: int = 4,
    ):
        self.refresh_interval = float(refresh_interval)
        self.max_entries = int(max_entries)
        self.refresh_timeout = float(refresh_timeout)
        self.refresh_workers = int(refresh_workers)
        self._clock = clock
        self._lock = threading.Lock()
        # insertion/refresh-ordered so eviction is O(1) popitem(last=False)
        # instead of a min-scan under the lock on the serving path
        self._data: "OrderedDict[Hashable, tuple[Any, float]]" = OrderedDict()
        # key → wall-clock start of the in-flight refresh; entries older
        # than refresh_timeout are presumed hung (e.g. a TCP black hole on
        # a remote store) and no longer block a new refresh of that key
        self._inflight: dict[Hashable, float] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        self.stats = CacheStats()

    # -- core ---------------------------------------------------------------
    def get(
        self,
        key: Hashable,
        loader: Callable[[], Any],
        token: Any = None,
    ) -> Any:
        """Cached value for ``key``; loads synchronously on a miss.

        ``token`` opts the entry into event-driven invalidation: pass the
        current invalidation token for the entities this lookup depends on
        (``result_cache.INVALIDATIONS.token(...)``).  A stored entry whose
        token no longer matches is reloaded SYNCHRONOUSLY — the caller
        sees the post-event value immediately instead of one refresh
        interval later.  ``token=None`` keeps the pure TTL behavior.
        """
        now = self._clock()
        with self._lock:
            entry = self._data.get(key)
            if entry is not None and token is not None and entry[2] != token:
                # an event moved a dependency: the stale value must not be
                # served even once, so this is a hard miss, not a refresh
                del self._data[key]
                self.stats.invalidated += 1
                entry = None
            if entry is not None:
                self.stats.hits += 1
        if entry is not None:
            value, loaded_at, _ = entry
            if now - loaded_at >= self.refresh_interval:
                self._schedule_refresh(key, loader, token)
            return value
        value = loader()
        with self._lock:
            self.stats.misses += 1
            self._data[key] = (value, now, token)
            self._data.move_to_end(key)
            self._evict_locked()
        return value

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats_dict(self) -> dict:
        """Counter snapshot + sizing for the obs bridge
        (``pio_event_cache_*``).  Named ``stats_dict`` because ``stats``
        is the live :class:`CacheStats` attribute."""
        with self._lock:
            out = self.stats.to_dict()
            out["entries"] = len(self._data)
            out["max_entries"] = self.max_entries
            out["refresh_interval_s"] = self.refresh_interval
            out["inflight_refreshes"] = len(self._inflight)
        return out

    # -- internals ----------------------------------------------------------
    def _evict_locked(self) -> None:
        # stalest-first (insertion/refresh order) O(1) eviction; max_entries
        # bounds resident memory for unbounded user populations
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.stats.evictions += 1

    def _schedule_refresh(
        self, key: Hashable, loader: Callable[[], Any], token: Any = None
    ) -> None:
        # same clock as entry ages: with an injected test clock the staleness
        # and hung-refresh timeout domains must not diverge
        started = self._clock()
        with self._lock:
            inflight_since = self._inflight.get(key)
            if (
                inflight_since is not None
                and started - inflight_since < self.refresh_timeout
            ):
                return  # a live refresh is already running for this key
            # either no refresh in flight, or the previous one is presumed
            # hung (its thread, if still alive, loses the write race below)
            self._inflight[key] = started
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.refresh_workers,
                    thread_name_prefix="event-cache-refresh",
                )
            executor = self._executor

        def work():
            try:
                value = loader()
                with self._lock:
                    # a superseded (hung-then-completed) refresh must not
                    # clobber a newer one's in-flight bookkeeping
                    if self._inflight.get(key) == started:
                        self._data[key] = (value, self._clock(), token)
                        self._data.move_to_end(key)
                        self.stats.refreshes += 1
            except Exception:
                logger.exception("cache refresh for %r failed; keeping stale", key)
            finally:
                with self._lock:
                    if self._inflight.get(key) == started:
                        del self._inflight[key]

        try:
            executor.submit(work)
        except RuntimeError:
            # a concurrent close() shut the executor down between the lock
            # release and submit; serving is winding down — drop the refresh
            # (the stale value was already returned) and clear bookkeeping
            with self._lock:
                if self._inflight.get(key) == started:
                    del self._inflight[key]

    def wait_refreshes(self, timeout: float = 5.0) -> None:
        """Block until no refresh is in flight (tests / graceful shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    return
            time.sleep(0.005)
        raise TimeoutError("cache refreshes still in flight")

    def close(self) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False)
