"""Result cache with event-driven invalidation for the serving hot path.

Counterpart of ``predictionio_tpu/serving/result_cache.py``, whole.

Real serving traffic is Zipf-distributed: a small head of hot users
generates most queries, and an identical query re-scored on device is pure
waste — the answer only changes when (a) a relevant event lands, or (b) a
new model generation deploys.  This module turns that observation into the
platform's ONE caching idiom:

* :func:`canonical_fingerprint` — a stable key for "identical query":
  sorted-key compact JSON of the raw request body, minus fields that do
  not affect the prediction (``prId``).  The same fingerprint also keys
  single-flight coalescing in the micro-batcher.
* :class:`InvalidationIndex` — generation counters bumped by the ingest
  path.  A cached answer records the generations of every entity it
  depends on; a new event for user U bumps ``U``'s generation, so U's
  cached answers fail validation on the next lookup.  ``$``-prefixed
  events, deletes, and counter overflow bump the GLOBAL generation —
  conservative over clever: when attribution is unclear, everything
  invalidates.
* :class:`ResultCache` — bounded LRU of jsonable predictions, validated
  on ``get`` against TTL (the backstop for cross-process ingest, where no
  in-process hook fires), the invalidation token, and the model
  generation (a reload flushes everything).

Everything here is stdlib-only (no torch): the event server imports it for
the ingest-side hooks without touching accelerator code. Off by default
(``PIO_RESULT_CACHE``, ``PIO_COALESCE``).
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional

# query fields whose values name entities a cached answer depends on;
# override with PIO_RESULT_CACHE_KEYS=field1,field2
DEFAULT_KEY_FIELDS = ("user", "users", "item", "items")


def canonical_fingerprint(
    data: dict, namespace: Optional[str] = None
) -> Optional[str]:
    """Stable fingerprint of a raw query body; None when unfingerprintable.

    Sorted keys + compact separators make JSON-equal bodies collide
    regardless of field order; ``prId`` is excluded because the feedback
    tag never changes what the engine predicts, and ``accessKey`` because
    auth metadata never changes the answer — tenant identity lives in
    ``namespace`` instead.  ``namespace`` (tenant id + engine variant
    under multi-tenancy) prefixes the fingerprint so two tenants with
    byte-identical query bodies NEVER share a cache entry or a coalesced
    leader slot: the fingerprint doubles as the batcher coalescing key,
    so an un-namespaced key would leak one tenant's answer to another.
    """
    if not isinstance(data, dict):
        return None
    try:
        body = json.dumps(
            {k: v for k, v in data.items() if k not in ("prId", "accessKey")},
            sort_keys=True, separators=(",", ":"),
        )
    except (TypeError, ValueError):
        return None
    if namespace:
        return f"{namespace}\x1f{body}"
    return body


def entity_ids_from(data: dict, key_fields: Iterable[str]) -> tuple[str, ...]:
    """Entity ids a query touches, read from its well-known key fields.

    Scalars and flat lists both contribute; anything else is ignored (the
    TTL backstop still bounds staleness for exotic query shapes).
    """
    ids: list[str] = []
    for field in key_fields:
        v = data.get(field)
        if isinstance(v, (str, int)):
            ids.append(str(v))
        elif isinstance(v, (list, tuple)):
            ids.extend(str(x) for x in v if isinstance(x, (str, int)))
    return tuple(ids)


class InvalidationIndex:
    """Per-entity + global generation counters driven by the ingest path.

    ``token(ids)`` snapshots the generations a cached answer depends on;
    the answer is valid while a fresh snapshot compares equal.  The
    per-entity map is bounded: evicting an entity silently could let a
    stale token validate (entity bumped to gen 1, evicted, recomputed as
    gen 0 == the stale 0), so every eviction bumps the global generation —
    overflow degrades to coarser invalidation, never to staleness.
    """

    def __init__(self, max_entities: int = 100_000):
        self.max_entities = int(max_entities)
        self._lock = threading.Lock()
        self._gens: "OrderedDict[str, int]" = OrderedDict()
        self._global_gen = 0
        self._counts = {
            "entity_bumps": 0, "global_bumps": 0, "evictions": 0,
        }

    def bump_entities(self, ids: Iterable[str]) -> None:
        with self._lock:
            for eid in ids:
                self._gens[eid] = self._gens.get(eid, 0) + 1
                self._gens.move_to_end(eid)
                self._counts["entity_bumps"] += 1
            while len(self._gens) > self.max_entities:
                self._gens.popitem(last=False)
                self._counts["evictions"] += 1
                self._global_gen += 1
                self._counts["global_bumps"] += 1

    def bump_all(self) -> None:
        with self._lock:
            self._global_gen += 1
            self._counts["global_bumps"] += 1

    def token(self, ids: Iterable[str]) -> tuple:
        with self._lock:
            return (
                self._global_gen,
                tuple(self._gens.get(str(i), 0) for i in ids),
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "entities": len(self._gens),
                "global_gen": self._global_gen,
                **self._counts,
            }


# THE process-wide index: the event server's ingest hooks bump it, every
# in-process cache (result cache, serving event cache) validates against
# it.  Split-process deployments have no in-process hook — there the TTL
# backstop bounds staleness.
INVALIDATIONS = InvalidationIndex()


def notify_event(event: Any) -> None:
    """Ingest-side hook: one committed event → the generations it moves.

    Called AFTER the storage write lands (direct insert, batch insert,
    buffer flush-commit, WAL replay) — bumping at ack time would let a
    query recompute from pre-flush storage and re-cache the stale answer.
    ``$``-prefixed events mutate entity properties with app-wide reach
    (``$set`` on a constraint entity changes every answer), so they bump
    globally.
    """
    name = str(getattr(event, "event", "") or "")
    if name.startswith("$"):
        INVALIDATIONS.bump_all()
        return
    ids = []
    for attr in ("entity_id", "target_entity_id"):
        v = getattr(event, attr, None)
        if v:
            ids.append(str(v))
    if ids:
        INVALIDATIONS.bump_entities(ids)
    else:
        INVALIDATIONS.bump_all()


def notify_delta(user_ids: Iterable[Any]) -> int:
    """Streaming micro-generation hook: a sealed delta touched these users.

    Delta apply rewrites factor rows for a *known* set of users, so the
    invalidation is entity-targeted — every other entity's cached answer
    stays hot (a full flush here would turn each micro-generation into a
    cache stampede, defeating the freshness pipeline's latency win).
    """
    ids = [str(u) for u in user_ids if u is not None and str(u)]
    if ids:
        INVALIDATIONS.bump_entities(ids)
    return len(ids)


def notify_delete() -> None:
    """Event deletion hook: the deleted row's entity is unknown by the
    time the DELETE returns, so invalidate globally (deletes are rare)."""
    INVALIDATIONS.bump_all()


class ResultCache:
    """Bounded LRU of jsonable predictions keyed by query fingerprint.

    Entries are validated on ``get`` in order of cheapness: model
    generation (a reload flushed the world), TTL (cross-process ingest
    backstop), then the invalidation token (an event moved a dependency).
    Values are deep-copied on both ``put`` and ``get`` — downstream code
    mutates results (``prId``, output-blocker plugins) and a shared
    reference would leak one caller's rewrite into another's answer.
    """

    def __init__(
        self,
        max_entries: int = 4096,
        ttl_s: float = 30.0,
        key_fields: Iterable[str] = DEFAULT_KEY_FIELDS,
        index: InvalidationIndex = INVALIDATIONS,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self.key_fields = tuple(key_fields)
        self.index = index
        self._clock = clock
        self._lock = threading.Lock()
        # fp → (value, stored_at, entity_ids, token, model_gen)
        self._data: "OrderedDict[str, tuple]" = OrderedDict()
        self._counts = {
            "hits": 0, "misses": 0, "stores": 0, "evictions": 0,
            "invalidated_ttl": 0, "invalidated_event": 0,
            "invalidated_model": 0,
        }

    def get(self, fp: str, model_gen: int) -> Optional[dict]:
        now = self._clock()
        with self._lock:
            entry = self._data.get(fp)
            if entry is None:
                self._counts["misses"] += 1
                return None
            value, stored_at, entity_ids, token, gen = entry
            if gen != model_gen:
                reason = "invalidated_model"
            elif now - stored_at > self.ttl_s:
                reason = "invalidated_ttl"
            else:
                reason = None
            if reason is not None:
                del self._data[fp]
                self._counts[reason] += 1
                self._counts["misses"] += 1
                return None
        # token check outside this cache's lock: the index has its own
        if self.index.token(entity_ids) != token:
            with self._lock:
                # guard against a concurrent put having replaced the entry
                if self._data.get(fp) is entry:
                    del self._data[fp]
                self._counts["invalidated_event"] += 1
                self._counts["misses"] += 1
            return None
        with self._lock:
            if fp in self._data:
                self._data.move_to_end(fp)
            self._counts["hits"] += 1
        return copy.deepcopy(value)

    def put(
        self, fp: str, value: dict, entity_ids: tuple, model_gen: int
    ) -> None:
        # snapshot the token BEFORE copying: if an event lands mid-copy the
        # stored token is already stale and the entry self-invalidates
        token = self.index.token(entity_ids)
        stored = copy.deepcopy(value)
        with self._lock:
            self._data[fp] = (
                stored, self._clock(), entity_ids, token, model_gen
            )
            self._data.move_to_end(fp)
            self._counts["stores"] += 1
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)
                self._counts["evictions"] += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            entries = len(self._data)
        lookups = c["hits"] + c["misses"]
        return {
            "entries": entries,
            "max_entries": self.max_entries,
            "ttl_s": self.ttl_s,
            "hit_rate": round(c["hits"] / lookups, 4) if lookups else None,
            **c,
        }


def _env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "off", "no")


def result_cache_from_env() -> Optional[ResultCache]:
    """Build the serving result cache from PIO_RESULT_CACHE_* knobs;
    None when the cache is off (the default — off-by-default-safe)."""
    if not _env_flag("PIO_RESULT_CACHE"):
        return None
    ttl_ms = float(os.environ.get("PIO_RESULT_CACHE_TTL_MS", 30_000.0))
    max_entries = int(os.environ.get("PIO_RESULT_CACHE_MAX", 4096))
    keys_raw = os.environ.get("PIO_RESULT_CACHE_KEYS", "")
    key_fields = tuple(
        k.strip() for k in keys_raw.split(",") if k.strip()
    ) or DEFAULT_KEY_FIELDS
    return ResultCache(
        max_entries=max_entries, ttl_s=ttl_ms / 1e3, key_fields=key_fields
    )


def coalesce_from_env() -> bool:
    """PIO_COALESCE: single-flight identical in-flight queries at the
    micro-batcher (off by default)."""
    return _env_flag("PIO_COALESCE")
