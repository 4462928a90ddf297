"""REST event server: the ingestion front door.

Counterpart of the plain path of ``predictionio_tpu/data/api/event_server.py``
(parity: ``data/.../data/api/EventServer.scala:61-560``):

* access-key auth by ``?accessKey=`` or the HTTP Basic user, the key's
  event whitelist, and ``?channel=<name>`` (an unknown channel → 400);
* ``POST /events.json`` → 201 ``{"eventId": ...}``; ``GET``/``DELETE
  /events/<id>.json``; filtered ``GET /events.json`` (startTime, untilTime,
  entityType, entityId, event, targetEntityType, targetEntityId, limit,
  reversed);
* ``POST /batch/events.json``, at most ``PIO_MAX_BATCH_SIZE`` (50) events,
  a status per item and partial success;
* ``GET /stats.json`` under ``stats=True``; ``GET /``, ``/healthz``,
  ``/readyz``; ``POST /stop``;
* input blocker and sniffer plugins (:class:`EventServerPlugin`);
* ``GET /metrics`` and ``GET /trace/recent.json`` when telemetry is on
  (the default, as in the JAX server; ``PIO_TELEMETRY=0`` turns it off);
* the write-behind ingest buffer (``ingest_mode`` ``durable`` or ``fast``,
  ``PIO_INGEST_BUFFER``): single-event POSTs coalesce into one
  ``insert_batch`` a group every ``PIO_INGEST_FLUSH_MS``; ``durable``
  answers 201 after the commit, ``fast`` 202 at once; a full buffer sheds
  503 with ``Retry-After``; ``GET /ingest/stats.json``;
* the fast-ack WAL (``wal_dir``/``PIO_WAL_DIR``, fast mode): each event is
  journaled before its 202 and replayed at the next start;
* every committed write bumps the serving result cache's invalidation
  generations (``result_cache.notify_event``; a delete,
  ``notify_delete``) and, under ``PIO_STREAMING=1``, feeds a bounded ring
  of committed events and the delta sinks
  (:meth:`EventServer.enable_delta_publisher`: committed events fold into
  sealed micro-generation deltas, ``core/delta.py``);
* ``drain()`` (SIGTERM, ``POST /stop``): refuse new writes, fold what the
  publisher holds, flush the buffer and the WAL within
  ``PIO_DRAIN_TIMEOUT_MS``, close the event writer, stop listening.

``POST /webhooks/<name>.json|.form`` turns a third-party payload into an
event through the registered connector (``data/webhooks/``: segmentio,
mailchimp and the two examples); ``GET`` on the same path probes that the
connector exists (parity: ``EventServer.scala:442-505``).
"""

from __future__ import annotations

import base64
import collections
import logging
import os
import threading
import time
from typing import Optional

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.core import delta as _delta
from predictionio_tpu_torch.data.api.ingest_buffer import BufferFull, IngestBuffer, wal_decode
from predictionio_tpu_torch.data.api.stats import Stats
from predictionio_tpu_torch.data.api.wal import WriteAheadLog
from predictionio_tpu_torch.data.event import Event, parse_time_or_none
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.webhooks.connector import (
    ConnectorError,
    connector_to_event,
    get_form_connector,
    get_json_connector,
)
from predictionio_tpu_torch.obs import bridges as _bridges
from predictionio_tpu_torch.serving.result_cache import notify_delete, notify_event

logger = logging.getLogger(__name__)

MAX_BATCH_SIZE = 50  # parity default: EventServer.scala:66


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError, TypeError):
        return default


class EventServerPlugin:
    """Parity: data/.../api/EventServerPlugin.scala."""

    INPUT_BLOCKER = "inputblocker"
    INPUT_SNIFFER = "inputsniffer"

    name = "plugin"
    plugin_type = INPUT_SNIFFER

    def process(self, event_info: dict, context: dict) -> None:
        """Blockers raise to reject the event; sniffers observe."""


class EventServer:
    def __init__(
        self,
        storage: Optional[Storage] = None,
        stats: bool = False,
        plugins: Optional[list[EventServerPlugin]] = None,
        ingest_mode: Optional[str] = None,
        ingest_flush_ms: Optional[float] = None,
        ingest_buffer_max: Optional[int] = None,
        telemetry: bool = True,
        wal_dir: Optional[str] = None,
        drain_timeout_ms: Optional[float] = None,
    ):
        mode = ingest_mode if ingest_mode is not None else os.environ.get(
            "PIO_INGEST_BUFFER", "off"
        )
        if mode not in ("off", "durable", "fast"):
            raise ValueError(f"ingest mode must be off|durable|fast, got {mode!r}")
        self.ingest_mode = mode
        self.storage = storage or Storage.instance()
        self.stats_enabled = stats
        self.stats = Stats()
        self.plugins = list(plugins or [])
        self.max_batch_size = _env_num("PIO_MAX_BATCH_SIZE", MAX_BATCH_SIZE, int)
        self.drain_timeout_ms = (
            drain_timeout_ms if drain_timeout_ms is not None
            else _env_num("PIO_DRAIN_TIMEOUT_MS", 5000.0, float)
        )
        self._draining = False
        self._stopped = False
        # drain() is reachable from SIGTERM, POST /stop and stop(): the flag
        # and the counters share one lock across those threads
        self._drain_lock = threading.Lock()
        self._drain_counts = {"drains": 0, "drained_events": 0, "abandoned_events": 0}
        # streaming micro-generations (PIO_STREAMING=1): committed-event
        # sinks beside the cache hook, and a bounded ring of recently
        # committed events, so a publisher attached after construction still
        # sees every acked event. Built BEFORE the WAL replay below, which
        # commits through _notify_committed and so feeds the ring.
        self._delta_sinks: list = []
        # guards the ring's extend and the sinks' snapshot against attach:
        # every committed event lands in exactly one of {attach backlog,
        # live dispatch}
        self._sink_lock = threading.Lock()
        self._delta_publisher = None
        self._delta_flush_stop = threading.Event()
        self._delta_flush_thread: Optional[threading.Thread] = None
        self._recent_committed = (
            collections.deque(maxlen=max(4096, _env_num("PIO_DELTA_MAX_EVENTS", 512, int) * 8))
            if _delta.streaming_enabled() else None
        )
        # fast-ack WAL: journaled before the 202, replayed at startup
        self.wal: Optional[WriteAheadLog] = None
        self.wal_replayed = 0
        wal_dir = wal_dir if wal_dir is not None else os.environ.get("PIO_WAL_DIR")
        if mode == "fast" and wal_dir:
            self.wal = WriteAheadLog(wal_dir)
            self.wal_replayed = self._replay_wal()
        self.ingest_buffer: Optional[IngestBuffer] = None
        if mode != "off":
            self.ingest_buffer = IngestBuffer(
                self.storage.get_l_events(),
                flush_ms=(
                    ingest_flush_ms if ingest_flush_ms is not None
                    else _env_num("PIO_INGEST_FLUSH_MS", 5.0, float)
                ),
                buffer_max=(
                    ingest_buffer_max if ingest_buffer_max is not None
                    else _env_num("PIO_INGEST_BUFFER_MAX", 10_000, int)
                ),
                durable_ack=(mode == "durable"),
                wal=self.wal,
                on_commit=self._notify_committed,
            )
        self.service = HttpService("eventserver")
        # /metrics + /trace/recent.json, and the bridges that put the
        # ingestion stats behind the one registry
        self.telemetry = (
            obs.Telemetry("eventserver").install(self.service)
            if telemetry and obs.telemetry_enabled()
            else None
        )
        if self.telemetry is not None:
            self._register_metrics()
        self._register_routes()

    def _replay_wal(self) -> int:
        """Re-insert what a previous incarnation journaled but never
        flush-committed. Ids were pinned at submit, so replaying a record
        whose flush did land rewrites the same row. A replay that cannot
        reach storage keeps its segments for the next start."""
        records = self.wal.replay()
        if not records:
            return 0
        groups: dict[tuple, list] = {}
        bad = 0
        for payload in records:
            try:
                event, app_id, channel_id = wal_decode(payload)
            except Exception:
                bad += 1
                continue
            groups.setdefault((app_id, channel_id), []).append(event)
        le = self.storage.get_l_events()
        replayed = 0
        try:
            for (app_id, channel_id), events in groups.items():
                le.init(app_id, channel_id)
                le.insert_batch(events, app_id, channel_id)
                self._notify_committed(events)
                replayed += len(events)
        except Exception:
            logger.exception(
                "WAL replay failed after %d events; segments retained for the next startup",
                replayed,
            )
            return replayed
        self.wal.reclaim_replayed()
        if bad:
            logger.warning("WAL replay skipped %d undecodable records", bad)
        logger.info("WAL replay restored %d fast-acked events", replayed)
        return replayed

    def _register_metrics(self) -> None:
        reg = self.telemetry.registry
        _bridges.bridge_event_stats(reg, self.stats)
        reg.gauge_fn(
            "pio_stats_enabled",
            "1 when per-app ingestion stats collection is on.",
            lambda: 1.0 if self.stats_enabled else 0.0,
        )
        reg.gauge_fn(
            "pio_ingest_buffer_enabled",
            "1 when the group-commit write-behind buffer is active.",
            lambda: 0.0 if self.ingest_buffer is None else 1.0,
        )
        if self.ingest_buffer is not None:
            _bridges.bridge_ingest_buffer(reg, self.ingest_buffer.stats)
        reg.gauge_fn(
            "pio_draining",
            "1 while the server is draining toward shutdown.",
            lambda: 1.0 if self._draining else 0.0,
        )
        reg.gauge_fn(
            "pio_drain_drained_events",
            "Buffered events flushed to storage by graceful drains.",
            lambda: float(self._drain_counts["drained_events"]),
        )
        reg.gauge_fn(
            "pio_drain_abandoned_events",
            "Buffered events abandoned when a drain budget lapsed.",
            lambda: float(self._drain_counts["abandoned_events"]),
        )
        reg.gauge_fn(
            "pio_wal_replayed_on_start",
            "Fast-acked events restored from the WAL at startup.",
            lambda: float(self.wal_replayed),
        )
        # a network-backed storage carries the retry/breaker client
        storage_rs = getattr(self.storage, "resilience_stats", None)
        if callable(storage_rs):
            _bridges.bridge_resilience(reg, storage_rs)

        def _delta_families():
            # only while a publisher is live (PIO_STREAMING=1 and
            # enable_delta_publisher called)
            pub = self._delta_publisher
            if pub is None:
                return []
            s = pub.stats()
            F = _bridges.Family
            return [
                F("pio_delta_sealed_total", "counter",
                  "Micro-generation deltas sealed into the log.",
                  [("", (), float(s["sealed"]))]),
                F("pio_delta_seal_refused_total", "counter",
                  "Fold-ins quarantined before sealing (quality gate, empty fold).",
                  [("", (), float(s["seal_refused"]))]),
                F("pio_delta_events_folded_total", "counter",
                  "Committed events folded into sealed deltas.",
                  [("", (), float(s["events_folded"]))]),
                F("pio_delta_unknown_users_total", "counter",
                  "Events skipped because the user is not in the base "
                  "generation (waits for the next full retrain).",
                  [("", (), float(s["unknown_users"]))]),
                F("pio_delta_dedup_skipped_total", "counter",
                  "Replayed committed events skipped because their id "
                  "already folded into a sealed epoch (exactly-once "
                  "fold across WAL/ring replay).",
                  [("", (), float(s["dedup_skipped"]))]),
                F("pio_delta_pending_events", "gauge",
                  "Committed events buffered toward the next fold.",
                  [("", (), float(s["pending"]))]),
                F("pio_delta_log_epoch", "gauge",
                  "Newest epoch sealed in the publisher's delta log.",
                  [("", (), float(s["log_epoch"]))]),
            ]

        reg.register_collector(_delta_families)

    def _notify_committed(self, events: list) -> None:
        """Committed writes → serving-cache invalidation bumps, the ring
        and the delta sinks. Called at commit time on every write path
        (direct, batch, buffer flush, WAL replay) with each event's stored
        id; never allowed to fail a write that already landed."""
        try:
            for event in events:
                notify_event(event)
        except Exception:
            logger.exception("cache-invalidation hook failed; TTL backstop bounds staleness")
        with self._sink_lock:
            if self._recent_committed is not None:
                self._recent_committed.extend(events)
            sinks = tuple(self._delta_sinks)
        for sink in sinks:
            # a sink failure never fails a landed write: the events stay
            # durable in storage for the next fold
            try:
                sink(events)
            except Exception:
                logger.exception("delta sink failed; events remain durable in storage")

    # -- streaming micro-generations (PIO_STREAMING=1) ---------------------
    def attach_delta_sink(self, sink, replay_recent: bool = True) -> None:
        """Register a committed-event sink. ``replay_recent`` first feeds it
        the ring of events committed before it attached (the WAL replay in
        ``__init__``, early writes). The ring's snapshot and the sink's
        append share one ``_sink_lock`` section with ``_notify_committed``:
        an event committed meanwhile is in the snapshot or dispatched live,
        never neither, never both."""
        backlog: list = []
        with self._sink_lock:
            if replay_recent and self._recent_committed:
                backlog = list(self._recent_committed)
            self._delta_sinks.append(sink)
        if backlog:
            try:
                sink(backlog)
            except Exception:
                logger.exception("delta sink failed replaying %d committed events", len(backlog))

    def enable_delta_publisher(self, model, delta_dir: Optional[str] = None,
                               on_receipt=None, **publisher_kw):
        """Fold committed events into sealed micro-generation deltas.

        Does nothing (returns None) unless ``PIO_STREAMING=1``. ``model`` is
        the event plane's own copy of the deployed base generation; its
        fingerprint routes the log to ``<delta_dir>/<fingerprint>/``, where
        the replicas of that base look. Starts the flush worker (pace
        ``PIO_DELTA_FLUSH_MS``; a fold also runs inline once
        ``PIO_DELTA_MAX_EVENTS`` are pending).
        """
        if not _delta.streaming_enabled():
            return None
        fp = _delta.model_fingerprint(model.user_factors, model.item_factors)
        directory = delta_dir or _delta.delta_dir_for(fp)
        pub = _delta.DeltaPublisher(
            model, _delta.DeltaLog(directory), on_receipt=on_receipt, **publisher_kw
        )
        # one rebind, before the flush worker starts: sinks and metrics
        # read None or the finished publisher
        # pio: ignore[race-unguarded-rebind]
        self._delta_publisher = pub
        self.attach_delta_sink(pub.on_committed)
        self._delta_flush_stop.clear()
        t = threading.Thread(target=self._delta_loop, name="eventserver-delta-flush", daemon=True)
        self._delta_flush_thread = t
        t.start()
        logger.info("delta publisher enabled: base %s, log %s", fp, directory)
        return pub

    def _delta_loop(self) -> None:
        """Delta flush worker: paces on ``PIO_DELTA_FLUSH_MS`` and hands the
        fold, gate and seal to the publisher."""
        pace_s = _env_num("PIO_DELTA_FLUSH_MS", 250.0, float) / 1e3
        while not self._delta_flush_stop.is_set():
            self._delta_flush_stop.wait(pace_s)
            if self._delta_flush_stop.is_set():
                return
            self._delta_flush_once()

    def _delta_flush_once(self) -> None:
        pub = self._delta_publisher
        if pub is None:
            return
        try:
            pub.flush()
        except Exception:
            logger.exception("delta flush failed; events remain buffered")

    # -- auth (parity: withAccessKey, EventServer.scala:92-130) ------------
    def _authenticate(self, req: Request) -> tuple[Optional[dict], Optional[Response]]:
        key = req.params.get("accessKey")
        if not key:
            auth = req.headers.get("Authorization", "")
            if auth.startswith("Basic "):
                try:
                    key = base64.b64decode(auth[6:]).decode("utf-8").split(":", 1)[0]
                except Exception:
                    key = None
        if not key:
            return None, json_response(401, {"message": "Missing accessKey."})
        access_key = self.storage.get_meta_data_access_keys().get(key)
        if access_key is None:
            return None, json_response(401, {"message": "Invalid accessKey."})
        channel_id = None
        if "channel" in req.params:
            channels = self.storage.get_meta_data_channels().get_by_app_id(access_key.app_id)
            match = [c for c in channels if c.name == req.params["channel"]]
            if not match:
                return None, json_response(400, {"message": "Invalid channel."})
            channel_id = match[0].id
        return (
            {
                "app_id": access_key.app_id,
                "channel_id": channel_id,
                "events_allowed": access_key.events,
            },
            None,
        )

    def _check_event_allowed(self, auth: dict, event_name: str) -> Optional[Response]:
        allowed = auth["events_allowed"]
        if allowed and event_name not in allowed:
            return json_response(403, {"message": f"{event_name} events are not allowed"})
        return None

    def _run_plugins(self, event: Event, auth: dict) -> Optional[Response]:
        info = {"event": event.to_dict(), "appId": auth["app_id"]}
        for p in self.plugins:
            if p.plugin_type == EventServerPlugin.INPUT_BLOCKER:
                try:
                    p.process(info, {})
                except Exception as e:
                    return json_response(403, {"message": f"blocked: {e}"})
        for p in self.plugins:
            if p.plugin_type == EventServerPlugin.INPUT_SNIFFER:
                try:
                    p.process(info, {})
                except Exception:
                    logger.exception("sniffer plugin %s failed", p.name)
        return None

    def _admit(self, auth: dict, event: Event) -> Optional[Response]:
        """The whitelist, then the plugins: a refusal, or None to write."""
        denied = self._check_event_allowed(auth, event.event)
        return denied if denied is not None else self._run_plugins(event, auth)

    def _insert(self, auth: dict, data: dict) -> Response:
        try:
            event = Event.from_dict(data)
        except (ValueError, KeyError, TypeError) as e:
            self.stats_update(auth, str(data.get("event", "")), 400)
            return json_response(400, {"message": str(e)})
        return self._insert_event(auth, event)

    def _insert_event(self, auth: dict, event: Event) -> Response:
        denied = self._admit(auth, event)
        if denied is not None:
            self.stats_update(auth, event.event, denied.status)
            return denied
        le = self.storage.get_l_events()
        le.init(auth["app_id"], auth["channel_id"])
        event_id = le.insert(event, auth["app_id"], auth["channel_id"])
        self._notify_committed([event.with_id(event_id)])
        self.stats_update(auth, event.event, 201)
        return json_response(201, {"eventId": event_id})

    def _insert_buffered(self, auth: dict, data: dict) -> Response:
        """A single-event POST through the write-behind buffer: validation
        and plugins run inline (a refused event is never buffered), the
        commit coalesces with its neighbours' in the flusher."""
        try:
            event = Event.from_dict(data)
        except (ValueError, KeyError, TypeError) as e:
            self.stats_update(auth, str(data.get("event", "")), 400)
            return json_response(400, {"message": str(e)})
        denied = self._admit(auth, event)
        if denied is not None:
            self.stats_update(auth, event.event, denied.status)
            return denied
        try:
            ticket = self.ingest_buffer.submit(event, auth["app_id"], auth["channel_id"])
        except BufferFull as e:
            # backpressure is visible: the shedding contract's 503
            self.stats_update(auth, event.event, 503)
            return Response(
                503,
                {"message": "ingest buffer full; retry later"},
                headers={"Retry-After": f"{max(e.retry_after_s, 1e-3):g}"},
            )
        if not self.ingest_buffer.durable_ack:
            # fast ack: buffered (and journaled), not yet committed: 202
            self.stats_update(auth, event.event, 202)
            return json_response(202, {"eventId": ticket.event_id})
        if not ticket.wait(30.0):
            self.stats_update(auth, event.event, 503)
            return Response(
                503,
                {"message": "ingest flush timed out; retry later"},
                headers={"Retry-After": "1"},
            )
        if ticket.error is not None:
            self.stats_update(auth, event.event, 500)
            return json_response(500, {"message": str(ticket.error)})
        self.stats_update(auth, event.event, 201)
        return json_response(201, {"eventId": ticket.event_id})

    def _insert_batch(self, auth: dict, items: list) -> list[dict]:
        """Decode and admit every item, then write the admitted ones with
        one ``insert_batch``; a status per item, as the reference answers
        (parity: EventServer.scala:340-419)."""
        results: list[Optional[dict]] = [None] * len(items)
        pending: list[tuple[int, Event]] = []
        for i, item in enumerate(items):
            if not isinstance(item, dict):
                results[i] = {"status": 400, "message": "not a JSON object"}
                continue
            try:
                event = Event.from_dict(item)
            except (ValueError, KeyError, TypeError) as e:
                self.stats_update(auth, str(item.get("event", "")), 400)
                results[i] = {"status": 400, "message": str(e)}
                continue
            denied = self._admit(auth, event)
            if denied is not None:
                self.stats_update(auth, event.event, denied.status)
                results[i] = {**denied.body, "status": denied.status}
                continue
            pending.append((i, event))
        if not pending:
            return results
        app_id, channel_id = auth["app_id"], auth["channel_id"]
        le = self.storage.get_l_events()
        le.init(app_id, channel_id)
        try:
            ids = le.insert_batch([e for _, e in pending], app_id, channel_id)
        except Exception as e:
            # a poison event or a storage fault: write item by item so the
            # good ones still land (partial success is the contract)
            logger.warning("insert_batch failed (%s); retrying items singly", e)
            ids = None
        for n, (i, event) in enumerate(pending):
            if ids is not None:
                eid = ids[n]
            else:
                try:
                    eid = le.insert(event, app_id, channel_id)
                except Exception as e:
                    self.stats_update(auth, event.event, 500)
                    results[i] = {"status": 500, "message": str(e)}
                    continue
            self.stats_update(auth, event.event, 201)
            results[i] = {"eventId": eid, "status": 201}
            # with the stored id: the delta publisher dedupes replays by it
            self._notify_committed([event.with_id(eid)])
        return results

    def stats_update(self, auth: dict, event_name: str, status: int) -> None:
        if self.stats_enabled:
            self.stats.update(auth["app_id"], event_name, status)

    # -- routes ---------------------------------------------------------------
    def _register_routes(self):
        svc = self.service

        @svc.route("GET", r"/")
        def index(req):
            return json_response(200, {"status": "alive"})

        @svc.route("GET", r"/healthz")
        def healthz(req):
            return json_response(200, {"status": "ok"})

        @svc.route("GET", r"/readyz")
        def readyz(req):
            if self._draining:
                return Response(503, {"status": "draining"}, headers={"Retry-After": "1"})
            return json_response(200, {"status": "ready"})

        @svc.route("POST", r"/stop")
        def stop_route(req):
            threading.Thread(target=self._delayed_drain, daemon=True).start()
            return json_response(202, {"message": "draining"})

        @svc.route("POST", r"/events\.json")
        def create_event(req):
            if self._draining:
                return self._draining_response()
            auth, err = self._authenticate(req)
            if err:
                return err
            data = req.json()
            if not isinstance(data, dict):
                return json_response(400, {"message": "request body must be a JSON object"})
            if self.ingest_buffer is not None:
                return self._insert_buffered(auth, data)
            return self._insert(auth, data)

        @svc.route("GET", r"/events\.json")
        def find_events(req):
            auth, err = self._authenticate(req)
            if err:
                return err
            p = req.params
            try:
                limit = int(p.get("limit", 20))
            except ValueError:
                return json_response(400, {"message": "limit must be an integer"})
            if p.get("reversed") == "true" and not (p.get("entityType") and p.get("entityId")):
                # parity: EventServer.scala:299-302
                return json_response(400, {
                    "message": "the parameter reversed can only be used "
                    "with both entityType and entityId specified."
                })
            try:
                events = self.storage.get_l_events().find(
                    auth["app_id"],
                    channel_id=auth["channel_id"],
                    start_time=parse_time_or_none(p.get("startTime")),
                    until_time=parse_time_or_none(p.get("untilTime")),
                    entity_type=p.get("entityType"),
                    entity_id=p.get("entityId"),
                    event_names=p["event"].split(",") if "event" in p else None,
                    target_entity_type=p.get("targetEntityType"),
                    target_entity_id=p.get("targetEntityId"),
                    limit=limit,
                    reversed=p.get("reversed") == "true",
                )
            except ValueError as e:
                return json_response(400, {"message": str(e)})
            out = [e.to_dict() for e in events]
            if not out:
                return json_response(404, {"message": "Not Found"})
            return json_response(200, out)

        @svc.route("GET", r"/events/(?P<eid>[^/]+)\.json")
        def get_event(req):
            auth, err = self._authenticate(req)
            if err:
                return err
            e = self.storage.get_l_events().get(
                req.match.group("eid"), auth["app_id"], auth["channel_id"]
            )
            if e is None:
                return json_response(404, {"message": "Not Found"})
            return json_response(200, e.to_dict())

        @svc.route("DELETE", r"/events/(?P<eid>[^/]+)\.json")
        def delete_event(req):
            auth, err = self._authenticate(req)
            if err:
                return err
            found = self.storage.get_l_events().delete(
                req.match.group("eid"), auth["app_id"], auth["channel_id"]
            )
            if not found:
                return json_response(404, {"message": "Not Found"})
            notify_delete()
            return json_response(200, {"message": "Found"})

        @svc.route("POST", r"/batch/events\.json")
        def batch_events(req):
            if self._draining:
                return self._draining_response()
            auth, err = self._authenticate(req)
            if err:
                return err
            data = req.json()
            if not isinstance(data, list):
                return json_response(400, {"message": "request body must be a JSON array"})
            if len(data) > self.max_batch_size:
                return json_response(400, {
                    "message": "Batch request must have less than or equal to "
                    f"{self.max_batch_size} events"
                })
            return json_response(200, self._insert_batch(auth, data))

        @svc.route("GET", r"/ingest/stats\.json")
        def ingest_stats(req):
            auth, err = self._authenticate(req)
            if err:
                return err
            if self.ingest_buffer is None:
                return json_response(200, {"mode": "off"})
            out = self.ingest_buffer.stats()
            out["drain"] = dict(self._drain_counts)
            if self.wal is not None:
                out.setdefault("wal", self.wal.stats())
                out["wal"]["replayed_on_start"] = self.wal_replayed
            return json_response(200, out)

        @svc.route("GET", r"/stats\.json")
        def stats_route(req):
            if not self.stats_enabled:
                return json_response(
                    404, {"message": "To see stats, launch the server with stats enabled."}
                )
            if not (req.params.get("accessKey") or req.headers.get("Authorization")):
                # no app scope asked for: the cross-app readout
                return json_response(200, self.stats.get_all())
            auth, err = self._authenticate(req)
            if err:
                return err
            return json_response(200, self.stats.get(auth["app_id"]))

        def webhook_route(kind: str, lookup, payload):
            @svc.route("POST", rf"/webhooks/(?P<name>[^/]+)\.{kind}")
            def webhook(req):
                auth, err = self._authenticate(req)
                if err:
                    return err
                connector = lookup(req.match.group("name"))
                if connector is None:
                    return json_response(404, {"message": "Not Found"})
                try:
                    event = connector_to_event(connector, payload(req))
                except (ConnectorError, ValueError, KeyError) as e:
                    return json_response(400, {"message": str(e)})
                return self._insert_event(auth, event)

            @svc.route("GET", rf"/webhooks/(?P<name>[^/]+)\.{kind}")
            def webhook_probe(req):
                auth, err = self._authenticate(req)
                if err:
                    return err
                if lookup(req.match.group("name")) is None:
                    return json_response(404, {"message": "Not Found"})
                return json_response(200, {"message": "Ok"})

        webhook_route("json", get_json_connector, lambda req: req.json() or {})
        webhook_route("form", get_form_connector, lambda req: req.form())

    # -- lifecycle --------------------------------------------------------------
    def start(
        self,
        host: str = "0.0.0.0",
        port: int = 7070,
        cert_path: Optional[str] = None,
        key_path: Optional[str] = None,
    ) -> int:
        actual = self.service.start(host, port, cert_path=cert_path, key_path=key_path)
        logger.info("event server listening on %s:%s", host, actual)
        return actual

    def _draining_response(self) -> Response:
        return Response(
            503,
            {"message": "server draining; retry against another instance"},
            headers={"Retry-After": "1"},
        )

    def _delayed_drain(self) -> None:
        # let the POST /stop response leave the socket first
        time.sleep(0.3)
        self.drain()

    def drain(self, timeout_ms: Optional[float] = None) -> bool:
        """Graceful shutdown: refuse new writes, fold what the delta
        publisher holds, flush the buffer and the WAL within the budget
        (``PIO_DRAIN_TIMEOUT_MS``), close the event writer and stop
        listening. Returns True when nothing was abandoned."""
        budget_s = (timeout_ms if timeout_ms is not None else self.drain_timeout_ms) / 1e3
        with self._drain_lock:
            if self._stopped:
                return True
            self._draining = True
            self._drain_counts["drains"] += 1
        clean = True
        # the flush worker first, then one last fold, so buffered events
        # still seal before the buffer and the WAL close under them
        self._delta_flush_stop.set()
        self._delta_flush_once()
        if self.ingest_buffer is not None:
            before = self.ingest_buffer.stats()["buffered"]
            drained = self.ingest_buffer.close(timeout=max(budget_s, 0.0))
            left = self.ingest_buffer.stats()["buffered"]
            with self._drain_lock:
                self._drain_counts["drained_events"] += max(before - left, 0)
            if not drained or left:
                with self._drain_lock:
                    self._drain_counts["abandoned_events"] += left
                logger.warning(
                    "drain budget (%.0fms) lapsed with %d events unflushed",
                    budget_s * 1e3, left,
                )
                clean = False
        if self.wal is not None:
            self.wal.close()
        try:
            self.storage.get_l_events().close()
        except Exception:
            logger.exception("LEvents close failed during drain")
        self.service.stop()
        with self._drain_lock:
            self._stopped = True
        return clean

    def stop(self) -> None:
        """Shutdown with the drain's semantics: every acked event is
        flushed (budget permitting) before this returns."""
        if self._stopped:
            return
        self.drain()


def register_builtin_connectors() -> None:
    """The connectors the JAX package registers at import, under the same
    names (``/webhooks/segmentio.json``, ``/webhooks/mailchimp.form``, ...)."""
    from predictionio_tpu_torch.data.webhooks.connector import (
        register_form_connector,
        register_json_connector,
    )
    from predictionio_tpu_torch.data.webhooks.examples import (
        ExampleFormConnector,
        ExampleJsonConnector,
    )
    from predictionio_tpu_torch.data.webhooks.mailchimp import MailChimpConnector
    from predictionio_tpu_torch.data.webhooks.segmentio import SegmentIOConnector

    register_json_connector("segmentio", SegmentIOConnector())
    register_form_connector("mailchimp", MailChimpConnector())
    register_json_connector("examplejson", ExampleJsonConnector())
    register_form_connector("exampleform", ExampleFormConnector())


register_builtin_connectors()
