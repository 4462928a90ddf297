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
* every committed write bumps the serving result cache's invalidation
  generations (``result_cache.notify_event``; a delete,
  ``notify_delete``), as the JAX server does;
* ``drain()`` (SIGTERM, ``POST /stop``): refuse new writes, close the
  event writer, stop listening.

Not ported yet, and raising an error that names the ROADMAP item that
brings them when asked for: the write-behind ingest buffer (an
``ingest_mode`` other than ``"off"``) and its WAL, and webhooks (item 14);
``PIO_STREAMING=1``, whose delta sinks and publisher the port lacks
(item 8).
"""

from __future__ import annotations

import base64
import logging
import os
import threading
import time
from typing import Optional

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.data.api.stats import Stats
from predictionio_tpu_torch.data.event import Event, parse_time_or_none
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import bridges as _bridges
from predictionio_tpu_torch.serving.result_cache import notify_delete, notify_event

logger = logging.getLogger(__name__)

MAX_BATCH_SIZE = 50  # parity default: EventServer.scala:66


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to predictionio_tpu_torch yet (ROADMAP §1 item {item})"
    )


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
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
        telemetry: bool = True,
        wal_dir: Optional[str] = None,
    ):
        mode = ingest_mode if ingest_mode is not None else os.environ.get(
            "PIO_INGEST_BUFFER", "off"
        )
        if mode not in ("off", "durable", "fast"):
            raise ValueError(f"ingest mode must be off|durable|fast, got {mode!r}")
        if mode != "off":
            raise _not_ported(f"the write-behind ingest buffer ({mode!r})", 14)
        if wal_dir is not None:
            raise _not_ported("the fast-ack write-ahead log", 14)
        if os.environ.get("PIO_STREAMING", "0") == "1":
            raise _not_ported("streaming micro-generations (PIO_STREAMING=1)", 8)
        self.storage = storage or Storage.instance()
        self.stats_enabled = stats
        self.stats = Stats()
        self.plugins = list(plugins or [])
        self.max_batch_size = _env_int("PIO_MAX_BATCH_SIZE", MAX_BATCH_SIZE)
        self._draining = False
        self._stopped = False
        self._stop_lock = threading.Lock()
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
            lambda: 0.0,  # the buffer is ROADMAP §1 item 14
        )
        reg.gauge_fn(
            "pio_draining",
            "1 while the server is draining toward shutdown.",
            lambda: 1.0 if self._draining else 0.0,
        )

    @staticmethod
    def _notify_committed(events: list) -> None:
        """Committed writes → serving-cache invalidation bumps. Called at
        commit time on every write path; never allowed to fail a write
        that already landed."""
        try:
            for event in events:
                notify_event(event)
        except Exception:
            logger.exception("cache-invalidation hook failed; TTL backstop bounds staleness")

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
        denied = self._admit(auth, event)
        if denied is not None:
            self.stats_update(auth, event.event, denied.status)
            return denied
        le = self.storage.get_l_events()
        le.init(auth["app_id"], auth["channel_id"])
        event_id = le.insert(event, auth["app_id"], auth["channel_id"])
        self._notify_committed([event])
        self.stats_update(auth, event.event, 201)
        return json_response(201, {"eventId": event_id})

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
            self._notify_committed([event])
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

        @svc.route("POST", r"/webhooks/(?P<name>[^/]+)\.(?:json|form)")
        def webhook(req):
            raise _not_ported("webhook connectors", 14)

        @svc.route("GET", r"/webhooks/(?P<name>[^/]+)\.(?:json|form)")
        def webhook_probe(req):
            raise _not_ported("webhook connectors", 14)

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
        """Graceful shutdown: refuse new writes, close the event writer
        (checkpointing its WAL) and stop listening. Every write is
        committed before it is answered, so nothing acknowledged is left to
        flush and the budget ``timeout_ms`` is never needed: the JAX
        server's drain of a write-behind buffer comes with that buffer
        (item 14). Returns True: nothing is abandoned."""
        del timeout_ms
        with self._stop_lock:
            if self._stopped:
                return True
            self._draining = True
            self._stopped = True
        try:
            self.storage.get_l_events().close()
        except Exception:
            logger.exception("LEvents close failed during drain")
        self.service.stop()
        return True

    def stop(self) -> None:
        """Shutdown with the drain's semantics."""
        self.drain()
