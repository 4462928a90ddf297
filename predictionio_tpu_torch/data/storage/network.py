"""Networked client/server storage driver: one data plane, many hosts.

Copy of ``predictionio_tpu/data/storage/network.py`` for the port: the same
routes, npz wire formats, capability list and resilience policy, so a port
client and a JAX server (or the other way round) interoperate.

The reference's defining ops capability is services on different machines
sharing one storage backend (event server on host A, trainer on host B,
query server on host C, all reading the same Postgres/HBase/ES — see
``storage/jdbc/.../JDBCPEvents.scala:35-119``, ``storage/hbase/.../
HBEventsUtil.scala:83-135``, ``storage/s3/.../S3Models.scala``).  The project
carries no database server, so it ships its OWN storage service:

* :class:`StorageServer` — ``pio storageserver`` — exposes a backing local
  driver (sqlite/parquet/memory) through an HTTP DAO protocol.  One per
  deployment, next to the data.
* ``Network*`` client DAOs — driver type ``network`` — implement every DAO
  family over that protocol, so any ``PIO_STORAGE_*`` repository can point
  at a remote host:

  .. code-block:: bash

     PIO_STORAGE_SOURCES_REMOTE_TYPE=network
     PIO_STORAGE_SOURCES_REMOTE_URL=http://storage-host:7077
     PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=REMOTE

**Predicate pushdown** (parity: JDBCPEvents building SQL WHERE clauses):
every ``find``/``aggregate_properties`` ships its filters as JSON and the
server evaluates them next to the data — only matching rows cross the wire.
Bulk paths (``PEvents.find``/``write``/``find_interactions``) use a binary
columnar wire format (npz of the EventBatch/Interactions columns), not
per-row JSON, so training reads stream at disk speed.

**Model repository** (parity: the S3/HDFS Models role): model blobs move as
raw bytes (``/blob/models/<id>``), so a host that never trained can
``pio deploy`` by pulling from the storage server.

Auth: optional shared secret (``SECRET`` source attr ↔ ``--secret`` server
flag) checked on every request via the ``X-PIO-Storage-Secret`` header.
"""

from __future__ import annotations

import datetime as _dt
import http.client
import io
import json
import logging
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

import numpy as np

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.common import resilience
from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.data import bimap
from predictionio_tpu_torch.data.batch import EventBatch, Interactions
from predictionio_tpu_torch.data.event import Event, PropertyMap, parse_time_or_none
from predictionio_tpu_torch.data.storage import base

logger = logging.getLogger(__name__)

SECRET_HEADER = "X-PIO-Storage-Secret"


# ---------------------------------------------------------------------------
# wire (de)serialization
# ---------------------------------------------------------------------------


def _dt_to_wire(d: Optional[_dt.datetime]) -> Optional[str]:
    return d.isoformat() if d is not None else None


def _dt_from_wire(s: Optional[str]) -> Optional[_dt.datetime]:
    return parse_time_or_none(s) if s else None


def _instance_to_wire(obj: Any) -> dict:
    import dataclasses

    d = dataclasses.asdict(obj)
    for k in ("start_time", "end_time"):
        if k in d:
            d[k] = _dt_to_wire(d[k])
    return d


def _instance_from_wire(cls: type, d: dict) -> Any:
    d = dict(d)
    for k in ("start_time", "end_time"):
        if k in d:
            d[k] = _dt_from_wire(d[k])
    return cls(**d)


def _snapshots_to_wire(snaps: dict[str, PropertyMap]) -> dict:
    return {
        eid: {
            "fields": pm.to_dict(),
            "firstUpdated": _dt_to_wire(pm.first_updated),
            "lastUpdated": _dt_to_wire(pm.last_updated),
        }
        for eid, pm in snaps.items()
    }


def _snapshots_from_wire(d: dict) -> dict[str, PropertyMap]:
    return {
        eid: PropertyMap(
            v["fields"],
            first_updated=_dt_from_wire(v["firstUpdated"]),
            last_updated=_dt_from_wire(v["lastUpdated"]),
        )
        for eid, v in d.items()
    }


def _pack_str_col(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Object str-or-None column → ('<U' values, None mask) for npz.

    Vectorized: these run over every cell of every string column on the
    bulk PEvents path, so they must stay out of the Python interpreter.
    """
    arr = np.asarray(arr, dtype=object)
    mask = np.equal(arr, None).astype(bool)
    vals = np.where(mask, "", arr).astype(str)
    if vals.dtype.kind != "U":  # empty batch → float64 from np.array([])
        vals = vals.astype("<U1")
    return vals, mask


def _unpack_str_col(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    out = vals.astype(object)
    out[mask] = None
    return out


def batch_to_npz(batch: EventBatch) -> bytes:
    """EventBatch → npz bytes (columnar wire format, no pickling)."""
    def str_arr(items: list[str]) -> np.ndarray:
        a = np.array(items)
        return a if a.dtype.kind == "U" else a.astype("<U1")

    cols: dict[str, np.ndarray] = {
        "event_time": np.asarray(batch.event_time, dtype=np.float64),
        "creation_time": np.asarray(batch.creation_time, dtype=np.float64),
        "properties": str_arr([json.dumps(dict(p)) for p in batch.properties]),
        "tags": str_arr([json.dumps(list(t)) for t in batch.tags]),
    }
    for name in (
        "event", "entity_type", "entity_id", "target_entity_type",
        "target_entity_id", "event_id", "pr_id",
    ):
        vals, mask = _pack_str_col(getattr(batch, name))
        cols[name] = vals
        cols[name + "__mask"] = mask
    buf = io.BytesIO()
    np.savez_compressed(buf, **cols)
    return buf.getvalue()


def _slice_batch(b: EventBatch, s: int, e: int) -> EventBatch:
    """Row-range view (copies) for chunked wire transfer."""
    return EventBatch(
        event=b.event[s:e],
        entity_type=b.entity_type[s:e],
        entity_id=b.entity_id[s:e],
        target_entity_type=b.target_entity_type[s:e],
        target_entity_id=b.target_entity_id[s:e],
        event_time=b.event_time[s:e],
        properties=list(b.properties[s:e]),
        event_id=b.event_id[s:e],
        tags=list(b.tags[s:e]),
        pr_id=b.pr_id[s:e],
        creation_time=b.creation_time[s:e],
    )


def _concat_batches(parts: list[EventBatch]) -> EventBatch:
    if len(parts) == 1:
        return parts[0]
    return EventBatch(
        event=np.concatenate([p.event for p in parts]),
        entity_type=np.concatenate([p.entity_type for p in parts]),
        entity_id=np.concatenate([p.entity_id for p in parts]),
        target_entity_type=np.concatenate([p.target_entity_type for p in parts]),
        target_entity_id=np.concatenate([p.target_entity_id for p in parts]),
        event_time=np.concatenate([p.event_time for p in parts]),
        properties=[d for p in parts for d in p.properties],
        event_id=np.concatenate([p.event_id for p in parts]),
        tags=[t for p in parts for t in p.tags],
        pr_id=np.concatenate([p.pr_id for p in parts]),
        creation_time=np.concatenate([p.creation_time for p in parts]),
    )


# Content type marking a framed stream: 8-byte big-endian length prefix per
# npz frame. Framing is ours (not HTTP chunk boundaries) so proxies that
# re-chunk the transfer can't corrupt it, and an old server that ignores
# chunk_rows still interoperates (client falls back on the content type).
FRAMES_CONTENT_TYPE = "application/x-pio-frames"

# Wire features this server build speaks, advertised on ``GET /``. Clients
# consult the list before choosing a format — a pre-capability server simply
# has no list, which reads as "legacy wire only" with no error-text sniffing.
# "sharded_scan": find/find_interactions accept shard=(index, count) +
# shard_key pushdown (a pre-sharding server 400s LOUDLY on them — silently
# returning full data to every worker would duplicate ratings N×).
# "search_query": LEvents search + EngineInstances/EvaluationInstances
# query evaluate server-side; clients without the advertisement fall back
# to the base-class host-side filter over the legacy wire.
SERVER_CAPABILITIES = frozenset({"framed_scan", "sharded_scan", "search_query"})


def batch_from_npz(data: bytes) -> EventBatch:
    z = np.load(io.BytesIO(data), allow_pickle=False)

    def col(name: str) -> np.ndarray:
        return _unpack_str_col(z[name], z[name + "__mask"])

    return EventBatch(
        event=col("event"),
        entity_type=col("entity_type"),
        entity_id=col("entity_id"),
        target_entity_type=col("target_entity_type"),
        target_entity_id=col("target_entity_id"),
        event_time=z["event_time"],
        properties=[json.loads(s) for s in z["properties"]],
        event_id=col("event_id"),
        tags=[tuple(json.loads(s)) for s in z["tags"]],
        pr_id=col("pr_id"),
        creation_time=z["creation_time"],
    )


def interactions_to_npz(inter: Interactions) -> bytes:
    def id_table(m) -> np.ndarray:
        if m is None:
            return np.array([], dtype="<U1")
        inv = m.inverse
        a = np.array([inv[i] for i in range(len(m))])
        return a if a.dtype.kind == "U" else a.astype("<U1")

    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        user=inter.user, item=inter.item, rating=inter.rating, t=inter.t,
        user_ids=id_table(inter.user_map), item_ids=id_table(inter.item_map),
    )
    return buf.getvalue()


def interactions_from_npz(data: bytes) -> Interactions:
    z = np.load(io.BytesIO(data), allow_pickle=False)
    user_map = bimap.BiMap({str(s): i for i, s in enumerate(z["user_ids"])})
    item_map = bimap.BiMap({str(s): i for i, s in enumerate(z["item_ids"])})
    return Interactions(
        user=z["user"].astype(np.int32),
        item=z["item"].astype(np.int32),
        rating=z["rating"].astype(np.float32),
        t=z["t"].astype(np.float64),
        user_map=user_map,
        item_map=item_map,
    )


def _find_kwargs_from_wire(args: dict) -> dict:
    """JSON filter args → DAO find() kwargs (the pushed-down predicates)."""
    out = dict(args)
    for k in ("start_time", "until_time"):
        if out.get(k) is not None:
            out[k] = _dt_from_wire(out[k])
    return out


def _find_kwargs_to_wire(kwargs: dict) -> dict:
    out = {k: v for k, v in kwargs.items() if v is not None and k != "self"}
    for k in ("start_time", "until_time"):
        if k in out:
            out[k] = _dt_to_wire(out[k])
    if "event_names" in out:
        out["event_names"] = list(out["event_names"])
    return out


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class StorageServer:
    """HTTP face of a local Storage — the data-plane service other hosts dial.

    Parity role: the database server in the reference's topology (Postgres/
    HBase/ES).  Run via ``pio storageserver`` on the host that owns the data
    directory; every other host configures driver type ``network``.
    """

    def __init__(self, storage, secret: Optional[str] = None,
                 telemetry: bool = True):
        self.storage = storage
        self.secret = secret
        self.service = HttpService("storageserver")
        # /metrics + /trace/recent.json on the data plane too: an incoming
        # X-Request-Id (propagated by the client) samples here, so a slow
        # query's storage half shows up in THIS server's ring
        self.telemetry = (
            obs.Telemetry("storageserver").install(self.service)
            if telemetry and obs.telemetry_enabled()
            else None
        )
        self._register()

    # route helpers --------------------------------------------------------
    def _auth_ok(self, req: Request) -> bool:
        if self.secret is None:
            return True
        import hmac

        provided = req.headers.get(SECRET_HEADER) or ""
        return hmac.compare_digest(provided, self.secret)

    def _register(self) -> None:
        svc = self.service
        server = self

        def guarded(fn):
            def wrapped(req: Request):
                if not server._auth_ok(req):
                    return json_response(401, {"message": "invalid storage secret"})
                try:
                    return fn(req)
                except (KeyError, ValueError, TypeError) as e:
                    return json_response(400, {"message": str(e)})
            return wrapped

        @svc.route("GET", r"/")
        def index(req: Request):
            # health probe stays open; topology detail is for authed peers.
            # capabilities is protocol metadata, not topology: clients use it
            # to pick wire formats structurally instead of sniffing error text
            info = {
                "status": "alive",
                "service": "pio-storage-server",
                "capabilities": sorted(SERVER_CAPABILITIES),
            }
            if server._auth_ok(req):
                info["repositories"] = {
                    repo: {"source": src, "type": typ}
                    for repo, (src, typ) in
                    self.storage.repository_bindings().items()
                }
            return json_response(200, info)

        # -- LEvents -------------------------------------------------------
        @svc.route("POST", r"/levents/(\w+)")
        @guarded
        def levents(req: Request):
            method = req.match.group(1)
            args = req.json() or {}
            le = self.storage.get_l_events()
            app_id = int(args.pop("app_id"))
            channel_id = args.pop("channel_id", None)
            channel_id = int(channel_id) if channel_id is not None else None
            if method == "init":
                return json_response(200, {"result": le.init(app_id, channel_id)})
            if method == "remove":
                return json_response(200, {"result": le.remove(app_id, channel_id)})
            if method == "insert":
                e = Event.from_dict(args["event"])
                return json_response(200, {"result": le.insert(e, app_id, channel_id)})
            if method in ("insert_batch", "batch_insert"):
                # one framed request per batch (not N round trips); the
                # legacy wire name keeps pre-rename clients served
                evs = [Event.from_dict(d) for d in args["events"]]
                return json_response(
                    200, {"result": le.insert_batch(evs, app_id, channel_id)}
                )
            if method == "get":
                e = le.get(args["event_id"], app_id, channel_id)
                return json_response(
                    200, {"result": e.to_dict() if e is not None else None}
                )
            if method == "delete":
                return json_response(
                    200, {"result": le.delete(args["event_id"], app_id, channel_id)}
                )
            if method == "find":
                kwargs = _find_kwargs_from_wire(args)
                events = le.find(app_id, channel_id=channel_id, **kwargs)
                return json_response(
                    200, {"result": [e.to_dict() for e in events]}
                )
            if method == "search":
                # the ES query-string role: evaluated next to the backing
                # store (sqlite pushes it into SQL); matches-only wire
                text = args.pop("text")
                kwargs = _find_kwargs_from_wire(args)
                events = le.search(
                    app_id, text, channel_id=channel_id, **kwargs
                )
                return json_response(
                    200, {"result": [e.to_dict() for e in events]}
                )
            if method == "aggregate_properties":
                kwargs = _find_kwargs_from_wire(args)
                snaps = le.aggregate_properties(
                    app_id, channel_id=channel_id, **kwargs
                )
                return json_response(200, {"result": _snapshots_to_wire(snaps)})
            return json_response(404, {"message": f"unknown LEvents method {method}"})

        # -- PEvents (binary columnar) --------------------------------------
        @svc.route("POST", r"/pevents/find")
        @guarded
        def pevents_find(req: Request):
            raw = req.json() or {}
            # chunked bulk pull (HBase bulk-scan role, HBEventsUtil.scala:
            # 83-135): the body streams as length-prefixed npz frames of
            # chunk_rows events each, so neither side ever holds one
            # multi-GB buffer and per-read timeouts replace a whole-body
            # deadline
            chunk_rows = int(raw.pop("chunk_rows", 0) or 0)
            args = _find_kwargs_from_wire(raw)
            app_id = int(args.pop("app_id"))
            batch = self.storage.get_p_events().find(app_id, **args)
            if chunk_rows > 0:
                n = len(batch)
                # first frame built EAGERLY: serialization errors (bad
                # property values etc.) still surface as a guarded 400,
                # not a half-sent 200 with truncated frames
                first = batch_to_npz(_slice_batch(batch, 0, min(chunk_rows, n)))

                def frames():
                    yield len(first).to_bytes(8, "big") + first
                    for s in range(chunk_rows, n, chunk_rows):
                        payload = batch_to_npz(
                            _slice_batch(batch, s, min(s + chunk_rows, n))
                        )
                        yield len(payload).to_bytes(8, "big") + payload

                return Response(200, frames(), content_type=FRAMES_CONTENT_TYPE)
            return Response(
                200, batch_to_npz(batch), content_type="application/octet-stream"
            )

        @svc.route("POST", r"/pevents/interactions")
        @guarded
        def pevents_interactions(req: Request):
            args = req.json() or {}
            app_id = int(args.pop("app_id"))
            if "event_names" in args:
                args["event_names"] = list(args["event_names"])
            inter = self.storage.get_p_events().find_interactions(app_id, **args)
            return Response(
                200, interactions_to_npz(inter),
                content_type="application/octet-stream",
            )

        @svc.route("POST", r"/pevents/aggregate_properties")
        @guarded
        def pevents_aggregate(req: Request):
            args = _find_kwargs_from_wire(req.json() or {})
            app_id = int(args.pop("app_id"))
            snaps = self.storage.get_p_events().aggregate_properties(app_id, **args)
            return json_response(200, {"result": _snapshots_to_wire(snaps)})

        @svc.route("POST", r"/pevents/write")
        @guarded
        def pevents_write(req: Request):
            app_id = int(req.params["app_id"])
            channel_id = req.params.get("channel_id")
            channel_id = int(channel_id) if channel_id is not None else None
            batch = batch_from_npz(req.body)
            self.storage.get_p_events().write(list(batch), app_id, channel_id)
            return json_response(200, {"result": len(batch)})

        @svc.route("POST", r"/pevents/delete")
        @guarded
        def pevents_delete(req: Request):
            args = req.json() or {}
            app_id = int(args.pop("app_id"))
            channel_id = args.pop("channel_id", None)
            channel_id = int(channel_id) if channel_id is not None else None
            self.storage.get_p_events().delete(
                list(args["event_ids"]), app_id, channel_id
            )
            return json_response(200, {"result": True})

        # -- Models (binary blobs; the S3Models role) ----------------------
        @svc.route("POST", r"/blob/models/(.+)")
        @guarded
        def models_put(req: Request):
            model_id = urllib.parse.unquote(req.match.group(1))
            self.storage.get_model_data_models().insert(
                base.Model(id=model_id, models=req.body)
            )
            return json_response(200, {"result": True})

        @svc.route("GET", r"/blob/models/(.+)")
        @guarded
        def models_get(req: Request):
            model_id = urllib.parse.unquote(req.match.group(1))
            m = self.storage.get_model_data_models().get(model_id)
            if m is None:
                return json_response(404, {"message": "model not found"})
            return Response(200, m.models, content_type="application/octet-stream")

        @svc.route("DELETE", r"/blob/models/(.+)")
        @guarded
        def models_delete(req: Request):
            model_id = urllib.parse.unquote(req.match.group(1))
            self.storage.get_model_data_models().delete(model_id)
            return json_response(200, {"result": True})

        # -- meta-data DAOs (generic JSON RPC) ------------------------------
        @svc.route("POST", r"/meta/(\w+)/(\w+)")
        @guarded
        def meta(req: Request):
            dao_name, method = req.match.group(1), req.match.group(2)
            args = req.json() or {}
            handler = _META_HANDLERS.get((dao_name, method))
            if handler is None:
                return json_response(
                    404, {"message": f"unknown meta call {dao_name}.{method}"}
                )
            return json_response(200, {"result": handler(self.storage, args)})

    # lifecycle ------------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 7077,
              allow_insecure: bool = False, **tls) -> int:
        if self.secret is None and not allow_insecure and host not in (
            "127.0.0.1", "localhost", "::1"
        ):
            # deploy unpickles model blobs pulled from this server, so an
            # open storage plane is remote code execution on serving hosts
            raise ValueError(
                "refusing to serve storage on a non-loopback interface "
                "without a --secret (model blobs are executable on deploy); "
                "pass allow_insecure=True only on a trusted network"
            )
        actual = self.service.start(host, port, **tls)
        logger.info("storage server listening on %s:%s", host, actual)
        return actual

    def stop(self) -> None:
        self.service.stop()

    def serve_forever(self) -> None:
        self.service.serve_forever()


def _apps(s):
    return s.get_meta_data_apps()


def _keys(s):
    return s.get_meta_data_access_keys()


def _channels(s):
    return s.get_meta_data_channels()


def _eng(s):
    return s.get_meta_data_engine_instances()


def _ev(s):
    return s.get_meta_data_evaluation_instances()


def _app_to_wire(a: Optional[base.App]):
    return None if a is None else {"id": a.id, "name": a.name, "description": a.description}


def _key_to_wire(k: Optional[base.AccessKey]):
    return None if k is None else {"key": k.key, "appId": k.app_id, "events": list(k.events)}


def _channel_to_wire(c: Optional[base.Channel]):
    return None if c is None else {"id": c.id, "name": c.name, "appId": c.app_id}


_META_HANDLERS = {
    # Apps
    ("apps", "insert"): lambda s, a: _apps(s).insert(base.App(**a["app"])),
    ("apps", "get"): lambda s, a: _app_to_wire(_apps(s).get(int(a["app_id"]))),
    ("apps", "get_by_name"): lambda s, a: _app_to_wire(_apps(s).get_by_name(a["name"])),
    ("apps", "get_all"): lambda s, a: [_app_to_wire(x) for x in _apps(s).get_all()],
    ("apps", "update"): lambda s, a: _apps(s).update(base.App(**a["app"])),
    ("apps", "delete"): lambda s, a: _apps(s).delete(int(a["app_id"])),
    # AccessKeys
    ("accesskeys", "insert"): lambda s, a: _keys(s).insert(
        base.AccessKey(key=a["key"], app_id=int(a["appId"]), events=list(a["events"]))
    ),
    ("accesskeys", "get"): lambda s, a: _key_to_wire(_keys(s).get(a["key"])),
    ("accesskeys", "get_all"): lambda s, a: [_key_to_wire(x) for x in _keys(s).get_all()],
    ("accesskeys", "get_by_app_id"): lambda s, a: [
        _key_to_wire(x) for x in _keys(s).get_by_app_id(int(a["app_id"]))
    ],
    ("accesskeys", "update"): lambda s, a: _keys(s).update(
        base.AccessKey(key=a["key"], app_id=int(a["appId"]), events=list(a["events"]))
    ),
    ("accesskeys", "delete"): lambda s, a: _keys(s).delete(a["key"]),
    # Channels
    ("channels", "insert"): lambda s, a: _channels(s).insert(
        base.Channel(id=int(a["id"]), name=a["name"], app_id=int(a["appId"]))
    ),
    ("channels", "get"): lambda s, a: _channel_to_wire(_channels(s).get(int(a["channel_id"]))),
    ("channels", "get_by_app_id"): lambda s, a: [
        _channel_to_wire(x) for x in _channels(s).get_by_app_id(int(a["app_id"]))
    ],
    ("channels", "delete"): lambda s, a: _channels(s).delete(int(a["channel_id"])),
    # EngineInstances
    ("engineinstances", "insert"): lambda s, a: _eng(s).insert(
        _instance_from_wire(base.EngineInstance, a["instance"])
    ),
    ("engineinstances", "get"): lambda s, a: (
        lambda i: None if i is None else _instance_to_wire(i)
    )(_eng(s).get(a["instance_id"])),
    ("engineinstances", "get_all"): lambda s, a: [
        _instance_to_wire(i) for i in _eng(s).get_all()
    ],
    ("engineinstances", "get_completed"): lambda s, a: [
        _instance_to_wire(i)
        for i in _eng(s).get_completed(
            a["engine_id"], a["engine_version"], a["engine_variant"]
        )
    ],
    ("engineinstances", "update"): lambda s, a: _eng(s).update(
        _instance_from_wire(base.EngineInstance, a["instance"])
    ),
    ("engineinstances", "delete"): lambda s, a: _eng(s).delete(a["instance_id"]),
    # the ES search-role query runs on the server, NEXT TO the backing
    # store (which may push it into SQL) — only matches cross the wire
    ("engineinstances", "query"): lambda s, a: [
        _instance_to_wire(i)
        for i in _eng(s).query(
            status=a.get("status"),
            engine_factory=a.get("engine_factory"),
            engine_variant=a.get("engine_variant"),
            since=_dt_from_wire(a.get("since")),
            until=_dt_from_wire(a.get("until")),
            text=a.get("text"),
            limit=a.get("limit"),
        )
    ],
    # EvaluationInstances
    ("evaluationinstances", "insert"): lambda s, a: _ev(s).insert(
        _instance_from_wire(base.EvaluationInstance, a["instance"])
    ),
    ("evaluationinstances", "get"): lambda s, a: (
        lambda i: None if i is None else _instance_to_wire(i)
    )(_ev(s).get(a["instance_id"])),
    ("evaluationinstances", "get_all"): lambda s, a: [
        _instance_to_wire(i) for i in _ev(s).get_all()
    ],
    ("evaluationinstances", "get_completed"): lambda s, a: [
        _instance_to_wire(i) for i in _ev(s).get_completed()
    ],
    ("evaluationinstances", "update"): lambda s, a: _ev(s).update(
        _instance_from_wire(base.EvaluationInstance, a["instance"])
    ),
    ("evaluationinstances", "delete"): lambda s, a: _ev(s).delete(a["instance_id"]),
    ("evaluationinstances", "query"): lambda s, a: [
        _instance_to_wire(i)
        for i in _ev(s).query(
            status=a.get("status"),
            evaluation_class=a.get("evaluation_class"),
            since=_dt_from_wire(a.get("since")),
            until=_dt_from_wire(a.get("until")),
            text=a.get("text"),
            limit=a.get("limit"),
        )
    ],
    # Sequences (ESSequences role): the backing DAO's atomicity makes the
    # networked counter cluster-wide — every client sees a unique value
    ("sequences", "gen_next"): lambda s, a: s.get_meta_data_sequences().gen_next(
        a["name"]
    ),
}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class NetworkStorageError(Exception):
    """Storage-wire failure; ``status`` carries the HTTP code (or None for
    transport errors) so callers can branch structurally, never on text."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _retryable(exc: BaseException) -> bool:
    """Transport faults (no HTTP status) and 5xx retry; 4xx and logical
    errors propagate — a structurally-bad request never earns a retry."""
    if isinstance(exc, NetworkStorageError):
        return exc.status is None or exc.status >= 500
    return False


class _Client:
    """Shared HTTP plumbing for all network DAOs of one source.

    Every request runs under the resilience policy layer
    (``common/resilience.py``): jittered-exponential retries with a global
    retry budget replace ad-hoc one-off retries, and a per-endpoint
    circuit breaker fails fast while a route is known-dead instead of
    burning a socket + timeout per call.  Retries are at-least-once:
    events are idempotent by eventId and meta/model writes are
    last-writer-wins, so a duplicate delivery is safe.
    """

    def __init__(self, source_name: str = "default", url: Optional[str] = None,
                 secret: Optional[str] = None, timeout: float = 60.0,
                 chunk_rows: int = 200_000, retries: int = 3,
                 backoff_ms: float = 50.0, breaker_threshold: int = 5,
                 breaker_reset_ms: float = 15_000.0,
                 retry_budget_ratio: float = 0.2):
        if not url:
            raise NetworkStorageError(
                f"network storage source {source_name!r} needs "
                f"PIO_STORAGE_SOURCES_{source_name}_URL"
            )
        self.url = url.rstrip("/")
        self.secret = secret
        # PIO_STORAGE_SOURCES_<N>_TIMEOUT: per-socket-read seconds (chunked
        # pulls reset it per frame); _CHUNK_ROWS: frame size for bulk
        # scans, 0 = single-body (legacy) wire; _RETRIES/_BACKOFF_MS/
        # _BREAKER_THRESHOLD/_BREAKER_RESET_MS/_RETRY_BUDGET_RATIO: the
        # resilience knobs (docs/operations.md "Resilience")
        self.timeout = float(timeout)
        self.chunk_rows = int(chunk_rows)
        self._caps: Optional[frozenset] = None
        self.policy = resilience.RetryPolicy(
            max_attempts=max(1, int(retries)),
            base_backoff_s=float(backoff_ms) / 1e3,
            budget=resilience.RetryBudget(ratio=float(retry_budget_ratio)),
        )
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_ms) / 1e3
        self._breakers: dict[str, resilience.CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self.retry_count = 0  # total retries performed (observability)
        self._rl_log = resilience.RateLimitedLogger(logger)

    def breaker_for(self, path: str) -> resilience.CircuitBreaker:
        """Per-ENDPOINT breaker: '/blob/models/<id>' and '/meta/apps/get'
        share the health signal of their route, not of the whole server."""
        endpoint = "/".join(path.split("/")[:3])
        with self._breakers_lock:
            br = self._breakers.get(endpoint)
            if br is None:
                br = resilience.CircuitBreaker(
                    endpoint,
                    failure_threshold=self._breaker_threshold,
                    reset_timeout_s=self._breaker_reset_s,
                )
                self._breakers[endpoint] = br
            return br

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        # fires as the resilience on_retry callback on whatever thread is
        # mid-call; the counter shares the breaker-map lock
        with self._breakers_lock:
            self.retry_count += 1
        self._rl_log.warning(
            "retry", "storage call failed (%s); retry %d", exc, attempt
        )

    def resilience_stats(self) -> dict:
        with self._breakers_lock:
            breakers = {k: b.stats() for k, b in self._breakers.items()}
        return {
            "retries": self.retry_count,
            "retry_budget_tokens": round(self.policy.budget.tokens(), 2)
            if self.policy.budget
            else None,
            "breakers": breakers,
        }

    def capabilities(self) -> frozenset:
        """Wire features the server advertises on ``GET /`` (cached).

        A pre-capability server returns no ``capabilities`` field — the
        caller falls back to the legacy wire structurally, never by matching
        error text (rolling-upgrade contract). Only non-empty capability
        sets are cached: a legacy answer (mixed fleet mid-upgrade) reads
        "none" for THIS call but re-probes on the next, so a long-lived
        client is never permanently downgraded to the single-body wire.
        A probe TRANSPORT failure raises instead — the server is down or
        mid-restart, and silently downgrading would run the very
        whole-body scan the framed wire exists to avoid. Bulk scans are
        heavy and rare; one extra GET per scan against a legacy server is
        noise.
        """
        if self._caps is None:
            payload, _ = self._request("GET", "/", None, "application/json")
            try:
                info = json.loads(payload.decode())
                caps = frozenset(info.get("capabilities") or ())
            except Exception:
                caps = frozenset()  # unparseable index = legacy server
            if not caps:
                return caps
            self._caps = caps
        return self._caps

    def _open(self, method: str, path: str, body: Optional[bytes],
              content_type: str):
        """Open the HTTP call; shared error mapping for body+stream paths."""
        # client-side fault shim (chaos tests): simulate transport faults
        # deterministically without needing a real broken network
        act = _faults.check(f"client:storage:{path}")
        if act is not None:
            if act.latency_s:
                import time as _time

                _time.sleep(act.latency_s)
            if act.kind == "drop":
                raise NetworkStorageError(
                    f"storage server unreachable at {self.url}: "
                    f"injected connection drop"
                )
            if act.kind == "error":
                raise NetworkStorageError(
                    f"{path}: injected fault", status=act.status
                )
        headers = {"Content-Type": content_type}
        if self.secret:
            headers[SECRET_HEADER] = self.secret
        active = _tracing.active_traces()
        if active:
            # cross-service correlation: the serving request's id rides
            # every storage call it causes, so the storage server's trace
            # ring and logs line up with the query's
            headers[_tracing.TRACE_HEADER] = active[0].request_id
        timeout = self.timeout
        deadline = resilience.current_deadline()
        if deadline is not None:
            # the storage hop inherits the request's remaining budget:
            # forward it on the wire and never block the socket past it
            # (floored so an already-expired budget fails fast on connect
            # instead of degenerating into a non-blocking socket)
            remaining_s = max(0.05, deadline.remaining_s())
            headers[resilience.DEADLINE_HEADER] = (
                f"{max(0.0, deadline.remaining_ms()):.0f}"
            )
            timeout = min(timeout, remaining_s) if timeout else remaining_s
        req = urllib.request.Request(
            self.url + path, data=body, method=method, headers=headers
        )
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read().decode()).get("message", str(e))
            except Exception:
                msg = str(e)
            if e.code == 404 and "not found" in msg:
                raise FileNotFoundError(msg) from None
            raise NetworkStorageError(f"{path}: {msg}", status=e.code) from None
        except urllib.error.URLError as e:
            raise NetworkStorageError(
                f"storage server unreachable at {self.url}: {e.reason}"
            ) from None

    def _request(self, method: str, path: str, body: Optional[bytes],
                 content_type: str) -> tuple[bytes, str]:
        def attempt() -> tuple[bytes, str]:
            with self._open(method, path, body, content_type) as r:
                return r.read(), r.headers.get("Content-Type", "")

        return resilience.call_with_resilience(
            attempt,
            self.policy,
            breaker=self.breaker_for(path),
            retryable=_retryable,
            deadline=resilience.current_deadline(),
            on_retry=self._note_retry,
        )

    def call(self, path: str, args: dict) -> Any:
        payload, _ = self._request(
            "POST", path, json.dumps(args).encode(), "application/json"
        )
        return json.loads(payload.decode())["result"]

    def call_binary(self, path: str, args: dict) -> bytes:
        payload, _ = self._request(
            "POST", path, json.dumps(args).encode(), "application/json"
        )
        return payload

    def put_binary(self, path: str, data: bytes, params: Optional[dict] = None) -> Any:
        qs = "?" + urllib.parse.urlencode(params) if params else ""
        payload, _ = self._request(
            "POST", path + qs, data, "application/octet-stream"
        )
        return json.loads(payload.decode())["result"]

    def iter_frames(self, path: str, args: dict):
        """POST and yield npz frames incrementally from a framed stream.

        Reads never buffer more than one frame; the socket timeout applies
        per read, so a 25M-event pull can't trip a whole-body deadline.
        Falls back to yielding the whole body once when the server answers
        with a plain (unframed) payload.
        """
        r = self._open(path=path, method="POST",
                       body=json.dumps(args).encode(),
                       content_type="application/json")
        with r:
            if FRAMES_CONTENT_TYPE not in (r.headers.get("Content-Type") or ""):
                yield r.read()  # unframed server: one body
                return

            def read_exact(n: int, eof_ok: bool = False) -> Optional[bytes]:
                buf = bytearray()
                while len(buf) < n:
                    try:
                        piece = r.read(n - len(buf))
                    except (http.client.HTTPException, OSError) as e:
                        # a connection torn mid-chunk surfaces as
                        # IncompleteRead/reset; normalize to the structural
                        # truncation error (status None ⇒ retryable)
                        raise NetworkStorageError(
                            f"{path}: truncated frame stream ({e})"
                        ) from None
                    if not piece:
                        if eof_ok and not buf:
                            return None
                        raise NetworkStorageError(
                            f"{path}: truncated frame stream"
                        )
                    buf.extend(piece)
                return bytes(buf)

            # chaos shim: tear the pull client-side on a seeded schedule
            fault_site = f"client:storage:frames:{path}"

            while True:
                header = read_exact(8, eof_ok=True)
                if header is None:
                    return
                if _faults.check(fault_site) is not None:
                    raise NetworkStorageError(
                        f"{path}: truncated frame stream (injected)"
                    )
                yield read_exact(int.from_bytes(header, "big"))

    def get_binary(self, path: str) -> Optional[bytes]:
        try:
            payload, _ = self._request("GET", path, None, "application/json")
        except FileNotFoundError:
            return None
        return payload

    def delete(self, path: str) -> Any:
        payload, _ = self._request("DELETE", path, None, "application/json")
        return json.loads(payload.decode())["result"]


class NetworkLEvents(base.LEvents):
    def __init__(self, **kw):
        self._c = _Client(**kw)

    def _call(self, method: str, app_id: int, channel_id: Optional[int], **args):
        args["app_id"] = app_id
        if channel_id is not None:
            args["channel_id"] = channel_id
        return self._c.call(f"/levents/{method}", args)

    def init(self, app_id, channel_id=None):
        return self._call("init", app_id, channel_id)

    def remove(self, app_id, channel_id=None):
        return self._call("remove", app_id, channel_id)

    def close(self):
        pass

    def insert(self, event, app_id, channel_id=None):
        return self._call("insert", app_id, channel_id, event=event.to_dict())

    def insert_batch(self, events, app_id, channel_id=None):
        # the whole batch travels as ONE request; a pre-rename server
        # doesn't know the route name, so fall back to the legacy wire
        # method (capabilities-style rolling-upgrade contract)
        events = list(events)
        if not events:
            return []
        wire = [e.to_dict() for e in events]
        try:
            return self._call("insert_batch", app_id, channel_id, events=wire)
        except NetworkStorageError as e:
            if e.status != 404:
                raise
            return self._call("batch_insert", app_id, channel_id, events=wire)

    def get(self, event_id, app_id, channel_id=None):
        d = self._call("get", app_id, channel_id, event_id=event_id)
        return Event.from_dict(d) if d is not None else None

    def delete(self, event_id, app_id, channel_id=None):
        return self._call("delete", app_id, channel_id, event_id=event_id)

    def find(self, app_id, channel_id=None, **kwargs):
        # predicates travel with the request; the server filters next to the
        # data (parity: JDBCLEvents SQL WHERE pushdown)
        wire = _find_kwargs_to_wire(kwargs)
        rows = self._call("find", app_id, channel_id, **wire)
        return [Event.from_dict(d) for d in rows]

    def search(self, app_id, text, channel_id=None, limit=None, **kwargs):
        # ES-role passthrough: text match runs server-side, only hits
        # cross the wire. A pre-capability server doesn't speak the route;
        # fall back to the base host-side filter over the legacy find wire
        # (rolling-upgrade contract, see capabilities())
        if "search_query" not in self._c.capabilities():
            return super().search(
                app_id, text, channel_id=channel_id, limit=limit, **kwargs
            )
        wire = _find_kwargs_to_wire(dict(kwargs, limit=limit))
        rows = self._call("search", app_id, channel_id, text=text, **wire)
        return [Event.from_dict(d) for d in rows]

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None, required=None):
        wire = _find_kwargs_to_wire(
            dict(entity_type=entity_type, start_time=start_time,
                 until_time=until_time, required=list(required) if required else None)
        )
        return _snapshots_from_wire(
            self._call("aggregate_properties", app_id, channel_id, **wire)
        )


class NetworkPEvents(base.PEvents):
    def __init__(self, **kw):
        self._c = _Client(**kw)

    def find(self, app_id, channel_id=None, **kwargs):
        if kwargs.get("shard") is None:
            # never put shard args on the wire for unsharded reads: a
            # pre-sharding server must keep serving new clients' plain scans
            kwargs.pop("shard", None)
            kwargs.pop("shard_key", None)
        else:
            kwargs["shard"] = [int(kwargs["shard"][0]), int(kwargs["shard"][1])]
        wire = _find_kwargs_to_wire(kwargs)
        wire["app_id"] = app_id
        if channel_id is not None:
            wire["channel_id"] = channel_id
        # framed bulk pull only when the server advertises it (GET /
        # capabilities); a pre-framing server would pass chunk_rows into its
        # backing DAO and 400, so the capability gate — not error-text
        # matching — keeps rolling upgrades safe
        if self._c.chunk_rows > 0 and "framed_scan" in self._c.capabilities():
            chunked = dict(wire, chunk_rows=self._c.chunk_rows)

            def framed_pull():
                parts = [
                    batch_from_npz(frame)
                    for frame in self._c.iter_frames("/pevents/find", chunked)
                ]
                return _concat_batches(parts)

            try:
                # the whole pull (not a single socket op) is the retry unit:
                # a dropped connection or truncated stream re-runs the scan
                # under the shared policy (backoff, budget, breaker) — the
                # generalization of the old one-off 400 retry
                return resilience.call_with_resilience(
                    framed_pull,
                    self._c.policy,
                    breaker=self._c.breaker_for("/pevents/find"),
                    retryable=_retryable,
                    deadline=resilience.current_deadline(),
                    on_retry=self._c._note_retry,
                )
            except NetworkStorageError as e:
                # one URL can front a mixed fleet mid-rolling-upgrade: the
                # probe may have hit an upgraded replica while this request
                # reached a legacy one, which 400s on the unknown chunk_rows
                # arg. Fall back to the legacy wire for exactly that status —
                # transport faults and 5xx have already consumed their retry
                # budget above and propagate rather than silently re-running
                # a multi-GB scan on the single-body wire
                if e.status != 400:
                    raise
                logger.warning(
                    "framed bulk scan rejected with 400 (%s); retrying once "
                    "on the single-body wire (mixed-fleet tolerance)", e
                )
        return batch_from_npz(self._c.call_binary("/pevents/find", wire))

    def find_interactions(self, app_id, channel_id=None, entity_type=None,
                          event_names=None, target_entity_type=None,
                          rating_key=None, default_rating=1.0,
                          shard=None, shard_key="row"):
        wire: dict[str, Any] = {"app_id": app_id, "default_rating": default_rating}
        if channel_id is not None:
            wire["channel_id"] = channel_id
        if entity_type is not None:
            wire["entity_type"] = entity_type
        if event_names is not None:
            wire["event_names"] = list(event_names)
        if target_entity_type is not None:
            wire["target_entity_type"] = target_entity_type
        if rating_key is not None:
            wire["rating_key"] = rating_key
        if shard is not None:
            # pushed to the server so only 1/count-th crosses the wire —
            # the N× ingest fix for multi-host training reads
            wire["shard"] = [int(shard[0]), int(shard[1])]
            wire["shard_key"] = shard_key
        return interactions_from_npz(
            self._c.call_binary("/pevents/interactions", wire)
        )

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None, required=None):
        wire = _find_kwargs_to_wire(
            dict(entity_type=entity_type, start_time=start_time,
                 until_time=until_time, required=list(required) if required else None)
        )
        wire["app_id"] = app_id
        if channel_id is not None:
            wire["channel_id"] = channel_id
        return _snapshots_from_wire(
            self._c.call("/pevents/aggregate_properties", wire)
        )

    def write(self, events, app_id, channel_id=None):
        batch = events if isinstance(events, EventBatch) else EventBatch.from_events(events)
        params = {"app_id": app_id}
        if channel_id is not None:
            params["channel_id"] = channel_id
        self._c.put_binary("/pevents/write", batch_to_npz(batch), params)

    def delete(self, event_ids, app_id, channel_id=None):
        args: dict[str, Any] = {"app_id": app_id, "event_ids": list(event_ids)}
        if channel_id is not None:
            args["channel_id"] = channel_id
        self._c.call("/pevents/delete", args)


class NetworkModels(base.Models):
    """Remote model repository client (parity role: S3Models/HDFSModels)."""

    def __init__(self, **kw):
        self._c = _Client(**kw)

    def insert(self, model):
        self._c.put_binary(
            "/blob/models/" + urllib.parse.quote(model.id, safe=""), model.models
        )

    def get(self, model_id):
        data = self._c.get_binary(
            "/blob/models/" + urllib.parse.quote(model_id, safe="")
        )
        return base.Model(id=model_id, models=data) if data is not None else None

    def delete(self, model_id):
        self._c.delete("/blob/models/" + urllib.parse.quote(model_id, safe=""))


class _MetaClient:
    dao = ""

    def __init__(self, **kw):
        self._c = _Client(**kw)

    def _call(self, method: str, **args):
        return self._c.call(f"/meta/{self.dao}/{method}", args)


class NetworkSequences(_MetaClient, base.Sequences):
    dao = "sequences"

    def gen_next(self, name: str) -> int:
        return int(self._call("gen_next", name=name))


class NetworkApps(_MetaClient, base.Apps):
    dao = "apps"

    def insert(self, app):
        return self._call("insert", app={
            "id": app.id, "name": app.name, "description": app.description,
        })

    def get(self, app_id):
        d = self._call("get", app_id=app_id)
        return base.App(**d) if d else None

    def get_by_name(self, name):
        d = self._call("get_by_name", name=name)
        return base.App(**d) if d else None

    def get_all(self):
        return [base.App(**d) for d in self._call("get_all")]

    def update(self, app):
        return self._call("update", app={
            "id": app.id, "name": app.name, "description": app.description,
        })

    def delete(self, app_id):
        return self._call("delete", app_id=app_id)


def _key_from_wire(d: Optional[dict]) -> Optional[base.AccessKey]:
    if not d:
        return None
    return base.AccessKey(key=d["key"], app_id=d["appId"], events=list(d["events"]))


class NetworkAccessKeys(_MetaClient, base.AccessKeys):
    dao = "accesskeys"

    def insert(self, access_key):
        return self._call(
            "insert", key=access_key.key, appId=access_key.app_id,
            events=list(access_key.events),
        )

    def get(self, key):
        return _key_from_wire(self._call("get", key=key))

    def get_all(self):
        return [_key_from_wire(d) for d in self._call("get_all")]

    def get_by_app_id(self, app_id):
        return [_key_from_wire(d) for d in self._call("get_by_app_id", app_id=app_id)]

    def update(self, access_key):
        return self._call(
            "update", key=access_key.key, appId=access_key.app_id,
            events=list(access_key.events),
        )

    def delete(self, key):
        return self._call("delete", key=key)


class NetworkChannels(_MetaClient, base.Channels):
    dao = "channels"

    def insert(self, channel):
        return self._call(
            "insert", id=channel.id, name=channel.name, appId=channel.app_id
        )

    def get(self, channel_id):
        d = self._call("get", channel_id=channel_id)
        return base.Channel(id=d["id"], name=d["name"], app_id=d["appId"]) if d else None

    def get_by_app_id(self, app_id):
        return [
            base.Channel(id=d["id"], name=d["name"], app_id=d["appId"])
            for d in self._call("get_by_app_id", app_id=app_id)
        ]

    def delete(self, channel_id):
        return self._call("delete", channel_id=channel_id)


class NetworkEngineInstances(_MetaClient, base.EngineInstances):
    dao = "engineinstances"

    def insert(self, instance):
        # contract parity with local drivers: insert assigns instance.id
        # in place (run_train's later update() calls rely on it)
        instance.id = self._call("insert", instance=_instance_to_wire(instance))
        return instance.id

    def get(self, instance_id):
        d = self._call("get", instance_id=instance_id)
        return _instance_from_wire(base.EngineInstance, d) if d else None

    def get_all(self):
        return [
            _instance_from_wire(base.EngineInstance, d)
            for d in self._call("get_all")
        ]

    def get_completed(self, engine_id, engine_version, engine_variant):
        return [
            _instance_from_wire(base.EngineInstance, d)
            for d in self._call(
                "get_completed", engine_id=engine_id,
                engine_version=engine_version, engine_variant=engine_variant,
            )
        ]

    def update(self, instance):
        return self._call("update", instance=_instance_to_wire(instance))

    def delete(self, instance_id):
        return self._call("delete", instance_id=instance_id)

    def query(self, status=None, engine_factory=None, engine_variant=None,
              since=None, until=None, text=None, limit=None):
        # passthrough: the server evaluates next to its backing store, so
        # only matching instances cross the wire (not get_all); legacy
        # servers get the base host-side filter instead
        if "search_query" not in self._c.capabilities():
            return super().query(
                status=status, engine_factory=engine_factory,
                engine_variant=engine_variant, since=since, until=until,
                text=text, limit=limit,
            )
        return [
            _instance_from_wire(base.EngineInstance, d)
            for d in self._call(
                "query", status=status, engine_factory=engine_factory,
                engine_variant=engine_variant,
                since=_dt_to_wire(since) if since else None,
                until=_dt_to_wire(until) if until else None,
                text=text, limit=limit,
            )
        ]


class NetworkEvaluationInstances(_MetaClient, base.EvaluationInstances):
    dao = "evaluationinstances"

    def insert(self, instance):
        instance.id = self._call("insert", instance=_instance_to_wire(instance))
        return instance.id

    def get(self, instance_id):
        d = self._call("get", instance_id=instance_id)
        return _instance_from_wire(base.EvaluationInstance, d) if d else None

    def get_all(self):
        return [
            _instance_from_wire(base.EvaluationInstance, d)
            for d in self._call("get_all")
        ]

    def get_completed(self):
        return [
            _instance_from_wire(base.EvaluationInstance, d)
            for d in self._call("get_completed")
        ]

    def update(self, instance):
        return self._call("update", instance=_instance_to_wire(instance))

    def delete(self, instance_id):
        return self._call("delete", instance_id=instance_id)

    def query(self, status=None, evaluation_class=None, since=None,
              until=None, text=None, limit=None):
        if "search_query" not in self._c.capabilities():
            return super().query(
                status=status, evaluation_class=evaluation_class,
                since=since, until=until, text=text, limit=limit,
            )
        return [
            _instance_from_wire(base.EvaluationInstance, d)
            for d in self._call(
                "query", status=status, evaluation_class=evaluation_class,
                since=_dt_to_wire(since) if since else None,
                until=_dt_to_wire(until) if until else None,
                text=text, limit=limit,
            )
        ]
