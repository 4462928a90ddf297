"""The port's write-behind ingest buffer against the JAX package's.

Mirrors ``tests/test_ingest.py``'s ``TestIngestBuffer``,
``TestBufferedEventServer`` and ``TestSqliteConcurrency`` on
``predictionio_tpu_torch``, and holds the two packages' buffered event
servers side by side: the same requests give the same statuses and the
same ``/ingest/stats.json`` shape, and ``pio eventserver``'s buffer options
parse to the JAX parser's values.
"""

import datetime as dt
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

from predictionio_tpu.data.api import event_server as jax_es
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.common import faults
from predictionio_tpu_torch.data.api.event_server import EventServer, EventServerPlugin
from predictionio_tpu_torch.data.api.ingest_buffer import BufferFull, IngestBuffer
from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools import cli as port_cli

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear()
    yield
    faults.clear()


def _mem_env():
    name = "I" + uuid.uuid4().hex[:8].upper()
    return name, {
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    }


@pytest.fixture()
def storage():
    name, env = _mem_env()
    yield Storage(env=env)
    memory.reset_store(name)


def ev(name, eid, t=0, target=None, props=None):
    return Event(
        event=name,
        entity_type="user",
        entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=props or {},
        event_time=T0 + dt.timedelta(seconds=t),
    )


# ---------------------------------------------------------------------------
# IngestBuffer unit behavior
# ---------------------------------------------------------------------------


class _MemLE:
    """Minimal id-keyed in-memory LEvents standing in for a real driver."""

    def __init__(self, fail_first=0, insert_delay=0.0):
        self.rows = {}
        self.batches = []
        self.fail_first = fail_first
        self.insert_delay = insert_delay
        self.lock = threading.Lock()

    def init(self, app_id, channel_id=None):
        return True

    def insert_batch(self, events, app_id, channel_id=None):
        if self.insert_delay:
            time.sleep(self.insert_delay)
        with self.lock:
            if self.fail_first > 0:
                self.fail_first -= 1
                raise RuntimeError("storage down")
            ids = []
            for e in events:
                eid = e.event_id or new_event_id()
                self.rows[(app_id, channel_id, eid)] = e
                ids.append(eid)
            self.batches.append((app_id, channel_id, len(events)))
            return ids


class TestIngestBuffer:
    def test_durable_ack_waits_for_commit(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=2.0)
        try:
            t = buf.submit(ev("buy", "u1"), 1)
            assert t.wait(5.0) and t.error is None
            assert (1, None, t.event_id) in le.rows
        finally:
            buf.close()

    def test_fast_ack_id_final_at_submit(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=2.0, durable_ack=False)
        try:
            tickets = [buf.submit(ev("buy", f"u{i}"), 1) for i in range(10)]
            ids = [t.event_id for t in tickets]
            assert len(set(ids)) == 10  # ids assigned before any flush
            for t in tickets:
                assert t.wait(5.0)
        finally:
            buf.close()
        assert sorted(k[2] for k in le.rows) == sorted(ids)

    def test_coalescing_groups_many_events_per_flush(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=50.0)
        try:
            tickets = [buf.submit(ev("buy", f"u{i}"), 1) for i in range(40)]
            for t in tickets:
                assert t.wait(5.0)
        finally:
            buf.close()
        # 40 submits inside a 50 ms window land in far fewer DAO calls
        assert len(le.batches) < 10
        assert sum(n for _, _, n in le.batches) == 40

    def test_groups_by_app_and_channel(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=40.0)
        try:
            ts = [
                buf.submit(ev("buy", "a"), 1),
                buf.submit(ev("buy", "b"), 1, 3),
                buf.submit(ev("buy", "c"), 2),
            ]
            for t in ts:
                assert t.wait(5.0)
        finally:
            buf.close()
        assert {(a, c) for a, c, _ in le.batches} == {(1, None), (1, 3), (2, None)}

    def test_buffer_full_sheds(self):
        # a slow flush keeps the queue occupied so the bound is observable
        le = _MemLE(insert_delay=0.2)
        buf = IngestBuffer(le, flush_ms=0.0, buffer_max=4, durable_ack=False)
        try:
            with pytest.raises(BufferFull) as ei:
                for i in range(200):
                    buf.submit(ev("buy", f"u{i}"), 1)
            assert ei.value.retry_after_s >= 0.0
            assert buf.stats()["overflows"] == 1
        finally:
            buf.close()

    def test_close_flushes_remaining(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=5_000.0)  # window far beyond close
        tickets = [buf.submit(ev("buy", f"u{i}"), 1) for i in range(7)]
        buf.close()
        for t in tickets:
            assert t.wait(0.0) and t.error is None
        assert len(le.rows) == 7
        with pytest.raises(RuntimeError):
            buf.submit(ev("buy", "late"), 1)

    def test_flush_failure_fails_tickets_after_retries(self):
        le = _MemLE(fail_first=99)
        buf = IngestBuffer(le, flush_ms=1.0)
        try:
            t = buf.submit(ev("buy", "u1"), 1)
            assert t.wait(10.0)
            assert t.error is not None
            s = buf.stats()
            assert s["flush_errors"] == 1 and s["retries"] >= 1
        finally:
            buf.close()

    def test_stats_histogram_counts_flushes(self):
        le = _MemLE()
        buf = IngestBuffer(le, flush_ms=30.0)
        try:
            ts = [buf.submit(ev("buy", f"u{i}"), 1) for i in range(3)]
            for t in ts:
                assert t.wait(5.0)
        finally:
            buf.close()
        s = buf.stats()
        assert s["accepted"] == s["flushed"] == 3
        assert sum(s["flush_batch_hist"].values()) == s["flushes"]

    def test_flush_retries_through_a_failure_exactly_once(self):
        """A failing first insert retries under the policy: every acked id
        lands once (the chaos suite's contract, without its HTTP shim)."""
        le = _MemLE(fail_first=1)
        buf = IngestBuffer(le, flush_ms=5.0, durable_ack=False)
        try:
            tickets = [buf.submit(ev("buy", f"u{i}"), 1) for i in range(20)]
            for t in tickets:
                assert t.wait(10.0) and t.error is None
        finally:
            buf.close()
        assert sorted(k[2] for k in le.rows) == sorted(t.event_id for t in tickets)
        assert buf.stats()["retries"] >= 1


# ---------------------------------------------------------------------------
# Event server: buffered modes over live HTTP
# ---------------------------------------------------------------------------


def _call(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


EV = {
    "event": "rate",
    "entityType": "user",
    "entityId": "u1",
    "targetEntityType": "item",
    "targetEntityId": "i1",
    "properties": {"rating": 5},
}


def _server(storage, module=None, base=None, **kw):
    module = module or __import__("predictionio_tpu_torch.data.api.event_server",
                                  fromlist=["EventServer"])
    base = base or __import__("predictionio_tpu_torch.data.storage.base", fromlist=["App"])
    app_id = storage.get_meta_data_apps().insert(base.App(0, "ingapp"))
    key = storage.get_meta_data_access_keys().insert(base.AccessKey("", app_id, []))
    chan_id = storage.get_meta_data_channels().insert(base.Channel(0, "live", app_id))
    es = module.EventServer(storage=storage, stats=True, **kw)
    port = es.start(host="127.0.0.1", port=0)
    return es, {"base": f"http://127.0.0.1:{port}", "key": key, "app_id": app_id,
                "chan_id": chan_id}


class TestBufferedEventServer:
    def test_durable_mode_201_and_readable(self, storage):
        es, srv = _server(storage, ingest_mode="durable", ingest_flush_ms=2.0)
        try:
            ids = []
            for i in range(10):
                status, body = _call(
                    "POST", srv["base"] + f"/events.json?accessKey={srv['key']}",
                    dict(EV, entityId=f"u{i}"),
                )
                assert status == 201
                ids.append(body["eventId"])
            le = storage.get_l_events()
            for i, eid in enumerate(ids):  # durable ack: already readable
                got = le.get(eid, srv["app_id"])
                assert got is not None and got.entity_id == f"u{i}"
            status, body = _call("GET", srv["base"] + f"/ingest/stats.json?accessKey={srv['key']}")
            assert status == 200 and body["mode"] == "durable"
            assert body["flushed"] == 10
        finally:
            es.stop()

    def test_fast_mode_202_then_visible(self, storage):
        es, srv = _server(storage, ingest_mode="fast", ingest_flush_ms=2.0)
        try:
            status, body = _call(
                "POST", srv["base"] + f"/events.json?accessKey={srv['key']}",
                dict(EV, entityId="ufast"),
            )
            assert status == 202
            eid = body["eventId"]
            le = storage.get_l_events()
            deadline = time.time() + 5.0
            while le.get(eid, srv["app_id"]) is None:
                assert time.time() < deadline, "buffered event never flushed"
                time.sleep(0.01)
        finally:
            es.stop()

    def test_buffered_channel_routing(self, storage):
        es, srv = _server(storage, ingest_mode="durable", ingest_flush_ms=2.0)
        try:
            status, body = _call(
                "POST", srv["base"] + f"/events.json?accessKey={srv['key']}&channel=live",
                dict(EV, entityId="uchan"),
            )
            assert status == 201
            le = storage.get_l_events()
            got = le.get(body["eventId"], srv["app_id"], srv["chan_id"])
            assert got is not None and got.entity_id == "uchan"
            assert le.get(body["eventId"], srv["app_id"]) is None
        finally:
            es.stop()

    def test_overflow_returns_503_retry_after(self, storage):
        es, srv = _server(storage, ingest_mode="fast", ingest_flush_ms=5_000.0,
                          ingest_buffer_max=2)
        try:
            url = srv["base"] + f"/events.json?accessKey={srv['key']}"
            statuses = []
            for i in range(6):
                req = urllib.request.Request(
                    url, data=json.dumps(dict(EV, entityId=f"u{i}")).encode(), method="POST",
                )
                req.add_header("Content-Type", "application/json")
                try:
                    with urllib.request.urlopen(req) as r:
                        statuses.append((r.status, None))
                except urllib.error.HTTPError as e:
                    statuses.append((e.code, e.headers.get("Retry-After")))
            codes = [s for s, _ in statuses]
            assert 503 in codes  # the bound sheds, it never queues unbounded
            retry_after = [ra for s, ra in statuses if s == 503][0]
            assert retry_after is not None and float(retry_after) > 0
        finally:
            es.stop()

    def test_blocked_event_never_buffered(self, storage):
        class Blocker(EventServerPlugin):
            plugin_type = EventServerPlugin.INPUT_BLOCKER
            name = "noU2"

            def process(self, event_info, context):
                if event_info["event"]["entityId"] == "u2":
                    raise ValueError("u2 is banned")

        es, srv = _server(storage, plugins=[Blocker()], ingest_mode="durable",
                          ingest_flush_ms=2.0)
        try:
            s1, _ = _call("POST", srv["base"] + f"/events.json?accessKey={srv['key']}",
                          dict(EV, entityId="u1"))
            s2, _ = _call("POST", srv["base"] + f"/events.json?accessKey={srv['key']}",
                          dict(EV, entityId="u2"))
            assert (s1, s2) == (201, 403)
            got = {e.entity_id for e in storage.get_l_events().find(app_id=srv["app_id"])}
            assert got == {"u1"}
        finally:
            es.stop()

    @pytest.mark.parametrize("mode", ["durable", "fast"])
    def test_same_requests_same_answers_as_jax(self, storage, mode):
        """The JAX and the port's buffered servers answer one request
        sequence with the same statuses, and their ``/ingest/stats.json``
        carry the same keys and counts."""
        jname, jenv = _mem_env()
        jstorage = JaxStorage(env=jenv)
        pair = [_server(storage, ingest_mode=mode, ingest_flush_ms=2.0, telemetry=False),
                _server(jstorage, jax_es, jax_base, ingest_mode=mode, ingest_flush_ms=2.0,
                        telemetry=False)]
        try:
            seqs = []
            for es, srv in pair:
                k = srv["key"]
                seq = [
                    _call("POST", srv["base"] + f"/events.json?accessKey={k}", EV)[0],
                    _call("POST", srv["base"] + f"/events.json?accessKey={k}", {"entityType": "user"})[0],
                    _call("POST", srv["base"] + "/events.json?accessKey=nope", EV)[0],
                    _call("POST", srv["base"] + f"/events.json?accessKey={k}&channel=live", EV)[0],
                    _call("POST", srv["base"] + f"/events.json?accessKey={k}&channel=gone", EV)[0],
                ]
                es.ingest_buffer.close()  # flush what the fast mode acked
                status, stats = _call("GET", srv["base"] + f"/ingest/stats.json?accessKey={k}")
                seqs.append((seq, status, {key: stats[key] for key in (
                    "mode", "buffer_max", "buffered", "accepted", "flushed", "overflows",
                    "flush_errors")}, sorted(stats)))
            assert seqs[0] == seqs[1]
            assert seqs[0][0] == ([201, 400, 401, 201, 400] if mode == "durable"
                                  else [202, 400, 401, 202, 400])
        finally:
            for es, _ in pair:
                es.stop()
            jax_memory.reset_store(jname)


@pytest.mark.parametrize("argv", [
    ["eventserver", "--ingest-buffer", "fast", "--flush-ms", "3", "--buffer-max", "64",
     "--wal-dir", "/tmp/wal"],
    ["eventserver", "--ingest-buffer", "durable"],
    ["eventserver"],
])
def test_eventserver_buffer_options_parse_as_in_jax(argv):
    port = vars(port_cli.build_parser().parse_args(argv))
    jax = vars(jax_cli.build_parser().parse_args(argv))
    for key in ("ingest_buffer", "flush_ms", "buffer_max", "wal_dir"):
        assert port[key] == jax[key], key


# ---------------------------------------------------------------------------
# sqlite: the writer's commits must not block readers
# ---------------------------------------------------------------------------


class TestSqliteConcurrency:
    def test_readers_progress_during_writer_commits(self, tmp_path):
        name = "W" + uuid.uuid4().hex[:8].upper()
        path = str(tmp_path / "wal.sqlite")
        store = Storage(env={
            f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
            f"PIO_STORAGE_SOURCES_{name}_PATH": path,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
        })
        le = store.get_l_events()
        le.init(1)
        le.insert_batch([ev("buy", f"seed{i}", t=i) for i in range(50)], 1)

        stop = threading.Event()
        errors = []
        reads = [0]

        def reader():
            try:
                while not stop.is_set():
                    assert len(list(le.find(app_id=1, limit=20))) >= 20
                    reads[0] += 1
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for i in range(30):
                le.insert_batch([ev("buy", f"w{i}-{j}", t=100 + i) for j in range(20)], 1)
        finally:
            stop.set()
            for t in threads:
                t.join(10.0)
        assert not errors
        assert reads[0] > 0
        assert len(list(le.find(app_id=1))) == 50 + 30 * 20
        from predictionio_tpu_torch.data.storage import sqlite

        sqlite.close_db(path)
