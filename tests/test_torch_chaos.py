"""The chaos suite on the port: seeded fault plans against its servers.

Counterpart of ``tests/test_resilience.py``'s ``TestHttpFaultShim``,
``TestStorageChaos``, ``TestQueryServerChaos`` and
``TestTelemetryUnderChaos``, run against the port's HTTP kit, network
storage client and server, and query server. The fault harness itself is
held against the JAX package: for the same plans, seeds and call sequences,
``faults.check`` returns the same actions and ``faults.kill_point`` picks
the same victims (exact equality). The breaker walk runs twice: on the
storage client's per-endpoint breaker (the JAX suite's) and on a router
replica's breaker, whose series the same bridge renders.
"""

import datetime as dt
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from predictionio_tpu.common import faults as jax_faults
from predictionio_tpu_torch.common import faults
from predictionio_tpu_torch.common.http import HttpService, Response, json_response
from predictionio_tpu_torch.common.resilience import BreakerOpen
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import memory as port_memory
from predictionio_tpu_torch.data.storage.network import NetworkStorageError, StorageServer
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import als_model_from_arrays
from predictionio_tpu_torch.obs import bridges as obs_bridges
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.serving.router import Router
from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


# -- the harness: the same decisions as the JAX package ----------------------

SITES = ["server:queryserver:/queries.json", "client:router:/queries.json",
         "server:generation:abc", "client:tenant:t1", "server:pipeline:ranking",
         "crash:fleet:replica", "client:canary:shadow"]

PLANS = [
    "site=server:*,kind=latency,latency_ms=5,p=0.3;site=client:router:*,kind=drop,times=4",
    "site=client:*,kind=error,status=502,p=0.5,after=3;site=*,kind=truncate,p=0.1",
    "site=crash:fleet:replica,kind=crash,p=0.4,times=3;site=server:generation:abc,kind=error,p=0.7",
    "site=client:tenant:t1,kind=error,after=2,times=5;site=server:pipeline:*,kind=latency,latency_ms=50",
]


def _action(a):
    return None if a is None else (a.kind, a.latency_s, a.status, a.rule, a.ordinal)


@pytest.mark.parametrize("spec", PLANS)
@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_check_decisions_equal_jax(spec, seed):
    """Exact: the same spec and seed fire the same action on the same call
    of a 600-call site sequence."""
    rng = np.random.default_rng(seed)
    calls = [SITES[i] for i in rng.integers(0, len(SITES), 600)]
    out = {}
    for name, mod in (("jax", jax_faults), ("port", faults)):
        mod.install(mod.FaultPlan(mod.parse_spec(spec), seed=seed))
        out[name] = [_action(mod.check(site)) for site in calls]
        out[name + "_stats"] = mod.active().stats()
        mod.clear()
    assert out["port"] == out["jax"]
    assert out["port_stats"] == out["jax_stats"]
    assert any(a is not None for a in out["port"])


@pytest.mark.parametrize("seed", [1, 3, 99])
def test_kill_point_victims_equal_jax(seed, monkeypatch):
    """Exact: ``kill_point`` SIGKILLs the same pid of the same list on the
    same firing in both packages (the kill itself is recorded, not sent)."""
    import os

    victims = {"jax": [], "port": []}
    spec = "site=crash:fleet:replica,kind=crash,p=0.5,times=12;site=crash:*,kind=latency"
    rng = np.random.default_rng(seed)
    pid_lists = [sorted(rng.choice(np.arange(1000, 1100), size=int(rng.integers(0, 6)),
                                   replace=False).tolist()) for _ in range(80)]
    for name, mod in (("jax", jax_faults), ("port", faults)):
        monkeypatch.setattr(os, "kill", lambda pid, sig, _n=name: victims[_n].append(pid))
        mod.install(mod.FaultPlan(mod.parse_spec(spec), seed=seed))
        picks = [mod.kill_point("crash:fleet:replica", list(reversed(p))) for p in pid_lists]
        mod.clear()
        victims[name + "_picks"] = picks
    assert victims["port_picks"] == victims["jax_picks"]
    assert victims["port"] == victims["jax"] and len(victims["port"]) >= 1


def test_kill_point_ignores_other_kinds_and_empty_pid_lists(monkeypatch):
    import os

    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append(pid))
    faults.install(faults.FaultPlan(faults.parse_spec(
        "site=crash:fleet:replica,kind=latency,latency_ms=1"), seed=0))
    assert faults.kill_point("crash:fleet:replica", [10, 11]) is None
    assert faults.kill_point("crash:fleet:replica", []) is None
    faults.clear()
    assert faults.kill_point("crash:fleet:replica", [10]) is None
    assert sent == []


# -- the HTTP kit's fault shim ------------------------------------------------


class TestHttpFaultShim:
    def _service(self, pieces):
        svc = HttpService("shim")

        @svc.route("GET", r"/plain")
        def plain(req):
            return json_response(200, {"ok": True})

        @svc.route("GET", r"/stream")
        def stream(req):
            return Response(status=200, body=iter(pieces))

        port = svc.start("127.0.0.1", 0)
        return svc, port

    def test_truncate_flag_scoped_to_faulted_request(self):
        """A truncate fault on a non-streamed response must NOT survive the
        keep-alive connection and tear a later stream the seeded plan never
        scheduled."""
        svc, port = self._service([b"abcd", b"efgh"])
        try:
            faults.install(faults.FaultPlan(
                [faults.FaultRule(site="server:shim:/plain", kind="truncate", times=1)],
                seed=6,
            ))
            conn = http.client.HTTPConnection("127.0.0.1", port)
            try:
                conn.request("GET", "/plain")
                r = conn.getresponse()
                assert r.status == 200 and r.read()  # non-streamed: unaffected
                # same keep-alive socket, next request: no fault scheduled
                conn.request("GET", "/stream")
                r = conn.getresponse()
                assert r.read() == b"abcdefgh"  # intact, cleanly terminated
            finally:
                conn.close()
        finally:
            svc.stop()

    def test_truncate_tears_first_nonempty_piece(self):
        """An empty leading piece must not turn the injected tear into a
        cleanly-terminated empty stream: the cut lands on real bytes and the
        client sees a torn chunked body."""
        svc, port = self._service([b"", b"payload-bytes"])
        try:
            faults.install(faults.FaultPlan(
                [faults.FaultRule(site="server:shim:/stream", kind="truncate", times=1)],
                seed=7,
            ))
            conn = http.client.HTTPConnection("127.0.0.1", port)
            try:
                conn.request("GET", "/stream")
                r = conn.getresponse()
                with pytest.raises((http.client.IncompleteRead, ConnectionError)):
                    r.read()
            finally:
                conn.close()
            assert faults.active().stats()["rules"][0]["fired"] == 1
        finally:
            svc.stop()

    def test_error_drop_and_latency_sites(self):
        """Error replies the rule's status, drop closes without a response,
        latency delays and then serves; each fires on the call the seeded
        schedule names (times/after), and the next request is clean."""
        svc, port = self._service([b"x"])
        try:
            faults.install(faults.FaultPlan(faults.parse_spec(
                "site=server:shim:/plain,kind=error,status=418,times=1;"
                "site=server:shim:/plain,kind=drop,times=1;"
                "site=server:shim:/stream,kind=latency,latency_ms=120,times=1"), seed=1))
            base = f"http://127.0.0.1:{port}"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/plain", timeout=5)
            assert e.value.code == 418
            assert json.loads(e.value.read())["message"] == "injected fault"
            with pytest.raises((http.client.RemoteDisconnected, ConnectionError,
                                urllib.error.URLError)):
                urllib.request.urlopen(base + "/plain", timeout=5).read()
            with urllib.request.urlopen(base + "/plain", timeout=5) as r:
                assert json.loads(r.read()) == {"ok": True}
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + "/stream", timeout=5) as r:
                assert r.read() == b"x"
            assert time.perf_counter() - t0 >= 0.1
            fired = [r["fired"] for r in faults.active().stats()["rules"]]
            assert fired == [1, 1, 1]
        finally:
            svc.stop()

    def test_no_plan_is_one_none_check(self):
        svc, port = self._service([b"a", b"b"])
        try:
            assert faults.active() is None
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=5) as r:
                assert r.read() == b"ab"
        finally:
            svc.stop()


# -- the query server under chaos --------------------------------------------

N_USERS, N_ITEMS = 8, 8


@pytest.fixture()
def trained(tmp_path, monkeypatch):
    """A published ALS instance in a port MEMORY store (random factors)."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for k in ("PIO_TENANTS", "PIO_PIPELINE", "PIO_FAULT_SPEC", "PIO_PIN_INSTANCE",
              "PIO_STREAMING", "PIO_RESULT_CACHE", "PIO_COALESCE"):
        monkeypatch.delenv(k, raising=False)
    src = "CH" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
    })
    rng = np.random.default_rng(5)
    model = als_model_from_arrays(
        rng.normal(size=(N_USERS, 2)).astype(np.float32),
        rng.normal(size=(N_ITEMS, 2)).astype(np.float32),
        [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)])
    engine = RecommendationEngine.apply()
    iid = publish(storage, engine, model)
    yield {"storage": storage, "engine": engine, "ctx": DeviceContext.create(device="cpu"),
           "instance": iid, "model": model}
    port_memory.reset_store(src)


def publish(storage, engine, model):
    params = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 2}}]})
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = port_base.EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="f", **params.to_json_strings())
    iid = instances.insert(inst)
    raw = persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                       [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(port_base.Model(id=iid, models=persistence.seal_model_blob(raw)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


def _call(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


class TestQueryServerChaos:
    def _server(self, trained, **kw):
        qs = QueryServer(trained["engine"], storage=trained["storage"], ctx=trained["ctx"], **kw)
        port = qs.start("127.0.0.1", 0)
        return qs, f"http://127.0.0.1:{port}"

    def test_healthz_readyz(self, trained):
        qs, base = self._server(trained)
        try:
            status, body, _ = _call("GET", base + "/healthz")
            assert status == 200 and body["status"] == "ok"
            status, body, _ = _call("GET", base + "/readyz")
            assert status == 200 and body["status"] == "ready"
            assert body["deployed"] and not body["reloadDegraded"]
        finally:
            qs.stop()

    def test_overload_sheds_with_retry_after(self, trained):
        qs, base = self._server(trained, max_inflight=0, shed_retry_after_s=2.0)
        try:
            status, body, headers = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 503 and "shed" in body["message"]
            assert headers.get("Retry-After") == "2"
            status, body, _ = _call("GET", base + "/readyz")
            assert status == 503 and body["status"] == "overloaded"
            status, info, _ = _call("GET", base + "/")
            assert info["resilience"]["counters"]["shed"] == 1
        finally:
            qs.stop()

    def test_expired_deadline_shed_before_device(self, trained):
        qs, base = self._server(trained)
        try:
            status, _, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200  # a live path works
            algo = qs._deployed.algorithms[0]
            orig = algo.predict
            calls = []
            algo.predict = lambda m, q: (calls.append(1), orig(m, q))[1]
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2},
                                    headers={"X-Request-Deadline": "0"})
            assert status == 504
            assert calls == []  # never reached the scorer, let alone the card
            status, info, _ = _call("GET", base + "/")
            assert info["resilience"]["counters"]["deadline_exceeded"] == 1
        finally:
            qs.stop()

    def test_default_deadline_applies_without_header(self, trained):
        qs, base = self._server(trained, default_deadline_ms=0.0)
        try:
            status, _, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 504
        finally:
            qs.stop()

    def test_scorer_failure_serves_degraded_not_500(self, trained):
        qs, base = self._server(trained)
        try:
            status, good, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200 and "degraded" not in good
            algo = qs._deployed.algorithms[0]
            algo.predict = lambda m, q: (_ for _ in ()).throw(RuntimeError("scorer down"))
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u2", "num": 2})
            assert status == 200 and body["degraded"] is True
            assert body["itemScores"] == good["itemScores"]  # last good answer
            status, info, _ = _call("GET", base + "/")
            assert info["resilience"]["counters"]["degraded"] == 1
            # the scorer recovers: fresh answers, flag gone
            del algo.predict
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200 and "degraded" not in body
        finally:
            qs.stop()

    def test_malformed_query_still_400_despite_fallback(self, trained):
        """A TypeError from bad query values is a CLIENT bug: 400 even when a
        degraded fallback is available, never a 200 with a stale answer."""
        qs, base = self._server(trained)
        try:
            status, _, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200  # _last_good is now populated
            algo = qs._deployed.algorithms[0]
            algo.predict = lambda m, q: (_ for _ in ()).throw(TypeError("num must be an int"))
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 400 and "num must be an int" in body["message"]
            status, info, _ = _call("GET", base + "/")
            counters = info["resilience"]["counters"]
            assert counters["degraded"] == 0 and counters["query_errors"] == 1
        finally:
            qs.stop()

    def test_loadtest_carries_deadline_and_breaks_out_sheds(self, trained):
        from predictionio_tpu_torch.tools.loadtest import run_loadtest

        qs, base = self._server(trained)
        try:
            res = run_loadtest(base, {"user": "u1", "num": 2}, requests=5, concurrency=2,
                               deadline_ms=0.0)
            assert res["deadlineExceeded"] == 5
            assert res["errors"] == 0 and res["ok"] == 0
        finally:
            qs.stop()

    def test_generation_fault_hits_only_the_named_instance(self, trained):
        """``server:generation:<id>`` fails only while that instance is
        deployed: after a reload to another generation the rule no longer
        matches (how a canary test plants a bad candidate)."""
        qs, base = self._server(trained)
        try:
            bad = trained["instance"]
            faults.install(faults.FaultPlan(faults.parse_spec(
                f"site=server:generation:{bad},kind=error,status=500"), seed=0))
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 500 and body["injected"] is True
            good = publish(trained["storage"], trained["engine"], trained["model"])
            assert qs.reload() == good
            status, body, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200 and body["itemScores"]
            assert faults.active().stats()["rules"][0]["fired"] == 1
        finally:
            qs.stop()

    def test_quarantined_reload_is_409_unless_forced(self, trained):
        qs, base = self._server(trained)
        try:
            newer = publish(trained["storage"], trained["engine"], trained["model"])
            persistence.write_quarantine_receipt(newer, "canary-rollback")
            # the newest-COMPLETED walk skips it; a pinned reload refuses it
            assert qs.reload() == trained["instance"]
            status, body, _ = _call("POST", base + f"/reload?instanceId={newer}", {})
            assert status == 409 and "quarantined" in body["message"]
            status, body, _ = _call("POST", base + f"/reload?instanceId={newer}&force=1", {})
            assert status == 200 and body["engineInstanceId"] == newer
        finally:
            qs.stop()


# -- storage client vs a faulty server/transport -----------------------------


def _mem_storage(name):
    return Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })


def _net_client(port, **overrides):
    env = {
        "PIO_STORAGE_SOURCES_NET_TYPE": "network",
        "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
        "PIO_STORAGE_SOURCES_NET_SECRET": "s3cret",
        "PIO_STORAGE_SOURCES_NET_RETRIES": "3",
        "PIO_STORAGE_SOURCES_NET_BACKOFF_MS": "5",
        "PIO_STORAGE_SOURCES_NET_TIMEOUT": "30",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
    }
    env.update({f"PIO_STORAGE_SOURCES_NET_{k}": v for k, v in overrides.items()})
    return Storage(env=env)


@pytest.fixture()
def served():
    name = "C" + uuid.uuid4().hex[:8].upper()
    backing = _mem_storage(name)
    server = StorageServer(backing, secret="s3cret")
    port = server.start("127.0.0.1", 0)
    try:
        yield {"server": server, "backing": backing, "client": _net_client(port), "port": port}
    finally:
        server.stop()
        port_memory.reset_store(name)


def _rule(**kw):
    return faults.FaultRule(**kw)


class TestStorageChaos:
    def test_retry_recovers_dropped_call(self, served):
        faults.install(faults.FaultPlan(
            [_rule(site="client:storage:/meta/apps/*", kind="drop", times=1)], seed=1))
        apps = served["client"].get_meta_data_apps()
        app_id = apps.insert(port_base.App(0, "chaos"))  # the first call drops, the retry lands
        assert apps.get(app_id).name == "chaos"
        assert apps._c.retry_count >= 1
        stats = apps._c.resilience_stats()
        assert stats["retries"] == apps._c.retry_count
        assert "/meta/apps" in stats["breakers"]

    def test_server_5xx_retried_to_success(self, served):
        app_id = served["backing"].get_meta_data_apps().insert(port_base.App(0, "chaos5xx"))
        served["backing"].get_l_events().init(app_id)
        faults.install(faults.FaultPlan(
            [_rule(site="server:storageserver:/levents/insert", kind="error", status=503,
                   times=2)], seed=2))
        le = served["client"].get_l_events()
        eid = le.insert(Event(event="$set", entity_type="user", entity_id="u1"), app_id)
        assert le.get(eid, app_id) is not None
        assert le._c.retry_count >= 2

    def test_breaker_opens_then_halfopen_probe_closes(self, served):
        client = _net_client(served["port"], RETRIES="1", BREAKER_THRESHOLD="2",
                             BREAKER_RESET_MS="200")
        apps = client.get_meta_data_apps()
        faults.install(faults.FaultPlan(
            [_rule(site="client:storage:/meta/apps/*", kind="error", status=503)], seed=3))
        for _ in range(2):
            with pytest.raises(NetworkStorageError):
                apps.get_all()
        br = apps._c.breaker_for("/meta/apps")
        assert br.state == "open"
        with pytest.raises(BreakerOpen):  # open: fails fast, no socket
            apps.get_all()
        assert br.fast_failures >= 1
        faults.clear()  # the half-open probe after the cooldown succeeds
        time.sleep(0.25)
        assert apps.get_all() == []
        assert br.state == "closed"

    def _seed_events(self, served, n=40):
        app_id = served["backing"].get_meta_data_apps().insert(port_base.App(0, "framed"))
        le = served["backing"].get_l_events()
        le.init(app_id)
        le.batch_insert([
            Event(event="rate", entity_type="user", entity_id=f"u{i % 7}",
                  target_entity_type="item", target_entity_id=f"i{i % 5}",
                  properties={"rating": float(i % 5 + 1)})
            for i in range(n)], app_id)
        return app_id

    @pytest.mark.parametrize("site,seed", [
        ("client:storage:frames:/pevents/find", 4),  # torn on the client
        ("server:storageserver:/pevents/find", 5),  # torn mid-frame by the server
    ])
    def test_truncated_frame_stream_retried(self, served, site, seed):
        """A torn frame stream is a truncation error (never a short result)
        that the policy layer recovers."""
        app_id = self._seed_events(served)
        faults.install(faults.FaultPlan([_rule(site=site, kind="truncate", times=1)], seed=seed))
        pe = served["client"].get_p_events()
        assert len(pe.find(app_id)) == 40
        assert pe._c.retry_count >= 1


class TestTelemetryUnderChaos:
    def test_breaker_metrics_walk_closed_open_halfopen(self, monkeypatch):
        """The router's per-replica breaker series follow the breaker's real
        state machine under a ``client:router`` fault: 0 → 1 → 2 → 0, with
        opens_total moving when it should."""
        monkeypatch.setenv("PIO_FLEET_BREAKER_THRESHOLD", "2")
        monkeypatch.setenv("PIO_FLEET_BREAKER_RESET_S", "0.2")
        stub = HttpService("stubreplica")

        @stub.route("GET", r"/readyz")
        def readyz(req):
            return json_response(200, {"status": "ready", "fastpathWarm": True})

        @stub.route("POST", r"/queries\.json")
        def queries(req):
            return json_response(200, {"ok": True})

        url = f"http://127.0.0.1:{stub.start('127.0.0.1', 0)}"
        router = Router([url], hedge_enabled=False, telemetry=False)
        router.max_retries = 0
        router.eject_after = 10**6
        base = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
        reg = obs_metrics.MetricsRegistry()
        obs_bridges.bridge_resilience(reg, router._resilience_stats, prefix="pio_router")

        def gauge(name):
            series = obs_metrics.parse_prometheus(reg.render_prometheus())
            return series.get((f"pio_router_{name}", (("endpoint", url),)))

        try:
            assert _call("POST", base + "/queries.json", {"q": 1})[0] == 200
            assert gauge("breaker_state") == 0
            faults.install(faults.FaultPlan(faults.parse_spec(
                "site=client:router:/queries.json,kind=error,status=503,times=2"), seed=11))
            for _ in range(2):
                assert _call("POST", base + "/queries.json", {"q": 1})[0] >= 500
            assert gauge("breaker_state") == 1 and gauge("breaker_opens_total") == 1
            faults.clear()
            # after the cooldown a slow probe holds the breaker HALF_OPEN
            faults.install(faults.FaultPlan(faults.parse_spec(
                "site=client:router:/queries.json,kind=latency,latency_ms=400,times=1"), seed=12))
            time.sleep(0.3)
            probe = threading.Thread(
                target=lambda: _call("POST", base + "/queries.json", {"q": 1}), daemon=True)
            probe.start()
            saw_half_open = False
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and not saw_half_open:
                saw_half_open = gauge("breaker_state") == 2
                time.sleep(0.01)
            probe.join(5.0)
            assert saw_half_open, "scrape never observed HALF_OPEN"
            assert gauge("breaker_state") == 0 and gauge("breaker_opens_total") == 1
        finally:
            router.stop()
            stub.stop()

    def test_storage_client_breaker_metrics_walk_closed_open_halfopen(self, served):
        """The pio_storage_client_* series track the storage client's breaker
        under a fault shim: 0 → 1 → 2 → 0, with the retry counter and
        opens_total moving when they should (the JAX suite's walk)."""
        client = _net_client(served["port"], RETRIES="2", BREAKER_THRESHOLD="2",
                             BREAKER_RESET_MS="200")
        apps = client.get_meta_data_apps()
        reg = obs_metrics.MetricsRegistry()
        obs_bridges.bridge_resilience(reg, client.resilience_stats)

        def series():
            return obs_metrics.parse_prometheus(reg.render_prometheus())

        def gauge(name):
            return series().get((f"pio_storage_client_{name}", (("endpoint", "/meta/apps"),)))

        assert apps.get_all() == []
        assert gauge("breaker_state") == 0
        assert series()[("pio_storage_client_retries_total", ())] == 0
        faults.install(faults.FaultPlan(
            [_rule(site="client:storage:/meta/apps/*", kind="error", status=503)], seed=11))
        with pytest.raises(NetworkStorageError):  # two attempts trip threshold 2
            apps.get_all()
        assert gauge("breaker_state") == 1 and gauge("breaker_opens_total") == 1
        assert series()[("pio_storage_client_retries_total", ())] >= 1
        faults.clear()
        faults.install(faults.FaultPlan(
            [_rule(site="client:storage:/meta/apps/*", kind="latency", latency_ms=400,
                   times=1)], seed=12))
        time.sleep(0.25)
        probe = threading.Thread(target=apps.get_all, daemon=True)
        probe.start()
        saw_half_open = False
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not saw_half_open:
            saw_half_open = gauge("breaker_state") == 2
            time.sleep(0.01)
        probe.join(5.0)
        assert saw_half_open, "scrape never observed HALF_OPEN"
        assert gauge("breaker_state") == 0 and gauge("breaker_opens_total") == 1

    def test_metrics_keeps_serving_while_degraded(self, trained):
        """/metrics answers — and shows the degradation — while the scorer
        is down and queries are served from the fallback."""
        qs = QueryServer(trained["engine"], storage=trained["storage"], ctx=trained["ctx"])
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            status, _, _ = _call("POST", base + "/queries.json", {"user": "u1", "num": 2})
            assert status == 200  # _last_good is populated
            algo = qs._deployed.algorithms[0]
            algo.predict = lambda m, q: (_ for _ in ()).throw(RuntimeError("scorer down"))
            for _ in range(3):
                status, body, _ = _call("POST", base + "/queries.json", {"user": "u2", "num": 2})
                assert status == 200 and body["degraded"] is True
            with urllib.request.urlopen(base + "/metrics") as r:
                assert r.status == 200
                text = r.read().decode()
            series = obs_metrics.parse_prometheus(text)
            assert series[("pio_query_errors_total", (("kind", "degraded"),))] == 3
            assert len(series) >= 25  # the exposition stays whole mid-outage
        finally:
            qs.stop()
