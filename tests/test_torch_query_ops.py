"""The port's query server as operators run it, against the JAX server.

One small explicit ALS trains on the CPU in the JAX package; the JAX
``QueryServer`` serves it from a JAX MEMORY store, the port's from a port
MEMORY store (the same factors, carried by ``als_model_from_arrays``).
The same requests go to both, and the operator-facing behaviour must be
the same: admission sheds with the same 503 and ``Retry-After``; a lapsed
``X-Request-Deadline`` answers 504; a scorer that raises gives the newest
good answer flagged ``degraded`` and counted; a failed reload keeps the
live generation and a cold start falls back to the last-known-good one;
the drain finishes in-flight work and counts what it abandons; feedback
posts ``predict`` events, which land in a port event server; ``/metrics``
carries the same families by name. One logged difference (ROADMAP §3): a
``KernelError`` (a kernel's refusal or failure, or a card error) answers
500 in the port where the JAX server would serve a degraded answer.
Answers are compared by ``topk_mismatches`` at 1e-5.
"""

import contextlib
import datetime as dt
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import numpy as np
import pytest

from predictionio_tpu.core import persistence as jax_persistence
from predictionio_tpu.data.batch import Interactions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models.als import ALSConfig as JaxALSConfig
from predictionio_tpu.models.als import train_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving import query_server as jax_qs
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import persistence as port_persistence
from predictionio_tpu_torch.data.api.event_server import EventServer
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import memory as port_memory
from predictionio_tpu_torch.data.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import als_model_from_arrays
from predictionio_tpu_torch.obs.metrics import parse_prometheus
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.serving import query_server as port_qs
from predictionio_tpu_torch.templates import recommendation as port_rec
from predictionio_tpu_torch.testing import topk_mismatches

N_USERS, N_ITEMS = 40, 30
VARIANT = {"algorithms": [{"name": "als", "params": {"rank": 4, "lambda": 0.01}}]}


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(N_USERS, 3)) / np.sqrt(3)
    V = rng.normal(size=(N_ITEMS, 3)) / np.sqrt(3)
    users, items = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.5)
    inter = Interactions(
        user=users.astype(np.int32), item=items.astype(np.int32),
        rating=(U @ V.T)[users, items].astype(np.float32), t=np.zeros(len(users)),
        user_map=JaxBiMap.string_int(f"u{i}" for i in range(N_USERS)),
        item_map=JaxBiMap.string_int(f"i{i}" for i in range(N_ITEMS)),
    )
    return train_als(MeshContext.create(devices=jax.devices()[:1]), inter,
                     JaxALSConfig(rank=4, iterations=4))


def _carry(m):
    inv_u, inv_i = m.user_map.inverse, m.item_map.inverse
    return als_model_from_arrays(m.user_factors, m.item_factors,
                                 [inv_u[i] for i in range(len(inv_u))],
                                 [inv_i[i] for i in range(len(inv_i))])


# (package modules, how to build its server) for each side
SIDES = {
    "jax": dict(storage=JaxStorage, memory=jax_memory, base=jax_base,
                persistence=jax_persistence, rec=jax_rec, qs=jax_qs,
                ctx=lambda: MeshContext.create(devices=jax.devices()[:1])),
    "port": dict(storage=PortStorage, memory=port_memory, base=port_base,
                 persistence=port_persistence, rec=port_rec, qs=port_qs,
                 ctx=lambda: DeviceContext.create(device="cpu")),
}


def _publish(side, storage, model, blob=None):
    s = SIDES[side]
    engine = s["rec"].RecommendationEngine.apply()
    params = engine.params_from_variant(VARIANT)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = s["base"].EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="f", **params.to_json_strings())
    iid = instances.insert(inst)
    if blob is None:
        raw = s["persistence"].serialize_models(
            iid, engine.make_algorithms(params), [model],
            [p for _, p in params.algorithm_params_list])
        blob = s["persistence"].seal_model_blob(raw)
    storage.get_model_data_models().insert(s["base"].Model(id=iid, models=blob))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


class Side:
    """One package's store, published model and (re)startable server."""

    def __init__(self, name, model, tmp_path, monkeypatch):
        self.name, self.s, self.model = name, SIDES[name], model
        self.tmp, self.mp = tmp_path / name, monkeypatch
        self.tmp.mkdir()
        src = "QO" + uuid.uuid4().hex[:8].upper()
        self.src = src
        self.storage = self.s["storage"](env={
            f"PIO_STORAGE_SOURCES_{src}_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
        })
        self.servers = []

    @contextlib.contextmanager
    def basedir(self):
        """Each package keeps its last-known-good pointer in its own base
        directory (the two packages name the pointer file alike)."""
        self.mp.setenv("PIO_FS_BASEDIR", str(self.tmp))
        yield

    def publish(self, blob=None):
        return _publish(self.name, self.storage, self.model, blob)

    def server(self, **kw):
        with self.basedir():
            qs = self.s["qs"].QueryServer(
                self.s["rec"].RecommendationEngine.apply(), storage=self.storage,
                ctx=self.s["ctx"](), **kw)
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        self.servers.append(qs)
        return qs, base

    def close(self):
        for qs in self.servers:
            with contextlib.suppress(Exception):
                qs.stop()
        self.s["memory"].reset_store(self.src)


@pytest.fixture()
def sides(jax_model, tmp_path, monkeypatch):
    for k in ("PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_TENANTS", "PIO_PIPELINE",
              "PIO_STREAMING", "PIO_PIN_INSTANCE", "PIO_FAULT_SPEC", "PIO_TELEMETRY",
              "PIO_POD_GROUP"):
        monkeypatch.delenv(k, raising=False)
    out = {"jax": Side("jax", jax_model, tmp_path, monkeypatch),
           "port": Side("port", _carry(jax_model), tmp_path, monkeypatch)}
    yield out
    for side in out.values():
        side.close()


def call(method, url, body=None, headers=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw[:1] in b"{[" else raw.decode()), r.headers
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw[:1] in b"{[" else raw.decode()), e.headers


def _same_answer(a, b):
    if a.get("itemScores") == [] or b.get("itemScores") == []:
        return a.get("itemScores") == b.get("itemScores")
    ia = np.array([[int(x["item"][1:]) for x in a["itemScores"]]])
    va = np.array([[x["score"] for x in a["itemScores"]]])
    ib = np.array([[int(x["item"][1:]) for x in b["itemScores"]]])
    vb = np.array([[x["score"] for x in b["itemScores"]]])
    return not topk_mismatches(vb, ib, va, ia, 1e-5)


@pytest.mark.parametrize("max_inflight,held,base_s", [(0, 0, 2.0), (2, 5, 1.5), (4, 1, 0.25)])
def test_shed_503_with_the_same_retry_after(sides, max_inflight, held, base_s):
    out = {}
    for name, side in sides.items():
        side.publish()
        qs, base = side.server(max_inflight=max_inflight, shed_retry_after_s=base_s)
        qs._inflight = held  # queries already inside the gate
        q = call("POST", base + "/queries.json", {"user": "u1", "num": 2})
        r = call("GET", base + "/readyz")
        qs._inflight = 0
        info = call("GET", base + "/")[1]
        out[name] = (q[0], q[1], q[2].get("Retry-After"), r[0], r[1]["status"],
                     r[2].get("Retry-After"), info["resilience"]["counters"]["shed"])
    assert out["jax"] == out["port"]
    if held >= max_inflight:
        assert out["port"][0] == 503 and out["port"][6] == 1
    else:
        assert out["port"][0] == 200


@pytest.mark.parametrize("how", ["header", "default"])
def test_lapsed_deadline_504(sides, how):
    out = {}
    for name, side in sides.items():
        side.publish()
        kw = {"default_deadline_ms": 0.0} if how == "default" else {}
        qs, base = side.server(**kw)
        hdr = {"X-Request-Deadline": "0"} if how == "header" else {}
        status, body, _ = call("POST", base + "/queries.json", {"user": "u1", "num": 2}, hdr)
        ok = call("POST", base + "/queries.json", {"user": "u1", "num": 2},
                  {"X-Request-Deadline": "60000"})[0] if how == "header" else 504
        counters = call("GET", base + "/")[1]["resilience"]["counters"]
        out[name] = (status, body, ok, counters["deadline_exceeded"])
    assert out["jax"] == out["port"]
    assert out["port"][0] == 504 and out["port"][3] == 1


@pytest.mark.parametrize("batching", [False, True])
def test_scorer_failure_serves_a_degraded_answer(sides, batching):
    out = {}
    for name, side in sides.items():
        side.publish()
        qs, base = side.server(batching=batching)
        good = call("POST", base + "/queries.json", {"user": "u3", "num": 4})[1]
        algo = qs._deployed.algorithms[0]

        def down(*a, **k):
            raise RuntimeError("scorer down")

        algo.predict = down
        algo.batch_predict = down
        status, body, _ = call("POST", base + "/queries.json", {"user": "u9", "num": 4})
        counters = call("GET", base + "/")[1]["resilience"]["counters"]
        del algo.predict, algo.batch_predict
        fresh = call("POST", base + "/queries.json", {"user": "u9", "num": 4})[1]
        out[name] = (status, body, good, counters["degraded"], counters["query_errors"], fresh)
    j, p = out["jax"], out["port"]
    assert (j[0], j[3], j[4]) == (p[0], p[3], p[4]) == (200, 1, 0)
    assert p[1]["degraded"] is True and j[1]["degraded"] is True
    assert _same_answer(p[1], p[2]) and _same_answer(j[1], p[1])
    assert "degraded" not in p[5] and _same_answer(j[5], p[5])


def test_kernel_error_answers_500(sides):
    """The logged difference: the port lets a card's failure through."""
    out = {}
    for name, side in sides.items():
        side.publish()
        qs, base = side.server(batching=True)
        call("POST", base + "/queries.json", {"user": "u3", "num": 4})

        def broken(*a, **k):
            raise KernelError("score kernel dispatch: CUDA error: an illegal memory access")

        algo = qs._deployed.algorithms[0]
        algo.batch_predict = broken
        algo.predict = broken
        status, body, _ = call("POST", base + "/queries.json", {"user": "u9", "num": 4})
        counters = call("GET", base + "/")[1]["resilience"]["counters"]
        out[name] = (status, body, counters["degraded"], counters["query_errors"])
    assert out["port"][0] == 500 and "CUDA error" in out["port"][1]["message"]
    assert out["port"][2:] == (0, 1)
    # the JAX server serves its newest good answer for any exception
    assert out["jax"][0] == 200 and out["jax"][1]["degraded"] and out["jax"][2:] == (1, 0)


def test_failed_reload_keeps_the_live_generation_and_cold_start_uses_lkg(sides):
    out = {}
    for name, side in sides.items():
        first = side.publish()
        qs, base = side.server()
        good = side.publish()  # a newer good instance the cold start must NOT take
        bad_blob = side.storage.get_model_data_models().get(good).models[:-7] + b"garbage"
        side.publish(blob=bad_blob)  # the newest, torn
        with side.basedir():
            status, rl, _ = call("POST", base + "/reload")
        rz = call("GET", base + "/readyz")[1]
        counters = call("GET", base + "/")[1]["resilience"]["counters"]
        answer = call("POST", base + "/queries.json", {"user": "u2", "num": 3})
        cold, cbase = side.server()
        cz = call("GET", cbase + "/readyz")[1]
        ccounters = call("GET", cbase + "/")[1]["resilience"]["counters"]
        out[name] = dict(
            reload=(status, rl["engineInstanceId"] == first), degraded=rz["reloadDegraded"],
            reload_failed=counters["reload_failed"], answer=answer[0],
            cold=(cz["engineInstanceId"] == first, cz["reloadDegraded"], cz["status"]),
            cold_failed=ccounters["reload_failed"])
    assert out["jax"] == out["port"]
    assert out["port"]["reload"] == (200, True) and out["port"]["cold"] == (True, True, "ready")


@pytest.mark.parametrize("budget_ms,sleep_s", [(3000, 0.3), (50, 0.6)])
def test_drain_finishes_or_counts_in_flight_work(sides, budget_ms, sleep_s):
    out = {}
    for name, side in sides.items():
        side.publish()
        qs, base = side.server()
        orig = qs.handle_query

        def slow(data, deadline=None, **kw):
            time.sleep(sleep_s)
            return orig(data, deadline)

        qs.handle_query = slow
        got = {}
        t = threading.Thread(target=lambda: got.update(
            r=call("POST", base + "/queries.json", {"user": "u1", "num": 2})))
        t.start()
        while qs._inflight == 0:
            time.sleep(0.005)
        drained = {}
        d = threading.Thread(target=lambda: drained.update(clean=qs.drain(timeout_ms=budget_ms)))
        d.start()
        while not qs._draining:
            time.sleep(0.002)
        # a query arriving during the drain is shed with the drain's hint
        shed = call("POST", base + "/queries.json", {"user": "u2", "num": 2}) \
            if budget_ms > 1000 else None
        d.join(10)
        t.join(10)
        clean = drained["clean"]
        counters = qs.counters.snapshot()
        out[name] = (clean, counters["drained"], counters["drain_abandoned"],
                     got["r"][0] if "r" in got and not isinstance(got["r"], Exception) else None,
                     None if shed is None else (shed[0], shed[2].get("Retry-After")))
    assert out["jax"][:3] == out["port"][:3]
    if budget_ms > 1000:
        assert out["port"] == out["jax"] and out["port"][:4] == (True, 1, 0, 200)
        assert out["port"][4][0] == 503
    else:
        assert out["port"][:3] == (False, 0, 1)


def test_feedback_events_land_in_a_port_event_server(sides):
    port = sides["port"]
    app_id = port.storage.get_meta_data_apps().insert(port_base.App(0, "fbapp"))
    port.storage.get_meta_data_access_keys().insert(port_base.AccessKey("fbkey-012345", app_id, []))
    port.storage.get_l_events().init(app_id)
    es = EventServer(storage=port.storage)
    es_url = f"http://127.0.0.1:{es.start('127.0.0.1', 0)}"
    answers = {}
    try:
        for name, side in sides.items():
            side.publish()
            qs, base = side.server(feedback=True, event_server_url=es_url,
                                   access_key="fbkey-012345")
            answers[name] = [call("POST", base + "/queries.json",
                                  {"user": f"u{i}", "num": 3, "prId": f"{name}-{i}"})[1]
                             for i in range(5)]
            answers[name].append(call("POST", base + "/queries.json", {"user": "u7", "num": 2})[1])
        t_end = time.monotonic() + 20
        while time.monotonic() < t_end:
            events = port.storage.get_l_events().find(app_id, event_names=["predict"], limit=-1)
            if len(events) >= 12:
                break
            time.sleep(0.05)
    finally:
        es.stop()
    by_pr = {e.entity_id: e for e in events}
    assert len(events) == 12 and all(e.entity_type == "pio_pr" for e in events)
    for name in sides:
        for i, a in enumerate(answers[name][:5]):
            assert a["prId"] == f"{name}-{i}"
            ev = by_pr[a["prId"]]
            assert ev.properties["query"] == {"user": f"u{i}", "num": 3, "prId": f"{name}-{i}"}
            assert ev.properties["prediction"] == a
        assert len(answers[name][5]["prId"]) == 16  # a fresh token_hex(8)
        assert answers[name][5]["prId"] in by_pr
    for a, b in zip(answers["jax"], answers["port"]):
        assert _same_answer(a, b)


def test_metrics_families_equal_by_name(sides):
    """After the same traffic, ``/metrics`` of both servers carries the same
    families by name, but for the JAX server's profile captures (``POST
    /debug/profile``, ROADMAP item 15)."""
    fams = {}
    for name, side in sides.items():
        side.publish()
        qs, base = side.server(batching=True, result_cache=None, coalesce=False)
        for i in range(6):
            call("POST", base + "/queries.json", {"user": f"u{i}", "num": 3})
        call("POST", base + "/queries.json", {"user": "u1", "num": 3},
             {"X-Request-Deadline": "0"})
        call("GET", base + "/trace/recent.json")
        status, text, _ = call("GET", base + "/metrics")
        assert status == 200
        parse_prometheus(text)
        fams[name] = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
        fams[name] = {f for f in fams[name] if not f.startswith("pio_train_kernel_")}
        traces = call("GET", base + "/trace/recent.json?limit=50")[1]
        assert traces["service"] == "queryserver"
    assert fams["port"] <= fams["jax"]
    assert fams["jax"] - fams["port"] == {"pio_profile_captures_total",
                                          "pio_profile_last_capture_unix"}
    for must in ("pio_query_errors_total", "pio_batcher_batches_total",
                 "pio_fastpath_calls_total", "pio_device_busy_fraction",
                 "pio_http_requests_total", "pio_query_latency_seconds"):
        assert must in fams["port"], must


def test_plugins_json_and_output_blocker_alike(sides):
    out = {}
    for name, side in sides.items():
        qs_mod = side.s["qs"]

        class Blocker(qs_mod.EngineServerPlugin):
            name = "keep-two"
            plugin_type = qs_mod.EngineServerPlugin.OUTPUT_BLOCKER

            def process(self, query, prediction, context):
                return {**prediction, "itemScores": prediction["itemScores"][:2]}

        class Sniffer(qs_mod.EngineServerPlugin):
            name = "sniff"
            plugin_type = qs_mod.EngineServerPlugin.OUTPUT_SNIFFER

            def process(self, query, prediction, context):
                raise RuntimeError("sniffer failure is counted, never served")

        side.publish()
        qs, base = side.server(plugins=[Blocker(), Sniffer()])
        plugins = call("GET", base + "/plugins.json")[1]
        ans = call("POST", base + "/queries.json", {"user": "u4", "num": 5})
        counters = call("GET", base + "/")[1]["resilience"]["counters"]
        out[name] = (plugins, ans[0], len(ans[1]["itemScores"]), counters["sniffer_errors"])
    assert out["jax"] == out["port"] and out["port"][1:] == (200, 2, 1)


@pytest.mark.parametrize("kw,item", [({"tenants": object()}, 13), ({"pipeline": object()}, 13)])
def test_waiting_options_name_their_item(sides, kw, item):
    side = sides["port"]
    side.publish()
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        side.server(**kw)


@pytest.mark.parametrize("env,item", [("PIO_TENANTS", 13), ("PIO_PIPELINE", 13), ("PIO_STREAMING", 8),
                                      ("PIO_POD_GROUP", 10)])
def test_waiting_env_knobs_name_their_item(sides, monkeypatch, env, item):
    side = sides["port"]
    side.publish()
    monkeypatch.setenv(env, "1")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        side.server()
