"""Pod serving across processes and the router's pod-group routing.

* Two gloo processes of 2 CPU placements each serve a pod plan of 2 host
  groups × 2 shards in lockstep (every process dispatches the same batches
  in the same order): each process launches the score path once a local
  shard, merges its host row (tier 1) and gathers the other process's row
  (tier 2). Every answer, at every rung and dtype, equals the one-process
  pod serve on 4 placements BIT FOR BIT; a delta is skipped there.
* A query server deployed on that mesh (an instance published with
  ``PIO_SHARD_COUNT=4 PIO_POD_HOST_GROUPS=2``) answers ``/readyz`` 503 with
  the group withheld and ``/queries.json`` 503 with the JAX server's body.
* With ``PIO_POD_GROUP`` pinned, a one-process pod replica advertises that
  group; the port's router and the JAX router, over the same two stub
  replicas (group 0 and 1), give every request body the same owner group
  and the same ``pio_pod_queries_routed_total{group}`` counts; both ignore
  adverts of meshes that span processes.

The workers import this module for its helpers (the JAX package is imported
inside the tests that use it), with jax and the JAX package blocked.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.request
import uuid
import zlib

import numpy as np
import pytest

from predictionio_tpu_torch.common.http import HttpService, json_response
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.obs import metrics
from predictionio_tpu_torch.ops.quantize import quantize_factors
from predictionio_tpu_torch.serving import sharding
from predictionio_tpu_torch.serving.fastpath import BUCKETS, BucketedScorer
from predictionio_tpu_torch.serving.router import Router

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS, RANK = 90, 300, 8
BLOCKED = "import sys\nsys.modules['jax'] = None\nsys.modules['predictionio_tpu'] = None\n"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _factors():
    rng = np.random.default_rng(7)
    U = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    V[:6] = V[6]  # ties across shards
    return U, V


def _scorer(ctx, dtype):
    U, V = _factors()
    plan = sharding.build_plan(N_ITEMS, 4, weights=np.linalg.norm(V, axis=1), host_groups=2)
    kw = {}
    if dtype != "f32":
        (U, us), (V, vs) = quantize_factors(U, dtype), quantize_factors(V, dtype)
        kw = {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}
    return BucketedScorer(ctx, U, V, max_k=20, plan=plan, sharding="sharded", **kw)


def _batches():
    return [np.random.default_rng(b).integers(0, N_USERS, b).astype(np.int32) for b in BUCKETS]


WORKER = BLOCKED + """
import json, urllib.request, urllib.error
import numpy as np
from predictionio_tpu_torch.parallel import distributed
assert distributed.initialize()
pid = distributed.process_index()
import test_torch_pod_processes as T
from predictionio_tpu_torch.device import DeviceContext
ctx = DeviceContext.create(devices=["cpu"] * 2)
out = {}
for dtype in ("f32", "bf16", "int8"):
    sc = T._scorer(ctx, dtype)
    assert sc._pod and sc._shard_ctx.spans_processes and len(sc._factors[1]) == 2
    res = [sc.score_topk(u, 20) for u in T._batches()]
    out[dtype] = [[i.tolist(), v.tolist()] for i, v in res]
    if dtype == "f32":
        out["pod"] = sc.stats()["pod"]
        out["delta"] = sc.apply_delta_rows([1], np.ones((1, T.RANK), np.float32))
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
qs = QueryServer(RecommendationEngine.apply(), storage=Storage.instance(), ctx=ctx,
                 batching=True, engine_id=FACTORY, telemetry=False)
base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"

def call(path, body=None):
    req = urllib.request.Request(base + path, data=body, method="POST" if body else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

out["readyz"] = call("/readyz")
out["queries"] = call("/queries.json", json.dumps({"user": "u1", "num": 3}).encode())
qs.stop()
with open(f"{DIR}/pod{pid}.json", "w") as f:
    json.dump(out, f)
distributed.barrier()
distributed.shutdown()
"""


@pytest.fixture(scope="module")
def pod_launch(tmp_path_factory):
    """Publish an instance with a pod plan (one process), then run the two
    lockstep workers."""
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    d = tmp_path_factory.mktemp("pod")
    name = "PD" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{name}_PATH": str(d / "pio.sqlite"),
           "PIO_FS_BASEDIR": str(d / "base")}
    for r in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = name
    factory = "predictionio_tpu_torch.templates.recommendation.RecommendationEngine"
    saved = {k: os.environ.get(k) for k in
             ("PIO_FS_BASEDIR", "PIO_SHARD_COUNT", "PIO_POD_HOST_GROUPS")}
    os.environ.update({"PIO_FS_BASEDIR": env["PIO_FS_BASEDIR"], "PIO_SHARD_COUNT": "4",
                       "PIO_POD_HOST_GROUPS": "2"})
    try:
        st = Storage(env=env)
        app_id = st.get_meta_data_apps().insert(App(0, "P"))
        rng = np.random.default_rng(3)
        st.get_l_events().insert_batch(
            [Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                   target_entity_id=f"i{int(i)}", properties={"rating": 4.0})
             for u in range(40) for i in rng.choice(40, 6, replace=False)], app_id)
        store.set_storage(st)
        engine = RecommendationEngine.apply()
        params = engine.params_from_variant({
            "datasource": {"params": {"appName": "P"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2,
                                                       "persistMode": "checkpoint"}}]})
        run_train(engine, params, factory, storage=st, engine_id=factory,
                  ctx=DeviceContext.create(device="cpu"))
    finally:
        store.set_storage(None)
        port_sqlite.close_all_dbs()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wenv = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and not k.startswith("PIO_SHARD")}
    wenv.update(env)
    wenv.update({"PYTHONPATH": f"{ROOT / 'tests'}{os.pathsep}{ROOT}", "PIO_NUM_PROCESSES": "2",
                 "OMP_NUM_THREADS": "1"})
    code = f"DIR = {str(d)!r}\nFACTORY = {factory!r}\n" + WORKER
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=d, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(wenv, PIO_COORDINATOR=f"127.0.0.1:{port}",
                                       PIO_PROCESS_ID=str(i)))
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return [json.load(open(d / f"pod{i}.json")) for i in range(2)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_lockstep_dispatches_equal_the_one_process_pod_serve(pod_launch, dtype):
    one = _scorer(DeviceContext.create(devices=["cpu"] * 4), dtype)
    assert one._pod and not one._shard_ctx.spans_processes
    for b, users in enumerate(_batches()):
        idx, val = one.score_topk(users, 20)
        for w in pod_launch:
            gi, gv = w[dtype][b]
            assert np.array_equal(np.array(gi, idx.dtype), idx)
            assert np.array(gv, np.float32).tobytes() == val.astype(np.float32).tobytes()


def test_pod_stats_and_deltas_on_a_mesh_that_spans_processes(pod_launch):
    for pid, w in enumerate(pod_launch):
        pod = w["pod"]
        assert (pod["process_index"], pod["process_count"], pod["spans_processes"]) == (pid, 2, True)
        assert pod["host_groups"] == 2 and pod["dispatches"] == len(BUCKETS)
        assert w["delta"]["skipped"] == "pod" and w["delta"]["users"] == 0


def test_readyz_and_queries_refuse_with_the_jax_bodies(pod_launch, monkeypatch):
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.serving import query_server as jax_qs

    # the JAX server's refusal, from its own route (its lockstep flag forced)
    empty = JaxStorage(env={f"PIO_STORAGE_SOURCES_J{uuid.uuid4().hex[:8].upper()}_TYPE": "memory"})
    monkeypatch.setattr(jax_qs.QueryServer, "reload", lambda self, *a, **k: None)  # no instance
    jserver = jax_qs.QueryServer(None, storage=empty, telemetry=False)
    monkeypatch.setattr(jserver, "_pod_lockstep", lambda: True)
    port = jserver.start("127.0.0.1", 0)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                     data=b'{"user": "u1"}', method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        jbody = json.loads(e.value.read())
        assert e.value.code == 503
    finally:
        jserver.stop()
    for pid, w in enumerate(pod_launch):
        status, body = w["queries"]
        assert status == 503 and body == jbody
        status, body = w["readyz"]
        assert status == 503 and body["status"] == "pod mesh spans processes (lockstep only)"
        assert body["pod"]["group"] is None and body["pod"]["spansProcesses"] is True
        assert body["pod"]["processIndex"] == pid and body["pod"]["processCount"] == 2


def test_pod_group_pins_a_self_contained_replicas_group(monkeypatch):
    """A one-process pod replica advertises PIO_POD_GROUP as its group (the
    JAX server's rule); without it, its process index."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.serving import query_server as qs_mod

    empty = Storage(env={f"PIO_STORAGE_SOURCES_P{uuid.uuid4().hex[:8].upper()}_TYPE": "memory"})
    monkeypatch.setattr(qs_mod.QueryServer, "reload", lambda self, *a, **k: None)  # no instance
    server = qs_mod.QueryServer(None, storage=empty, telemetry=False,
                                ctx=DeviceContext.create(device="cpu"))
    pod = {"pod": {"host_groups": 2, "fingerprint": "fp", "process_index": 0,
                   "process_count": 1, "spans_processes": False}}
    monkeypatch.setattr(server, "_fastpath_stats", lambda: pod)
    port = server.start("127.0.0.1", 0)
    try:
        for env, want in (("", 0), ("1", 1)):
            monkeypatch.setenv("PIO_POD_GROUP", env)
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=10)
            except urllib.error.HTTPError as e:  # not deployed: 503, body still carries pod
                body = json.loads(e.read())
            assert body["pod"]["group"] == want and body["pod"]["groups"] == 2
    finally:
        server.stop()


def _stub(group: int, spans: bool = False) -> tuple[HttpService, int]:
    svc = HttpService("podstub")

    @svc.route("GET", r"/readyz")
    def readyz(req):
        return json_response(200, {
            "status": "ready", "generation": 1, "fastpathWarm": True, "draining": False,
            "pod": {"group": group, "groups": 2, "fingerprint": "fp-pod", "processIndex": group,
                    "processCount": 2, "spansProcesses": spans},
        })

    @svc.route("POST", r"/queries\.json")
    def queries(req):
        return json_response(200, {"group": group})

    return svc, svc.start("127.0.0.1", 0)


def _post(base, user):
    req = urllib.request.Request(base + "/queries.json", method="POST",
                                 data=json.dumps({"user": user, "num": 3}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())["group"]


def _wait(fn, timeout=20.0):
    t0 = time.monotonic()
    while not fn():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.05)


@pytest.mark.parametrize("spans", [False, True])
def test_router_group_routing_equals_the_jax_router(spans):
    from predictionio_tpu.serving.router import Router as JaxRouter

    stubs = [_stub(g, spans) for g in (0, 1)]
    urls = [f"http://127.0.0.1:{port}" for _, port in stubs]
    routers = {"port": Router(urls, telemetry=True), "jax": JaxRouter(urls, telemetry=False)}
    bases = {}
    try:
        for k, r in routers.items():
            # never eject a stub on a slow probe: the picks must be the owners'
            r.health_interval_ms = 50.0
            r.probe_timeout_ms = 5000.0
            r.eject_after = 10**6
            r.outlier_min_samples = 10**6
            bases[k] = f"http://127.0.0.1:{r.start('127.0.0.1', 0)}"
            _wait(lambda r=r: all(x["generation"] is not None for x in r.stats()["replicas"]))
        users = [f"user-{i}" for i in range(40)]
        bodies = [json.dumps({"user": u, "num": 3}).encode() for u in users]
        owners = {k: [r._owner_group(b) for b in bodies] for k, r in routers.items()}
        assert owners["port"] == owners["jax"]
        if spans:
            assert owners["port"] == [None] * len(users)
        else:
            assert owners["port"] == [zlib.crc32(u.encode()) % 2 for u in users]
        answered = {k: [_post(bases[k], u) for u in users] for k in routers}
        if not spans:
            assert answered["port"] == answered["jax"] == owners["port"]
        pods = {k: r.stats()["pod"] for k, r in routers.items()}
        assert pods["port"] == pods["jax"]
        if spans:
            assert pods["port"] is None
            assert all(x["podGroup"] is None for x in routers["port"].stats()["replicas"])
        else:
            series = metrics.parse_prometheus(routers["port"].telemetry.registry.render_prometheus())
            routed = {dict(lbl)["group"]: v for (n, lbl), v in series.items()
                      if n == "pio_pod_queries_routed_total"}
            assert routed == {g: float(n) for g, n in pods["jax"]["queriesRouted"].items()}
    finally:
        for r in routers.values():
            r.stop()
        for svc, _ in stubs:
            svc.stop()
