"""``pio export``/``import``, ``instances``, ``status`` and
``storageserver`` on the port, and the shared-storage slice whole.

* ``pio export`` writes the lines the JAX export writes for the same store,
  from sqlite, through the network driver and from postgres; ``pio import``
  into postgres (the ``jdbc`` alias) round-trips every event, and a
  ``search`` for a property value finds the same ids on sqlite, postgres and
  the network driver.
* ``pio instances`` prints what the JAX verb prints; ``pio status`` shows
  the bindings the JAX verb shows (``jdbc→postgres`` included); ``pio
  storageserver`` serves a sqlite store with torch, jax and the JAX package
  all blocked (it opens no CUDA context).
* The slice: the same events trained by ``run_train`` through postgres + s3
  and through the network driver give the port's sqlite training's factors
  bit for bit; from the JAX trainer's initial draw, the port's training
  through postgres + s3 is within 1e-4 of the JAX package's ``run_train``
  over its own postgres driver; and a model the JAX package wrote into an
  s3stub deploys in the port with answers within 1e-4.

Every server binds port 0 and stops in a ``finally``; subprocesses and
requests carry time limits of their own.
"""

import contextlib
import functools
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from predictionio_tpu.core import workflow as jax_workflow
from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import postgres as jax_postgres
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import export_import as jax_export
from predictionio_tpu_torch.core import workflow
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage import postgres
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.network import StorageServer
from predictionio_tpu_torch.data.storage.pgstub import PGStub
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.storage.s3stub import S3Stub
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.tools.export_import import export_events, import_events

APP = "Remote"
FACTORY = "predictionio_tpu_torch.templates.recommendation.RecommendationEngine"
RANK, ITERS, SEED = 5, 4, 3
CPU = DeviceContext.create(device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(mod, n=900, seed=0):
    """Rate and buy events with fixed ids and times, as ``mod.Event``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u, i = f"u{int(rng.integers(40))}", f"i{int(rng.integers(30))}"
        t = 1_767_225_600 + int(rng.integers(0, n // 2))  # ties in event time
        if k % 6 == 0:
            out.append(mod.Event(event="buy", entity_type="user", entity_id=u,
                                 target_entity_type="item", target_entity_id=i,
                                 event_time=t, creation_time=1_767_225_600 + k,
                                 event_id=f"ev{k:05d}"))
        else:
            out.append(mod.Event(event="rate", entity_type="user", entity_id=u,
                                 target_entity_type="item", target_entity_id=i,
                                 properties={"rating": int(rng.integers(1, 6))},
                                 event_time=t, creation_time=1_767_225_600 + k,
                                 event_id=f"ev{k:05d}", tags=("t",) if k % 7 == 0 else ()))
    return out


def _env(name, **attrs):
    env = {f"PIO_STORAGE_SOURCES_{name}_{k}": str(v) for k, v in attrs.items()}
    env.update({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": name
                for r in ("METADATA", "EVENTDATA", "MODELDATA")})
    return env


@pytest.fixture()
def layouts(tmp_path):
    """A port sqlite store holding the events (app ``APP``), and the env of
    each remote layout: postgres (jdbc alias) + s3, and the network driver
    on a StorageServer over the sqlite store. Servers stop at the end."""
    pg = PGStub(users={"pio": "pw"})
    s3 = S3Stub(access_key="ak", secret_key="sk")
    server = None
    sqlite_env = _env("LOCAL", TYPE="sqlite", PATH=tmp_path / "local.sqlite")
    pg_url = f"postgresql://pio:pw@127.0.0.1:{pg.start()}/pio"
    try:
        local = Storage(env=sqlite_env)
        app_id = local.get_meta_data_apps().insert(base.App(0, APP))
        local.get_l_events().insert_batch(_events(port_event), app_id)
        server = StorageServer(local, secret="sec")
        net_port = server.start("127.0.0.1", 0)
        pg_env = {**_env("PG", TYPE="jdbc", URL="jdbc:" + pg_url),
                  "PIO_STORAGE_SOURCES_S3M_TYPE": "s3",
                  "PIO_STORAGE_SOURCES_S3M_ENDPOINT": f"http://127.0.0.1:{s3.start()}",
                  "PIO_STORAGE_SOURCES_S3M_BUCKET": "models",
                  "PIO_STORAGE_SOURCES_S3M_ACCESS_KEY": "ak",
                  "PIO_STORAGE_SOURCES_S3M_SECRET_KEY": "sk",
                  "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3M"}
        net_env = _env("NET", TYPE="network", URL=f"http://127.0.0.1:{net_port}", SECRET="sec",
                       TIMEOUT=30, CHUNK_ROWS=128)
        yield {"sqlite": sqlite_env, "postgres": pg_env, "network": net_env, "app_id": app_id,
               "pg_url": pg_url, "tmp": tmp_path}
    finally:
        if server is not None:
            server.stop()
        postgres.close_pg(pg_url)
        jax_postgres.close_pg(pg_url)
        pg.stop()
        s3.stop()
        port_sqlite.close_all_dbs()
        jax_sqlite.close_all_dbs()


def _import_into_postgres(layouts, path):
    """App ``APP`` created in postgres, then the export file imported."""
    pg = Storage(env=layouts["postgres"])
    app_id = pg.get_meta_data_apps().insert(base.App(0, APP))
    assert import_events(pg, app_id, str(path)) == 900
    return pg, app_id


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("driver", ["sqlite", "network", "postgres"])
def test_export_lines_equal_the_jax_export(layouts, driver):
    tmp = layouts["tmp"]
    ref = JaxStorage(env=_env("REF", TYPE="sqlite", PATH=tmp / "ref.sqlite"))
    ref_app = ref.get_meta_data_apps().insert(jax_base.App(0, APP))
    ref.get_l_events().insert_batch(_events(jax_event), ref_app)
    n, written = jax_export.export_events(ref, ref_app, str(tmp / "jax.json"))
    assert n == 900 and written == str(tmp / "jax.json")
    if driver == "postgres":
        export_events(Storage(env=layouts["sqlite"]), layouts["app_id"], str(tmp / "seed.json"))
        store, app_id = _import_into_postgres(layouts, tmp / "seed.json")
    else:
        store, app_id = Storage(env=layouts[driver]), layouts["app_id"]
    n, written = export_events(store, app_id, str(tmp / "port.json"))
    assert n == 900 and written == str(tmp / "port.json")
    assert _lines(tmp / "port.json") == _lines(tmp / "jax.json")


def test_import_round_trips_and_search_agrees(layouts):
    tmp = layouts["tmp"]
    local = Storage(env=layouts["sqlite"])
    export_events(local, layouts["app_id"], str(tmp / "out.json"))
    pg, pg_app = _import_into_postgres(layouts, tmp / "out.json")
    net = Storage(env=layouts["network"])
    key = lambda e: json.dumps(e.to_dict(), sort_keys=True)  # noqa: E731
    stores = ((local, layouts["app_id"]), (pg, pg_app), (net, layouts["app_id"]))
    found = [[key(e) for e in s.get_l_events().find(a)] for s, a in stores]
    assert found[0] == found[1] == found[2] and len(found[0]) == 900
    hits = [sorted(e.event_id for e in s.get_l_events().search(a, '"rating": 5')) for s, a in stores]
    assert hits[0] == hits[1] == hits[2] and len(hits[0]) > 50
    # the bulk PEvents path (framed through the network driver) agrees too
    batches = [s.get_p_events().find(a) for s, a in stores]
    assert all(b.event_id.tolist() == batches[0].event_id.tolist() for b in batches)
    # importing the same file again is idempotent by event id
    assert import_events(pg, pg_app, str(tmp / "out.json")) == 900
    assert len(pg.get_p_events().find(pg_app)) == 900


def _cli(mod, argv, env, monkeypatch):
    """One in-process ``pio`` call of either package under ``env``: its exit
    code and standard output."""
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    Storage.reset_instance()
    JaxStorage.reset_instance()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    Storage.reset_instance()
    JaxStorage.reset_instance()
    return rc, buf.getvalue()


def test_cli_export_import_and_status(layouts, monkeypatch):
    tmp = layouts["tmp"]
    rc, out = _cli(port_cli, ["export", "--appid", str(layouts["app_id"]),
                              "--output", str(tmp / "cli.json")], layouts["sqlite"], monkeypatch)
    assert rc == 0 and out.strip() == f"[INFO] Exported 900 events to {tmp / 'cli.json'}"
    rc, out = _cli(port_cli, ["app", "new", APP], layouts["postgres"], monkeypatch)
    assert rc == 0
    app_id = int(out.split("App created: ID ")[1].split(",")[0])
    rc, out = _cli(port_cli, ["import", "--appid", str(app_id), "--input", str(tmp / "cli.json")],
                   layouts["postgres"], monkeypatch)
    assert rc == 0 and out.strip() == "[INFO] Imported 900 events."
    for env, want in ((layouts["postgres"], ("jdbc→postgres", "jdbc→postgres", "s3")),
                      (layouts["network"], ("network",) * 3)):
        rc, port_out = _cli(port_cli, ["status"], env, monkeypatch)
        rc_ref, ref_out = _cli(jax_cli, ["status"], env, monkeypatch)
        assert rc == rc_ref == 0
        binding = lambda o: [line for line in o.splitlines() if "-> source" in line]  # noqa: E731
        assert binding(port_out) == binding(ref_out)
        assert [line.split("(type ")[1].rstrip(")") for line in binding(port_out)] == list(want)
    # events on a parquet source, metadata on sqlite (the JAX CLI test's
    # pairing): import, export and status work as the JAX verbs do, and the
    # JAX CLI exports the port-written store line for line
    pq_env = {**_env("META", TYPE="sqlite", PATH=tmp / "meta.sqlite"),
              "PIO_STORAGE_SOURCES_PQ_TYPE": "parquet",
              "PIO_STORAGE_SOURCES_PQ_PATH": str(tmp / "pq"),
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PQ"}
    rc, out = _cli(port_cli, ["app", "new", APP], pq_env, monkeypatch)
    assert rc == 0
    pq_app = int(out.split("App created: ID ")[1].split(",")[0])
    rc, out = _cli(port_cli, ["import", "--appid", str(pq_app), "--input", str(tmp / "cli.json")],
                   pq_env, monkeypatch)
    assert rc == 0 and out.strip() == "[INFO] Imported 900 events."
    assert (tmp / "pq" / f"app_{pq_app}_ch_0").is_dir()
    for mod, name in ((port_cli, "pq-port.json"), (jax_cli, "pq-jax.json")):
        rc, out = _cli(mod, ["export", "--appid", str(pq_app), "--output", str(tmp / name)],
                       pq_env, monkeypatch)
        assert rc == 0 and "Exported 900 events" in out, out
    assert _lines(tmp / "pq-port.json") == _lines(tmp / "pq-jax.json") == _lines(tmp / "cli.json")
    rc, port_out = _cli(port_cli, ["status"], pq_env, monkeypatch)
    rc_ref, ref_out = _cli(jax_cli, ["status"], pq_env, monkeypatch)
    binding = lambda o: [line for line in o.splitlines() if "-> source" in line]  # noqa: E731
    assert rc == rc_ref == 0 and binding(port_out) == binding(ref_out)
    assert "(type parquet)" in "\n".join(binding(port_out))


def _instances(b):
    now = 1_767_225_600
    import datetime as dt

    t = lambda s: dt.datetime.fromtimestamp(now + s, tz=dt.timezone.utc)  # noqa: E731
    eng = [b.EngineInstance(id=f"i{k}", status=("COMPLETED", "ABORTED")[k % 2], start_time=t(k),
                            end_time=t(k), engine_id="e", engine_version="1",
                            engine_variant=f"v{k % 2}", engine_factory=("a.ALS", "b.UR")[k % 2],
                            algorithms_params=f'[{{"rank": {k}}}]') for k in range(6)]
    evs = [b.EvaluationInstance(id=f"x{k}", status=("EVALCOMPLETED", "INIT")[k % 2],
                                start_time=t(k), end_time=t(k), evaluation_class="Prec",
                                evaluator_results=f"p@k={k}") for k in range(3)]
    return eng, evs


@pytest.mark.parametrize("argv", [
    ["instances", "--json"],
    ["instances", "--json", "--status", "COMPLETED", "--limit", "2"],
    ["instances", "--json", "--factory", "b.UR", "--text", "RANK"],
    ["instances", "--json", "--since", "2026-01-01T00:00:02Z", "--until", "2026-01-01T00:00:05Z"],
    ["instances", "--eval", "--json", "--text", "p@k=2"],
    ["instances", "--status", "COMPLETED"],
    ["instances", "--eval", "--variant", "v1"],
])
def test_instances_verb_prints_what_jax_prints(tmp_path, monkeypatch, argv):
    outs = []
    for cli, cls, b in ((port_cli, Storage, base), (jax_cli, JaxStorage, jax_base)):
        env = _env("I", TYPE="sqlite", PATH=tmp_path / f"{b.__name__}.sqlite")
        s = cls(env=env)
        eng, evs = _instances(b)
        for i in eng:
            s.get_meta_data_engine_instances().insert(i)
        for i in evs:
            s.get_meta_data_evaluation_instances().insert(i)
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc, out = _cli(cli, argv, env, monkeypatch)
        outs.append((rc, out, err.getvalue()))
    assert outs[0] == outs[1]
    if "--json" in argv:
        assert isinstance(json.loads(outs[0][1]), list)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_storageserver_verb_serves_without_torch(layouts):
    port = _free_port()
    code = f"""
import sys
for m in ('torch', 'jax', 'predictionio_tpu'):
    sys.modules[m] = None
from predictionio_tpu_torch.tools import cli
sys.exit(cli.main(['storageserver', '--ip', '127.0.0.1', '--port', '{port}', '--secret', 'sec']))
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(layouts["sqlite"], PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t_end = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                             headers={"X-PIO-Storage-Secret": "sec"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    info = json.loads(r.read())
                break
            except OSError:
                assert time.monotonic() < t_end
                time.sleep(0.05)
        assert info["capabilities"] == ["framed_scan", "search_query", "sharded_scan"]
        assert info["repositories"]["EVENTDATA"] == {"source": "LOCAL", "type": "sqlite"}
        net = Storage(env=_env("NET", TYPE="network", URL=f"http://127.0.0.1:{port}",
                               SECRET="sec", TIMEOUT=30))
        assert len(net.get_p_events().find(layouts["app_id"])) == 900
    finally:
        proc.kill()
        out, err = proc.communicate(timeout=30)
    assert "Storage Server is listening" in out


def _variant():
    return {"engineFactory": FACTORY, "datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "als", "params": {"rank": RANK, "numIterations": ITERS,
                                                      "lambda": 0.05, "seed": SEED}}]}


def _port_trained(storage):
    """``run_train`` through ``storage`` (the data source reads the ambient
    store), then the COMPLETED instance's model as deploy loads it."""
    engine = rec.RecommendationEngine.apply()
    port_store.set_storage(storage)
    try:
        iid = workflow.run_train(engine, engine.params_from_variant(_variant()), FACTORY,
                                 storage=storage, ctx=CPU)
        inst = storage.get_meta_data_engine_instances().get(iid)
        assert inst.status == "COMPLETED"
        return workflow.prepare_deploy(engine, inst, storage=storage, ctx=CPU)[3][0]
    finally:
        port_store.set_storage(None)


def _maps(m):
    return ([m.user_map.inverse[i] for i in range(len(m.user_map))],
            [m.item_map.inverse[i] for i in range(len(m.item_map))])


def test_trainings_through_remote_storage_equal_sqlite(layouts, monkeypatch):
    for k in ("PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    tmp = layouts["tmp"]
    export_events(Storage(env=layouts["sqlite"]), layouts["app_id"], str(tmp / "out.json"))
    pg, _ = _import_into_postgres(layouts, tmp / "out.json")
    ref = _port_trained(Storage(env=layouts["sqlite"]))
    for storage in (pg, Storage(env=layouts["network"])):
        got = _port_trained(storage)
        assert _maps(got) == _maps(ref)
        assert np.array_equal(got.user_factors, ref.user_factors)
        assert np.array_equal(got.item_factors, ref.item_factors)
    # the pg + s3 instance's blob is in the s3 bucket, not in postgres
    inst = workflow.get_latest_completed_instance(pg)
    assert pg.get_model_data_models().get(inst.id) is not None
    assert postgres.PostgresModels(url=layouts["pg_url"]).get(inst.id) is None


def test_training_through_postgres_matches_jax(layouts, monkeypatch):
    """From the JAX trainer's initial draw, the port's training through
    postgres + s3 is within 1e-4 of the JAX package's ``run_train`` over
    its own postgres driver, on one stub."""
    for k in ("PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_TRAIN_KERNEL", "reference")
    tmp = layouts["tmp"]
    export_events(Storage(env=layouts["sqlite"]), layouts["app_id"], str(tmp / "out.json"))
    pg, _ = _import_into_postgres(layouts, tmp / "out.json")
    jax_pg = JaxStorage(env=_env("JPG", TYPE="postgres", URL=layouts["pg_url"]))
    captured = []
    orig = jax_rec.train_als
    monkeypatch.setattr(jax_rec, "train_als",
                        lambda *a, **k: captured.append(orig(*a, **k)) or captured[-1])
    engine = jax_rec.RecommendationEngine.apply()
    variant = dict(_variant(), engineFactory="predictionio_tpu.templates.recommendation."
                                             "RecommendationEngine")
    jax_store.set_storage(jax_pg)
    try:
        jax_workflow.run_train(engine, engine.params_from_variant(variant), variant["engineFactory"],
                               storage=jax_pg, ctx=MeshContext.create(devices=jax.devices()[:1]))
    finally:
        jax_store.set_storage(None)
    jm = captured[0]
    ku, kv = jax.random.split(jax.random.PRNGKey(SEED))
    init = tuple(np.asarray(jax.random.normal(k_, (n, RANK), jnp.float32) / np.sqrt(RANK))
                 for k_, n in ((ku, len(jm.user_map)), (kv, len(jm.item_map))))
    monkeypatch.setattr(rec, "train_als", functools.partial(rec.train_als, init_factors=init))
    got = _port_trained(pg)
    assert _maps(got) == ([jm.user_map.inverse[i] for i in range(len(jm.user_map))],
                          [jm.item_map.inverse[i] for i in range(len(jm.item_map))])
    np.testing.assert_allclose(got.user_factors, np.asarray(jm.user_factors), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, np.asarray(jm.item_factors), rtol=1e-4, atol=1e-4)


def test_jax_model_blob_in_s3_deploys_in_the_port(layouts, monkeypatch):
    """The JAX package trains over a shared sqlite store with its models in
    the s3stub; the port deploys that instance and answers within 1e-4 of
    the JAX model's host ranking."""
    from predictionio_tpu_torch.serving.query_server import QueryServer

    monkeypatch.setenv("PIO_TRAIN_KERNEL", "reference")
    env = {**layouts["sqlite"],
           **{k: v for k, v in layouts["postgres"].items() if "S3M" in k or "MODELDATA" in k}}
    ref = JaxStorage(env=env)
    captured = []
    orig = jax_rec.train_als
    monkeypatch.setattr(jax_rec, "train_als",
                        lambda *a, **k: captured.append(orig(*a, **k)) or captured[-1])
    engine = jax_rec.RecommendationEngine.apply()
    variant = dict(_variant(), engineFactory="predictionio_tpu.templates.recommendation."
                                             "RecommendationEngine")
    jax_store.set_storage(ref)
    try:
        iid = jax_workflow.run_train(engine, engine.params_from_variant(variant),
                                     variant["engineFactory"], storage=ref,
                                     ctx=MeshContext.create(devices=jax.devices()[:1]))
    finally:
        jax_store.set_storage(None)
    jm = captured[0]
    port = Storage(env=env)
    assert port.get_model_data_models().get(iid) is not None  # the blob is in s3
    assert port.get_meta_data_engine_instances().get(iid).engine_factory == variant["engineFactory"]
    qs = QueryServer(rec.RecommendationEngine.apply(), storage=port, ctx=CPU, batching=True)
    try:
        url = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        U, V = np.asarray(jm.user_factors), np.asarray(jm.item_factors)
        for u in range(0, 40, 3):
            req = urllib.request.Request(
                f"{url}/queries.json", data=json.dumps({"user": f"u{u}", "num": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())["itemScores"]
            row = U[jm.user_map[f"u{u}"]] @ V.T
            want = np.argsort(-row, kind="stable")[:6]
            bad = topk_mismatches(np.array([[x["score"] for x in got]]),
                                  np.array([[jm.item_map[x["item"]] for x in got]]),
                                  row[want][None], want[None], 1e-4)
            assert not bad, bad[:3]
    finally:
        qs.stop()
