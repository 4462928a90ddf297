"""``pio loadtest`` of the port against the JAX package's, on the CPU.

``predictionio_tpu_torch/tools/loadtest.py`` and ``tools/scenarios.py``
are the JAX modules' counterparts: the same spec and seed compile to the
same open-loop arrival schedule and the same pre-drawn payloads; the
Zipf-Mandelbrot weights agree within rtol 1e-12; ``run_loadtest``,
``run_scenario`` and ``run_ingest_loadtest`` against the port's servers
report every key of the JAX summary (the port adds ``http5xx`` and error
samples to the closed loop's and ``issuedPerSec`` to the scenario's), and
``summarize_metrics`` reads a port server's ``/metrics`` as the JAX one
does. The CLI's ``loadtest`` parser takes every flag of the JAX parser.
"""

import datetime as dt
import json
import uuid

import numpy as np
import pytest

from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import loadtest as jax_lt
from predictionio_tpu.tools import scenarios as jax_sc
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.tools import loadtest as port_lt
from predictionio_tpu_torch.tools import scenarios as port_sc

SPECS = [
    "steady:rate=30,duration=2",
    "ramp:start=5,end=50,duration=3;steady:rate=200,duration=1",
    "sine:base=40,amp=30,period=2,duration=4;flash:base=10,peak=120,at=1,hold=1,duration=3",
    "zipfdrift:rate=60,s0=0.6,s1=1.4,duration=3,name=heat",
    "mixshift:rate=50,from=0.9,to=0.1,duration=2;steady:rate=0,duration=0.5",
]


@pytest.mark.parametrize("spec", SPECS)
def test_arrival_schedules_equal(spec):
    a, b = jax_sc.parse_scenario(spec), port_sc.parse_scenario(spec)
    assert a.arrivals() == b.arrivals()
    assert a.describe() == b.describe() and a.duration_s == b.duration_s


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("samples", [None, {"user": [f"u{i}" for i in range(40)]},
                                     {"user": ["a", "b", "c"], "item": ["x", "y"]}])
def test_payload_schedules_equal(spec, seed, samples):
    progs = [m.parse_scenario(spec) for m in (jax_sc, port_sc)]
    query = {"user": "u0", "num": 4}
    pays = [m._build_payloads(p, p.arrivals(), query, samples, seed, 50.0)
            for m, p in zip((jax_sc, port_sc), progs)]
    assert pays[0] == pays[1] and len(pays[1]) == len(progs[1].arrivals())


def test_bad_specs_refused_alike():
    for spec in ("bogus:rate=1", "steady:rate", "steady:duration=0", ""):
        errs = []
        for m in (jax_sc, port_sc):
            try:
                m.parse_scenario(spec)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1] and errs[1] is not None


@pytest.mark.parametrize("n,s,q", [(1, 1.1, 50.0), (59_047, 1.1, 50.0), (162_541, 0.7, 50.0),
                                   (100, 2.0, 0.0)])
def test_zipf_weights_equal(n, s, q):
    a, b = jax_lt.zipf_mandelbrot_weights(n, s, q), port_lt.zipf_mandelbrot_weights(n, s, q)
    np.testing.assert_allclose(b, a, rtol=1e-12)
    assert abs(b.sum() - 1.0) < 1e-12


def test_loadtest_parser_takes_every_jax_flag():
    argv = ["loadtest", "--ip", "10.0.0.1", "--port", "9000", "--query", '{"user": "x"}',
            "--requests", "7", "--concurrency", "3", "--sample", "user=a,b", "--sample", "item=c",
            "--dist", "zipf", "--zipf-s", "0.9", "--zipf-q", "10", "--deadline-ms", "25",
            "--events", "100", "--access-key", "k", "--batch-size", "5", "--channel", "ch",
            "--scrape-metrics", "--kill-after", "1.5", "--scenario", "steady:rate=1",
            "--slo-p99-ms", "40", "--seed", "11"]
    a = vars(jax_cli.build_parser().parse_args(argv))
    b = vars(port_cli.build_parser().parse_args(argv))
    a.pop("func"), b.pop("func")
    assert a == b


# -- against the port's servers ---------------------------------------------


@pytest.fixture()
def port_servers(monkeypatch):
    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.api.event_server import EventServer
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.base import AccessKey, App, EngineInstance, Model
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models.als import als_model_from_arrays
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    for k in ("PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(1)
    model = als_model_from_arrays(rng.standard_normal((50, 4)).astype(np.float32),
                                  rng.standard_normal((70, 4)).astype(np.float32),
                                  [f"u{i}" for i in range(50)], [f"i{j}" for j in range(70)])
    src = "LT" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={f"PIO_STORAGE_SOURCES_{src}_TYPE": "memory",
                           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
                           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
                           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src})
    engine = RecommendationEngine.apply()
    params = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 4}}]})
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
                          engine_id="default", engine_version="default",
                          engine_variant="default", engine_factory="f",
                          **params.to_json_strings())
    iid = instances.insert(inst)
    blob = persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                        [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(Model(id=iid, models=persistence.seal_model_blob(blob)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    app_id = storage.get_meta_data_apps().insert(App(0, "ltapp"))
    storage.get_meta_data_access_keys().insert(AccessKey("ltkey-0123456789", app_id, []))
    storage.get_l_events().init(app_id)
    qs = QueryServer(engine, storage=storage, ctx=DeviceContext.create(device="cpu"),
                     batching=True)
    es = EventServer(storage=storage, stats=True)
    urls = {"query": f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}",
            "event": f"http://127.0.0.1:{es.start('127.0.0.1', 0)}", "key": "ltkey-0123456789"}
    yield urls
    qs.stop()
    es.stop()
    memory.reset_store(src)


def test_closed_loop_reports_the_jax_keys(port_servers):
    kw = dict(url=port_servers["query"], query={"user": "u1", "num": 5}, requests=60,
              concurrency=4, samples={"user": [f"u{i}" for i in range(50)]}, dist="zipf",
              deadline_ms=30_000)
    a, b = jax_lt.run_loadtest(**kw), port_lt.run_loadtest(**kw)
    assert set(a) <= set(b) and set(b) - set(a) == {"http5xx"}
    assert b["ok"] == 60 and b["errors"] == 0 and b["http5xx"] == 0
    assert set(a["perKey"]) == set(b["perKey"])
    series = port_lt.scrape_metrics(port_servers["query"])
    # the JAX scraper parses the port's exposition to the same series keys
    assert set(jax_lt.scrape_metrics(port_servers["query"])) >= set(series)
    sa, sb = jax_lt.summarize_metrics(series), port_lt.summarize_metrics(series)
    assert sa == sb and sb["kernelBackend"] == "reference" and sb["batcherQueries"] >= 120
    assert "deviceBusyFraction" in sb and sb["fastpathCompiles"] == 0


def test_open_loop_reports_the_jax_keys(port_servers):
    kw = dict(url=port_servers["query"], query={"user": "u1", "num": 5},
              samples={"user": [f"u{i}" for i in range(50)]}, concurrency=4, seed=3,
              slo_p99_ms=5000.0)
    spec = "steady:rate=40,duration=1;flash:base=20,peak=80,at=0.3,hold=0.3,duration=1"
    a = jax_sc.run_scenario(program=jax_sc.parse_scenario(spec), **kw)
    b = port_sc.run_scenario(program=port_sc.parse_scenario(spec), **kw)
    assert set(b) - set(a) == {"issuedPerSec"} and set(a) <= set(b)
    assert [set(p) for p in a["phases"]] == [set(p) for p in b["phases"]]
    assert b["errors"] == 0 and b["ok"] == b["requests"] == a["requests"] and b["sloHeld"]
    assert 0 < b["issuedPerSec"]


@pytest.mark.parametrize("batch_size", [1, 10])
def test_ingest_loadtest_reports_the_jax_keys(port_servers, batch_size):
    kw = dict(url=port_servers["event"], access_key=port_servers["key"], events=40,
              concurrency=3, batch_size=batch_size)
    a, b = jax_lt.run_ingest_loadtest(**kw), port_lt.run_ingest_loadtest(**kw)
    assert set(a) == set(b)
    assert a["acked"] == b["acked"] == 40 and b["errors"] == 0


def test_kill_after_drains_the_port_server(port_servers):
    r = port_lt.run_loadtest(url=port_servers["query"], query={"user": "u1", "num": 3},
                             requests=3000, concurrency=4, kill_after_s=0.4)
    assert r["stopPosted"] and r["http5xx"] == 0 and r["errors"] == 0 and r["ok"] > 0
    # what the drain turned away: 503 sheds while draining, refused
    # connections after the stop
    assert r["shed"] + r["afterStop"] == 3000 - r["ok"] > 0 and r["killAfterSec"] == 0.4


def test_cli_loadtest_prints_one_json_report(port_servers, capsys):
    port = port_servers["query"].rsplit(":", 1)[1]
    rc = port_cli.main(["loadtest", "--port", port, "--requests", "20", "--concurrency", "2",
                        "--sample", "user=u1,u2,u3", "--scrape-metrics"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["ok"] == 20 and "fastpathCompiles" in rep["serverMetrics"]
    rc = port_cli.main(["loadtest", "--port", port, "--scenario", "steady:rate=20,duration=0.5",
                        "--concurrency", "2"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["phases"][0]["offered"] == rep["requests"]
    ev = port_servers["event"].rsplit(":", 1)[1]
    rc = port_cli.main(["loadtest", "--port", ev, "--events", "12", "--access-key",
                        port_servers["key"], "--batch-size", "4"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["acked"] == 12
    assert port_cli.main(["loadtest", "--port", port, "--scenario", "nope:rate=1"]) == 1
