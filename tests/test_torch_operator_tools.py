"""The port's operator tools against the JAX package's, on the CPU.

Both packages open ONE zero-config sqlite store (the same
``PIO_FS_BASEDIR``):

* pypio: ``init`` + ``find_events`` return equal columns from either
  package; a model published by each package's ``save_model`` deploys in
  each package's ``QueryServer`` (the port maps the JAX package's
  ``PythonEngine`` path to its own) and answers alike.
* The ``python`` template: ``template list|get``, ``build``, ``train``
  (refused, as in JAX) and ``deploy`` in a thread, answering over HTTP.
* ``pio shell`` fed on stdin in a subprocess with jax blocked, ``pio run``
  (a JAX-package path resolves to the port's counterpart or is refused),
  ``pio upgrade``.
* ``adminserver`` and ``dashboard``: the same routes give the same status
  codes, bodies and headers from either package on the one store.
* The two CLIs' subcommand trees are equal.
"""

import argparse
import contextlib
import datetime as dt
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu import pypio as jax_pypio
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.serving import query_server as jax_qs
from predictionio_tpu.tools import admin as jax_admin
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import dashboard as jax_dashboard
from predictionio_tpu_torch import pypio as port_pypio
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.serving import query_server as port_qs
from predictionio_tpu_torch.tools import admin as port_admin
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.tools import dashboard as port_dashboard

ROOT = pathlib.Path(__file__).resolve().parents[1]


class ScaleModel:
    """A model a notebook might save: ``predict`` scales the query's x."""

    def __init__(self, factor):
        self.factor = factor

    def predict(self, query):
        return float(query["x"]) * self.factor


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """One sqlite file both packages open; the two Storage singletons and
    ambient stores are reset around the test."""
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    for k in ("PIO_TELEMETRY", "PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_STREAMING"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    JaxStorage.reset_instance()
    PortStorage.reset_instance()
    yield JaxStorage.instance(), PortStorage.instance()
    jax_pypio._storage = None
    port_pypio._storage = None
    jax_store.set_storage(None)
    port_store.set_storage(None)
    JaxStorage.reset_instance()
    PortStorage.reset_instance()
    jax_sqlite.close_all_dbs()
    port_sqlite.close_all_dbs()


def call(method, url, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _events(n=120, seed=0):
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    return [Event(event="rate" if k % 3 else "buy", entity_type="user",
                  entity_id=f"u{int(rng.integers(20))}", target_entity_type="item",
                  target_entity_id=f"i{int(rng.integers(15))}",
                  properties={"rating": int(rng.integers(1, 6))} if k % 3 else None,
                  event_time=t0 + dt.timedelta(seconds=k))
            for k in range(n)]


# -- pypio ----------------------------------------------------------------------


def test_find_events_gives_equal_columns(store):
    jax_s, port_s = store
    app_id = port_s.get_meta_data_apps().insert(port_base.App(0, "Notebook"))
    port_s.get_l_events().init(app_id)
    port_s.get_l_events().insert_batch(_events(), app_id)
    with pytest.raises(RuntimeError, match="pypio.init"):
        port_pypio.find_events("Notebook")
    jax_pypio.init()
    jb = jax_pypio.find_events("Notebook")
    port_pypio.init()
    pb = port_pypio.find_events("Notebook")
    assert len(pb.event) == len(jb.event) == 120
    for col in ("event", "entity_type", "entity_id", "target_entity_type",
                "target_entity_id", "event_id", "pr_id"):
        assert list(getattr(pb, col)) == list(getattr(jb, col)), col
    for col in ("event_time", "creation_time"):
        np.testing.assert_array_equal(getattr(pb, col), getattr(jb, col))
    assert pb.properties == jb.properties
    assert [tuple(t) for t in pb.tags] == [tuple(t) for t in jb.tags]


def _serve(qs_mod, engine, storage, engine_id, ctx):
    kw = {"ctx": ctx} if ctx is not None else {}
    qs = qs_mod.QueryServer(engine, storage=storage, engine_id=engine_id, telemetry=False, **kw)
    return qs, f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_save_model_instances_deploy_and_answer_in_both(saved_by, store):
    jax_s, port_s = store
    from predictionio_tpu.parallel.mesh import MeshContext
    import jax

    jax_pypio.init()
    port_pypio.init()
    saver = jax_pypio if saved_by == "jax" else port_pypio
    iid_model = saver.save_model(ScaleModel(2.5))
    iid_cols = saver.save_model({"kind": "columns"}, predict_columns=["x", "y"],
                                engine_factory=saver.__name__ + ".PythonEngine.cols")
    factory = f"{saver.__name__}.PythonEngine"
    inst = port_s.get_meta_data_engine_instances().get(iid_model)
    assert inst.status == "COMPLETED" and inst.engine_factory == factory
    servers = []
    try:
        answers = {}
        for side, qs_mod, pkg, storage, ctx in (
                ("jax", jax_qs, jax_pypio, jax_s, MeshContext.create(devices=jax.devices()[:1])),
                ("port", port_qs, port_pypio, port_s, DeviceContext.create(device="cpu"))):
            qs, base = _serve(qs_mod, pkg.PythonEngine.apply(), storage, factory, ctx)
            servers.append(qs)
            status, body, _ = call("POST", f"{base}/queries.json", {"x": 4})
            assert status == 200, body
            qs2, base2 = _serve(qs_mod, pkg.PythonEngine.apply(), storage, factory + ".cols", ctx)
            servers.append(qs2)
            status2, body2, _ = call("POST", f"{base2}/queries.json", {"x": 1, "y": "a", "z": 3})
            assert status2 == 200, body2
            answers[side] = (json.loads(body), json.loads(body2))
        assert answers["jax"] == answers["port"]
        assert answers["port"][0] == {"prediction": 10.0}
        assert answers["port"][1] == {"x": 1, "y": "a"}
        assert iid_cols
    finally:
        for qs in servers:
            with contextlib.suppress(Exception):
                qs.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_template_lifecycle(store, tmp_path, capsys):
    _, port_s = store
    assert port_cli.main(["template", "list"]) == 0
    listed = capsys.readouterr().out
    assert "python" in listed and "predictionio_tpu_torch.pypio.PythonEngine" in listed
    assert jax_cli.main(["template", "list"]) == 0
    jax_listed = capsys.readouterr().out
    assert [ln.split()[0] for ln in listed.splitlines()] == \
        [ln.split()[0] for ln in jax_listed.splitlines()]
    eng = tmp_path / "py"
    assert port_cli.main(["template", "get", "python", "--directory", str(eng)]) == 0
    variant = json.loads((eng / "engine.json").read_text())
    assert variant["engineFactory"] == "predictionio_tpu_torch.pypio.PythonEngine"
    jeng = tmp_path / "jpy"
    assert jax_cli.main(["template", "get", "python", "--directory", str(jeng)]) == 0
    capsys.readouterr()
    # the skeleton's appName has no Params to bind to, in both packages
    errs = []
    for cli, d in ((port_cli, eng), (jax_cli, jeng)):
        assert cli.main(["build", "--engine-dir", str(d)]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "appName" in errs[0]
    for d in (eng, jeng):
        v = json.loads((d / "engine.json").read_text())
        v["datasource"]["params"] = {}
        (d / "engine.json").write_text(json.dumps(v))
    assert port_cli.main(["build", "--engine-dir", str(eng)]) == 0
    assert jax_cli.main(["build", "--engine-dir", str(jeng)]) == 0
    capsys.readouterr()
    # trained outside `pio train`, as in the JAX package
    assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 1
    port_err = capsys.readouterr().err
    assert jax_cli.main(["train", "--engine-dir", str(jeng)]) == 1
    jax_err = capsys.readouterr().err
    assert "PythonEngine models are trained externally" in port_err
    assert port_err.splitlines()[-1] == jax_err.splitlines()[-1]
    # a notebook publishes; `pio deploy` serves it
    port_pypio.init()
    port_pypio.save_model(ScaleModel(-1.0))
    port = _free_port()
    import threading

    t = threading.Thread(target=port_cli.main, daemon=True, args=([
        "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
        "--device", "cpu"],))
    t.start()
    base = f"http://127.0.0.1:{port}"
    t_end = time.monotonic() + 60
    while time.monotonic() < t_end:
        with contextlib.suppress(OSError):
            if call("GET", f"{base}/readyz")[0] == 200:
                break
        time.sleep(0.05)
    status, body, _ = call("POST", f"{base}/queries.json", {"x": 7})
    assert status == 200 and json.loads(body) == {"prediction": -7.0}
    assert port_cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)]) == 0
    t.join(30)
    assert not t.is_alive()


# -- shell, run, upgrade ----------------------------------------------------------


def test_shell_reads_stdin_with_pypio_preloaded(tmp_path):
    code = ("import sys; sys.modules['jax'] = None; sys.modules['predictionio_tpu'] = None; "
            "from predictionio_tpu_torch.tools.cli import main; sys.exit(main(['shell']))")
    feed = ("print('NS', sorted(k for k in dir() if not k.startswith('_')))\n"
            "pypio.init(storage)\n"
            "print('APPS', len(storage.get_meta_data_apps().get_all()))\n"
            "print('MOD', pypio.__name__)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(tmp_path), PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], input=feed, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # the console writes its prompts to stdout when stdin is a pipe
    out = [ln.replace(">>> ", "") for ln in r.stdout.splitlines()]
    assert "NS ['LEventStore', 'PEventStore', 'pypio', 'storage']" in out
    assert "APPS 0" in out and "MOD predictionio_tpu_torch.pypio" in out
    assert "predictionio_tpu_torch shell" in r.stderr  # the banner


@pytest.mark.parametrize("argv,rc,out", [
    (["run", "os.path.join", "a", "b"], 0, "a/b\n"),
    (["run", "os.getpid"], 0, None),
    (["run", "predictionio_tpu.tools.cli.main"], 1, None),
    (["run", "no_such_module.f"], None, None),
])
def test_run_calls_a_dotted_callable(argv, rc, out, capsys):
    if rc is None:
        with pytest.raises(ModuleNotFoundError):
            port_cli.main(argv)
        with pytest.raises(ModuleNotFoundError):
            jax_cli.main(argv)
        return
    got = port_cli.main(argv)
    cap = capsys.readouterr()
    assert got == rc
    if rc == 0:
        assert jax_cli.main(argv) == 0
        jax_out = capsys.readouterr().out
        if out is not None:
            assert cap.out == out == jax_out
        else:
            assert cap.out == jax_out == f"{os.getpid()}\n"
    else:
        # the port refuses the JAX package's own classes
        assert "predictionio_tpu.tools.cli.main" in cap.err and "[ERROR]" in cap.err


def test_run_maps_the_jax_pypio_engine_to_the_port():
    engine = port_cli.resolve_engine_from_variant(
        {"engineFactory": "predictionio_tpu.pypio.PythonEngine"})
    assert type(engine).__module__ == "predictionio_tpu_torch.core.engine"
    assert engine.algorithm_cls_map["python"].__module__ == "predictionio_tpu_torch.pypio"


def test_upgrade(capsys):
    assert port_cli.main(["upgrade"]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["upgrade"]) == 0
    jax_out = capsys.readouterr().out
    assert port_out.startswith("[INFO] predictionio_tpu_torch ")
    assert port_out.split(":", 1)[1] == jax_out.split(":", 1)[1]


def _verbs(parser, prefix=""):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sp in a.choices.items():
                out[prefix + name] = sorted(
                    o for act in sp._actions for o in act.option_strings)
                out.update(_verbs(sp, prefix + name + " "))
    return out


def test_the_two_clis_have_the_same_verbs():
    port, jax = _verbs(port_cli.build_parser()), _verbs(jax_cli.build_parser())
    assert sorted(port) == sorted(jax)
    # the operator verbs take the JAX package's flags
    for verb in ("profile", "analyze", "adminserver", "dashboard", "shell", "run", "upgrade"):
        assert port[verb] == jax[verb], verb


# -- admin server and dashboard -----------------------------------------------------


def _pair(port_cls, jax_cls, jax_s, port_s, **kw):
    p, j = port_cls(storage=port_s, **kw), jax_cls(storage=jax_s, **kw)
    return (p, f"http://127.0.0.1:{p.start('127.0.0.1', 0)}"), \
        (j, f"http://127.0.0.1:{j.start('127.0.0.1', 0)}")


def test_admin_server_routes_match(store):
    jax_s, port_s = store
    (p, pb), (j, jb) = _pair(port_admin.AdminServer, jax_admin.AdminServer, jax_s, port_s)
    try:
        def both(method, path, body=None):
            a, b = call(method, pb + path, body), call(method, jb + path, body)
            assert a[0] == b[0], (path, a[:2], b[:2])
            return json.loads(a[1]), json.loads(b[1])

        a, b = both("GET", "/")
        assert a == b == {"status": "alive", "description": "admin server"}
        assert both("GET", "/cmd/app") == ([], [])
        assert both("POST", "/cmd/app", {}) == ({"message": "name is required"},) * 2
        st, created, _ = call("POST", pb + "/cmd/app", {"name": "A", "description": "d"})
        created = json.loads(created)
        assert st == 201 and created["name"] == "A"
        st, jcreated, _ = call("POST", jb + "/cmd/app", {"name": "B"})
        assert st == 201
        a, b = both("GET", "/cmd/app")
        assert a == b and [x["name"] for x in a] == ["A", "B"]
        assert [x["accessKeys"] for x in a] == [[created["accessKey"]],
                                                [json.loads(jcreated)["accessKey"]]]
        port_s.get_l_events().insert(_events(1)[0], created["id"])
        assert both("DELETE", "/cmd/app/A/data") == ({"message": "deleted data of A"},) * 2
        assert port_s.get_l_events().find(created["id"]) == []
        assert both("DELETE", "/cmd/app/nope") == ({"message": "app not found"},) * 2
        assert both("DELETE", "/cmd/app/nope/data") == ({"message": "app not found"},) * 2
        assert call("DELETE", pb + "/cmd/app/B")[0] == 200
        assert call("DELETE", jb + "/cmd/app/A")[0] == 200
        assert both("GET", "/cmd/app") == ([], [])
        # a duplicate name: 409 from both. The port's driver rolls the failed
        # INSERT back, so a write from the JAX side goes through after it; the
        # JAX driver's transaction stays open and holds the file's write lock
        # (ROADMAP §3), so its duplicate goes last
        assert call("POST", pb + "/cmd/app", {"name": "C"})[0] == 201
        a, b = both("POST", "/cmd/app", {"name": "C"})
        assert a == b == {"message": "app C already exists"}
    finally:
        p.stop()
        j.stop()


def test_dashboard_routes_match(store):
    jax_s, port_s = store
    t0 = dt.datetime(2026, 3, 1, 12, 0, 0, tzinfo=dt.timezone.utc)
    evals = port_s.get_meta_data_evaluation_instances()
    ids = []
    for k in range(2):
        ids.append(evals.insert(port_base.EvaluationInstance(
            id="", status=evals.STATUS_COMPLETED, start_time=t0 + dt.timedelta(minutes=k),
            end_time=t0 + dt.timedelta(minutes=k + 1),
            evaluation_class=f"my.Evaluation<{k}>", evaluator_results=f"score {k}",
            evaluator_results_html=f"<b>{k}</b>",
            evaluator_results_json=json.dumps({"score": k}))))
    evals.insert(port_base.EvaluationInstance(
        id="", status=evals.STATUS_EVALUATING, start_time=t0, end_time=t0))
    (p, pb), (j, jb) = _pair(port_dashboard.Dashboard, jax_dashboard.Dashboard, jax_s, port_s,
                             telemetry=False)
    try:
        paths = ["/"] + [f"/engine_instances/{i}/evaluator_results.{fmt}"
                         for i in ids for fmt in ("txt", "html", "json", "xml")] + \
                ["/engine_instances/missing/evaluator_results.txt"]
        for path in paths:
            a, b = call("GET", pb + path), call("GET", jb + path)
            assert (a[0], a[1]) == (b[0], b[1]), path
            for h in ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
                      "Access-Control-Allow-Headers", "Content-Type"):
                assert a[2].get(h) == b[2].get(h), (path, h)
        index = call("GET", pb + "/")[1].decode()
        assert index.count("<tr><td>") == 2 and "my.Evaluation&lt;1&gt;" in index
        assert call("GET", pb + f"/engine_instances/{ids[1]}/evaluator_results.json")[1] == \
            b'{"score": 1}'
    finally:
        p.stop()
        j.stop()
