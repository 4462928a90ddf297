"""The quickstart through the port's CLI against the JAX package's, on the CPU.

Both packages run the reference quickstart in-process through their own
``cli.main``, each on its own zero-config sqlite file (``PIO_FS_BASEDIR``):
``status``, ``app new``, ``accesskey new/list/delete``, ``app show/list/
channel-new/data-delete/channel-delete/delete``, ``eventserver`` taking the
same ~2,000 rate/buy events over HTTP, ``template get``, ``build``,
``train``, then ``deploy --batching`` answering every user over HTTP, and
``undeploy``. The operator-facing lines must be equal (keys and ids by
shape), and so must the answers, by ``topk_mismatches`` at tol 1e-4 (the
trained factors' own tolerance, ``tests/test_torch_als_train.py``).

The JAX side trains on a one-device mesh (its CLI's ``make_ctx`` is
monkeypatched; the test conftest forces 8 CPU devices), and the port's
``train_als`` is handed the JAX trainer's threefry draw as its initial
factors, as in ``tests/test_torch_train_workflow.py``.

Then one real-subprocess lifecycle of the port's CLI (``eventserver``,
``train``, ``deploy --batching``, queries, ``undeploy``, all with
``--device cpu``), and ``train``/``deploy`` without ``--device cpu`` on a
machine without a card, which must exit non-zero.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = "QuickApp"
ALS = {"rank": 6, "numIterations": 4, "lambda": 0.05, "seed": 5}
KEY_RE = re.compile(r"Access Key: (\S+)")
N_EVENTS = 2000


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, body=None, method=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def wait_ready(url, deadline_s=120):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        try:
            if http(url, timeout=5)[0] == 200:
                return
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"{url} never answered 200")


def events(n=N_EVENTS, seed=0):
    """Rate events with integer ratings 1-5, and every 5th a buy."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u = f"u{int(rng.integers(60) if k % 3 else rng.integers(10))}"
        i = f"i{int(rng.integers(40) if k % 4 else rng.integers(6))}"
        d = {"entityType": "user", "entityId": u, "targetEntityType": "item",
             "targetEntityId": i, "eventTime": 1_767_225_600 + k}
        out.append({"event": "buy", **d} if k % 5 == 0 else
                   {"event": "rate", **d, "properties": {"rating": int(rng.integers(1, 6))}})
    return out


class Run:
    """One package's CLI: ``main`` in-process, the outputs it printed."""

    def __init__(self, cli, capsys, device_args):
        self.cli, self.capsys, self.device_args = cli, capsys, device_args
        self.lines: list[str] = []

    def __call__(self, *argv, rc=0, record=True):
        got = self.cli.main(list(argv))
        out = self.capsys.readouterr()
        assert got == rc, (argv, got, out.err)
        if record:
            self.lines += (out.out + out.err).splitlines()
        return out.out + out.err

    def in_thread(self, *argv):
        t = threading.Thread(target=self.cli.main, args=(list(argv),), daemon=True)
        t.start()
        return t


def quickstart(run: Run, tmp, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp / "base"))
    run("status")
    key = KEY_RE.search(run("app", "new", APP)).group(1)
    rate_key = KEY_RE.search(run("accesskey", "new", APP, "rate")).group(1)
    assert rate_key in run("accesskey", "list", record=False)
    run("accesskey", "delete", rate_key)
    run("accesskey", "delete", rate_key, rc=1)
    run("app", "new", APP, rc=1)
    run("app", "channel-new", APP, "web")
    run("app", "channel-new", APP, "bad name", rc=1)
    run("app", "new", "Scratch")
    run("app", "show", APP)
    run("app", "list")

    port = free_port()
    es = run.in_thread("eventserver", "--ip", "127.0.0.1", "--port", str(port), "--stats")
    base = f"http://127.0.0.1:{port}"
    wait_ready(f"{base}/readyz")
    evs = events()
    for b in range(0, len(evs), 50):
        status, body = http(f"{base}/batch/events.json?accessKey={key}", evs[b:b + 50])
        assert status == 200 and all(x["status"] == 201 for x in body)
    assert http(f"{base}/events.json?accessKey={key}&channel=web", evs[0])[0] == 201
    stats = http(f"{base}/stats.json?accessKey={key}")[1]["statusCount"]
    assert sum(x["count"] for x in stats) == N_EVENTS + 1
    http(f"{base}/stop", method="POST")
    es.join(30)
    assert not es.is_alive()
    run("app", "data-delete", APP, "--channel", "web")
    run("app", "channel-delete", APP, "web")
    run("app", "data-delete", "Scratch")
    run("app", "delete", "Scratch")
    run("app", "show", "Scratch", rc=1)

    engine_dir = tmp / "engine"
    run("template", "get", "recommendation", "--directory", str(engine_dir), record=False)
    path = engine_dir / "engine.json"
    variant = json.loads(path.read_text())
    variant["datasource"]["params"]["appName"] = APP
    variant["algorithms"] = [{"name": "als", "params": ALS}]
    path.write_text(json.dumps(variant))
    run("build", "--engine-dir", str(engine_dir), record=False)
    out = run("train", "--engine-dir", str(engine_dir), *run.device_args, record=False)
    assert "Training completed" in out

    port = free_port()
    dep = run.in_thread("deploy", "--engine-dir", str(engine_dir), "--ip", "127.0.0.1",
                        "--port", str(port), "--batching", *run.device_args)
    base = f"http://127.0.0.1:{port}"
    wait_ready(f"{base}/readyz")
    users = sorted({e["entityId"] for e in evs}) + ["nobody"]
    answers = {u: http(f"{base}/queries.json", {"user": u, "num": 8})[1] for u in users}
    run("undeploy", "--port", str(port))
    dep.join(30)
    assert not dep.is_alive()
    return answers


def shaped(lines):
    """Keys → <key>, ports → <port>; everything else as printed."""
    return [re.sub(r":\d+(\.?)$", r":<port>\1", re.sub(r"[A-Za-z0-9_-]{60,}", "<key>", line))
            for line in lines]


def test_quickstart_through_both_clis_gives_the_same_answers(tmp_path, monkeypatch, capsys):
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_") or k in ("PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE"):
            monkeypatch.delenv(k)
    one_device = MeshContext.create(devices=jax.devices()[:1])
    monkeypatch.setattr(jax_cli, "make_ctx", lambda variant: one_device)

    def from_jax_draw(ctx, inter, cfg, **kw):
        ku, kv = jax.random.split(jax.random.PRNGKey(cfg.seed))
        scale = 1.0 / np.sqrt(cfg.rank)
        init = tuple(np.asarray(jax.random.normal(k, (n, cfg.rank), jnp.float32) * scale)
                     for k, n in ((ku, inter.n_users), (kv, inter.n_items)))
        return port_train_als(ctx, inter, cfg, init_factors=init, **kw)

    port_train_als = rec.train_als
    monkeypatch.setattr(rec, "train_als", from_jax_draw)

    runs = {}
    for name, cli, storage_cls, store, sqlite_mod, device in (
        ("jax", jax_cli, JaxStorage, jax_store, jax_sqlite, ()),
        ("port", port_cli, Storage, port_store, port_sqlite, ("--device", "cpu")),
    ):
        storage_cls.reset_instance()
        store.set_storage(None)
        run = Run(cli, capsys, device)
        try:
            runs[name] = (run, quickstart(run, tmp_path / name, monkeypatch))
        finally:
            storage_cls.reset_instance()
            sqlite_mod.close_all_dbs()
    (jrun, jax_answers), (prun, port_answers) = runs["jax"], runs["port"]
    assert shaped(prun.lines) == shaped(jrun.lines)
    assert "[INFO] METADATA  -> source DEFAULT (type sqlite)" in prun.lines

    assert jax_answers.keys() == port_answers.keys()
    assert port_answers["nobody"] == jax_answers["nobody"] == {"itemScores": []}
    items = sorted({x["item"] for a in jax_answers.values() for x in a["itemScores"]}
                   | {x["item"] for a in port_answers.values() for x in a["itemScores"]})
    index = {it: k for k, it in enumerate(items)}
    for u, ref in jax_answers.items():
        got, ref = port_answers[u]["itemScores"], ref["itemScores"]
        bad = topk_mismatches(
            np.array([[x["score"] for x in got]]), np.array([[index[x["item"]] for x in got]]),
            np.array([[x["score"] for x in ref]]), np.array([[index[x["item"]] for x in ref]]),
            tol=1e-4)
        assert not bad, (u, bad[:3])


def _cli(*argv, env, timeout=60):
    return subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _spawn(*argv, env):
    return subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _subprocess_env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_") and k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["PIO_FS_BASEDIR"] = str(tmp_path / "base")
    return env


def test_subprocess_lifecycle_on_the_cpu(tmp_path):
    """eventserver → events → train → deploy --batching → queries →
    undeploy, each verb its own process, as an operator runs them."""
    env = _subprocess_env(tmp_path)
    t0 = time.monotonic()
    r = _cli("app", "new", APP, env=env)
    assert r.returncode == 0, r.stderr
    key = KEY_RE.search(r.stdout).group(1)
    es_port, qs_port = free_port(), free_port()
    es = _spawn("eventserver", "--ip", "127.0.0.1", "--port", str(es_port), env=env)
    qs = None
    try:
        base = f"http://127.0.0.1:{es_port}"
        wait_ready(f"{base}/readyz", 30)
        evs = events(n=600, seed=1)
        for b in range(0, len(evs), 50):
            assert http(f"{base}/batch/events.json?accessKey={key}", evs[b:b + 50])[0] == 200
        http(f"{base}/stop", method="POST")
        assert es.wait(timeout=30) == 0
        engine_dir = tmp_path / "engine"
        engine_dir.mkdir()
        (engine_dir / "engine.json").write_text(json.dumps({
            "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
            "datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "als", "params": ALS}]}))
        r = _cli("train", "--engine-dir", str(engine_dir), "--device", "cpu", env=env)
        assert r.returncode == 0 and "Training completed" in r.stdout, r.stderr
        qs = _spawn("deploy", "--engine-dir", str(engine_dir), "--ip", "127.0.0.1",
                    "--port", str(qs_port), "--batching", "--device", "cpu", env=env)
        base = f"http://127.0.0.1:{qs_port}"
        wait_ready(f"{base}/readyz", 60)
        users = sorted({e["entityId"] for e in evs})[:10]
        for u in users:
            status, body = http(f"{base}/queries.json", {"user": u, "num": 5})
            assert status == 200 and len(body["itemScores"]) == 5
        info = http(f"{base}/")[1]
        assert info["device"] == "cpu" and info["fastpath"][0]["calls"] >= 1
        assert info["scoreKernelLaunches"] == 0  # the plain version ran: no kernel launched
        r = _cli("undeploy", "--port", str(qs_port), env=env)
        assert r.returncode == 0, r.stderr
        assert qs.wait(timeout=30) == 0
        with pytest.raises(ConnectionRefusedError):  # nothing listens there now
            socket.create_connection(("127.0.0.1", qs_port), timeout=5).close()
        with socket.socket() as s:  # and a new server can take the port
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", qs_port))
    finally:
        for p in (es, qs):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    assert time.monotonic() - t0 < 60


@pytest.mark.skipif(torch.cuda.is_available(), reason="the check is for machines without a card")
@pytest.mark.parametrize("verb", ["train", "deploy"])
def test_train_and_deploy_need_a_card_unless_told_cpu(tmp_path, verb):
    env = _subprocess_env(tmp_path)
    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
        "datasource": {"params": {"appName": APP}}}))
    r = _cli(verb, "--engine-dir", str(tmp_path), "--port", str(free_port()), env=env) \
        if verb == "deploy" else _cli(verb, "--engine-dir", str(tmp_path), env=env)
    assert r.returncode != 0
    assert "[ERROR] DeviceContext: no CUDA device" in r.stderr


@pytest.mark.parametrize("argv,item", [
    (["template", "get", "classification"], 11),
    (["template", "get", "universalrecommender"], 11),
    (["deploy", "--fleet", "2"], 13),
    (["deploy", "--canary"], 13),
    (["deploy", "--autoscale"], 13),
    (["eventserver", "--ingest-buffer", "durable"], 14),
    (["eventserver", "--wal-dir", "w"], 14),
    (["eventserver", "--ingest-buffer", "fast"], 14),
])
def test_waiting_options_name_their_roadmap_item(tmp_path, monkeypatch, capsys, argv, item):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    Storage.reset_instance()
    try:
        assert port_cli.main(argv) == 1
    finally:
        Storage.reset_instance()
        port_sqlite.close_all_dbs()
    assert f"(ROADMAP §1 item {item})" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["eventserver", "--flush-ms", "3"],
    ["eventserver", "--buffer-max", "64"],
])
def test_options_of_waiting_features_are_rejected_by_the_parser(capsys, argv):
    # they only tune the ingest buffer (item 14)
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["deploy", "--feedback", "--event-server-ip", "127.0.0.1"],
    ["deploy", "--event-server-port", "7071"],
    ["deploy", "--accesskey", "k", "--plugin", "a.B"],
])
def test_feedback_options_parse_as_in_jax(argv):
    """The feedback loop's options (ported with the loop) parse to the JAX
    parser's values."""
    port = vars(port_cli.build_parser().parse_args(argv))
    jax = vars(jax_cli.build_parser().parse_args(argv))
    for key in ("feedback", "event_server_ip", "event_server_port", "accesskey", "plugin"):
        assert port[key] == jax[key], key


def test_version_and_template_list(capsys):
    assert port_cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == jax_cli.__version__
    assert port_cli.main(["template", "list"]) == 0
    listed = capsys.readouterr().out
    assert "predictionio_tpu_torch.templates.recommendation.RecommendationEngine" in listed
    assert "predictionio_tpu_torch.templates.sequentialrecommendation." in listed


def test_sigterm_stops_a_server_cleanly(tmp_path):
    """SIGTERM → ``drain()`` → exit 0, as in the JAX CLI."""
    import signal

    port = free_port()
    es = _spawn("eventserver", "--ip", "127.0.0.1", "--port", str(port),
                env=_subprocess_env(tmp_path))
    try:
        wait_ready(f"http://127.0.0.1:{port}/readyz", 30)
        es.send_signal(signal.SIGTERM)
        assert es.wait(timeout=30) == 0
    finally:
        if es.poll() is None:
            es.kill()
            es.wait()
