"""The port's training telemetry and profile capture against the JAX package's,
on the CPU.

* devprof's training half: ``als_train_cost``, ``train_utilization`` and
  ``fused_train_vread_bytes`` equal the JAX functions on the same dims
  (``tests/test_devprof.py``'s cases); the port's own formulas for the card
  (``als_train_cost_amplified`` with the H100's 32-byte sector,
  ``fused_train_cost`` as kernel 2 is written) are held to
  ``chip_smoke.py``'s ``train_bound``.
* The train accountant after a small CPU ``train_als`` (dense, segment, and
  dense over two placements): one record an iteration, a busy share in
  (0, 1], the ``cpu`` peak row; ``train_kernel.stats()`` and the
  ``pio_train_kernel_*`` exposition, family by family against the JAX
  bridge's names, types and label names, and on a port query server's
  ``/metrics``.
* ``utils/profiling.trace`` and ``obs/devprof.capture_profile`` write a
  Chrome trace with events of every thread in it; ``POST /debug/profile``
  answers 403, 400, 409 and 500 as the JAX server does, caps ``ms`` at
  10,000, counts its captures, and keeps serving after a failed one; ``pio
  profile`` drives load through a capture against a CPU server.
"""

import contextlib
import importlib.util
import json
import math
import os
import pathlib
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from predictionio_tpu.obs import bridges as jax_bridges
from predictionio_tpu.obs import devprof as jax_devprof
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.serving import query_server as jax_qs
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.obs import bridges as port_bridges
from predictionio_tpu_torch.obs import devprof as port_devprof
from predictionio_tpu_torch.obs import metrics as port_metrics
from predictionio_tpu_torch.obs.metrics import parse_prometheus
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.parallel.mesh import MeshContext
from predictionio_tpu_torch.serving import query_server as port_qs
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.utils import profiling as port_prof

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = [(1000, 50, 40, 8), (25_000_095, 162_541, 59_047, 10), (3000, 7, 900, 64)]
DTYPES = ("f32", "bf16", "int8")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interactions(seed=0, n=2000, n_users=100, n_items=50):
    rng = np.random.default_rng(seed)
    return interactions_from_arrays(
        rng.integers(0, n_users, n), rng.integers(0, n_items, n),
        rng.uniform(1, 5, n).astype(np.float32), np.zeros(n),
        (f"u{i}" for i in range(n_users)), (f"i{i}" for i in range(n_items)))


# -- cost models ---------------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_cost_models_equal_the_jax_ones(dims, dtype):
    assert port_devprof.als_train_cost(*dims, dtype) == jax_devprof.als_train_cost(*dims, dtype)
    nu, ni, k = dims[1:]
    assert port_devprof.fused_train_vread_bytes(nu, ni, k, dtype) == \
        jax_devprof.fused_train_vread_bytes(nu, ni, k, dtype)
    for platform in ("cpu", None, "h100-sxm"):
        got = port_devprof.train_utilization(*dims, 20, dtype, 3.5, 1, platform)
        want = jax_devprof.train_utilization(*dims, 20, dtype, 3.5, 1,
                                             platform if platform != "h100-sxm" else None)
        assert got["model_flops_per_sec_per_chip"] == want["model_flops_per_sec_per_chip"]
        assert got["model_hbm_gbps_per_chip"] == want["model_hbm_gbps_per_chip"]
        if platform == "cpu":
            assert got == want
    # the H100 row divides by the card's own peaks
    h = port_devprof.train_utilization(*dims, 20, dtype, 3.5, 1, "h100-sxm")
    f, b = port_devprof.als_train_cost(*dims, dtype)
    assert h["mfu"] == round(f * 20 / 3.5 / 989e12, 6)
    assert h["hbm_util"] == round(b * 20 / 3.5 / 3.35e12, 6)


@pytest.mark.parametrize("rank,dtype,sectors", [(10, "f32", 2), (8, "f32", 1), (10, "bf16", 1),
                                                (10, "int8", 1), (64, "f32", 8), (9, "f32", 2)])
def test_amplified_cost_charges_the_cards_sectors(rank, dtype, sectors):
    nr, nu, ni = 1000, 50, 40
    flops, nbytes = port_devprof.als_train_cost_amplified(nr, nu, ni, rank, dtype)
    assert port_devprof.SECTOR_BYTES == 32.0
    assert flops == port_devprof.als_train_cost(nr, nu, ni, rank, dtype)[0]
    s = {"f32": 4, "bf16": 2, "int8": 1}[dtype]
    assert nbytes == nr * 2 * (sectors * 32 + 12) + (nu + ni) * rank * (4 + s)
    # never fewer bytes than the unamplified row reads
    assert nbytes >= port_devprof.als_train_cost(nr, nu, ni, rank, "f32" if dtype == "int8"
                                                 else dtype)[1] - nr * 2 * rank * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_train_cost_is_what_chip_smokes_train_bound_counts(dtype, seed, monkeypatch):
    """Both half-steps' bytes of ``train_bound`` (operations made free, so
    the bound is the bytes' time) equal ``fused_train_cost``'s bytes given
    the buckets' padded slots and rows."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "PEAK_F32_OPS_S", math.inf)
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 65))
    nu, ni = int(rng.integers(100, 5000)), int(rng.integers(100, 5000))
    sides = []
    for n_rows in (nu, ni):
        cut = np.sort(rng.choice(np.arange(1, n_rows), 3, replace=False))
        rows = np.diff(np.concatenate([[0], cut, [n_rows]]))
        sides.append([(int(r), int(rng.integers(1, 600)), 0) for r in rows])
    total_ms = sum(cs.train_bound(b, n_opp, rank, dtype)[0]
                   for b, n_opp in ((sides[0], ni), (sides[1], nu)))
    slots = sum(n_b * d for side in sides for n_b, d, _ in side)
    rows = sum(n_b for side in sides for n_b, _, _ in side)
    n_ratings = 12345
    flops, nbytes = port_devprof.fused_train_cost(n_ratings, nu, ni, rank, dtype,
                                                  slots=slots, rows=rows)
    assert nbytes == pytest.approx(total_ms * 1e-3 * cs.PEAK_BYTES_S, rel=1e-12)
    assert flops == port_devprof.als_train_cost(n_ratings, nu, ni, rank)[0]
    # unpadded defaults: one slot a rating a side, one row an entity
    _, plain = port_devprof.fused_train_cost(n_ratings, nu, ni, rank, dtype)
    assert plain == (2 * n_ratings * 12 + port_devprof.fused_train_vread_bytes(nu, ni, rank, dtype)
                     + (nu + ni) * (rank * rank + rank + 1) * 4)


def test_fused_cost_counts_more_bytes_than_the_tpu_model():
    """The TPU model writes only the solved factors; kernel 2 writes A, b
    and cnt for every row, so the card's bytes are never fewer."""
    for dims in DIMS:
        for dtype in DTYPES:
            assert port_devprof.fused_train_cost(*dims, dtype)[1] > \
                jax_devprof.fused_train_cost(*dims, dtype)[1]


def test_default_platform_is_a_peak_row():
    want = port_devprof.platform_for("cuda:0" if torch.cuda.is_available() else "cpu")
    assert port_devprof.default_platform() == want
    if not torch.cuda.is_available():
        assert port_devprof.peak_for(want) == jax_devprof.peak_for("cpu")


# -- the train accountant -------------------------------------------------------


@pytest.fixture()
def fresh_recorder(monkeypatch):
    monkeypatch.setattr(port_devprof, "_train_acc", None)
    train_kernel.reset_stats()
    yield
    train_kernel.reset_stats()


def test_train_recorder_is_process_global(fresh_recorder):
    assert port_devprof.train_snapshot() is None
    a = port_devprof.train_recorder(platform="cpu")
    assert port_devprof.train_recorder() is a
    assert port_devprof.train_recorder(platform="cpu") is a
    b = port_devprof.train_recorder(platform="h100-sxm")
    assert b is not a and b.platform == "h100-sxm"
    a2, j2 = port_devprof.DeviceUtilization("cpu", 60), jax_devprof.DeviceUtilization("cpu", 60)
    for acc in (a2, j2):
        acc.set_cost("k", 1e9, 2e8, source="analytic")
        acc.record("k", 0.25)
    ps, js = a2.snapshot(), j2.snapshot()
    for key in ("dispatches_window", "busy_s", "window_s", "platform"):
        assert ps[key] == js[key]


@pytest.mark.parametrize("case", ["dense", "segment", "dense-two-placements"])
def test_train_snapshot_after_a_cpu_training(case, fresh_recorder, monkeypatch):
    monkeypatch.delenv("PIO_ALS_COMPUTE_DTYPE", raising=False)
    monkeypatch.delenv("PIO_ALS_SOLVER", raising=False)
    inter = _interactions()
    ctx = (MeshContext.create(devices=["cpu"] * 2) if case.endswith("placements")
           else DeviceContext.create(device="cpu"))
    solver = "segment" if case == "segment" else "dense"
    cfg = als.ALSConfig(rank=4, iterations=3, solver=solver)
    als.train_als(ctx, inter, cfg)
    snap = port_devprof.train_snapshot()
    assert snap is not None
    assert snap["platform"] == "cpu" and snap["dispatches_total"] == 3
    assert 0.0 < snap["busy_fraction"] <= 1.0
    assert snap["mfu"] > 0 and snap["hbm_util"] > 0
    costs = port_devprof.train_recorder().costs()
    assert list(costs) == ["als_iter_r4"]
    n_pad = als._pad_to_multiple
    shards = ctx.axis_size("data")
    nu, ni = n_pad(inter.n_users, shards), n_pad(inter.n_items, shards)
    if solver == "dense":
        ub, ib, _, _ = als._dense_shards_for(inter, cfg, shards)
        slots = sum(idx.size for blk in (ub, ib) for j in range(shards)
                    for idx, _, _ in blk.shard(j))
        rows = sum(idx.shape[0] for blk in (ub, ib) for j in range(shards)
                   for idx, _, _ in blk.shard(j))
        flops, nbytes = port_devprof.fused_train_cost(len(inter.user), nu, ni, 4, "f32",
                                                      slots=slots, rows=rows)
        nbytes += (shards - 1) * port_devprof.fused_train_vread_bytes(nu, ni, 4, "f32")
    else:
        flops, nbytes = port_devprof.als_train_cost(len(inter.user), nu, ni, 4, "f32")
    assert costs["als_iter_r4"]["flops"] == pytest.approx(flops, rel=1e-12)
    assert costs["als_iter_r4"]["bytes"] == pytest.approx(nbytes, rel=1e-12)
    st = train_kernel.stats()
    assert st == {"backend": "cpu", "compute_dtype": "f32",
                  "resident_bytes": float(max(nu, ni) * 4 * 4),
                  "intensity_flop_per_byte": pytest.approx(flops / nbytes, rel=1e-12)}


def _families(reg):
    out = {}
    for f in reg.collect():
        out[f.name] = (f.kind, sorted({tuple(k for k, _ in labels) for _, labels, _ in f.samples}))
    return out


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_train_kernel_exposition_matches_the_jax_bridge(dtype, fresh_recorder):
    als.train_als(DeviceContext.create(device="cpu"), _interactions(1),
                  als.ALSConfig(rank=3, iterations=2, compute_dtype=dtype))
    stats = train_kernel.stats()
    jax_stats = {"backend": "reference", "compute_dtype": dtype,
                 "resident_bytes": 1.0, "intensity_flop_per_byte": 2.0}
    preg, jreg = port_metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    port_bridges.bridge_train_kernel(preg, lambda: stats)
    jax_bridges.bridge_train_kernel(jreg, lambda: jax_stats)
    assert _families(preg) == _families(jreg)
    series = parse_prometheus(preg.render_prometheus())
    assert series[("pio_train_kernel_info", (("backend", "cpu"), ("compute_dtype", dtype)))] == 1.0
    assert series[("pio_train_kernel_resident_bytes", ())] == stats["resident_bytes"]
    assert series[("pio_train_kernel_intensity_flop_per_byte", ())] == \
        pytest.approx(stats["intensity_flop_per_byte"], rel=1e-9)
    # nothing before the first train, in both packages
    empty_p, empty_j = port_metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    port_bridges.bridge_train_kernel(empty_p, lambda: {})
    jax_bridges.bridge_train_kernel(empty_j, lambda: {})
    assert empty_p.render_prometheus() == empty_j.render_prometheus() == ""


# -- a CPU server --------------------------------------------------------------


def _publish(storage, model):
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage import base
    from predictionio_tpu_torch.templates import recommendation as rec

    engine = rec.RecommendationEngine.apply()
    params = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 4}}]})
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = base.EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="f", **params.to_json_strings())
    iid = instances.insert(inst)
    raw = persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                       [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(base.Model(id=iid, models=persistence.seal_model_blob(raw)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)


@pytest.fixture()
def server(tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.templates import recommendation as rec

    for k in ("PIO_PROFILE_ENDPOINT", "PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_TELEMETRY",
              "PIO_FAULT_SPEC", "PIO_STREAMING", "PIO_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    src = "TL" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
    })
    rng = np.random.default_rng(3)
    model = als.als_model_from_arrays(
        rng.normal(size=(40, 4)).astype(np.float32), rng.normal(size=(30, 4)).astype(np.float32),
        [f"u{i}" for i in range(40)], [f"i{i}" for i in range(30)])
    _publish(storage, model)
    qs = port_qs.QueryServer(rec.RecommendationEngine.apply(), storage=storage,
                             ctx=DeviceContext.create(device="cpu"), batching=True)
    port = qs.start("127.0.0.1", 0)
    yield qs, port
    with contextlib.suppress(Exception):
        qs.stop()
    memory.reset_store(src)


def call(method, url, body=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw[:1] in b"{[" else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _metrics(port):
    status, text = call("GET", f"http://127.0.0.1:{port}/metrics")
    assert status == 200
    return parse_prometheus(text)


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


# -- profiling -------------------------------------------------------------------


def _busy_thread(stop):
    def work():
        a = torch.ones(64, 64)
        while not stop.is_set():
            (a @ a).sum()
    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("how", ["log_dir", "env", "stage"])
def test_trace_writes_a_chrome_trace_of_every_thread(how, tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_PROFILE_DIR", raising=False)
    out = tmp_path / "prof"
    stop = threading.Event()
    worker = _busy_thread(stop)
    try:
        if how == "env":
            monkeypatch.setenv("PIO_PROFILE_DIR", str(out))
            ctx = port_prof.trace()
        elif how == "stage":
            ctx = port_prof.trace(log_dir=str(out), stage="device")
        else:
            ctx = port_prof.trace(log_dir=str(out))
        with ctx:
            time.sleep(0.1)
    finally:
        stop.set()
        worker.join()
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in _trace_events(files[0])}
    assert "aten::mm" in names  # the other thread's ops
    # no profile dir and no stage: a no-op that writes nothing
    with port_prof.trace():
        pass
    assert len(list(out.glob("*.pt.trace.json"))) == (2 if how == "env" else 1)


def test_capture_profile_under_the_basedir(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    stop = threading.Event()
    worker = _busy_thread(stop)
    try:
        path = port_devprof.capture_profile(50)
    finally:
        stop.set()
        worker.join()
    assert pathlib.Path(path).parent == tmp_path / "profiles"
    assert pathlib.Path(path).name.endswith(f"-{os.getpid()}")
    assert any(e.get("name") == "aten::mm" for e in _trace_events(os.path.join(path, "trace.json")))
    # captures take turns: two at once both finish, one after the other
    paths = []
    ts = [threading.Thread(target=lambda d=d: paths.append(
        port_devprof.capture_profile(30, str(tmp_path / d)))) for d in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(os.path.basename(p) for p in paths) == ["a", "b"]


@pytest.mark.parametrize("env,query,status", [("0", "?ms=10", 403), (None, "?ms=abc", 400),
                                              ("0", "?ms=abc", 403)])
def test_profile_endpoint_refusals_match_the_jax_server(env, query, status, server, monkeypatch):
    """403 and 400 need no capture; their bodies are the JAX server's, word
    for word (``query_server.py:1690-1728``)."""
    qs, port = server
    if env is not None:
        monkeypatch.setenv("PIO_PROFILE_ENDPOINT", env)
    got = call("POST", f"http://127.0.0.1:{port}/debug/profile{query}")
    assert got[0] == status
    jax_source = pathlib.Path(jax_qs.__file__).read_text()
    words = got[1]["message"].split()
    assert " ".join(words[:2]) in jax_source and words[-1] in jax_source
    assert got[1]["message"] == {
        403: "profile endpoint disabled (PIO_PROFILE_ENDPOINT=0)",
        400: "ms must be an integer"}[status]
    assert _metrics(port)[("pio_profile_captures_total", ())] == 0.0


def test_profile_endpoint_captures_caps_and_counts(server, monkeypatch):
    qs, port = server
    base = f"http://127.0.0.1:{port}"
    before = _metrics(port)
    assert before[("pio_profile_captures_total", ())] == 0.0
    assert before[("pio_profile_last_capture_unix", ())] == 0.0
    stop = threading.Event()
    load = threading.Thread(target=lambda: [
        call("POST", f"{base}/queries.json", {"user": f"u{i % 40}", "num": 5})
        for i in range(10_000) if not stop.is_set()], daemon=True)
    load.start()
    try:
        status, body = call("POST", f"{base}/debug/profile?ms=300")
    finally:
        stop.set()
        load.join()
    assert status == 200 and body["ms"] == 300
    events = _trace_events(os.path.join(body["path"], "trace.json"))
    assert len(events) > 10
    m = _metrics(port)
    assert m[("pio_profile_captures_total", ())] == 1.0
    assert 0 < time.time() - m[("pio_profile_last_capture_unix", ())] < 60
    # the cap and the floor, without holding the profiler for 10 s
    seen = []
    monkeypatch.setattr(port_qs._devprof, "capture_profile",
                        lambda ms: seen.append(ms) or str(qs))
    assert call("POST", f"{base}/debug/profile?ms=99999")[1]["ms"] == 10_000
    assert call("POST", f"{base}/debug/profile?ms=-5")[1]["ms"] == 1
    assert call("POST", f"{base}/debug/profile")[1]["ms"] == 500
    assert seen == [10_000, 1, 500]
    assert _metrics(port)[("pio_profile_captures_total", ())] == 4.0


def test_profile_endpoint_is_single_flight_and_survives_a_failed_capture(server, monkeypatch):
    qs, port = server
    base = f"http://127.0.0.1:{port}"
    entered, release = threading.Event(), threading.Event()

    def slow(ms):
        entered.set()
        release.wait(30)
        return "/nowhere"

    monkeypatch.setattr(port_qs._devprof, "capture_profile", slow)
    first = []
    t = threading.Thread(target=lambda: first.append(call("POST", f"{base}/debug/profile?ms=5")))
    t.start()
    assert entered.wait(30)
    status, body = call("POST", f"{base}/debug/profile?ms=5")
    assert status == 409 and body == {"message": "a profile capture is already running"}
    release.set()
    t.join()
    assert first[0][0] == 200

    def broken(ms):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(port_qs._devprof, "capture_profile", broken)
    status, body = call("POST", f"{base}/debug/profile?ms=5")
    assert status == 500 and "profiler unavailable" in body["message"]
    # still serving, the lock released, the failure not counted
    assert call("POST", f"{base}/queries.json", {"user": "u1", "num": 3})[0] == 200
    assert _metrics(port)[("pio_profile_captures_total", ())] == 1.0
    monkeypatch.setattr(port_qs._devprof, "capture_profile", lambda ms: "/again")
    assert call("POST", f"{base}/debug/profile?ms=5")[0] == 200


def test_query_server_exports_the_train_kernel_families(server, fresh_recorder):
    qs, port = server
    assert not any(k[0].startswith("pio_train_kernel") for k in _metrics(port))
    als.train_als(DeviceContext.create(device="cpu"), _interactions(2),
                  als.ALSConfig(rank=4, iterations=1))
    m = _metrics(port)
    assert m[("pio_train_kernel_info", (("backend", "cpu"), ("compute_dtype", "f32")))] == 1.0
    assert m[("pio_train_kernel_resident_bytes", ())] == train_kernel.stats()["resident_bytes"]


def test_pio_profile_against_a_cpu_server(server, capsys):
    qs, port = server
    rc = port_cli.main(["profile", "--port", str(port), "--ms", "200", "--requests", "400",
                        "--concurrency", "4", "--query", json.dumps({"user": "u3", "num": 5})])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    last = json.loads(out[-1])
    assert set(last) == {"profile", "loadtest", "serverMetrics"}
    assert last["loadtest"]["errors"] == 0 and last["loadtest"]["ok"] == 400
    assert last["profile"]["ms"] == 200
    assert os.path.isfile(os.path.join(last["profile"]["path"], "trace.json"))
    assert any(line.startswith("[INFO] profile trace (200 ms): ") for line in out)
    assert any("roofline" in line and "obs/devprof.PEAKS" in line for line in out)
    assert _metrics(port)[("pio_profile_captures_total", ())] == 1.0
    # a refused capture fails the verb
    os.environ["PIO_PROFILE_ENDPOINT"] = "0"
    try:
        rc = port_cli.main(["profile", "--port", str(port), "--ms", "10", "--requests", "5"])
    finally:
        del os.environ["PIO_PROFILE_ENDPOINT"]
    assert rc == 1 and "HTTP 403" in capsys.readouterr().out
