"""Checkpoint mode and the quantized publish gate, port against JAX.

* ``quantize_factors`` gives the JAX package's int8 bytes and scales and
  its bf16 bits (the port holds bf16 as uint16 bit patterns), and
  ``quantized_topk_overlap`` the same number, so both packages' gates
  refuse the same generations;
* ``CheckpointedALSModel`` publish → load: every case of the JAX package's
  ``tests/test_quantize_publish.py`` (int8 and bf16 round trips, the f32
  default, a refusal, a corrupt or missing ``quant.blob``, the f32
  rollback, a dtype mismatch) answered the same way by both packages: the
  manifest's quant record, whether a blob exists, the dtype the load
  serves and its arrays, exactly;
* sharding knobs at publish raise naming ROADMAP item 10; ``PIO_IVF_NLIST``
  at publish seals an index whose manifest record equals the JAX package's;
* a CPU ``pio train`` in checkpoint mode under ``PIO_QUANT_DTYPE=int8``, then
  ``pio deploy --batching --device cpu``: the server reports int8 (``GET /``
  and the ``dtype`` label of ``/metrics``) and its answers equal the JAX
  package's quantized fast path (XLA reference backend) on the same
  factors by ``topk_mismatches`` at rtol = atol = 1e-5.
"""

import copy
import json
import os
import pickle
import re
import threading
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core import evaluation as jax_evaluation
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import evaluation
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import quantize
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli

TOL = 1e-5
CPU = DeviceContext.create(device="cpu")


def _factors(n_users=60, n_items=40, rank=8, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, rank)).astype(np.float32),
            rng.standard_normal((n_items, rank)).astype(np.float32))


def _bits(a):
    """A quantized array as comparable numpy: bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_quantized_bytes_scales_and_overlap_equal_jax(dtype, seed, scale):
    U, V = (f * scale for f in _factors(80, 300, 10, seed))
    V[3] = 0.0  # an all-zero row: unit scale
    uq, us = quantize.quantize_factors(U, dtype)
    vq, vs = quantize.quantize_factors(V, dtype)
    juq, jus = jax_quantize.quantize_factors(U, dtype)
    jvq, jvs = jax_quantize.quantize_factors(V, dtype)
    np.testing.assert_array_equal(uq, _bits(juq))
    np.testing.assert_array_equal(vq, _bits(jvq))
    if dtype == "int8":
        np.testing.assert_array_equal(us, jus)
        np.testing.assert_array_equal(vs, jvs)
    else:
        assert us is None and jus is None
    for k, sample in ((100, 256), (7, 13)):
        got = evaluation.quantized_topk_overlap(U, V, uq, us, vq, vs, k=k, sample=sample)
        ref = jax_evaluation.quantized_topk_overlap(U, V, juq, jus, jvq, jvs, k=k, sample=sample)
        assert got == ref


# (publish PIO_QUANT_DTYPE, PIO_QUANT_MIN_OVERLAP, deploy PIO_QUANT_DTYPE, damage to quant.blob)
CASES = {
    "int8-round-trip": ("int8", None, None, None),
    "bf16-round-trip": ("bf16", None, None, None),
    "default-f32": (None, None, None, None),
    "refused": ("int8", "1.01", None, None),
    "corrupt-blob": ("int8", None, None, "corrupt"),
    "missing-blob": ("int8", None, None, "missing"),
    "f32-rollback": ("int8", None, "f32", None),
    "dtype-mismatch": ("bf16", None, "int8", None),
    "auto-at-deploy": ("int8", None, "auto", None),
}


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _publish_and_load(pkg, tmp_path, monkeypatch, case):
    publish, threshold, deploy, damage = CASES[case]
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
    _set(monkeypatch, "PIO_QUANT_DTYPE", publish)
    _set(monkeypatch, "PIO_QUANT_MIN_OVERLAP", threshold)
    U, V = _factors()
    if pkg == "jax":
        cls, bimap, ctx = jax_als.CheckpointedALSModel, JaxBiMap, MeshContext.create()
    else:
        cls, bimap, ctx = als.CheckpointedALSModel, BiMap, CPU
    m = cls(U, V, bimap.string_int(f"u{i}" for i in range(len(U))),
            bimap.string_int(f"i{i}" for i in range(len(V))), None)
    assert m.save("inst", None) is True
    d = cls._dir("inst")
    with open(os.path.join(d, "maps.pkl"), "rb") as f:
        meta = pickle.load(f)
    blob = os.path.join(d, "quant.blob")
    had_blob = os.path.exists(blob)
    if damage == "corrupt":
        data = open(blob, "rb").read()
        with open(blob, "wb") as f:
            f.write(data[:-7] + b"XXXXXXX")
    elif damage == "missing":
        os.remove(blob)
    _set(monkeypatch, "PIO_QUANT_DTYPE", deploy)
    loaded = cls.load("inst", None, ctx)
    np.testing.assert_array_equal(loaded.user_factors, U)
    return meta, had_blob, loaded


@pytest.mark.parametrize("case", sorted(CASES))
def test_publish_and_load_answer_as_jax(tmp_path, monkeypatch, case):
    jmeta, jblob, jm = _publish_and_load("jax", tmp_path, monkeypatch, case)
    pmeta, pblob, pm = _publish_and_load("port", tmp_path, monkeypatch, case)
    assert pmeta["quant"] == jmeta["quant"]
    assert pmeta["sharding"] == jmeta["sharding"] == {"n_shards": 0}
    assert pmeta["ivf"] == jmeta["ivf"] == {"nlist": 0}
    assert pblob == jblob
    assert pm.factor_dtype == jm.factor_dtype
    if pm.factor_dtype == "f32":
        assert pm.user_factors_q is None and jm.user_factors_q is None
    else:
        for name in ("user_factors_q", "item_factors_q"):
            np.testing.assert_array_equal(getattr(pm, name), _bits(getattr(jm, name)))
        for name in ("user_scale", "item_scale"):
            a, b = getattr(pm, name), getattr(jm, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_quant_warnings_name_the_fallback(tmp_path, monkeypatch, caplog):
    _publish_and_load("port", tmp_path, monkeypatch, "corrupt-blob")
    assert "quantized factors unavailable" in caplog.text and "serving fp32" in caplog.text


@pytest.mark.parametrize("knob,item", [("PIO_SHARD_COUNT", "4"), ("PIO_SHARD_HBM_BUDGET", "400")])
def test_unported_publish_knobs_raise(tmp_path, monkeypatch, knob, item):
    """The ``PIO_SHARD_*`` knobs are ported: each declares the JAX
    package's plan at publish (``item`` is the knob's value: 4 shards, or
    400 bytes a shard of the 40 × 8 float32 items, also 4), sealed as
    ``plan.blob`` with the same manifest record and payload, and a load
    brings it back."""
    for k in ("PIO_SHARD_COUNT", "PIO_SHARD_HBM_BUDGET", "PIO_SHARD_STRATEGY",
              "PIO_POD_HOST_GROUPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(knob, item)
    U, V = _factors()
    out = {}
    for pkg, mod, bimap in (("jax", jax_als, JaxBiMap), ("port", als, BiMap)):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
        m = mod._declare_sharding_plan(mod.CheckpointedALSModel(
            U, V, bimap.string_int(f"u{i}" for i in range(len(U))),
            bimap.string_int(f"i{i}" for i in range(len(V))), None))
        assert m.save("inst", None) is True
        d = mod.CheckpointedALSModel._dir("inst")
        with open(os.path.join(d, "maps.pkl"), "rb") as f:
            record = pickle.load(f)["sharding"]
        with open(os.path.join(d, "plan.blob"), "rb") as f:
            out[pkg] = (record, f.read())
    assert out["port"] == out["jax"]
    assert out["port"][0]["n_shards"] == 4
    loaded = als.CheckpointedALSModel.load("inst", None, DeviceContext.create(device="cpu"))
    assert loaded.sharding_plan.fingerprint == out["port"][0]["fingerprint"]


def test_ivf_nlist_at_publish_seals_the_jax_record(tmp_path, monkeypatch):
    for k in ("PIO_IVF_NPROBE", "PIO_IVF_MIN_RECALL", "PIO_IVF_EVAL_USERS", "PIO_RETRIEVAL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_IVF_NLIST", "4")
    monkeypatch.setenv("PIO_IVF_MIN_RECALL", "0")  # the gate seals whatever recall it measures
    U, V = _factors()
    metas = {}
    for pkg, mod, bimap in (("jax", jax_als, JaxBiMap), ("port", als, BiMap)):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
        m = mod.CheckpointedALSModel(U, V, bimap.string_int(f"u{i}" for i in range(len(U))),
                                     bimap.string_int(f"i{i}" for i in range(len(V))), None)
        assert m.save("inst", None) is True
        d = mod.CheckpointedALSModel._dir("inst")
        with open(os.path.join(d, "maps.pkl"), "rb") as f:
            metas[pkg] = pickle.load(f)["ivf"]
        assert os.path.exists(os.path.join(d, "ivf.blob"))
    assert metas["port"] == metas["jax"]
    assert metas["port"]["nlist"] == 4 and metas["port"]["fingerprint"]


def test_batch_recommend_stays_on_the_host_on_the_cpu():
    U, V = _factors()
    m = als.als_model_from_arrays(U, V, [f"u{i}" for i in range(len(U))],
                                  [f"i{i}" for i in range(len(V))])
    scorer = als.ALSScorer(CPU, m)
    idx, _ = scorer.recommend_batch(np.arange(10), 5)
    assert getattr(scorer, "_fastpath", None) is None
    np.testing.assert_array_equal(idx, np.argsort(-(U[:10] @ V.T), axis=1, kind="stable")[:, :5])


def _http(url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        raw = r.read()
    return json.loads(raw) if body is not None or url.endswith("/") else raw.decode()


def _wait(url):
    t_end = time.monotonic() + 60
    while time.monotonic() < t_end:
        try:
            urllib.request.urlopen(url, timeout=5).close()
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"{url} never answered")


def test_int8_checkpoint_deploy_on_the_cpu_matches_jax_quantized_fast_path(
        tmp_path, monkeypatch, capsys):
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_QUANT_", "PIO_ALS_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    Storage.reset_instance()
    try:
        assert port_cli.main(["app", "new", "QuantApp"]) == 0
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("QuantApp").id
        rng = np.random.default_rng(4)
        storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                  target_entity_type="item", target_entity_id=f"i{int(i)}",
                  properties={"rating": int(r)}, event_time=1_767_225_600.0 + k)
            for k, (u, i, r) in enumerate(zip(rng.integers(0, 50, 1500),
                                              rng.integers(0, 300, 1500),
                                              rng.integers(1, 6, 1500)))], app_id)
        eng = tmp_path / "engine"
        eng.mkdir()
        (eng / "engine.json").write_text(json.dumps({
            "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
            "datasource": {"params": {"appName": "QuantApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "numIterations": 4, "persistMode": "checkpoint"}}]}))
        monkeypatch.setenv("PIO_QUANT_DTYPE", "int8")
        assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 0
        iid = re.search(r"Engine instance ID: (\S+)", capsys.readouterr().out).group(1)
        monkeypatch.delenv("PIO_QUANT_DTYPE")  # auto at deploy: the recorded int8
        d = als.CheckpointedALSModel._dir(iid)
        assert os.path.exists(os.path.join(d, "quant.blob"))
        port = _free_port()
        t = threading.Thread(target=port_cli.main, args=([
            "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
            "--batching", "--device", "cpu"],), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        _wait(f"{base}/readyz")
        info = _http(f"{base}/")
        assert info["engineInstanceId"] == iid
        assert info["fastpath"][0]["kernel"]["factor_dtype"] == "int8"
        assert 'dtype="int8"' in _http(f"{base}/metrics")
        users = [f"u{k}" for k in range(50)]
        answers = {u: _http(f"{base}/queries.json", {"user": u, "num": 10}) for u in users}
        assert port_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(30)
        model = als.CheckpointedALSModel.load(iid, None, CPU)
    finally:
        Storage.reset_instance()
        port_sqlite.close_all_dbs()

    # the JAX package's quantized fast path on the same fp32 factors
    jm = jax_als.ALSModel(
        model.user_factors, model.item_factors,
        JaxBiMap(model.user_map.to_dict()), JaxBiMap(model.item_map.to_dict()), None)
    jq = copy.copy(jm)
    jq.factor_dtype = "int8"
    jq.user_factors_q, jq.user_scale = jax_quantize.quantize_factors(jm.user_factors, "int8")
    jq.item_factors_q, jq.item_scale = jax_quantize.quantize_factors(jm.item_factors, "int8")
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=8))
    algo.load_serializable_model(MeshContext.create(), jq)
    algo.warmup(jq)
    ref = dict(algo.batch_predict(jq, [(k, jax_rec.Query(user=u, num=10))
                                        for k, u in enumerate(users)]))
    items = {it: k for k, it in enumerate(model.item_map.keys())}
    for k, u in enumerate(users):
        got, want = answers[u]["itemScores"], ref[k].itemScores
        bad = topk_mismatches(
            np.array([[x["score"] for x in got]]), np.array([[items[x["item"]] for x in got]]),
            np.array([[s.score for s in want]]), np.array([[items[s.item] for s in want]]), TOL)
        assert not bad, (u, bad[:3])


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
