"""The serving slice end to end: a JAX-trained ALS model served by the port.

A small explicit ALS trains on the CPU in the JAX package; its factors and
id tables carry across with ``als_model_from_arrays``; the port's
``QueryServer`` (``batching=True``, ``device="cpu"``, MEMORY storage)
deploys it from a sealed blob and answers ``/queries.json``. Every answer —
plain, blacklist and whitelist queries, quantized variants, a concurrent
burst — must equal the JAX package's ``ALSAlgorithm.batch_predict`` /
``predict`` on the same model, warmed so the JAX side serves through its
own fast path (XLA ``reference`` backend).

Tolerance: scores within rtol = atol = 1e-5; item order equal except
between two reference scores within that tolerance (``topk_mismatches``).
Filtered queries take the host numpy path in both packages (the model is
below ``HOST_THRESHOLD``), so those must be exactly equal.
"""

import datetime as dt
import json
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from predictionio_tpu.data.batch import Interactions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.als import ALSConfig as JaxALSConfig
from predictionio_tpu.models.als import train_als
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.data.storage import memory
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.localfs import LocalFSModels
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSModel, als_model_from_arrays
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    RecommendationEngine,
)

TOL = 1e-5
N_USERS, N_ITEMS = 40, 30


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(N_USERS, 3)) / np.sqrt(3)
    V = rng.normal(size=(N_ITEMS, 3)) / np.sqrt(3)
    users, items = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.5)
    inter = Interactions(
        user=users.astype(np.int32),
        item=items.astype(np.int32),
        rating=(U @ V.T)[users, items].astype(np.float32),
        t=np.zeros(len(users)),
        user_map=JaxBiMap.string_int(f"u{i}" for i in range(N_USERS)),
        item_map=JaxBiMap.string_int(f"i{i}" for i in range(N_ITEMS)),
    )
    return train_als(MeshContext.create(), inter, JaxALSConfig(rank=4, iterations=4))


def _carry(m, dtype="f32"):
    inv_u, inv_i = m.user_map.inverse, m.item_map.inverse
    return als_model_from_arrays(
        m.user_factors, m.item_factors,
        [inv_u[i] for i in range(len(inv_u))],
        [inv_i[i] for i in range(len(inv_i))],
        factor_dtype=dtype,
    )


def _jax_quantized(m, dtype):
    """The JAX model with its published quantized variant filled in."""
    import copy

    q = copy.copy(m)
    q.factor_dtype = dtype
    q.user_factors_q, q.user_scale = jax_quantize.quantize_factors(m.user_factors, dtype)
    q.item_factors_q, q.item_scale = jax_quantize.quantize_factors(m.item_factors, dtype)
    return q


def publish(storage, model, engine_variant="default"):
    """Store ``model`` as a COMPLETED instance with its sealed blob (the
    steps the training workflow takes after training)."""
    engine = RecommendationEngine.apply()
    params = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 4, "lambda": 0.01}}]}
    )
    algos = engine.make_algorithms(params)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant=engine_variant,
        engine_factory="predictionio_tpu_torch.templates.recommendation.RecommendationEngine",
        **params.to_json_strings(),
    )
    iid = instances.insert(inst)
    blob = persistence.serialize_models(
        iid, algos, [model], [p for _, p in params.algorithm_params_list]
    )
    storage.get_model_data_models().insert(
        Model(id=iid, models=persistence.seal_model_blob(blob))
    )
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


@pytest.fixture()
def mem_storage():
    name = "T" + uuid.uuid4().hex[:8].upper()
    yield Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })
    memory.reset_store(name)


def _serve(storage, model):
    iid = publish(storage, model)
    qs = QueryServer(
        RecommendationEngine.apply(), storage=storage,
        ctx=DeviceContext.create(device="cpu"), batching=True,
    )
    port = qs.start("127.0.0.1", 0)
    return qs, f"http://127.0.0.1:{port}", iid


def _post(base, q):
    req = urllib.request.Request(
        f"{base}/queries.json", data=json.dumps(q).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax_algo(m):
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4))
    algo.load_serializable_model(MeshContext.create(), m)
    algo.warmup(m)
    return algo


def _jax_answer(algo, m, q):
    query = jax_rec.Query(**q)
    if q.get("blackList") or q.get("whiteList"):
        res = algo.predict(m, query)
    else:
        [(_, res)] = algo.batch_predict(m, [(0, query)])
    return [(s.item, s.score) for s in res.itemScores]


def _assert_same(got, ref, exact=False):
    assert len(got) == len(ref), (got, ref)
    if not ref:
        return
    item_id = {it: i for i, it in enumerate(sorted({x for x, _ in got + ref}))}
    gv = np.array([[s for _, s in got]], np.float32)
    gi = np.array([[item_id[x] for x, _ in got]])
    rv = np.array([[s for _, s in ref]], np.float32)
    ri = np.array([[item_id[x] for x, _ in ref]])
    bad = topk_mismatches(gv, gi, rv, ri, 0.0 if exact else TOL)
    assert not bad, bad[:3]


class TestServedAnswersMatchJax:
    @pytest.fixture(scope="class")
    def served(self, jax_model):
        name = "T" + uuid.uuid4().hex[:8].upper()
        storage = Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"})
        qs, base, iid = _serve(storage, _carry(jax_model))
        yield qs, base, iid, _jax_algo(jax_model)
        qs.stop()
        memory.reset_store(name)

    @pytest.mark.parametrize("num", (1, 5, 12, 30))
    def test_plain_queries(self, served, jax_model, num):
        qs, base, _, algo = served
        for u in ("u0", "u7", "u39"):
            q = {"user": u, "num": num}
            _assert_same(
                [(s["item"], s["score"]) for s in _post(base, q)["itemScores"]],
                _jax_answer(algo, jax_model, q),
            )

    @pytest.mark.parametrize(
        "extra",
        [{"blackList": ["i0", "i3", "i17", "nope"]},
         {"whiteList": ["i2", "i5", "i9", "i11", "i29"]},
         {"blackList": ["i5"], "whiteList": ["i2", "i5", "i9"]},
         {"whiteList": ["nope"]}],
    )
    def test_filtered_queries(self, served, jax_model, extra):
        qs, base, _, algo = served
        q = {"user": "u3", "num": 4, **extra}
        got = [(s["item"], s["score"]) for s in _post(base, q)["itemScores"]]
        _assert_same(got, _jax_answer(algo, jax_model, q), exact=True)
        for it in extra.get("blackList", []):
            assert it not in [x for x, _ in got]
        if "whiteList" in extra:
            assert {x for x, _ in got} <= set(extra["whiteList"])

    def test_unknown_user_is_empty(self, served):
        _, base, _, _ = served
        assert _post(base, {"user": "stranger", "num": 3}) == {"itemScores": []}

    def test_concurrent_burst_batches_and_matches(self, served, jax_model):
        qs, base, _, algo = served
        before = qs._deployed.algorithms[0].serving_stats(qs._deployed.models[0])
        queries = [{"user": f"u{i % N_USERS}", "num": 3 + i % 9} for i in range(48)]
        out = [None] * len(queries)
        threads = [
            threading.Thread(target=lambda i=i: out.__setitem__(i, _post(base, queries[i])))
            for i in range(len(queries))
        ]
        with qs._batcher.held():
            for t in threads:
                t.start()
        for t in threads:
            t.join(30)
        for q, a in zip(queries, out):
            _assert_same(
                [(s["item"], s["score"]) for s in a["itemScores"]],
                _jax_answer(algo, jax_model, q),
            )
        after = qs._deployed.algorithms[0].serving_stats(qs._deployed.models[0])
        assert after["queries"] - before["queries"] == len(queries)
        assert after["calls"] - before["calls"] < len(queries)  # batched

    def test_readyz_and_index(self, served):
        _, base, iid, _ = served
        status, body = _get(base, "/readyz")
        assert status == 200 and body["status"] == "ready"
        assert body["fastpathWarm"] and body["engineInstanceId"] == iid
        status, info = _get(base, "/")
        assert status == 200 and info["engineInstanceId"] == iid
        fp = info["fastpath"][0]
        assert fp["kernel"]["device"] == "cpu"
        assert fp["kernel"]["warmup_executions"] == 5
        assert info["batching"]["queries"] >= 1

    def test_bad_query_is_400(self, served):
        _, base, _, _ = served
        req = urllib.request.Request(
            f"{base}/queries.json", data=b"[1, 2]",
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400


@pytest.mark.parametrize("dtype", ("bf16", "int8"))
def test_quantized_variant_matches_jax(jax_model, mem_storage, dtype):
    qs, base, _ = _serve(mem_storage, _carry(jax_model, dtype))
    try:
        jm = _jax_quantized(jax_model, dtype)
        algo = _jax_algo(jm)
        for u in ("u1", "u20"):
            q = {"user": u, "num": 10}
            _assert_same(
                [(s["item"], s["score"]) for s in _post(base, q)["itemScores"]],
                _jax_answer(algo, jm, q),
            )
        _, info = _get(base, "/")
        assert info["fastpath"][0]["kernel"]["factor_dtype"] == dtype
    finally:
        qs.stop()


def test_reload_serves_newest_instance(jax_model, mem_storage):
    qs, base, first = _serve(mem_storage, _carry(jax_model))
    try:
        second = publish(mem_storage, _carry(jax_model))
        assert qs.reload() == second
        assert _get(base, "/readyz")[1]["engineInstanceId"] == second
        assert first != second
    finally:
        qs.stop()


def test_no_instance_raises(mem_storage):
    with pytest.raises(RuntimeError, match="No completed engine instance"):
        QueryServer(
            RecommendationEngine.apply(), storage=mem_storage,
            ctx=DeviceContext.create(device="cpu"),
        )


def test_corrupt_blob_raises(jax_model, mem_storage):
    iid = publish(mem_storage, _carry(jax_model))
    row = mem_storage.get_model_data_models().get(iid)
    torn = row.models[:-7] + b"garbage"
    mem_storage.get_model_data_models().insert(Model(id=iid, models=torn))
    with pytest.raises(persistence.ModelIntegrityError):
        QueryServer(
            RecommendationEngine.apply(), storage=mem_storage,
            ctx=DeviceContext.create(device="cpu"),
        )


class TestPersistenceAndStorage:
    def test_blob_round_trip_keeps_port_classes(self, jax_model):
        m = _carry(jax_model, "bf16")
        algo = ALSAlgorithm(ALSAlgorithmParams())
        blob = persistence.serialize_models("x", [algo], [m], [algo.params])
        assert b"predictionio_tpu_torch.models.als" in blob
        sealed = persistence.seal_model_blob(blob)
        models, retrain = persistence.deserialize_models(
            persistence.open_model_blob(sealed), "x", [algo], [algo.params],
            DeviceContext.create(device="cpu"),
        )
        assert retrain == [] and isinstance(models[0], ALSModel)
        np.testing.assert_array_equal(models[0].user_factors_q, m.user_factors_q)
        assert models[0].user_map == m.user_map

    def test_seal_blob_file(self, tmp_path):
        p = str(tmp_path / "x.blob")
        persistence.seal_blob_file(p, b"payload")
        assert persistence.open_blob_file(p) == b"payload"
        with open(p, "r+b") as f:
            f.seek(-1, 2)
            f.write(b"!")
        with pytest.raises(persistence.ModelIntegrityError):
            persistence.open_blob_file(p)

    def test_localfs_models(self, tmp_path):
        dao = LocalFSModels(path=str(tmp_path))
        dao.insert(Model(id="a/b", models=b"1"))
        dao.insert(Model(id="a_b", models=b"2"))
        assert dao.get("a/b").models == b"1" and dao.get("a_b").models == b"2"
        dao.delete("a/b")
        assert dao.get("a/b") is None

    def test_env_contract(self, tmp_path, monkeypatch):
        env = {
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        }
        s = Storage(env=env)
        assert isinstance(s.get_model_data_models(), LocalFSModels)
        s.get_model_data_models().insert(Model(id="m", models=b"z"))
        assert (tmp_path / "m").read_bytes() == b"z"
        with pytest.raises(StorageError, match="does not implement"):
            Storage(env={**env, "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS"}) \
                .get_meta_data_engine_instances()
        # no source named: the zero-config sqlite source under PIO_FS_BASEDIR
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
        zero = Storage(env={})
        assert zero.repository_bindings() == {
            r: ("DEFAULT", "sqlite") for r in ("METADATA", "EVENTDATA", "MODELDATA")}
        zero.get_model_data_models().insert(Model(id="z", models=b"0"))
        assert (tmp_path / "base" / "default.sqlite").exists()
        assert zero.get_model_data_models().get("z").models == b"0"
        with pytest.raises(StorageError, match="unknown storage type"):
            Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": "hbase"}).get_model_data_models()

    def test_engine_json_binds_like_jax(self):
        variant = {
            "datasource": {"params": {"appName": "MyApp"}},
            "algorithms": [{"name": "als", "params": {"rank": 10, "numIterations": 20,
                                                      "lambda": 0.01, "seed": 3}}],
        }
        port = RecommendationEngine.apply().params_from_variant(variant)
        ref = jax_rec.RecommendationEngine.apply().params_from_variant(variant)
        assert port.to_json_strings() == ref.to_json_strings()

    def test_algorithm_trains_and_its_model_serves(self, jax_model):
        """``ALSAlgorithm.train`` trains on the CPU through ``train_als`` and
        the model it returns answers through the same algorithm."""
        from predictionio_tpu_torch.data.batch import interactions_from_arrays
        from predictionio_tpu_torch.templates.recommendation import Query, TrainingData

        rng = np.random.default_rng(1)
        users, items = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.4)
        inter = interactions_from_arrays(
            users, items, rng.uniform(1, 5, len(users)), np.zeros(len(users)),
            [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)],
        )
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=4, numIterations=3))
        model = algo.train(DeviceContext.create(device="cpu"), TrainingData(inter))
        assert isinstance(model, ALSModel) and model.user_factors.shape == (N_USERS, 4)
        assert np.isfinite(model.item_factors).all()
        res = algo.predict(model, Query(user="u3", num=5))
        scores = [s.score for s in res.itemScores]
        assert len(scores) == 5 and scores == sorted(scores, reverse=True)
        U, V = model.user_factors, model.item_factors
        best = np.argsort(-(U[3] @ V.T), kind="stable")[:5]
        assert [s.item for s in res.itemScores] == [f"i{j}" for j in best]
