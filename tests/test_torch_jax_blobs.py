"""Records the JAX package wrote, read by the port without importing it.

The sqlite store is shared by both packages, so the port meets JAX-written
model blobs, manifests and ``engineFactory`` paths. It reads them through
``core/persistence``'s table of counterparts and never imports
``predictionio_tpu``:

* a JAX auto-mode ALS blob (its pickle names only the JAX ``ALSModel``,
  ``ALSConfig``, ``BiMap`` and numpy) loads as the port's classes, factors
  and id maps exactly equal, the config reconciled (``train_kernel``
  dropped, ``checkpoint_interval`` kept);
* a JAX SASRec blob: its pickle holds host numpy arrays only, and it loads
  as the port's ``SASRecModel`` whose logits on a history equal the JAX
  model's within rtol = atol = 1e-4 (``tests/test_torch_sequential.py``'s
  tolerance);
* a blob naming a JAX class without a counterpart (a sharding plan), an
  unported template, and a checkpoint-mode manifest (orbax factors) are
  refused with errors that name them;
* ``pio train`` of the JAX CLI into a sqlite store, then the port's ``pio
  deploy --batching --device cpu`` on the same store and engine.json: the
  answers equal the JAX model's host ranking (``topk_mismatches``, 1e-5).
  ``tests/test_torch_imports.py`` does the same with jax blocked.
"""

import json
import os
import pickle
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax

from predictionio_tpu.core import persistence as jax_persistence
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.models import sequential as jax_seq
from predictionio_tpu.serving import sharding as jax_sharding
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu.templates import sequentialrecommendation as jax_seq_tmpl
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als, sequential
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.templates import sequentialrecommendation as seq_tmpl
from predictionio_tpu_torch.testing import topk_mismatches

CPU = DeviceContext.create(device="cpu")


class _Recorder(pickle.Unpickler):
    def __init__(self, data):
        import io

        super().__init__(io.BytesIO(data))
        self.paths = set()

    def find_class(self, module, name):
        self.paths.add(f"{module}.{name}")
        return super().find_class(module, name)


def _globals(blob: bytes) -> set:
    r = _Recorder(blob)
    r.load()
    return r.paths


def _jax_als_model():
    rng = np.random.default_rng(0)
    return jax_als.ALSModel(
        rng.standard_normal((30, 5)).astype(np.float32),
        rng.standard_normal((20, 5)).astype(np.float32),
        JaxBiMap.string_int(f"u{i}" for i in range(30)),
        JaxBiMap.string_int(f"i{i}" for i in range(20)),
        jax_als.ALSConfig(rank=5, iterations=3, compute_dtype="bf16", train_kernel="fused",
                          checkpoint_interval=7),
    )


def _jax_blob(algo, model):
    return jax_persistence.serialize_models("x", [algo], [model], [algo.params])


def test_jax_als_blob_loads_as_port_classes():
    m = _jax_als_model()
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=5))
    blob = _jax_blob(algo, m)
    names = {p for p in _globals(blob) if p.startswith("predictionio_tpu")}
    assert names == {"predictionio_tpu.models.als.ALSModel",
                     "predictionio_tpu.models.als.ALSConfig",
                     "predictionio_tpu.data.bimap.BiMap"}
    port_algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=5))
    [got], retrain = persistence.deserialize_models(blob, "x", [port_algo], [port_algo.params], CPU)
    assert retrain == [] and type(got) is als.ALSModel
    np.testing.assert_array_equal(got.user_factors, m.user_factors)
    np.testing.assert_array_equal(got.item_factors, m.item_factors)
    assert got.user_map.to_dict() == m.user_map.to_dict()
    assert got.item_map.inverse[3] == m.item_map.inverse[3]
    assert type(got.config) is als.ALSConfig and not hasattr(got.config, "train_kernel")
    assert (got.config.rank, got.config.compute_dtype, got.config.checkpoint_interval) == \
        (5, "bf16", 7)
    assert got.factor_dtype == "f32" and got.sharding_plan is None
    idx, _ = port_algo._scorer(got).recommend_batch(np.arange(5), 4)
    np.testing.assert_array_equal(
        idx, np.argsort(-(m.user_factors[:5] @ m.item_factors.T), axis=1, kind="stable")[:, :4])


def test_jax_sasrec_blob_holds_host_arrays_and_loads():
    cfg = jax_seq.SASRecConfig(d_model=8, n_layers=1, n_heads=2, max_len=6)
    params = jax.tree.map(np.asarray, jax_seq._init_params(jax.random.PRNGKey(0), cfg, 12))
    m = jax_seq.SASRecModel(params, JaxBiMap.string_int(f"i{k}" for k in range(12)), cfg)
    algo = jax_seq_tmpl.SASRecAlgorithm(jax_seq_tmpl.SASRecParams())
    blob = _jax_blob(algo, m)
    names = _globals(blob)
    assert {p for p in names if p.startswith("predictionio_tpu")} == {
        "predictionio_tpu.models.sequential.SASRecModel",
        "predictionio_tpu.models.sequential.SASRecConfig",
        "predictionio_tpu.data.bimap.BiMap"}
    assert all(p.split(".")[0] in ("predictionio_tpu", "numpy", "builtins", "copyreg",
                                   "collections", "_codecs") for p in names), names
    port_algo = seq_tmpl.SASRecAlgorithm(seq_tmpl.SASRecParams())
    [got], _ = persistence.deserialize_models(blob, "x", [port_algo], [port_algo.params], CPU)
    assert type(got) is sequential.SASRecModel and got.losses is None
    assert got.config == sequential.SASRecConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    history = ["i1", "i4", "i4", "i9"]
    items, scores = got.recommend(history, 5)
    ref_items, ref_scores = m.recommend(history, 5)
    assert items == ref_items
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-4, atol=1e-4)


def test_jax_blob_with_a_sharding_plan_is_refused():
    """Sharded serving is ported: a JAX blob whose model declares a plan
    loads with the port's ShardingPlan, payload for payload, and a mesh of
    the plan's placements serves it sharded, equal to the replicated
    answers bit for bit."""
    from predictionio_tpu_torch.serving import sharding

    m = _jax_als_model()
    m.sharding_plan = jax_sharding.build_plan(20, n_shards=2)
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=5))
    port_algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=5))
    [got], _ = persistence.deserialize_models(_jax_blob(algo, m), "x", [port_algo],
                                              [port_algo.params], CPU)
    assert type(got.sharding_plan) is sharding.ShardingPlan
    assert got.sharding_plan.to_payload() == m.sharding_plan.to_payload()
    mesh = DeviceContext.create(devices=["cpu"] * 2)
    shrd = als.ALSScorer(mesh, got).enable_fastpath()
    repl = als.ALSScorer(CPU, got).enable_fastpath()
    assert (shrd.sharding, repl.sharding) == ("sharded", "replicated")
    users = np.arange(len(got.user_factors))
    (si, sv), (ri, rv) = shrd.score_topk(users, 5), repl.score_topk(users, 5)
    assert np.array_equal(si, ri) and sv.tobytes() == rv.tobytes()


@pytest.mark.parametrize("path,want", [
    ("predictionio_tpu.templates.recommendation.RecommendationEngine",
     rec.RecommendationEngine),
    ("predictionio_tpu.templates.recommendation.RecommendationEvaluation",
     rec.RecommendationEvaluation),
    ("predictionio_tpu.templates.sequentialrecommendation.SequentialRecommendationEngine",
     seq_tmpl.SequentialRecommendationEngine),
    ("predictionio_tpu.models.als.ALSModel", als.ALSModel),
    ("predictionio_tpu_torch.models.als.CheckpointedALSModel", als.CheckpointedALSModel),
])
def test_resolve_class_maps_jax_paths(path, want):
    assert persistence.resolve_class(path) is want


@pytest.mark.parametrize("path,match", [
    ("predictionio_tpu.models.als.CheckpointedALSModel", "orbax"),
    ("predictionio_tpu.templates.nosuchtemplate.Engine", "no counterpart"),
    ("predictionio_tpu.serving.fleet.Fleet", "no counterpart"),
    ("jax.numpy.ndarray", "no counterpart"),
    ("orbax.checkpoint.PyTreeCheckpointer", "does not import"),
])
def test_resolve_class_refuses_foreign_paths(path, match):
    with pytest.raises(persistence.ForeignClassError, match=match) as e:
        persistence.resolve_class(path)
    assert path in str(e.value)


def test_jax_checkpoint_manifest_is_refused():
    slots = pickle.dumps([("manifest", "predictionio_tpu.models.als.CheckpointedALSModel")])
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams())
    with pytest.raises(persistence.ForeignClassError, match="orbax checkpoint"):
        persistence.deserialize_models(slots, "x", [algo], [algo.params], CPU)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_jax_trained_instance_deploys_in_the_port(tmp_path, monkeypatch, capsys):
    from predictionio_tpu_torch.tools import cli as port_cli

    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_QUANT_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    JaxStorage.reset_instance()
    try:
        assert jax_cli.main(["app", "new", "Shared"]) == 0
        storage = JaxStorage.instance()
        from predictionio_tpu.data.event import Event

        app_id = storage.get_meta_data_apps().get_by_name("Shared").id
        rng = np.random.default_rng(1)
        storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                  target_entity_type="item", target_entity_id=f"i{int(i)}",
                  properties={"rating": int(r)}, event_time=1_767_225_600.0 + k)
            for k, (u, i, r) in enumerate(zip(rng.integers(0, 30, 600),
                                              rng.integers(0, 25, 600),
                                              rng.integers(1, 6, 600)))], app_id)
        eng = tmp_path / "engine"
        eng.mkdir()
        (eng / "engine.json").write_text(json.dumps({
            "engineFactory": "predictionio_tpu.templates.recommendation.RecommendationEngine",
            "datasource": {"params": {"appName": "Shared"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3}}]}))
        assert jax_cli.main(["train", "--engine-dir", str(eng)]) == 0
        inst = storage.get_meta_data_engine_instances().get_latest_completed(
            "predictionio_tpu.templates.recommendation.RecommendationEngine", "default",
            "default")
        jm = jax_persistence.deserialize_models(
            jax_persistence.open_model_blob(storage.get_model_data_models().get(inst.id).models),
            inst.id, [jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams())],
            [jax_rec.ALSAlgorithmParams()], None)[0][0]
    finally:
        JaxStorage.reset_instance()
        jax_sqlite.close_all_dbs()
    Storage.reset_instance()
    port = _free_port()
    try:
        t = threading.Thread(target=port_cli.main, args=([
            "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
            "--batching", "--device", "cpu"],), daemon=True)
        t.start()
        url = f"http://127.0.0.1:{port}"
        t_end = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(f"{url}/readyz", timeout=5).close()
                break
            except OSError:
                assert time.monotonic() < t_end and t.is_alive()
                time.sleep(0.05)
        with urllib.request.urlopen(f"{url}/", timeout=10) as r:
            assert json.loads(r.read())["engineInstanceId"] == inst.id
        for u in range(30):
            req = urllib.request.Request(
                f"{url}/queries.json", data=json.dumps({"user": f"u{u}", "num": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())["itemScores"]
            row = jm.user_factors[jm.user_map[f"u{u}"]] @ jm.item_factors.T
            ref = np.argsort(-row, kind="stable")[:6]
            bad = topk_mismatches(
                np.array([[x["score"] for x in got]]),
                np.array([[jm.item_map[x["item"]] for x in got]]),
                row[ref][None], ref[None], 1e-5)
            assert not bad, bad[:3]
        assert port_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(30)
    finally:
        Storage.reset_instance()
        port_sqlite.close_all_dbs()


def _template_events():
    """Events every template below trains on: views and buys in two taste
    groups, follows, item categories and labeled user attributes."""
    from predictionio_tpu.data.event import Event

    rng = np.random.default_rng(2)
    out = []
    for u in range(40):
        group = [i for i in range(16) if i % 2 == u % 2]
        for i in rng.choice(group, 4, replace=False):
            out.append(Event(event="view", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{i}",
                             event_time=1_767_225_600.0 + len(out)))
        out.append(Event(event="buy", entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{group[u % 8]}",
                         event_time=1_767_225_600.0 + len(out)))
        for v in rng.choice([x for x in range(40) if x % 2 == u % 2 and x != u], 3,
                            replace=False):
            out.append(Event(event="follow", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="user", target_entity_id=f"u{v}",
                             event_time=1_767_225_600.0 + len(out)))
    for i in range(16):
        out.append(Event(event="$set", entity_type="item", entity_id=f"i{i}",
                         properties={"categories": [f"c{i % 2}"]},
                         event_time=1_767_225_600.0 + len(out)))
    for c in range(60):
        a0, a1, a2 = (float(x) for x in rng.uniform(0, 10, 3))
        out.append(Event(event="$set", entity_type="user", entity_id=f"p{c}",
                         properties={"attr0": a0, "attr1": a1, "attr2": a2,
                                     "plan": "premium" if a0 + a1 > 10 else "basic"},
                         event_time=1_767_225_600.0 + len(out)))
    return out


TEMPLATE_CASES = {
    "classification": (
        [{"name": "naive", "params": {"lambda": 1.0}},
         {"name": "randomforest", "params": {"numTrees": 4, "maxDepth": 3}}],
        [{"features": [9.0, 8.0, 1.0]}, {"features": [1.0, 2.0, 3.0]}]),
    "similarproduct": (
        [{"name": "als", "params": {"rank": 4, "numIterations": 3}},
         {"name": "cooccurrence", "params": {"n": 5, "llr": True}}],
        [{"items": ["i0"], "num": 4}, {"items": ["i1", "i3"], "num": 3, "categories": ["c1"]}]),
    "similaruser": (
        [{"name": "als", "params": {"rank": 4, "numIterations": 3}}],
        [{"users": ["u0"], "num": 4}, {"users": ["u1", "u3"], "num": 3}]),
    "ecommercerecommendation": (
        [{"name": "ecomm", "params": {"appName": "Shared", "rank": 4, "numIterations": 3,
                                      "unseenOnly": True}}],
        [{"user": "u0", "num": 4}, {"user": "nobody", "num": 3},
         {"user": "u1", "num": 3, "categories": ["c1"]}]),
    "universalrecommender": (
        [{"name": "ur", "params": {"appName": "Shared", "maxCorrelatorsPerItem": 5}}],
        [{"user": "u0", "num": 4}, {"user": "u5", "num": 3, "blackList": ["i1"]}]),
}


def _without_none(obj):
    """A result as the servers encode it: fields that are None are left out."""
    if isinstance(obj, dict):
        return {k: _without_none(v) for k, v in obj.items() if v is not None}
    if isinstance(obj, list):
        return [_without_none(v) for v in obj]
    return obj


@pytest.mark.parametrize("template", sorted(TEMPLATE_CASES))
def test_jax_written_template_instance_deploys_and_answers(tmp_path, monkeypatch, template):
    """An auto-mode instance the JAX CLI trained for each of the other
    templates deploys with the port's ``pio deploy`` on the same sqlite
    store and answers what the JAX model answers from the same arrays."""
    import dataclasses

    from predictionio_tpu.data import store as jax_store
    from predictionio_tpu_torch.tools import cli as port_cli

    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_QUANT_", "PIO_IVF_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    from predictionio_tpu.parallel.mesh import MeshContext

    monkeypatch.setattr(jax_cli, "make_ctx",
                        lambda variant: MeshContext.create(devices=jax.devices()[:1]))
    algorithms, queries = TEMPLATE_CASES[template]
    factory = jax_cli.BUILTIN_TEMPLATES[template]
    JaxStorage.reset_instance()
    try:
        assert jax_cli.main(["app", "new", "Shared"]) == 0
        storage = JaxStorage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("Shared").id
        storage.get_l_events().insert_batch(_template_events(), app_id)
        eng = tmp_path / "engine"
        eng.mkdir()
        variant = {"engineFactory": factory, "datasource": {"params": {"appName": "Shared"}},
                   "algorithms": algorithms}
        (eng / "engine.json").write_text(json.dumps(variant))
        assert jax_cli.main(["train", "--engine-dir", str(eng)]) == 0
        inst = storage.get_meta_data_engine_instances().get_latest_completed(
            factory, "default", "default")
        engine = jax_persistence.resolve_class(factory).apply()
        ep = engine.params_from_variant(variant)
        algos, serving = engine.make_algorithms(ep), engine.make_serving(ep)
        models = jax_persistence.deserialize_models(
            jax_persistence.open_model_blob(storage.get_model_data_models().get(inst.id).models),
            inst.id, algos, [p for _, p in ep.algorithm_params_list], None)[0]
        jax_store.set_storage(storage)
        want = []
        for q in queries:
            query = serving.supplement(engine.query_cls(**q))
            want.append(dataclasses.asdict(
                serving.serve(query, [a.predict(m, query) for a, m in zip(algos, models)])))
    finally:
        jax_store.set_storage(None)
        JaxStorage.reset_instance()
        jax_sqlite.close_all_dbs()
    Storage.reset_instance()
    port = _free_port()
    try:
        t = threading.Thread(target=port_cli.main, args=([
            "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
            "--device", "cpu"] + (["--batching"] if template == "similarproduct" else []),),
            daemon=True)
        t.start()
        url = f"http://127.0.0.1:{port}"
        t_end = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(f"{url}/readyz", timeout=5).close()
                break
            except OSError:
                assert time.monotonic() < t_end and t.is_alive()
                time.sleep(0.05)
        with urllib.request.urlopen(f"{url}/", timeout=10) as r:
            assert json.loads(r.read())["engineInstanceId"] == inst.id
        for q, w in zip(queries, want):
            req = urllib.request.Request(f"{url}/queries.json", data=json.dumps(q).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())
            got.pop("degraded", None)
            assert got == _without_none(w), (q, got, w)
        assert port_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(30)
    finally:
        Storage.reset_instance()
        port_sqlite.close_all_dbs()
