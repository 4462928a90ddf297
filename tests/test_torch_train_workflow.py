"""The training slice whole: events → ``run_train`` → COMPLETED instance →
``QueryServer(batching=True)`` → ``/queries.json``, on the CPU.

Rate and buy events go into a MEMORY event source. The port trains through
its normal entry points (``run_train(RecommendationEngine.apply(), …)`` →
``RecommendationDataSource`` → ``ExcludeItemsPreparator`` →
``ALSAlgorithm.train`` → ``train_als``), persists a COMPLETED instance and
serves it. The JAX package reads the same events through its own
DataSource and trains them (dense solver, ``reference`` backend, a
one-device mesh). Both start from the same initial factors: the JAX
trainer's threefry draw, which the test hands to the port's ``train_als``.

Tolerance: answers by ``topk_mismatches`` with tol 1e-4, the trained
factors' own tolerance (``tests/test_torch_als_train.py``).

``ALSConfig`` reads ``PIO_ALS_COMPUTE_DTYPE`` and ``PIO_ALS_SOLVER`` for the
fields left at None, as the JAX package's does, so an engine trained with
``run_train`` under ``PIO_ALS_COMPUTE_DTYPE=bf16`` trains in bf16: its
factors must EQUAL those of ``train_als`` with ``compute_dtype="bf16"``.
Under ``PIO_ALS_SOLVER=segment`` it trains with the segment solver: its
factors must EQUAL those of ``train_als`` with ``solver="segment"``, and it
serves the answers of the JAX engine trained with the segment solver.
"""

import functools
import json
import urllib.request
import uuid

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import workflow
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage import memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.testing import topk_mismatches

APP = "FlowApp"
FACTORY = "predictionio_tpu_torch.templates.recommendation.RecommendationEngine"
RANK, ITERS, SEED = 6, 4, 5
CPU = DeviceContext.create(device="cpu")


def _events(n_users=50, n_items=35, n=1500, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u = f"u{int(rng.integers(n_users) if k % 3 else rng.integers(10))}"
        i = f"i{int(rng.integers(n_items) if k % 4 else rng.integers(6))}"
        if k % 5 == 0:
            out.append(dict(event="buy", entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            event_time=1_767_225_600 + k))
        else:
            out.append(dict(event="rate", entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties={"rating": float(rng.integers(1, 6))},
                            event_time=1_767_225_600 + k))
    return out


@pytest.fixture()
def stores():
    name = "W" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    evs = _events()
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, APP))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in evs], app_id)
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    yield port, ref
    port_store.set_storage(None)
    jax_store.set_storage(None)
    memory.reset_store(name)
    jax_memory.reset_store(name)


def _variant(**algo):
    return {
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERS, "lambda": 0.05, "seed": SEED, **algo}}],
    }


def _jax_trained(variant, solver="dense"):
    """The JAX package's read → prepare → train on a one-device mesh, and
    the initial factors its trainer drew (original order)."""
    engine = jax_rec.RecommendationEngine.apply()
    params = engine.params_from_variant(variant)
    pd = engine.prepare_data(None, params)
    ap = params.algorithm_params_list[0][1]
    cfg = jax_als.ALSConfig(
        rank=ap.rank, iterations=ap.numIterations, reg=ap.reg,
        implicit=ap.implicitPrefs, alpha=ap.alpha, seed=ap.seed,
        solver=solver, train_kernel="reference",
    )
    inter = pd.interactions
    model = jax_als.train_als(MeshContext.create(devices=jax.devices()[:1]), inter, cfg)
    ku, kv = jax.random.split(jax.random.PRNGKey(ap.seed))
    scale = 1.0 / np.sqrt(ap.rank)
    init = (
        np.asarray(jax.random.normal(ku, (inter.n_users, ap.rank), jnp.float32) * scale),
        np.asarray(jax.random.normal(kv, (inter.n_items, ap.rank), jnp.float32) * scale),
    )
    return model, init


def _post(base_url, q):
    req = urllib.request.Request(
        f"{base_url}/queries.json", data=json.dumps(q).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("implicit", (False, True))
def test_events_to_served_answers_match_jax(stores, monkeypatch, implicit):
    port_storage, _ = stores
    variant = _variant(implicitPrefs=implicit)
    jax_model, init = _jax_trained(variant)
    # the one seam: the port trains from the JAX trainer's initial draw
    monkeypatch.setattr(rec, "train_als", functools.partial(rec.train_als, init_factors=init))
    engine = rec.RecommendationEngine.apply()
    iid = workflow.run_train(
        engine, engine.params_from_variant(variant), FACTORY,
        storage=port_storage, ctx=CPU,
    )
    inst = port_storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED" and inst.engine_factory == FACTORY
    assert workflow.get_latest_completed_instance(port_storage).id == iid

    _assert_served_like_jax(port_storage, engine, jax_model)


def _assert_served_like_jax(port_storage, engine, jax_model):
    """Deploy the latest COMPLETED instance with ``QueryServer(batching=True)``
    and hold every user's answer against the JAX engine's predict."""
    qs = QueryServer(engine, storage=port_storage, ctx=CPU, batching=True)
    try:
        base_url = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        users = [jax_model.user_map.inverse[k] for k in range(len(jax_model.user_map))]
        ref_algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=RANK))
        ref_algo.load_serializable_model(MeshContext.create(devices=jax.devices()[:1]), jax_model)
        inv = {it: k for k, it in enumerate(sorted(jax_model.item_map.keys()))}
        for u in users:
            got = _post(base_url, {"user": u, "num": 8})["itemScores"]
            ref = ref_algo.predict(jax_model, jax_rec.Query(user=u, num=8)).itemScores
            bad = topk_mismatches(
                np.array([[x["score"] for x in got]]), np.array([[inv[x["item"]] for x in got]]),
                np.array([[x.score for x in ref]]), np.array([[inv[x.item] for x in ref]]),
                tol=1e-4,
            )
            assert not bad, (u, bad[:3])
        assert _post(base_url, {"user": "nobody", "num": 3}) == {"itemScores": []}
    finally:
        qs.stop()


def test_preparator_filepath_and_retrain_mode(stores, tmp_path):
    """A preparator file drops items from the trained model; persistMode
    "retrain" stores a RETRAIN slot that deploy retrains from the events."""
    port_storage, _ = stores
    path = tmp_path / "drop.txt"
    path.write_text("i0\ni1\n")
    engine = rec.RecommendationEngine.apply()
    variant = {**_variant(persistMode="retrain"), "preparator": {"params": {"filepath": str(path)}}}
    iid = workflow.run_train(engine, engine.params_from_variant(variant), FACTORY,
                             storage=port_storage, ctx=CPU)
    inst = workflow.get_latest_completed_instance(port_storage)
    assert inst.id == iid
    _, _, _, models = workflow.prepare_deploy(engine, inst, storage=port_storage, ctx=CPU)
    model = models[0]
    assert "i0" not in model.item_map and "i1" not in model.item_map
    assert model.item_factors.shape == (len(model.item_map), RANK)


def test_failed_train_marks_instance_aborted(stores):
    port_storage, _ = stores
    engine = rec.RecommendationEngine.apply()
    for variant, err in (
        (_variant(persistMode="bogus"), ValueError),
        (_variant(rank=65), ValueError),
        ({"datasource": {"params": {"appName": "missing"}}}, ValueError),
    ):
        with pytest.raises(err):
            workflow.run_train(engine, engine.params_from_variant(variant), FACTORY,
                               storage=port_storage, ctx=CPU)
    statuses = sorted(i.status for i in port_storage.get_meta_data_engine_instances().get_all())
    assert statuses == ["ABORTED"] * 3


def test_stop_after_read_and_cleanup_hooks(stores):
    port_storage, _ = stores
    engine = rec.RecommendationEngine.apply()
    ran = []
    workflow.CleanupFunctions.add(lambda: ran.append(1))
    try:
        from predictionio_tpu_torch.core.engine import StopAfterReadInterruption

        with pytest.raises(StopAfterReadInterruption):
            workflow.run_train(
                engine, engine.params_from_variant(_variant()), FACTORY,
                storage=port_storage, ctx=CPU,
                workflow_params=workflow.WorkflowParams(stop_after_read=True),
            )
    finally:
        workflow.CleanupFunctions.clear()
    assert ran == [1]
    assert workflow.resolve_engine(FACTORY).algorithm_cls_map == engine.algorithm_cls_map


ENV_KEYS = ("PIO_ALS_COMPUTE_DTYPE", "PIO_ALS_SOLVER")


@pytest.mark.parametrize("env, want", [
    ({}, ("f32", "dense")),
    ({"PIO_ALS_COMPUTE_DTYPE": "bf16"}, ("bf16", "dense")),
    ({"PIO_ALS_COMPUTE_DTYPE": "int8", "PIO_ALS_SOLVER": "dense"}, ("int8", "dense")),
    ({"PIO_ALS_SOLVER": "segment"}, ("f32", "segment")),
])
def test_als_config_reads_the_environment_as_jax_does(monkeypatch, env, want):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port, ref = als.ALSConfig(), jax_als.ALSConfig()
    assert (port.compute_dtype, port.solver) == (ref.compute_dtype, ref.solver) == want
    # a field that is set wins over the environment, in both packages
    port, ref = als.ALSConfig(compute_dtype="f32"), jax_als.ALSConfig(compute_dtype="f32")
    assert port.compute_dtype == ref.compute_dtype == "f32"


def test_als_config_refusals_follow_the_environment(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    # the segment solver is ported: the environment picks it in both packages
    monkeypatch.setenv("PIO_ALS_SOLVER", "segment")
    assert jax_als.ALSConfig().solver == als.ALSConfig().solver == "segment"
    monkeypatch.delenv("PIO_ALS_SOLVER")
    assert als.ALSConfig(solver="segment").solver == "segment"
    monkeypatch.setenv("PIO_ALS_SOLVER", "sparse")
    for cls in (als.ALSConfig, jax_als.ALSConfig):
        with pytest.raises(ValueError):
            cls()
    monkeypatch.delenv("PIO_ALS_SOLVER")
    monkeypatch.setenv("PIO_ALS_COMPUTE_DTYPE", "fp8")
    for cls in (als.ALSConfig, jax_als.ALSConfig):
        with pytest.raises(ValueError):
            cls()


def test_run_train_under_bf16_environment_trains_bf16(stores, monkeypatch):
    port_storage, _ = stores
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    engine = rec.RecommendationEngine.apply()
    params = engine.params_from_variant(_variant())
    monkeypatch.setenv("PIO_ALS_COMPUTE_DTYPE", "bf16")
    iid = workflow.run_train(engine, params, FACTORY, storage=port_storage, ctx=CPU)
    inst = port_storage.get_meta_data_engine_instances().get(iid)
    _, _, _, models = workflow.prepare_deploy(engine, inst, storage=port_storage, ctx=CPU)
    monkeypatch.delenv("PIO_ALS_COMPUTE_DTYPE")
    got = models[0]
    assert got.config.compute_dtype == "bf16"
    inter = engine.prepare_data(CPU, params).interactions
    want = als.train_als(CPU, inter, als.ALSConfig(
        rank=RANK, iterations=ITERS, reg=0.05, seed=SEED, compute_dtype="bf16"))
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)
    f32 = als.train_als(CPU, inter, als.ALSConfig(
        rank=RANK, iterations=ITERS, reg=0.05, seed=SEED))
    assert not np.array_equal(got.item_factors, f32.item_factors)


def test_run_train_under_segment_environment_trains_segment(stores, monkeypatch):
    """``PIO_ALS_SOLVER=segment`` reaches the engine's ``ALSConfig``: the
    stored model is the segment solver's ``train_als`` exactly, and it serves
    the JAX engine's answers (segment solver, reference backend) by the
    1e-4 rule."""
    port_storage, _ = stores
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    variant = _variant()
    jax_model, init = _jax_trained(variant, solver="segment")
    monkeypatch.setattr(rec, "train_als", functools.partial(rec.train_als, init_factors=init))
    engine = rec.RecommendationEngine.apply()
    params = engine.params_from_variant(variant)
    monkeypatch.setenv("PIO_ALS_SOLVER", "segment")
    iid = workflow.run_train(engine, params, FACTORY, storage=port_storage, ctx=CPU)
    monkeypatch.delenv("PIO_ALS_SOLVER")
    inst = port_storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    _, _, _, models = workflow.prepare_deploy(engine, inst, storage=port_storage, ctx=CPU)
    got = models[0]
    assert got.config.solver == "segment"
    inter = engine.prepare_data(CPU, params).interactions
    want = als.train_als(CPU, inter, als.ALSConfig(
        rank=RANK, iterations=ITERS, reg=0.05, seed=SEED, solver="segment"), init_factors=init)
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)
    _assert_served_like_jax(port_storage, engine, jax_model)
