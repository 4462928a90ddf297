"""The port's similar-product, e-commerce, similar-user and classification
templates against the JAX package's, on the same events.

Each package reads one MEMORY source holding the same seeded events
(views, buys, item categories, the ``unavailableItems`` constraint,
follows and user attributes) through its own DataSource, trains on the CPU
and answers the same queries.

* Implicit ALS (similar-product, e-commerce, similar-user) starts from the
  JAX package's initial draw (jax's threefry; the port's ``train_als`` takes
  it as ``init_factors``) on a one-device mesh with the ``reference``
  backend. Factors agree within rtol = atol = 1e-4, the port's implicit f32
  tolerance (``tests/test_torch_als_train.py``); answers computed from them
  agree by rule 4 (``topk_mismatches``) at the same 1e-4.
* Co-occurrence counts are integers: their answers are exact. LLR answers
  hold by ROADMAP §3's LLR rule (``llr_atol`` + 1e-5 relative).
* Naive Bayes parameters agree within 1e-6; the random forest's trees node
  for node; labels exactly; the evaluation's accuracy exactly.
* The e-commerce event cache: a new ``view`` posted for a user (with the
  event server's ``notify_event``) drops the item from that user's
  ``unseenOnly`` answer at once, in both packages.
"""

import dataclasses
import datetime as dt
import functools
import json
import time
import uuid

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving import result_cache as jax_result_cache
from predictionio_tpu.serving.event_cache import ServingEventCache as JaxServingEventCache
from predictionio_tpu.templates import classification as jax_cls
from predictionio_tpu.templates import ecommerce as jax_ecomm
from predictionio_tpu.templates import similarproduct as jax_sp
from predictionio_tpu.templates import similaruser as jax_su
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.core.evaluation import run_evaluation
from predictionio_tpu_torch.core.persistence import resolve_class
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.serving import result_cache
from predictionio_tpu_torch.serving.event_cache import ServingEventCache
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates import classification as cls_tmpl
from predictionio_tpu_torch.templates import ecommerce
from predictionio_tpu_torch.templates import similarproduct as sp
from predictionio_tpu_torch.templates import similaruser as su
from predictionio_tpu_torch.testing import llr_atol, topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = "TmplApp"
CPU = DeviceContext.create(device="cpu")
FACTOR_TOL = 1e-4
N_USERS, N_ITEMS, N_CLS = 60, 24, 120


def event_dicts(seed=0):
    """Views and buys in three taste groups, item categories, a constraint,
    follows in two communities and labeled user attributes."""
    rng = np.random.default_rng(seed)
    out, k = [], 0

    def add(**d):
        nonlocal k
        out.append(dict(event_time=T0 + dt.timedelta(minutes=k), **d))
        k += 1

    for u in range(N_USERS):
        group = [i for i in range(N_ITEMS) if i % 3 == u % 3]
        viewed = rng.choice(group, 5, replace=False)
        for i in viewed:
            add(event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}")
        add(event="view", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{rng.integers(N_ITEMS)}")
        for i in viewed[:2]:
            add(event="buy", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}")
        for v in rng.choice([x for x in range(N_USERS) if x % 2 == u % 2 and x != u], 4,
                            replace=False):
            add(event="follow", entity_type="user", entity_id=f"u{u}",
                target_entity_type="user", target_entity_id=f"u{v}")
    for i in range(N_ITEMS):
        add(event="$set", entity_type="item", entity_id=f"i{i}",
            properties={"categories": [f"g{i % 3}", "even" if i % 2 == 0 else "odd"],
                        "title": f"Item {i}"})
    add(event="$set", entity_type="constraint", entity_id="unavailableItems",
        properties={"items": ["i3", "i7"]})
    for c in range(N_CLS):
        a0, a1, a2 = (float(x) for x in rng.uniform(0, 10, 3))
        add(event="$set", entity_type="user", entity_id=f"c{c}",
            properties={"attr0": a0, "attr1": a1, "attr2": a2,
                        "plan": "premium" if a0 + a1 > 10 else "basic"})
    return out


@pytest.fixture()
def both(monkeypatch):
    """One MEMORY source per package with the same events; each package's
    ambient store points at its own. Implicit ALS in both starts from the
    JAX package's initial draw."""
    for k in ("PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE", "PIO_IVF_NLIST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_TRAIN_KERNEL", "reference")
    name = "T" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    events = event_dicts()
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, APP))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in events], app_id)
    for module in (sp, ecommerce, su):
        monkeypatch.setattr(module, "train_als", _with_jax_init(module.train_als))
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    yield port, ref
    port_store.set_storage(None)
    jax_store.set_storage(None)


def _with_jax_init(train_als):
    @functools.wraps(train_als)
    def wrapped(ctx, inter, cfg):
        ku, kv = jax.random.split(jax.random.PRNGKey(cfg.seed))
        scale = 1.0 / np.sqrt(cfg.rank)
        U0 = jax.random.normal(ku, (inter.n_users, cfg.rank), jnp.float32) * scale
        V0 = jax.random.normal(kv, (inter.n_items, cfg.rank), jnp.float32) * scale
        return train_als(ctx, inter, cfg, init_factors=(np.asarray(U0), np.asarray(V0)))
    return wrapped


@pytest.fixture(scope="module")
def jctx():
    return MeshContext.create(devices=jax.devices()[:1])


def train_both(port_engine, jax_engine, variant, jctx):
    ep, jep = port_engine.params_from_variant(variant), jax_engine.params_from_variant(variant)
    return (port_engine.train(CPU, ep), port_engine.make_algorithms(ep),
            port_engine.make_serving(ep), jax_engine.train(jctx, jep),
            jax_engine.make_algorithms(jep), jax_engine.make_serving(jep))


def answer(algos, serving, models, query):
    q = serving.supplement(query)
    return serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])


def same_answer(got, want, ids, tol, field="itemScores", key="item"):
    """Rule 4 over one answer: the same length, values within ``tol`` and
    ids equal except across near-equal scores."""
    g, w = getattr(got, field), getattr(want, field)
    assert len(g) == len(w), (g, w)
    if not w:
        return
    bad = topk_mismatches(
        np.array([[s.score for s in g]]), np.array([[ids[getattr(s, key)] for s in g]]),
        np.array([[s.score for s in w]]), np.array([[ids[getattr(s, key)] for s in w]]), tol)
    assert not bad, bad[:3]


def factors_close(port_als, jax_als):
    for a, b in ((port_als.user_factors, jax_als.user_factors),
                 (port_als.item_factors, jax_als.item_factors)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=FACTOR_TOL, atol=FACTOR_TOL)
    assert dict(port_als.item_map.items()) == dict(jax_als.item_map.items())


ITEM_IDS = {f"i{i}": i for i in range(N_ITEMS)}
SP_QUERIES = [
    dict(items=["i0"], num=4),
    dict(items=["i0", "i3"], num=6),
    dict(items=["i1"], num=5, categories=["odd"]),
    dict(items=["i2"], num=4, blackList=["i5", "i8"]),
    dict(items=["i4"], num=3, whiteList=["i1", "i7", "i10", "i13"]),
    dict(items=["zzz"], num=3),
]


class TestSimilarProduct:
    @pytest.mark.parametrize("llr", [False, True])
    def test_multi_algo_answers_match_jax(self, both, jctx, llr):
        variant = {
            "datasource": {"params": {"appName": APP}},
            "algorithms": [
                {"name": "als", "params": {"rank": 6, "numIterations": 5}},
                {"name": "cooccurrence", "params": {"n": 6, "llr": llr}},
            ],
        }
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            sp.SimilarProductEngine.apply(), jax_sp.SimilarProductEngine.apply(), variant, jctx)
        factors_close(models[0].als, jmodels[0].als)
        np.testing.assert_allclose(models[0].norm_factors, jmodels[0].norm_factors,
                                   rtol=FACTOR_TOL, atol=FACTOR_TOL)
        co, jco = models[1].cooccurrence, jmodels[1].cooccurrence
        if not llr:
            np.testing.assert_array_equal(co.top_items, jco.top_items)
            np.testing.assert_array_equal(co.top_scores, jco.top_scores)
        n_users = len(set(e["entity_id"] for e in event_dicts() if e["event"] == "view"))
        tol = FACTOR_TOL + (llr_atol(n_users) if llr else 0.0)
        for qd in SP_QUERIES:
            got = answer(algos, serving, models, sp.Query(**qd))
            want = answer(jalgos, jserving, jmodels, jax_sp.Query(**qd))
            same_answer(got, want, ITEM_IDS, tol)
        assert answer(algos, serving, models, sp.Query(items=["zzz"], num=3)).itemScores == []

    def test_als_batch_predict_is_one_matmul_and_matches(self, both, jctx):
        variant = {"datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "als", "params": {"rank": 6, "numIterations": 4}}]}
        models, algos, _, jmodels, jalgos, _ = train_both(
            sp.SimilarProductEngine.apply(), jax_sp.SimilarProductEngine.apply(), variant, jctx)
        queries = [(k, qd) for k, qd in enumerate(SP_QUERIES)]
        got = dict(algos[0].batch_predict(models[0], [(k, sp.Query(**qd)) for k, qd in queries]))
        want = dict(jalgos[0].batch_predict(
            jmodels[0], [(k, jax_sp.Query(**qd)) for k, qd in queries]))
        for k, qd in queries:
            single = algos[0].predict(models[0], sp.Query(**qd))
            assert [s.item for s in got[k].itemScores] == [s.item for s in single.itemScores]
            same_answer(got[k], want[k], ITEM_IDS, FACTOR_TOL)

    def test_return_properties(self, both, jctx):
        variant = {"datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "cooccurrence",
                                   "params": {"n": 4, "returnProperties": True}}]}
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            sp.SimilarProductEngine.apply(), jax_sp.SimilarProductEngine.apply(), variant, jctx)
        got = answer(algos, serving, models, sp.Query(items=["i0"], num=3))
        want = answer(jalgos, jserving, jmodels, jax_sp.Query(items=["i0"], num=3))
        assert [dataclasses.asdict(s) for s in got.itemScores] == \
            [dataclasses.asdict(s) for s in want.itemScores]
        assert got.itemScores and got.itemScores[0].properties["title"].startswith("Item ")


USER_IDS = {f"u{u}": u for u in range(N_USERS)}


class TestECommerce:
    VARIANT = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "ecomm", "params": {
                   "appName": APP, "rank": 6, "numIterations": 5, "unseenOnly": True}}]}

    def test_answers_match_jax(self, both, jctx):
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            ecommerce.ECommerceEngine.apply(), jax_ecomm.ECommerceEngine.apply(),
            self.VARIANT, jctx)
        factors_close(models[0].als, jmodels[0].als)
        np.testing.assert_array_equal(models[0].popular, jmodels[0].popular)
        queries = [
            dict(user="u0", num=5),
            dict(user="u1", num=4, categories=["g1", "even"]),
            dict(user="u2", num=3, whiteList=["i0", "i2", "i5", "i8", "i11"]),
            dict(user="u4", num=6, blackList=["i1", "i4"]),
            dict(user="nobody", num=5),  # unknown user: popular fallback
        ]
        for qd in queries:
            got = answer(algos, serving, models, ecommerce.Query(**qd))
            want = answer(jalgos, jserving, jmodels, jax_ecomm.Query(**qd))
            same_answer(got, want, ITEM_IDS, FACTOR_TOL)
            got_items = {s.item for s in got.itemScores}
            assert not got_items & {"i3", "i7"}  # unavailableItems
        popular = answer(algos, serving, models, ecommerce.Query(user="nobody", num=3))
        assert [s.score for s in popular.itemScores] == sorted(models[0].popular, reverse=True)[:3]

    def test_new_view_invalidates_the_unseen_cache(self, both, jctx):
        port, ref = both
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            ecommerce.ECommerceEngine.apply(), jax_ecomm.ECommerceEngine.apply(),
            self.VARIANT, jctx)
        before = answer(algos, serving, models, ecommerce.Query(user="u5", num=4))
        jbefore = answer(jalgos, jserving, jmodels, jax_ecomm.Query(user="u5", num=4))
        same_answer(before, jbefore, ITEM_IDS, FACTOR_TOL)
        top = before.itemScores[0].item
        stats = algos[0]._event_cache.stats_dict()
        for s, ev_mod, notify in ((port, port_event, result_cache.notify_event),
                                  (ref, jax_event, jax_result_cache.notify_event)):
            e = ev_mod.Event(event="view", entity_type="user", entity_id="u5",
                             target_entity_type="item", target_entity_id=top,
                             event_time=T0 + dt.timedelta(days=1))
            s.get_l_events().insert(e, s.get_meta_data_apps().get_by_name(APP).id)
            notify(e)
        after = answer(algos, serving, models, ecommerce.Query(user="u5", num=4))
        jafter = answer(jalgos, jserving, jmodels, jax_ecomm.Query(user="u5", num=4))
        assert top not in {s.item for s in after.itemScores}
        same_answer(after, jafter, ITEM_IDS, FACTOR_TOL)
        now = algos[0]._event_cache.stats_dict()
        assert now["invalidated"] > stats["invalidated"]
        algos[0]._event_cache.close()
        jalgos[0]._event_cache.close()

    def test_unavailable_items_constraint_moves_with_set(self, both, jctx):
        port, ref = both
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            ecommerce.ECommerceEngine.apply(), jax_ecomm.ECommerceEngine.apply(),
            self.VARIANT, jctx)
        first = answer(algos, serving, models, ecommerce.Query(user="u6", num=3))
        banned = [s.item for s in first.itemScores[:2]]
        for s, ev_mod, notify in ((port, port_event, result_cache.notify_event),
                                  (ref, jax_event, jax_result_cache.notify_event)):
            e = ev_mod.Event(event="$set", entity_type="constraint",
                             entity_id="unavailableItems", properties={"items": banned},
                             event_time=T0 + dt.timedelta(days=2))
            s.get_l_events().insert(e, s.get_meta_data_apps().get_by_name(APP).id)
            notify(e)
        got = answer(algos, serving, models, ecommerce.Query(user="u6", num=3))
        want = answer(jalgos, jserving, jmodels, jax_ecomm.Query(user="u6", num=3))
        assert not {s.item for s in got.itemScores} & set(banned)
        same_answer(got, want, ITEM_IDS, FACTOR_TOL)
        algos[0]._event_cache.close()
        jalgos[0]._event_cache.close()

    def test_boost_and_weighted_items(self, both, jctx):
        variant = {"datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "ecomm", "params": {
                       "appName": APP, "rank": 6, "numIterations": 4,
                       "boostCategories": {"g2": 3.0},
                       "weightedItems": [{"items": ["i9", "i10"], "weight": 5.0}],
                       "cacheRefreshSeconds": 0}}]}
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            ecommerce.ECommerceEngine.apply(), jax_ecomm.ECommerceEngine.apply(), variant, jctx)
        for user in ("u0", "u1", "nobody"):
            got = answer(algos, serving, models, ecommerce.Query(user=user, num=6))
            want = answer(jalgos, jserving, jmodels, jax_ecomm.Query(user=user, num=6))
            same_answer(got, want, ITEM_IDS, 5 * 3 * FACTOR_TOL)

    def test_rate_event_training(self, both, jctx):
        variant = {"datasource": {"params": {"appName": APP, "eventNames": ["buy"]}},
                   "algorithms": [{"name": "ecomm", "params": {
                       "appName": APP, "rank": 4, "numIterations": 3, "cacheRefreshSeconds": 0}}]}
        models, _, _, jmodels, _, _ = train_both(
            ecommerce.ECommerceEngine.apply(), jax_ecomm.ECommerceEngine.apply(), variant, jctx)
        factors_close(models[0].als, jmodels[0].als)

    def test_sharded_interactions_raise_naming_item_10(self, both):
        # a launch's ShardedInteractions train (the popular count through
        # host_sum); one host's equals the plain rows' model bit for bit
        from predictionio_tpu_torch.parallel.ingest import ShardedInteractions

        inter = port_store.PEventStore.find_interactions(
            APP, entity_type="user", event_names=["view", "buy"], target_entity_type="item")
        sh = ShardedInteractions(
            user_rows=inter, item_rows=inter, user_map=inter.user_map, item_map=inter.item_map,
            user_counts=np.bincount(inter.user, minlength=inter.n_users),
            item_counts=np.bincount(inter.item, minlength=inter.n_items),
            process_index=0, num_processes=1)
        algo = ecommerce.ECommAlgorithm(ecommerce.ECommAlgorithmParams(rank=3, numIterations=2))
        a = algo.train(CPU, ecommerce.TrainingData(interactions=inter, item_categories={}))
        b = algo.train(CPU, ecommerce.TrainingData(interactions=sh, item_categories={}))
        assert a.popular.tobytes() == b.popular.tobytes()
        assert a.als.user_factors.tobytes() == b.als.user_factors.tobytes()
        assert a.als.item_factors.tobytes() == b.als.item_factors.tobytes()


class TestSimilarUser:
    def test_answers_match_jax(self, both, jctx):
        variant = {"datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "als", "params": {"rank": 6, "numIterations": 5}}]}
        models, algos, serving, jmodels, jalgos, jserving = train_both(
            su.SimilarUserEngine.apply(), jax_su.SimilarUserEngine.apply(), variant, jctx)
        factors_close(models[0].als, jmodels[0].als)
        queries = [dict(users=["u0"], num=5), dict(users=["u1", "u3"], num=4),
                   dict(users=["u2"], num=4, blackList=["u4", "u6"]),
                   dict(users=["u0"], num=3, whiteList=["u2", "u8", "u9", "u11"]),
                   dict(users=["nobody"], num=3)]
        for qd in queries:
            got = answer(algos, serving, models, su.Query(**qd))
            want = answer(jalgos, jserving, jmodels, jax_su.Query(**qd))
            same_answer(got, want, USER_IDS, FACTOR_TOL, "similarUserScores", "user")
            assert all(s.user not in qd["users"] and s.score > 0
                       for s in got.similarUserScores)


class TestClassification:
    VARIANT = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "naive", "params": {"lambda": 1.0}},
                              {"name": "randomforest",
                               "params": {"numTrees": 8, "maxDepth": 4, "seed": 3}}]}

    def test_models_and_labels_match_jax(self, both, jctx):
        models, algos, _, jmodels, jalgos, _ = train_both(
            cls_tmpl.ClassificationEngine.apply(), jax_cls.ClassificationEngine.apply(),
            self.VARIANT, jctx)
        nb, jnb = models[0], jmodels[0]
        np.testing.assert_allclose(nb.log_theta, jnb.log_theta, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(nb.log_prior, jnb.log_prior, rtol=1e-6, atol=1e-6)
        rf, jrf = models[1], jmodels[1]
        for name in ("split_feature", "split_bin", "leaf_class", "bin_edges"):
            np.testing.assert_array_equal(getattr(rf, name), getattr(jrf, name))
        rng = np.random.default_rng(9)
        for feats in rng.uniform(0, 10, (40, 3)).tolist():
            for algo, model, jalgo, jmodel in zip(algos, models, jalgos, jmodels):
                assert algo.predict(model, cls_tmpl.Query(features=feats)).label == \
                    jalgo.predict(jmodel, jax_cls.Query(features=feats)).label
        assert algos[0].predict(nb, cls_tmpl.Query(features=[9.0, 9.0, 5.0])).label == "premium"
        assert algos[1].predict(rf, cls_tmpl.Query(features=[1.0, 1.0, 5.0])).label == "basic"

    def test_evaluation_accuracy_matches_jax(self, both, jctx):
        port, ref = both
        eng, jeng = cls_tmpl.ClassificationEngine.apply(), jax_cls.ClassificationEngine.apply()
        variant = {"datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "naive"}]}
        acc = cls_tmpl.Accuracy().calculate(CPU, eng.eval(CPU, eng.params_from_variant(variant)))
        jacc = jax_cls.Accuracy().calculate(
            jctx, jeng.eval(jctx, jeng.params_from_variant(variant)))
        assert acc == jacc and acc > 0.6

        class AppEval(cls_tmpl.ClassificationEvaluation):
            def __init__(self):
                super().__init__(app_name=APP, smoothing_grid=(0.5, 2.0))

        cls_tmpl.AppEval = AppEval
        try:
            result = run_evaluation(
                "predictionio_tpu_torch.templates.classification.AppEval",
                storage=port, ctx=CPU)
        finally:
            del cls_tmpl.AppEval
        assert 0.6 < result.best_score <= 1.0
        inst = port.get_meta_data_evaluation_instances().get(result.instance_id)
        assert inst.status == "EVALCOMPLETED"


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class TestServingEventCache:
    """``tests/test_event_cache.py``'s cases on the port's cache."""

    def test_miss_loads_then_hits_serve_from_memory(self):
        cache = ServingEventCache(refresh_interval=5.0, clock=FakeClock())
        calls = []
        loader = lambda: calls.append(1) or {"a"}  # noqa: E731
        assert [cache.get("k", loader) for _ in range(3)] == [{"a"}] * 3
        assert len(calls) == 1
        assert cache.stats.hits == 2 and cache.stats.misses == 1

    def test_stale_hit_returns_old_value_and_refreshes_async(self):
        clock = FakeClock()
        cache = ServingEventCache(refresh_interval=5.0, clock=clock)
        state = {"value": {"old"}}
        cache.get("k", lambda: state["value"])
        state["value"] = {"new"}
        clock.now += 10
        assert cache.get("k", lambda: state["value"]) == {"old"}
        cache.wait_refreshes()
        assert cache.get("k", lambda: state["value"]) == {"new"}
        assert cache.stats.refreshes == 1
        cache.close()

    def test_failed_refresh_keeps_stale_value(self):
        clock = FakeClock()
        cache = ServingEventCache(refresh_interval=1.0, clock=clock)

        def boom():
            raise RuntimeError("storage down")

        cache.get("k", lambda: {"v1"})
        clock.now += 5
        assert cache.get("k", boom) == {"v1"}
        cache.wait_refreshes()
        assert cache.get("k", boom) == {"v1"}
        cache.close()

    def test_eviction_bounds_entries(self):
        clock = FakeClock()
        cache = ServingEventCache(refresh_interval=60, max_entries=3, clock=clock)
        for i in range(5):
            clock.now += 1
            cache.get(f"k{i}", lambda i=i: i)
        assert len(cache) == 3 and cache.stats.evictions == 2
        assert cache.get("k4", lambda: "reload") == 4

    def test_token_change_reloads_synchronously(self):
        cache = ServingEventCache(refresh_interval=60, clock=FakeClock())
        assert cache.get("k", lambda: 1, token=(1,)) == 1
        assert cache.get("k", lambda: 2, token=(1,)) == 1
        assert cache.get("k", lambda: 3, token=(2,)) == 3
        assert cache.stats_dict()["invalidated"] == 1

    def test_refresh_deduplicates_inflight(self):
        clock = FakeClock()
        cache = ServingEventCache(refresh_interval=1.0, clock=clock)
        loads = []

        def slow_load():
            loads.append(1)
            time.sleep(0.05)
            return len(loads)

        cache.get("k", slow_load)
        clock.now += 5
        for _ in range(10):
            cache.get("k", slow_load)
        cache.wait_refreshes()
        assert len(loads) == 2
        cache.close()

    def test_stats_match_the_jax_cache(self):
        caches = (ServingEventCache(refresh_interval=5.0, max_entries=2, clock=FakeClock()),
                  JaxServingEventCache(refresh_interval=5.0, max_entries=2, clock=FakeClock()))
        for cache in caches:
            for key in ("a", "b", "a", "c", "a"):
                cache.get(key, lambda key=key: key.upper(), token=(key,))
        assert caches[0].stats_dict() == caches[1].stats_dict()


class TestECommerceServingCache:
    VARIANT = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "ecomm", "params": {
                   "appName": APP, "rank": 4, "numIterations": 3, "unseenOnly": True,
                   "cacheRefreshSeconds": 5}}]}

    def make(self, clock):
        engine = ecommerce.ECommerceEngine.apply()
        ep = engine.params_from_variant(self.VARIANT)
        model = engine.train(CPU, ep)[0]
        algo = engine.make_algorithms(ep)[0]
        algo._event_cache = ServingEventCache(refresh_interval=5.0, clock=clock)
        return algo, model

    def test_steady_state_makes_zero_storage_reads(self, both, monkeypatch):
        algo, model = self.make(FakeClock())
        reads = []
        orig = port_store.LEventStore.find_by_entity

        def counting(*args, **kwargs):
            reads.append(1)
            return orig(*args, **kwargs)

        monkeypatch.setattr(port_store.LEventStore, "find_by_entity", staticmethod(counting))
        algo.predict(model, ecommerce.Query(user="u0", num=3))
        warm = len(reads)
        assert warm >= 1
        for _ in range(20):
            algo.predict(model, ecommerce.Query(user="u0", num=3))
        assert len(reads) == warm

    def test_new_events_appear_after_refresh(self, both):
        port, _ = both
        clock = FakeClock()
        algo, model = self.make(clock)
        top = algo.predict(model, ecommerce.Query(user="u0", num=3)).itemScores[0].item
        port.get_l_events().insert(
            port_event.Event(event="view", entity_type="user", entity_id="u0",
                             target_entity_type="item", target_entity_id=top,
                             event_time=T0 + dt.timedelta(days=3)),
            port.get_meta_data_apps().get_by_name(APP).id)
        # no notify_event: the cached seen-set is served until the TTL lapses
        assert algo.predict(model, ecommerce.Query(user="u0", num=3)).itemScores[0].item == top
        clock.now += 10
        algo.predict(model, ecommerce.Query(user="u0", num=3))
        algo._event_cache.wait_refreshes()
        res = algo.predict(model, ecommerce.Query(user="u0", num=3))
        assert top not in {s.item for s in res.itemScores}
        algo._event_cache.close()

    def test_query_server_exposes_the_cache_on_metrics(self, both):
        port, _ = both
        name = "M" + uuid.uuid4().hex[:8].upper()
        meta = Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
                            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
                            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name})
        engine = ecommerce.ECommerceEngine.apply()
        factory = "predictionio_tpu_torch.templates.ecommerce.ECommerceEngine"
        run_train(engine, engine.params_from_variant(self.VARIANT), factory,
                  storage=meta, ctx=CPU)
        qs = QueryServer(engine, storage=meta, ctx=CPU)
        try:
            assert "pio_event_cache_" not in qs.telemetry.registry.render_prometheus()
            for _ in range(3):
                out = qs.handle_query({"user": "u1", "num": 4})
                assert len(out["itemScores"]) == 4
            text = qs.telemetry.registry.render_prometheus()
            assert 'pio_event_cache_lookups_total{outcome="hit"} 4' in text
            assert "pio_event_cache_entries 2" in text
        finally:
            qs.stop()


def test_cli_lists_and_gets_every_template(tmp_path, capsys):
    assert port_cli.main(["template", "list"]) == 0
    listed = capsys.readouterr().out.split()
    names = ("recommendation", "classification", "similarproduct", "similaruser",
             "ecommercerecommendation", "sequentialrecommendation", "universalrecommender")
    assert set(names) <= set(listed) and len(port_cli.BUILTIN_TEMPLATES) == 7
    for name in names:
        d = tmp_path / name
        assert port_cli.main(["template", "get", name, "--directory", str(d)]) == 0
        variant = json.loads((d / "engine.json").read_text())
        assert variant["engineFactory"] == port_cli.BUILTIN_TEMPLATES[name]
        assert resolve_class(variant["engineFactory"]).apply() is not None
        jax_factory = jax_cli.BUILTIN_TEMPLATES[name]
        assert resolve_class(jax_factory) is resolve_class(variant["engineFactory"])
