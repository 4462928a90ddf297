"""The port's Universal Recommender template against the JAX package's, on
the same events (``templates/universal.py``).

Both packages read one MEMORY source each, holding the same seeded ``buy``
and ``view`` events, through their own ``URDataSource`` (one scan, split
with ``EventBatch.filter_events``), train on the CPU and answer the same
queries from the users' live histories.

* Indicator lists follow ROADMAP §3's LLR rule against the float64 LLR of
  the exact counts (``testing.llr_topk_mismatches``), in the dense path and
  in the column-blocked path (``DENSE_ITEM_LIMIT`` monkeypatched to 1).
* A query's answer sums one LLR value per event of the user's history, so
  answers are held by rule 4 (``topk_mismatches``) at that many times the
  LLR tolerance.
* Only bought items are excluded, the blacklist holds, an unknown user gets
  nothing, and a run without primary events is refused; the multi-host
  read and trainer raise naming ROADMAP item 10.
"""

import datetime as dt
import uuid

import numpy as np
import pytest

import jax

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import universal as jax_ur
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.cooccurrence import (
    cross_occurrence_matrix,
    distinct_item_counts,
)
from predictionio_tpu_torch.templates import universal as ur
from predictionio_tpu_torch.testing import (
    llr_atol,
    llr_reference64,
    llr_topk_mismatches,
    topk_mismatches,
)

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = "URApp"
CPU = DeviceContext.create(device="cpu")
N_USERS, N_ITEMS = 90, 30


def event_dicts(seed=4):
    """Two taste groups: views are dense, buys sparse; a few cross views."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for u in range(N_USERS):
        group = list(range(0, 15)) if u % 2 == 0 else list(range(15, 30))
        evs = [("view", i) for i in rng.choice(group, 4, replace=False)]
        evs += [("view", int(rng.integers(N_ITEMS)))]
        evs += [("buy", group[u % len(group)]), ("buy", int(rng.choice(group)))]
        for name, i in evs:
            out.append(dict(event=name, entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{i}",
                            event_time=T0 + dt.timedelta(minutes=k)))
            k += 1
    return out


@pytest.fixture()
def both():
    name = "U" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    events = event_dicts()
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, APP))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in events], app_id)
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    yield port, ref
    port_store.set_storage(None)
    jax_store.set_storage(None)


@pytest.fixture(scope="module")
def jctx():
    return MeshContext.create(devices=jax.devices()[:1])


def variant(k=6, names=("buy", "view")):
    return {"datasource": {"params": {"appName": APP, "eventNames": list(names)}},
            "algorithms": [{"name": "ur", "params": {"appName": APP,
                                                     "maxCorrelatorsPerItem": k}}]}


def train(engine, ctx, v):
    ep = engine.params_from_variant(v)
    return engine.train(ctx, ep)[0], engine.make_algorithms(ep)[0]


def test_data_source_matches_jax(both):
    td = ur.URDataSource(ur.URDataSourceParams(appName=APP)).read_training(CPU)
    jtd = jax_ur.URDataSource(jax_ur.URDataSourceParams(appName=APP)).read_training(None)
    assert dict(td.user_map.items()) == dict(jtd.user_map.items())
    assert dict(td.item_map.items()) == dict(jtd.item_map.items())
    for name in ("buy", "view"):
        for col in ("user", "item", "rating", "t"):
            np.testing.assert_array_equal(getattr(td.per_event[name], col),
                                          getattr(jtd.per_event[name], col))


@pytest.mark.parametrize("blocked", [False, True])
def test_indicators_follow_the_llr_rule(both, jctx, monkeypatch, blocked):
    if blocked:
        monkeypatch.setattr(ur.URAlgorithm, "DENSE_ITEM_LIMIT", 1)
        monkeypatch.setattr(jax_ur.URAlgorithm, "DENSE_ITEM_LIMIT", 1)
    model, _ = train(ur.UniversalRecommenderEngine.apply(), CPU, variant())
    jmodel, _ = train(jax_ur.UniversalRecommenderEngine.apply(), jctx, variant())
    td = ur.URDataSource(ur.URDataSourceParams(appName=APP)).read_training(CPU)
    primary = td.per_event["buy"]
    n_users = len(td.user_map)
    pc = distinct_item_counts(primary, N_ITEMS)
    assert set(model.indicators) == set(jmodel.indicators) == {"buy", "view"}
    for name, inter in td.per_event.items():
        C = cross_occurrence_matrix(CPU, primary, inter, N_ITEMS, N_ITEMS).numpy()
        ref = llr_reference64(C, pc, distinct_item_counts(inter, N_ITEMS), n_users)
        if name == "buy":
            # the dense path zeroes the diagonal (an item can then list
            # itself among the zero ties); the blocked path masks it to -1
            np.fill_diagonal(ref, -1.0 if blocked else 0.0)
        for idx, vals in (model.indicators[name], jmodel.indicators[name]):
            bad = [m for j in range(N_ITEMS)
                   for m in llr_topk_mismatches(idx[j], vals[j], ref[:, j], llr_atol(n_users))]
            assert not bad, bad[:3]
        idx, vals = model.indicators[name]
        if name == "buy":  # no item lists itself with a positive score
            assert not np.any((idx == np.arange(N_ITEMS)[:, None]) & (vals > 0))


@pytest.mark.parametrize("blocked", [False, True])
def test_answers_match_jax(both, jctx, monkeypatch, blocked):
    if blocked:
        monkeypatch.setattr(ur.URAlgorithm, "DENSE_ITEM_LIMIT", 1)
        monkeypatch.setattr(jax_ur.URAlgorithm, "DENSE_ITEM_LIMIT", 1)
    model, algo = train(ur.UniversalRecommenderEngine.apply(), CPU, variant())
    jmodel, jalgo = train(jax_ur.UniversalRecommenderEngine.apply(), jctx, variant())
    ids = {f"i{i}": i for i in range(N_ITEMS)}
    for u in range(0, N_USERS, 7):
        tol = sum(e["entity_id"] == f"u{u}" for e in event_dicts()) * llr_atol(N_USERS)
        for extra in ({}, {"blackList": ["i3", "i20"]}):
            got = algo.predict(model, ur.Query(user=f"u{u}", num=5, **extra))
            want = jalgo.predict(jmodel, jax_ur.Query(user=f"u{u}", num=5, **extra))
            assert len(got.itemScores) == len(want.itemScores)
            assert got.itemScores
            bad = topk_mismatches(
                np.array([[s.score for s in got.itemScores]]),
                np.array([[ids[s.item] for s in got.itemScores]]),
                np.array([[s.score for s in want.itemScores]]),
                np.array([[ids[s.item] for s in want.itemScores]]), tol)
            assert not bad, bad[:3]
            items = {s.item for s in got.itemScores}
            bought = {e["target_entity_id"] for e in event_dicts()
                      if e["entity_id"] == f"u{u}" and e["event"] == "buy"}
            assert not items & bought
            assert not items & set(extra.get("blackList", ()))
    assert algo.predict(model, ur.Query(user="ghost", num=3)).itemScores == []


def test_missing_primary_rejected(both):
    engine = ur.UniversalRecommenderEngine.apply()
    with pytest.raises(ValueError, match="primary"):
        engine.train(CPU, engine.params_from_variant(variant(names=("purchase",))))


def test_multi_host_paths_raise_naming_item_10(both):
    ds = ur.URDataSource(ur.URDataSourceParams(appName=APP))
    with pytest.raises(NotImplementedError, match="item 10"):
        ds._read_training_sharded()
    td = ds.read_training(CPU)
    td.n_hosts = 2
    with pytest.raises(NotImplementedError, match="item 10"):
        ur.URAlgorithm(ur.URAlgorithmParams(appName=APP)).train(CPU, td)
