"""SASRec serving in the port against the JAX package.

* Params carried across (``sasrec_params_from_jax``): the port's
  ``_predict_logits`` against the JAX one on the same numpy params and
  sequences, at T = 8 (both dense) and at T = 256 with both gates forced
  open (the JAX Pallas kernel in interpret mode, the port's flash wrapper on
  CPU tensors, i.e. its plain version), as ``tests/test_flash_attention.py``
  forces the JAX gate. Tolerance rtol = atol = 1e-4.
* ``SASRecModel.recommend``: items and scores by ``topk_mismatches`` at
  1e-4 (host top-k over logits that agree to float rounding: two near-equal
  logits may swap).
* ``LEventStore.find_by_entity``: the same events in both packages' memory
  stores read back in the same order, equal event times included.
* The slice as a whole: a tiny SASRec trained by the JAX engine on
  cycle-walk events, carried across, published as a COMPLETED instance,
  deployed by the port's ``QueryServer`` on the CPU (per-query and
  batching) and asked for every user: the answers equal the JAX
  ``SASRecAlgorithm.predict`` answers on the same events by the same rule,
  an unknown user gets ``[]`` and history items never come back.
"""

import dataclasses
import datetime as dt
import json
import pickle
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models import sequential as jax_seq
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import sequentialrecommendation as jax_tmpl
from predictionio_tpu_torch.core import persistence, workflow
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import base, memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import sequential as seq
from predictionio_tpu_torch.ops import flash_attention as fa
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates import sequentialrecommendation as tmpl
from predictionio_tpu_torch.testing import topk_mismatches

TOL = 1e-4
N_ITEMS = 40
APP = "SeqApp"
FACTORY = "predictionio_tpu_torch.templates.sequentialrecommendation.SequentialRecommendationEngine"
CPU = DeviceContext.create(device="cpu")
RECOMMEND_CFG = jax_seq.SASRecConfig(d_model=16, n_heads=2, n_layers=2, max_len=8)


def _jax_params(cfg, seed):
    """The JAX init, made less trivial: embeddings at unit scale and
    layer-norm gains away from 1, so every term of the forward shows."""
    params = jax.tree.map(np.asarray, jax_seq._init_params(jax.random.PRNGKey(seed), cfg, N_ITEMS))
    rng = np.random.default_rng(seed)
    params["emb"] = (params["emb"] * 50).astype(np.float32)
    params["pos"] = (params["pos"] * 50).astype(np.float32)
    for layer in params["layers"]:
        for g in ("ln1", "ln2"):
            layer[g] = (1 + 0.2 * rng.standard_normal(layer[g].shape)).astype(np.float32)
    return params


def _sequences(rng, batch, t):
    s = rng.integers(1, N_ITEMS + 1, (batch, t)).astype(np.int32)
    for row, n_pad in enumerate(rng.integers(0, t, batch)):
        s[row, :n_pad] = 0
    s[0, :] = rng.integers(1, N_ITEMS + 1, t)  # one row without padding
    return s


def _port_cfg(jax_cfg):
    return seq.SASRecConfig(**dataclasses.asdict(jax_cfg))


def _tree(params):
    return seq.SASRecNet(seq.sasrec_params_from_jax(params), seq.SASRecConfig(), "cpu").tree()


@pytest.mark.parametrize("d_model, n_heads, n_layers", [(16, 2, 2), (12, 1, 1), (24, 3, 2)])
def test_dense_logits_match_jax(d_model, n_heads, n_layers):
    cfg = jax_seq.SASRecConfig(d_model=d_model, n_heads=n_heads, n_layers=n_layers, max_len=8)
    params = _jax_params(cfg, seed=d_model)
    s = _sequences(np.random.default_rng(1), 5, 8)
    want = np.asarray(jax_seq._predict_logits(params, s, cfg))
    got = seq._predict_logits(_tree(params), torch.from_numpy(s), _port_cfg(cfg))
    assert got.shape == (5, N_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_path_logits_match_jax_at_256(monkeypatch):
    monkeypatch.setattr(jax_seq, "_use_flash", lambda t: t >= 256 and t % 128 == 0)
    monkeypatch.setattr(seq, "_use_flash", lambda t, device: t >= 256 and t % 128 == 0)
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fa.flash_attention(*a, **kw)

    monkeypatch.setattr(seq, "flash_attention", counted)
    cfg = jax_seq.SASRecConfig(d_model=16, n_heads=2, n_layers=2, max_len=256, seed=7)
    params = _jax_params(cfg, seed=3)
    s = _sequences(np.random.default_rng(2), 2, 256)
    want = np.asarray(jax_seq._predict_logits(params, s, cfg))
    got = seq._predict_logits(_tree(params), torch.from_numpy(s), _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert calls == [(2, 2, 256, 8)] * 2  # one flash call per layer


def test_gate_keeps_cpu_and_short_blocks_dense(monkeypatch):
    used = []
    monkeypatch.setattr(seq, "flash_attention", lambda *a, **kw: used.append("flash"))
    cfg = seq.SASRecConfig(d_model=8, n_heads=1, n_layers=1, max_len=256)
    tree = seq.SASRecNet(seq.init_params(0, cfg, N_ITEMS), cfg, "cpu").tree()
    hidden, aux = seq._forward(tree, torch.ones((1, 256), dtype=torch.long), cfg, allow_flash=True)
    assert hidden.shape == (1, 256, 8) and not used and float(aux) == 0.0


def test_pad_rows_are_zero_after_every_layer():
    cfg = seq.SASRecConfig(d_model=8, n_heads=2, n_layers=2, max_len=8)
    tree = seq.SASRecNet(seq.init_params(1, cfg, N_ITEMS), cfg, "cpu").tree()
    s = torch.tensor([[0, 0, 0, 3, 4, 5, 6, 7]])
    hidden, _ = seq._forward(tree, s, cfg)
    assert torch.all(hidden[0, :3] == 0) and torch.all(hidden[0, 3:].abs().sum(-1) > 0)


def test_layer_norm_is_the_jax_formula():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32) * 3 + 1
    g = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jax_seq._layer_norm(x, g))
    got = seq._layer_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_params_have_the_jax_shapes_and_scales():
    cfg = seq.SASRecConfig(d_model=50, n_heads=1, n_layers=2, max_len=256)
    mine = seq.init_params(np.random.default_rng(0), cfg, 3416)
    ref = jax.tree.map(np.asarray, jax_seq._init_params(
        jax.random.PRNGKey(0), jax_seq.SASRecConfig(d_model=50, n_heads=1, n_layers=2, max_len=256), 3416))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
        assert abs(float(a.std()) - float(b.std())) <= 0.05 * float(b.std()) + 1e-6
    assert np.array_equal(seq.init_params(5, cfg, 10)["emb"], seq.init_params(5, cfg, 10)["emb"])


def _models(cfg, seed):
    params = _jax_params(cfg, seed)
    ids = [f"i{j}" for j in range(N_ITEMS)]
    jm = jax_seq.SASRecModel(params=params, item_map=JaxBiMap.string_int(ids), config=cfg)
    pm = seq.SASRecModel(
        params=seq.sasrec_params_from_jax(params),
        item_map=BiMap({it: j for j, it in enumerate(ids)}),
        config=_port_cfg(cfg),
    )
    pm.bind("cpu")
    return jm, pm


@pytest.mark.parametrize("history, num", [
    (["i3"], 5),
    (["i1", "i7", "i7", "i30", "nope"], 10),
    ([f"i{j % N_ITEMS}" for j in range(13)], 7),  # longer than max_len
    ([f"i{j}" for j in range(N_ITEMS - 3)], 10),  # fewer candidates than num
    (["i2", "i5"], 100),  # num above the catalog
])
def test_recommend_matches_jax(history, num):
    jm, pm = _models(RECOMMEND_CFG, seed=11)
    ref_items, ref_scores = jm.recommend(history, num)
    items, scores = pm.recommend(history, num)
    assert len(items) == len(ref_items) > 0
    idx = {f"i{j}": j for j in range(N_ITEMS)}
    bad = topk_mismatches(
        np.asarray([scores]), np.asarray([[idx[i] for i in items]]),
        np.asarray([ref_scores]), np.asarray([[idx[i] for i in ref_items]]), TOL,
    )
    assert not bad, bad[:3]
    assert not set(items) & set(history)


def test_recommend_with_no_known_item_is_empty():
    _, pm = _models(RECOMMEND_CFG, seed=12)
    items, scores = pm.recommend(["zzz", "yyy"], 5)
    assert items == [] and len(scores) == 0


def test_blob_pickles_host_params_only_and_binds_at_deploy():
    _, pm = _models(RECOMMEND_CFG, seed=13)
    before = pm.recommend(["i1", "i2"], 5)
    blob = pickle.loads(pickle.dumps(pm))
    assert blob._net is None
    assert all(isinstance(v, np.ndarray) for v in jax.tree.leaves(blob.params))
    algo = tmpl.SASRecAlgorithm(tmpl.SASRecParams())
    loaded = algo.load_serializable_model(CPU, blob)
    assert loaded._net is not None and loaded._net.device.type == "cpu"
    net = loaded._net
    assert loaded.bind("cpu") is net  # built once
    after = loaded.recommend(["i1", "i2"], 5)
    assert after[0] == before[0] and np.array_equal(after[1], before[1])


def test_unbound_model_goes_to_the_card_or_raises():
    cfg = seq.SASRecConfig(d_model=8, n_heads=1, n_layers=1, max_len=8)
    model = seq.SASRecModel(seq.init_params(0, cfg, N_ITEMS),
                            BiMap({f"i{j}": j for j in range(N_ITEMS)}), cfg)
    if torch.cuda.is_available():
        model.recommend(["i1"], 3)
        assert model._net.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.recommend(["i1"], 3)


def test_not_ported_parts_name_their_roadmap_item():
    # experts and training are ported: an expert model draws, binds and
    # carries across; train_sasrec refuses only what later items bring
    cfg = seq.SASRecConfig(d_model=8, n_heads=2, n_experts=4, max_len=8)
    params = seq.init_params(0, cfg, 10)
    assert params["layers"][0]["router"].shape == (8, 4)
    assert params["layers"][0]["w1"].shape == (4, 8, 32) and params["layers"][0]["w2"].shape == (4, 32, 8)
    net = seq.SASRecNet(params, cfg, "cpu")
    assert net(torch.tensor([[0, 0, 3, 4, 5, 6, 7, 8]])).shape == (1, 10)
    assert seq.sasrec_params_from_jax(params)["layers"][1]["router"].shape == (8, 4)
    params["layers"][0]["router"] = np.zeros((8, 3), np.float32)  # E disagrees with w1
    with pytest.raises(ValueError, match="layer shapes"):
        seq.sasrec_params_from_jax(params)
    # seq_parallel is ported: it needs a model axis of 2 or more, and trains
    # on a mesh of repeated CPU placements
    inter = _cycle_interactions()
    with pytest.raises(ValueError, match="model.*axis"):
        seq.train_sasrec(CPU, inter, seq.SASRecConfig(max_len=8, seq_parallel=True))
    sp = seq.train_sasrec(
        DeviceContext.create(axes={"data": 1, "model": 2}, devices=["cpu"] * 2), inter,
        seq.SASRecConfig(d_model=8, n_heads=2, n_layers=1, max_len=8, epochs=2,
                         seq_parallel=True))
    assert sp.losses.shape == (2,) and np.isfinite(sp.losses).all()
    # checkpoints are ported: only the sharded input stops this one
    with pytest.raises(NotImplementedError, match="item 10"):
        seq.train_sasrec(CPU, None, seq.SASRecConfig(checkpoint_dir="/nowhere"))
    with pytest.raises(NotImplementedError, match="item 10"):
        seq.train_sasrec(CPU, None)
    with pytest.raises(NotImplementedError, match="item 10"):
        tmpl.SASRecAlgorithm(tmpl.SASRecParams()).train(CPU, tmpl.TrainingData(None))


def _cycle_interactions(n_users=64, n_items=10, length=12, seed=0):
    """Every user walks the cycle 0 → 1 → … → 9 → 0 from a random start
    (the JAX tests' ``cyclic_interactions``)."""
    from predictionio_tpu_torch.data.batch import interactions_from_arrays

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_items, n_users)
    user = np.repeat(np.arange(n_users), length)
    item = (np.repeat(starts, length) + np.tile(np.arange(length), n_users)) % n_items
    t = np.tile(np.arange(length), n_users).astype(np.float64)
    return interactions_from_arrays(user, item, np.ones(len(user)), t,
                                    [f"u{k}" for k in range(n_users)],
                                    [f"i{k}" for k in range(n_items)])


def test_config_and_params_mirror_jax():
    assert [f.name for f in dataclasses.fields(seq.SASRecConfig)] == [
        f.name for f in dataclasses.fields(jax_seq.SASRecConfig)]
    assert seq.SASRecConfig() == seq.SASRecConfig(**dataclasses.asdict(jax_seq.SASRecConfig()))
    assert dataclasses.asdict(tmpl.SASRecParams()) == dataclasses.asdict(jax_tmpl.SASRecParams())


# -- stores with the same events in both packages ------------------------------


def _cycle_events():
    """48 users walk 5 steps of the cycle i0 → … → i7 → i0 (the JAX template
    test's data), u_long has 23 events over three items (more than maxLen),
    u_tie has equal event times."""
    out = []
    for u in range(48):
        for t in range(5):
            out.append(dict(event="view", entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{(u % 8 + t) % 8}",
                            event_time=1000.0 + t))
    for t in range(23):
        out.append(dict(event="view", entity_type="user", entity_id="u_long",
                        target_entity_type="item", target_entity_id=f"i{3 + t % 3}",
                        event_time=2000.0 + t))
    base_t = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    for t, item in enumerate(("i4", "i1", "i6")):
        out.append(dict(event="view", entity_type="user", entity_id="u_tie",
                        target_entity_type="item", target_entity_id=item, event_time=1500.0,
                        creation_time=base_t + dt.timedelta(seconds=t)))
    out.append(dict(event="rate", entity_type="user", entity_id="u_tie",
                    target_entity_type="item", target_entity_id="i2", event_time=1400.0,
                    properties={"rating": 4.0}))
    out.append(dict(event="like", entity_type="user", entity_id="u_tie",
                    target_entity_type="item", target_entity_id="i7", event_time=1600.0))
    return out


@pytest.fixture()
def stores():
    name = "Q" + uuid.uuid4().hex[:8].upper()
    env = {
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    }
    port, ref = Storage(env=env), JaxStorage(env=env)
    evs = _cycle_events()
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


@pytest.mark.parametrize("user", ["u0", "u_long", "u_tie", "ghost"])
@pytest.mark.parametrize("kw", [
    dict(limit=None, latest=True),
    dict(limit=3, latest=True),
    dict(limit=4, latest=False),
    dict(limit=10, latest=True, event_names=["view", "rate"]),
])
def test_find_by_entity_matches_jax(stores, user, kw):
    def read(mod):
        return [(e.event, e.target_entity_id, e.event_time) for e in mod.LEventStore.find_by_entity(
            APP, entity_type="user", entity_id=user, target_entity_type="item", **kw)]

    assert read(port_store) == read(jax_store)
    assert [(e.event, e.target_entity_id) for e in port_store.LEventStore.find(APP, entity_id=user)] == [
        (e.event, e.target_entity_id) for e in jax_store.LEventStore.find(APP, entity_id=user)]


def test_datasource_reads_what_jax_reads(stores):
    params = dict(appName=APP, eventNames=("view", "rate"))
    got = tmpl.SequentialDataSource(tmpl.SeqDataSourceParams(**params)).read_training(CPU)
    want = jax_tmpl.SequentialDataSource(jax_tmpl.SeqDataSourceParams(**params)).read_training(None)
    a, b = got.interactions, want.interactions
    assert len(a) == len(b) > 0
    assert [a.user_map.inverse[int(u)] for u in a.user] == [b.user_map.inverse[int(u)] for u in b.user]
    assert [a.item_map.inverse[int(i)] for i in a.item] == [b.item_map.inverse[int(i)] for i in b.item]


def _publish(storage, engine, model, variant):
    """``model`` as a COMPLETED instance with its sealed blob, the steps
    the training workflow takes after training."""
    now = dt.datetime.now(tz=dt.timezone.utc)
    params = engine.params_from_variant(variant)
    instances = storage.get_meta_data_engine_instances()
    inst = base.EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory=FACTORY, **params.to_json_strings(),
    )
    iid = instances.insert(inst)
    blob = persistence.serialize_models(
        iid, engine.make_algorithms(params), [model], [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(base.Model(id=iid, models=persistence.seal_model_blob(blob)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


def _post(base_url, q):
    req = urllib.request.Request(
        f"{base_url}/queries.json", data=json.dumps(q).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_jax_trained_model_served_by_the_port(stores):
    port_storage, _ = stores
    algo_params = {"appName": APP, "eventNames": ["view", "rate"], "dModel": 32,
                   "numLayers": 1, "maxLen": 8, "epochs": 60, "lr": 0.005}
    variant = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "sasrec", "params": algo_params}]}
    jax_engine = jax_tmpl.SequentialRecommendationEngine.apply()
    jax_ep = jax_engine.params_from_variant(variant)
    jm = jax_engine.train(MeshContext.create(devices=jax.devices()[:1]), jax_ep)[0]
    jax_algo = jax_engine.make_algorithms(jax_ep)[0]
    inv = jm.item_map.inverse
    pm = seq.SASRecModel(
        params=seq.sasrec_params_from_jax(jax.tree.map(np.asarray, jm.params)),
        item_map=BiMap({inv[j]: j for j in range(len(inv))}),
        config=_port_cfg(jm.config),
    )
    engine = tmpl.SequentialRecommendationEngine.apply()
    iid = _publish(port_storage, engine, pm, variant)
    assert workflow.get_latest_completed_instance(port_storage).id == iid

    idx = {inv[j]: j for j in range(len(inv))}
    users = [f"u{u}" for u in range(0, 48, 5)] + ["u_long", "u_tie"]
    for batching in (False, True):
        qs = QueryServer(engine, storage=port_storage, ctx=CPU, batching=batching)
        try:
            base_url = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
            for n, user in enumerate(users):
                num = 3 + n % 4
                got = _post(base_url, {"user": user, "num": num})["itemScores"]
                ref = jax_algo.predict(jm, jax_tmpl.Query(user=user, num=num)).itemScores
                assert len(got) == len(ref) > 0, user
                bad = topk_mismatches(
                    np.array([[x["score"] for x in got]]), np.array([[idx[x["item"]] for x in got]]),
                    np.array([[x.score for x in ref]]), np.array([[idx[x.item] for x in ref]]), TOL,
                )
                assert not bad, (user, bad[:3])
            res = _post(base_url, {"user": "u0", "num": 3})["itemScores"]
            assert not {"i0", "i1", "i2", "i3", "i4"} & {x["item"] for x in res}
            assert _post(base_url, {"user": "ghost", "num": 3}) == {"itemScores": []}
        finally:
            qs.stop()
