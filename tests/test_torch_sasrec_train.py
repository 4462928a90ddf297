"""SASRec training in the port against the JAX package.

The same numpy inputs (drawn from a seed) go through both packages:

* ``_moe_ffn``: ``(out, aux)`` and the gradients of ``Σ out·c + aux`` with
  respect to y, router, w1 and w2, at routings that overflow capacity and
  with pads, plus the JAX package's own MoE cases
  (``tests/test_sequential.py``: one expert is the dense FFN, overflow
  tokens get a zero delta, pads neither route nor take capacity);
* ``build_sequences`` with equal event times (the stable lexsort);
* one step's loss and gradients: the port's ``_loss_fn`` under autograd
  against ``jax.value_and_grad`` of the JAX ``_loss_fn``, dense and with
  experts, and at T = 256 with the port's gate forced open, so the
  attention runs through the autograd Function and its plain backward;
* ``train_sasrec`` from the JAX start (``_init_params(PRNGKey(seed))`` as
  numpy, the draw jax's threefry makes) against JAX ``train_sasrec`` on a
  one-device mesh, after 5 steps, dense and with experts;
* ``run_train`` on the sequential engine from MEMORY events to a COMPLETED
  instance, deployed by ``QueryServer`` and answering as the JAX engine
  trained on the same events from the same start.

Tolerances. MoE outputs and gradients rtol = atol = 1e-5. One step: loss
rtol 1e-5; each gradient within rtol 1e-4 plus 1e-6 of its leaf's largest
|g| (float32 sums over B·T tokens in another order). Trained params after
5 Adam steps: rtol = atol = 1e-4. Adam's first steps move each entry by
about lr·sign(g) (lr 1e-3 here), so an entry whose gradient the two
packages round to opposite signs would part by 2e-3; no such entry occurs
at these seeds, and the test would show it. Served answers: ``topk_mismatches``
at 1e-4.
"""

import dataclasses
import functools
import json
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.batch import Interactions as JaxInteractions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models import sequential as jax_seq
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import sequentialrecommendation as jax_tmpl
from predictionio_tpu_torch.core import workflow
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.data.storage import base, memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import sequential as seq
from predictionio_tpu_torch.ops import flash_attention as fa
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates import sequentialrecommendation as tmpl
from predictionio_tpu_torch.testing import topk_mismatches

CPU = DeviceContext.create(device="cpu")
FACTORY = "predictionio_tpu_torch.templates.sequentialrecommendation.SequentialRecommendationEngine"
APP = "SeqTrainApp"


def _port_cfg(jax_cfg):
    return seq.SASRecConfig(**dataclasses.asdict(jax_cfg))


def _jax_start(cfg, n_items):
    return jax.tree.map(np.asarray, jax_seq._init_params(jax.random.PRNGKey(cfg.seed), cfg, n_items))


def _leaves(params):
    """(name, array) pairs in one order for both packages' trees."""
    out = [("emb", params["emb"]), ("pos", params["pos"])]
    for n, layer in enumerate(params["layers"]):
        out += [(f"layers.{n}.{k}", layer[k]) for k in sorted(layer)]
    return out


# -- the mixture-of-experts FFN ------------------------------------------------


def _moe_inputs(seed, b, t, d, e):
    rng = np.random.default_rng(seed)
    return dict(
        y=rng.normal(size=(b, t, d)).astype(np.float32),
        router=rng.normal(size=(d, e)).astype(np.float32),
        w1=(rng.normal(size=(e, d, 4 * d)) / np.sqrt(d)).astype(np.float32),
        w2=(rng.normal(size=(e, 4 * d, d)) / np.sqrt(4 * d)).astype(np.float32),
        c=rng.normal(size=(b, t, d)).astype(np.float32),
    )


@pytest.mark.parametrize("e, capacity, with_pads", [
    (4, 1.25, True), (4, 1.25, False), (3, 0.5, True), (2, 4.0, True),
])
def test_moe_ffn_and_its_gradients_match_jax(e, capacity, with_pads):
    b, t, d = 3, 16, 8
    x = _moe_inputs(e * 10 + int(capacity * 4), b, t, d, e)
    valid = np.ones((b, t), bool)
    if with_pads:
        valid[:, :5] = False
        valid[1, :12] = False
    jcfg = jax_seq.SASRecConfig(n_experts=e, expert_capacity=capacity)

    def jax_obj(y, router, w1, w2):
        out, aux = jax_seq._moe_ffn(dict(router=router, w1=w1, w2=w2), y, jcfg,
                                    valid=valid if with_pads else None)
        return (out * x["c"]).sum() + aux, (out, aux)

    (_, (want_out, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2, 3), has_aux=True))(x["y"], x["router"], x["w1"], x["w2"])
    ty, tr, t1, t2 = (torch.tensor(x[k], requires_grad=True) for k in ("y", "router", "w1", "w2"))
    out, aux = seq._moe_ffn(dict(router=tr, w1=t1, w2=t2), ty, _port_cfg(jcfg),
                            valid=torch.from_numpy(valid) if with_pads else None)
    ((out * torch.from_numpy(x["c"])).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-5)
    for got, want in zip((ty.grad, tr.grad, t1.grad, t2.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if with_pads:  # pads get no delta
        assert float(out.detach()[torch.from_numpy(~valid)].abs().max()) == 0.0


def test_single_expert_equals_dense_ffn():
    x = _moe_inputs(0, 2, 8, 16, 1)
    layer = dict(router=torch.zeros(16, 1), w1=torch.from_numpy(x["w1"]), w2=torch.from_numpy(x["w2"]))
    y = torch.from_numpy(x["y"])
    out, aux = seq._moe_ffn(layer, y, seq.SASRecConfig(n_experts=1, expert_capacity=1.0))
    dense = torch.relu(y @ layer["w1"][0]) @ layer["w2"][0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


@pytest.mark.parametrize("valid, first", [(None, 0), ([[0, 0, 0, 1, 1, 1, 1, 1]], 3)])
def test_overflow_gets_zero_delta_and_pads_do_not_route(valid, first):
    """A zero router ties every token on expert 0 (the first index wins);
    with one slot, only the first real token gets a delta."""
    x = _moe_inputs(1, 1, 8, 4, 2)
    layer = dict(router=torch.zeros(4, 2), w1=torch.from_numpy(x["w1"]), w2=torch.from_numpy(x["w2"]))
    cfg = seq.SASRecConfig(n_experts=2, expert_capacity=2 / 8)
    out, aux = seq._moe_ffn(layer, torch.from_numpy(x["y"]), cfg,
                            valid=None if valid is None else torch.tensor(valid, dtype=torch.bool))
    nonzero = np.flatnonzero(out.reshape(8, 4).abs().sum(-1).numpy() > 1e-9)
    assert list(nonzero) == [first] and np.isfinite(float(aux))


# -- sequences ----------------------------------------------------------------


def _both_interactions(user, item, t, n_users, n_items):
    uids = [f"u{k}" for k in range(n_users)]
    iids = [f"i{k}" for k in range(n_items)]
    jax_inter = JaxInteractions(
        user=user.astype(np.int32), item=item.astype(np.int32),
        rating=np.ones(len(user), np.float32), t=t.astype(np.float64),
        user_map=JaxBiMap({x: k for k, x in enumerate(uids)}),
        item_map=JaxBiMap({x: k for k, x in enumerate(iids)}),
    )
    return jax_inter, interactions_from_arrays(user, item, np.ones(len(user)), t, uids, iids)


def _histories(seed, n_users, n_items, max_events):
    """Histories of 0 to ``max_events`` events per user in shuffled order,
    with runs of equal event times."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_events + 1, n_users)
    lengths[0], lengths[1] = 1, 0  # a user below the >= 2 filter, one with none
    user = np.repeat(np.arange(n_users), lengths)
    item = rng.integers(0, n_items, len(user))
    t = np.concatenate([np.sort(rng.integers(0, max(n // 2, 1), n)) for n in lengths]).astype(np.float64)
    order = rng.permutation(len(user))
    return user[order], item[order], t[order]


def test_build_sequences_matches_jax_with_equal_times():
    user, item, t = _histories(0, 30, 20, 40)
    jax_inter, port_inter = _both_interactions(user, item, t, 30, 20)
    for max_len in (1, 9, 33, 64):
        got = seq.build_sequences(port_inter, max_len)
        np.testing.assert_array_equal(got, jax_seq.build_sequences(jax_inter, max_len))
    rows = seq.training_sequences(port_inter, seq.SASRecConfig(max_len=8))
    assert rows.shape[1] == 9 and ((rows != 0).sum(1) >= 2).all()


def test_no_trainable_user_raises_like_jax():
    jax_inter, port_inter = _both_interactions(np.arange(4), np.arange(4), np.zeros(4), 4, 4)
    with pytest.raises(ValueError, match=">= 2 interaction events"):
        jax_seq.train_sasrec(MeshContext.create(devices=jax.devices()[:1]), jax_inter,
                             jax_seq.SASRecConfig(max_len=8, epochs=1))
    with pytest.raises(ValueError, match=">= 2 interaction events"):
        seq.train_sasrec(CPU, port_inter, seq.SASRecConfig(max_len=8, epochs=1))


# -- one step -----------------------------------------------------------------


def _batch(seed, b, length, n_items):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, n_items + 1, (b, length)).astype(np.int32)
    for row, n_pad in enumerate(rng.integers(0, length - 1, b)):
        s[row, :n_pad] = 0
    s[0] = rng.integers(1, n_items + 1, length)
    return s


def _step_grads_close(cfg_kw, length, monkeypatch=None):
    n_items = 30
    jcfg = jax_seq.SASRecConfig(**cfg_kw)
    params = _jax_start(jcfg, n_items)
    s = _batch(7, 4, length, n_items)
    loss, grads = jax.jit(jax.value_and_grad(jax_seq._loss_fn), static_argnums=(2,))(params, s, jcfg)
    net = seq.SASRecNet(params, _port_cfg(jcfg), "cpu", trainable=True)
    got = seq._loss_fn(net.tree(), torch.from_numpy(s), _port_cfg(jcfg))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    port_grads = {"emb": net.emb.grad, "pos": net.pos.grad,
                  "layers": [{k: v.grad for k, v in layer.items()} for layer in net.layers]}
    for (name, g), (_, want) in zip(_leaves(port_grads), _leaves(jax.tree.map(np.asarray, grads))):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6 * scale, err_msg=name)
        assert scale > 0, name


@pytest.mark.parametrize("cfg_kw", [
    dict(d_model=12, n_heads=1, n_layers=2, max_len=12),
    dict(d_model=16, n_heads=2, n_layers=2, max_len=12, n_experts=4, expert_capacity=0.5),
])
def test_one_step_loss_and_grads_match_jax(cfg_kw):
    _step_grads_close(cfg_kw, cfg_kw["max_len"] + 1)


def test_one_step_through_the_flash_function_matches_jax_at_256(monkeypatch):
    """The port's gate forced open: the attention runs through the autograd
    Function (forward and backward plain versions on the CPU)."""
    monkeypatch.setattr(seq, "_use_flash", lambda t, device: t >= 256 and t % 128 == 0)
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fa.flash_attention(*a, **kw)

    monkeypatch.setattr(seq, "flash_attention", counted)
    _step_grads_close(dict(d_model=16, n_heads=2, n_layers=2, max_len=256), 257)
    assert calls == [(4, 2, 256, 8)] * 2  # one Function call per layer


# -- training -----------------------------------------------------------------


@pytest.fixture(scope="module")
def histories():
    user, item, t = _histories(3, 40, 25, 30)
    return _both_interactions(user, item, t, 40, 25)


@pytest.mark.parametrize("cfg_kw", [
    dict(d_model=16, n_heads=2, n_layers=2, max_len=16, lr=1e-3, batch_size=16, seed=2),
    dict(d_model=16, n_heads=2, n_layers=1, max_len=16, lr=1e-3, batch_size=64, seed=5, n_experts=4),
])
def test_train_sasrec_matches_jax_from_the_jax_start(histories, cfg_kw):
    jax_inter, port_inter = histories
    jcfg = jax_seq.SASRecConfig(epochs=5, **cfg_kw)
    want = jax_seq.train_sasrec(MeshContext.create(devices=jax.devices()[:1]), jax_inter, jcfg)
    start = _jax_start(jcfg, port_inter.n_items)
    got = seq.train_sasrec(CPU, port_inter, _port_cfg(jcfg), init_params=start)
    assert got.losses.shape == (5,) and np.isfinite(got.losses).all()
    moved = 0.0
    for (name, a), (_, b), (_, a0) in zip(_leaves(got.params), _leaves(jax.tree.map(np.asarray, want.params)),
                                          _leaves(start)):
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        moved = max(moved, float(np.abs(a - a0).max()))
    assert moved > 1e-3  # five steps of lr 1e-3 moved the params
    assert got.item_map == port_inter.item_map and got.config == _port_cfg(jcfg)


def test_default_start_is_seeded_and_counts_no_launch(histories):
    _, port_inter = histories
    cfg = seq.SASRecConfig(d_model=8, n_heads=2, n_layers=1, max_len=8, epochs=3, batch_size=8)
    before = (fa.launches.count, fa.bwd_dq_launches.count, fa.bwd_dkv_launches.count)
    a = seq.train_sasrec(CPU, port_inter, cfg)
    b = seq.train_sasrec(CPU, port_inter, cfg)
    c = seq.train_sasrec(CPU, port_inter, dataclasses.replace(cfg, seed=1))
    assert (fa.launches.count, fa.bwd_dq_launches.count, fa.bwd_dkv_launches.count) == before
    np.testing.assert_array_equal(a.params["emb"], b.params["emb"])
    np.testing.assert_array_equal(a.losses, b.losses)
    assert not np.allclose(a.params["emb"], c.params["emb"])
    a.bind("cpu")
    items, scores = a.recommend(["i1", "i2"], 5)
    assert len(items) == 5 and np.isfinite(scores).all()


# -- the slice whole: events → run_train → deploy → /queries.json --------------


def _events():
    rng = np.random.default_rng(9)
    out = []
    for u in range(30):
        start = int(rng.integers(0, 12))
        for step in range(int(rng.integers(2, 20))):
            out.append(dict(event="view", entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{(start + step) % 12}",
                            event_time=1_767_225_600.0 + step))
    return out


@pytest.fixture()
def stores():
    name = "T" + uuid.uuid4().hex[:8].upper()
    env = {
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    }
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


def _post(base_url, q):
    req = urllib.request.Request(f"{base_url}/queries.json", data=json.dumps(q).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_run_train_reaches_completed_and_serves_as_jax(stores, monkeypatch):
    port_storage, _ = stores
    algo_params = {"appName": APP, "eventNames": ["view"], "dModel": 16, "numLayers": 1,
                   "maxLen": 8, "epochs": 8, "batchSize": 16, "lr": 0.005, "seed": 4}
    variant = {"datasource": {"params": {"appName": APP, "eventNames": ["view"]}},
               "algorithms": [{"name": "sasrec", "params": algo_params}]}
    jax_engine = jax_tmpl.SequentialRecommendationEngine.apply()
    jax_ep = jax_engine.params_from_variant(variant)
    jm = jax_engine.train(MeshContext.create(devices=jax.devices()[:1]), jax_ep)[0]
    jax_algo = jax_engine.make_algorithms(jax_ep)[0]
    start = _jax_start(jm.config, len(jm.item_map))
    monkeypatch.setattr(tmpl, "train_sasrec", functools.partial(seq.train_sasrec, init_params=start))

    engine = tmpl.SequentialRecommendationEngine.apply()
    iid = workflow.run_train(engine, engine.params_from_variant(variant), FACTORY,
                             storage=port_storage, ctx=CPU)
    inst = port_storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    assert workflow.get_latest_completed_instance(port_storage).id == iid

    inv = jm.item_map.inverse
    idx = {inv[j]: j for j in range(len(inv))}
    qs = QueryServer(engine, storage=port_storage, ctx=CPU, batching=True)
    try:
        base_url = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        for n, user in enumerate(f"u{u}" for u in range(0, 30, 3)):
            num = 2 + n % 4
            got = _post(base_url, {"user": user, "num": num})["itemScores"]
            ref = jax_algo.predict(jm, jax_tmpl.Query(user=user, num=num)).itemScores
            assert len(got) == len(ref) > 0, user
            bad = topk_mismatches(
                np.array([[x["score"] for x in got]]), np.array([[idx[x["item"]] for x in got]]),
                np.array([[x.score for x in ref]]), np.array([[idx[x.item] for x in ref]]), 1e-4)
            assert not bad, (user, bad[:3])
        assert _post(base_url, {"user": "ghost", "num": 3}) == {"itemScores": []}
    finally:
        qs.stop()
