"""The 1/N sharded read of a launch, held against the JAX package on ONE
sqlite file that both packages open.

* ``PEvents.shard_hash`` equals the JAX package's on 10,000 ids (ASCII,
  accented and CJK);
* ``find(shard=(p, N), shard_key=...)`` gives the same event ids, in the
  same order, as the JAX package's sqlite store, for every key and N ∈ {2, 3}; the
  shards are disjoint and cover the app; the MEMORY store's post-scan
  filter puts every event on the same shard for the entity keys;
* ``read_sharded_interactions`` run by two threads (process 0 and 1 of a
  virtual launch) gives the same global maps, degree vectors, translated
  rows and exchanged row digest as the JAX function run the same way;
* ``read_sharded_event_batch`` gives the same maps; the exchange of a peer
  that never publishes times out loudly; ``cleanup_exchange_keys`` removes
  every blob.
"""

import threading
import uuid

import numpy as np
import pytest

from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel import ingest as jax_ingest
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.parallel import ingest

KW = dict(entity_type="user", event_names=["rate"], target_entity_type="item",
          rating_key="rating")


def _env(path):
    name = "SH" + uuid.uuid4().hex[:8].upper()
    return {f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
            f"PIO_STORAGE_SOURCES_{name}_PATH": str(path)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One sqlite file: 3,000 ratings, some buys, a few events without a
    target, written by the port; opened by both packages."""
    path = tmp_path_factory.mktemp("shard") / "events.db"
    env = _env(path)
    port = Storage(env=env)
    app_id = port.get_meta_data_apps().insert(App(0, "S"))
    rng = np.random.default_rng(2)
    evs = [Event(event="rate", entity_type="user", entity_id=f"u{int(rng.integers(0, 80))}é",
                 target_entity_type="item", target_entity_id=f"i{int(rng.zipf(1.5) % 40)}",
                 properties={"rating": float(rng.integers(1, 6))})
           for _ in range(3000)]
    evs += [Event(event="buy", entity_type="user", entity_id=f"u{k}é",
                  target_entity_type="item", target_entity_id=f"i{k % 7}") for k in range(50)]
    evs += [Event(event="$set", entity_type="user", entity_id=f"u{k}é",
                  properties={"a": k}) for k in range(10)]
    port.get_l_events().insert_batch(evs, app_id)
    jax = JaxStorage(env=env)
    yield port, jax, app_id
    port_sqlite.close_all_dbs()
    jax_sqlite.close_all_dbs()


def test_shard_hash_equals_jax_on_10000_ids():
    rng = np.random.default_rng(0)
    alphabet = list("abcxyz0189-_ :/") + ["é", "ü", "ß", "中", "文", "🙂"]
    ids = ["".join(rng.choice(alphabet, int(rng.integers(0, 24)))) for _ in range(10_000)]
    got = np.array([port_base.PEvents.shard_hash(s) for s in ids])
    want = np.array([jax_base.PEvents.shard_hash(s) for s in ids])
    assert np.array_equal(got, want)
    assert len(np.unique(got % 7)) == 7


@pytest.mark.parametrize("key", ["row", "entity", "target"])
@pytest.mark.parametrize("n", [2, 3])
def test_sqlite_shards_give_the_jax_event_ids(both, key, n):
    port, jax, app_id = both
    every = port.get_p_events().find(app_id)
    seen = []
    for p in range(n):
        got = port.get_p_events().find(app_id, shard=(p, n), shard_key=key)
        want = jax.get_p_events().find(app_id, shard=(p, n), shard_key=key)
        assert list(got.event_id) == list(want.event_id)
        seen.extend(got.event_id)
    assert sorted(seen) == sorted(every.event_id)  # disjoint and covering


@pytest.mark.parametrize("key", ["entity", "target"])
def test_memory_store_puts_every_event_on_the_sqlite_shard(both, key):
    port, _, app_id = both
    batch = port.get_p_events().find(app_id)
    for p in range(3):
        mem = port_base.PEvents.shard_select(batch, (p, 3), key)
        sql = port.get_p_events().find(app_id, shard=(p, 3), shard_key=key)
        assert sorted(mem.event_id) == sorted(sql.event_id)


def test_find_interactions_shard_filters_like_jax(both):
    port, jax, app_id = both
    for p in range(2):
        got = port.get_p_events().find_interactions(app_id, shard=(p, 2), shard_key="entity", **KW)
        want = jax.get_p_events().find_interactions(app_id, shard=(p, 2), shard_key="entity", **KW)
        assert list(got.user_map.keys()) == list(want.user_map.keys())
        assert np.array_equal(got.user, want.user) and np.array_equal(got.rating, want.rating)


@pytest.fixture(scope="module", autouse=True)
def jax_udf_under_lock():
    """The JAX package's sqlite store registers its shard function without its
    connection lock; two threads of one process sharing the connection (the
    virtual launch here) then collide. Register it under the lock, as the
    port's store does."""
    orig = jax_sqlite.SqlitePEvents._ensure_shard_udf

    def locked(self):
        with self.lock:
            orig(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sqlite.SqlitePEvents, "_ensure_shard_udf", locked)
        yield


def _threads(fn, n):
    out, errs = [None] * n, []

    def run(p):
        try:
            out[p] = fn(p)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_read_sharded_interactions_equals_jax(both, n):
    port, jax, app_id = both
    run = uuid.uuid4().hex[:8]
    parts = [dict(KW), dict(entity_type="user", event_names=["buy"],
                            target_entity_type="item", default_rating=4.0)]
    got = _threads(lambda p: ingest.read_sharded_interactions(
        port, app_id, run_key="port" + run, process_index=p, num_processes=n, parts=parts), n)
    want = _threads(lambda p: jax_ingest.read_sharded_interactions(
        jax, app_id, run_key="jax" + run, process_index=p, num_processes=n, parts=parts), n)
    for g, w in zip(got, want):
        assert list(g.user_map.keys()) == list(w.user_map.keys())
        assert list(g.item_map.keys()) == list(w.item_map.keys())
        assert np.array_equal(g.user_counts, w.user_counts)
        assert np.array_equal(g.item_counts, w.item_counts)
        assert g.dataset_digest == w.dataset_digest != 0
        for side in ("user_rows", "item_rows"):
            a, b = getattr(g, side), getattr(w, side)
            for f in ("user", "item", "rating", "t"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), (side, f)
        assert len(g) == len(w)
    # every process holds the same maps; the user passes cover every rating
    assert all(list(g.user_map.keys()) == list(got[0].user_map.keys()) for g in got)
    assert sum(len(g.user_rows.rating) for g in got) == int(got[0].user_counts.sum())
    got[0].cleanup()
    models = port.get_model_data_models()
    for suffix in ("_user", "_item", "_digest"):
        for p in range(n):
            assert models.get(f"__pio_shardmap__port{run}{suffix}_m{p}") is None


def test_item_pass_off_derives_the_item_table_from_the_user_pass(both):
    port, jax, app_id = both
    run = uuid.uuid4().hex[:8]
    got = _threads(lambda p: ingest.read_sharded_interactions(
        port, app_id, run_key="a" + run, process_index=p, num_processes=2,
        item_pass=False, **KW), 2)
    want = _threads(lambda p: jax_ingest.read_sharded_interactions(
        jax, app_id, run_key="b" + run, process_index=p, num_processes=2,
        item_pass=False, **KW), 2)
    for g, w in zip(got, want):
        assert list(g.item_map.keys()) == list(w.item_map.keys())
        assert np.array_equal(g.item_counts, w.item_counts)
        assert len(g.item_rows.rating) == 0


def test_read_sharded_event_batch_equals_jax(both):
    port, jax, app_id = both
    run = uuid.uuid4().hex[:8]
    got = _threads(lambda p: ingest.read_sharded_event_batch(
        port, app_id, run_key="c" + run, process_index=p, num_processes=2), 2)
    want = _threads(lambda p: jax_ingest.read_sharded_event_batch(
        jax, app_id, run_key="d" + run, process_index=p, num_processes=2), 2)
    for (gb, gu, gi, _), (wb, wu, wi, _) in zip(got, want):
        assert list(gb.event_id) == list(wb.event_id)
        assert list(gu.keys()) == list(wu.keys()) and list(gi.keys()) == list(wi.keys())


def test_array_pair_input_equals_dict_input(both):
    port, _, _ = both
    run = uuid.uuid4().hex[:8]
    d = {"x": 3, "y": 1, "zé": 2}
    a = ingest.exchange_entity_tables(port, "p" + run, d, 0, 1)
    b = ingest.exchange_entity_tables(
        port, "q" + run, (np.array(list(d), dtype=object), np.array(list(d.values()))), 0, 1)
    assert list(a[0].keys()) == list(b[0].keys()) and np.array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="NUL"):
        ingest.exchange_entity_tables(port, "r" + run, {"x\0": 1}, 0, 1)


def test_a_missing_peer_times_out_loudly(both):
    port, _, _ = both
    with pytest.raises(TimeoutError, match="never appeared"):
        ingest.exchange_entity_tables(port, "lonely" + uuid.uuid4().hex[:8], {"a": 1}, 0, 2,
                                      timeout=0.5, poll=0.05)


def test_sharded_read_needs_a_run_id(both, monkeypatch):
    port, _, app_id = both
    monkeypatch.delenv("PIO_RUN_ID", raising=False)
    with pytest.raises(RuntimeError, match="run id"):
        ingest.read_sharded_interactions(port, app_id, process_index=0, num_processes=2, **KW)
