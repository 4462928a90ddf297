"""The port's event side against the JAX package's, on the same events.

* The memory ``LEvents``/``PEvents`` insert, find and filter (time range,
  entity, event names, targets, the "None" target, limit, order, channels)
  as the JAX driver does; apps, access keys, channels and sequences.
* ``PEventStore.find_interactions`` and ``RecommendationDataSource.
  read_training`` (rate+buy, and the ``eventRatings`` mapping) give the
  same triples under the same id maps as the JAX package's.
* ``ExcludeItemsPreparator`` drops and compacts as the JAX one
  (``Interactions.drop_items``).

Equality is exact throughout: the same events give the same integers and
the same float32 ratings.
"""

import datetime as dt
import uuid

import numpy as np
import pytest

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.batch import EventBatch, interactions_from_arrays
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage import memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as rec

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = "EvApp"


def _event_dicts(n=400, seed=0):
    """rate/buy/view/like events plus non-user and target-less rows that
    every training read must skip; distinct times fix the scan order."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.choice(["rate", "rate", "buy", "view", "like", "set", "rate-item"])
        u, i = f"u{rng.integers(30)}", f"i{rng.integers(20)}"
        t = T0 + dt.timedelta(minutes=k)
        if kind == "set":
            out.append(dict(event="$set", entity_type="user", entity_id=u,
                            properties={"age": int(rng.integers(90))}, event_time=t))
        elif kind == "rate-item":
            out.append(dict(event="rate", entity_type="item", entity_id=i,
                            target_entity_type="user", target_entity_id=u,
                            properties={"rating": 3.0}, event_time=t))
        else:
            props = {"rating": float(rng.integers(1, 6))} if kind == "rate" else {}
            if kind == "rate" and k % 17 == 0:
                props = {}  # a rate without its rating falls back to the default
            out.append(dict(event=kind, entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties=props, event_time=t))
    return out


@pytest.fixture()
def both_stores():
    """One MEMORY source per package holding app APP and the same events;
    each package's ambient store points at its own."""
    name = "E" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    events = _event_dicts()
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, APP))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in events], app_id)
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    yield port, ref
    port_store.set_storage(None)
    jax_store.set_storage(None)
    memory.reset_store(name)
    jax_memory.reset_store(name)


def _assert_same_interactions(got, ref):
    np.testing.assert_array_equal(got.user, ref.user)
    np.testing.assert_array_equal(got.item, ref.item)
    np.testing.assert_array_equal(got.rating, ref.rating)
    np.testing.assert_array_equal(got.t, ref.t)
    assert got.user.dtype == ref.user.dtype and got.rating.dtype == ref.rating.dtype
    assert got.user_map.to_dict() == ref.user_map.to_dict()
    assert got.item_map.to_dict() == ref.item_map.to_dict()


class TestMemoryEvents:
    @pytest.fixture()
    def levents(self):
        name = "L" + uuid.uuid4().hex[:8].upper()
        yield memory.MemoryLEvents(name)
        memory.reset_store(name)

    def test_insert_get_delete(self, levents):
        e = port_event.Event(event="rate", entity_type="user", entity_id="u1",
                             target_entity_type="item", target_entity_id="i1")
        eid = levents.insert(e, 1)
        got = levents.get(eid, 1)
        assert got.event_id == eid and got.entity_id == "u1"
        assert levents.get(eid, 2) is None
        ids = levents.insert_batch([e.with_id("fixed"), e], 1, channel_id=0)
        assert ids[0] == "fixed" and len(set(ids)) == 2
        assert levents.get("fixed", 1) is not None  # channel 0 is the default
        assert levents.delete(eid, 1) and not levents.delete(eid, 1)
        assert levents.remove(1) and list(levents.find(1)) == []

    def test_find_filters_like_jax(self, levents):
        name = "J" + uuid.uuid4().hex[:8].upper()
        ref = jax_memory.MemoryLEvents(name)
        events = _event_dicts(120, seed=3)
        for d in events:
            levents.insert(port_event.Event(**d), 7)
            ref.insert(jax_event.Event(**d), 7)
        cases = [
            {}, {"entity_type": "item"}, {"entity_id": "u3"},
            {"event_names": ["buy", "view"]}, {"target_entity_type": "None"},
            {"target_entity_id": "i4"}, {"limit": 5}, {"limit": 5, "reversed": True},
            {"start_time": T0 + dt.timedelta(minutes=30),
             "until_time": (T0 + dt.timedelta(minutes=60)).replace(tzinfo=None)},
        ]
        for f in cases:
            got = [(e.event, e.entity_id, e.target_entity_id, e.event_time)
                   for e in levents.find(7, **f)]
            want = [(e.event, e.entity_id, e.target_entity_id, e.event_time)
                    for e in ref.find(7, **f)]
            assert got == want and (got or f.get("entity_id")), f
        jax_memory.reset_store(name)

    def test_event_validation(self):
        with pytest.raises(ValueError, match="together"):
            port_event.Event(event="rate", entity_type="user", entity_id="u",
                             target_entity_type="item")
        with pytest.raises(ValueError, match="reserved"):
            port_event.Event(event="$bogus", entity_type="user", entity_id="u")
        with pytest.raises(ValueError, match="entityId"):
            port_event.Event(event="rate", entity_type="user", entity_id="")
        e = port_event.Event(event="rate", entity_type="user", entity_id="u",
                             event_time=1_767_225_600_000)
        assert e.event_time == T0  # epoch millis parse as UTC

    def test_meta_data_daos(self):
        name = "M" + uuid.uuid4().hex[:8].upper()
        s = Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"})
        apps = s.get_meta_data_apps()
        a = apps.insert(base.App(0, "shop"))
        assert apps.insert(base.App(0, "shop")) is None
        assert apps.get_by_name("shop").id == a and apps.get(a).name == "shop"
        keys = s.get_meta_data_access_keys()
        k = keys.insert(base.AccessKey("", a, ["rate"]))
        assert keys.get(k).events == ["rate"] and k[0] not in "-_"
        assert [x.key for x in keys.get_by_app_id(a)] == [k]
        chans = s.get_meta_data_channels()
        assert chans.insert(base.Channel(0, "bad name!", a)) is None
        c = chans.insert(base.Channel(0, "web", a))
        assert [x.name for x in chans.get_by_app_id(a)] == ["web"]
        seq = s.get_meta_data_sequences()
        assert [seq.gen_next("x"), seq.gen_next("x"), seq.gen_next("y")] == [1, 2, 1]
        port_store.set_storage(s)
        try:
            assert port_store.resolve_app("shop", "web") == (a, c)
            with pytest.raises(ValueError, match="Invalid app"):
                port_store.resolve_app("nope")
            with pytest.raises(ValueError, match="Invalid channel"):
                port_store.resolve_app("shop", "app")
        finally:
            port_store.set_storage(None)
            memory.reset_store(name)


class TestTrainingReads:
    def test_p_events_find_matches_jax(self, both_stores):
        got = port_store.PEventStore.find(APP, event_names=["rate"])
        ref = jax_store.PEventStore.find(APP, event_names=["rate"])
        assert isinstance(got, EventBatch) and len(got) == len(ref) > 0
        np.testing.assert_array_equal(got.entity_id, ref.entity_id)
        np.testing.assert_array_equal(got.event_time, ref.event_time)
        assert got.properties == list(ref.properties)

    @pytest.mark.parametrize(
        "kw",
        [dict(event_names=["rate"], rating_key="rating", default_rating=4.0),
         dict(event_names=["buy"], default_rating=4.0),
         dict(event_names=["view", "like"]),
         dict(entity_type="item", target_entity_type="user", event_names=["rate"])],
    )
    def test_find_interactions_matches_jax(self, both_stores, kw):
        got = port_store.PEventStore.find_interactions(APP, **kw)
        ref = jax_store.PEventStore.find_interactions(APP, **kw)
        assert len(ref) > 0
        _assert_same_interactions(got, ref)

    @pytest.mark.parametrize("ratings", (None, {"like": 4.0, "view": 1.0}, {"view": 1.0}))
    def test_read_training_matches_jax(self, both_stores, ratings):
        params = dict(appName=APP, eventRatings=ratings)
        got = rec.RecommendationDataSource(rec.DataSourceParams(**params)).read_training(None)
        ref = jax_rec.RecommendationDataSource(
            jax_rec.DataSourceParams(**params)
        ).read_training(None)
        _assert_same_interactions(got.interactions, ref.interactions)
        got.sanity_check()

    def test_unknown_app_and_empty_reads(self, both_stores):
        with pytest.raises(ValueError, match="Invalid app"):
            rec.RecommendationDataSource(rec.DataSourceParams(appName="none")).read_training(None)
        td = rec.RecommendationDataSource(
            rec.DataSourceParams(appName=APP, eventRatings={"never": 1.0})
        ).read_training(None)
        assert len(td.interactions) == 0
        with pytest.raises(ValueError, match="No rating events"):
            td.sanity_check()

    def test_not_ported_options_name_their_roadmap_item(self, both_stores):
        ds = rec.RecommendationDataSource(
            rec.DataSourceParams(appName=APP, eventWindow={"duration": "3 days"})
        )
        with pytest.raises(NotImplementedError, match="item 11"):
            ds.read_training(None)
        with pytest.raises(NotImplementedError, match="item 11"):
            ds.read_eval(None)


class TestExcludeItemsPreparator:
    @pytest.mark.parametrize("drop", (["i0", "i3", "nope"], ["i1"], [], ["zzz"]))
    def test_matches_jax(self, both_stores, tmp_path, drop):
        path = tmp_path / "no_train.txt"
        path.write_text("\n".join(drop + [""]))
        params = dict(appName=APP)
        got_td = rec.RecommendationDataSource(rec.DataSourceParams(**params)).read_training(None)
        ref_td = jax_rec.RecommendationDataSource(
            jax_rec.DataSourceParams(**params)
        ).read_training(None)
        got = rec.ExcludeItemsPreparator(rec.PreparatorParams(str(path))).prepare(None, got_td)
        ref = jax_rec.ExcludeItemsPreparator(
            jax_rec.PreparatorParams(str(path))
        ).prepare(None, ref_td)
        _assert_same_interactions(got.interactions, ref.interactions)
        if set(drop) & set(ref_td.interactions.item_map.keys()):
            assert len(got.interactions.item_map) < len(got_td.interactions.item_map)
        ident = rec.ExcludeItemsPreparator(rec.PreparatorParams()).prepare(None, got_td)
        assert ident is got_td

    def test_drop_items_drops_users_left_without_rows(self):
        inter = interactions_from_arrays(
            [0, 0, 1, 2], [0, 1, 1, 2], [1, 2, 3, 4], [0, 0, 0, 0],
            ["a", "b", "c"], ["x", "y", "z"],
        )
        out = inter.drop_items(np.array([1]))
        assert out.item_map.to_dict() == {"x": 0, "z": 1}
        assert out.user_map.to_dict() == {"a": 0, "c": 1}
        np.testing.assert_array_equal(out.user, [0, 1])
        np.testing.assert_array_equal(out.rating, [1, 4])
