"""The port's self-cleaning data source (``core/self_cleaning.py``) against
the JAX package's, on the same events in each package's MEMORY and sqlite
stores.

* ``tests/test_maintenance.py::TestSelfCleaning``'s cases on the port: the
  window drops old regular events but never property events, ``$set``/
  ``$unset`` streams compress into one snapshot, duplicates go.
* The same events cleaned by both packages leave the same events (compared
  by content: event ids differ between stores) and the same
  ``{"before", "after"}`` counts, for every combination of the options.
* ``RecommendationDataSource`` with an ``eventWindow`` cleans before its read
  and reads the same triples as the JAX one.
"""

import datetime as dt
import uuid

import numpy as np
import pytest

from predictionio_tpu.core import self_cleaning as jax_sc
from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core.self_cleaning import (
    EventWindow,
    clean_persisted_events,
    parse_duration,
)
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.event import Event, utcnow
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as rec

NOW = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def storage():
    name = "S" + uuid.uuid4().hex[:8].upper()
    return Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"})


def ev(event, eid, t_offset_s=0, props=None, target=None):
    return Event(event=event, entity_type="user", entity_id=eid,
                 target_entity_type="item" if target else None, target_entity_id=target,
                 properties=props or {},
                 event_time=utcnow() - dt.timedelta(seconds=-t_offset_s))


class TestSelfCleaning:
    def test_compress_dedup_window(self, storage):
        le = storage.get_l_events()
        le.init(5)
        le.insert(Event(event="buy", entity_type="user", entity_id="u1",
                        target_entity_type="item", target_entity_id="i1",
                        event_time=utcnow() - dt.timedelta(days=10)), 5)
        le.insert(ev("$set", "u1", props={"a": 1}), 5)
        le.insert(ev("$set", "u1", props={"b": 2}), 5)
        le.insert(ev("$unset", "u1", props={"a": 0}), 5)
        base_t = utcnow()
        for _ in range(3):
            le.insert(Event(event="view", entity_type="user", entity_id="u2",
                            target_entity_type="item", target_entity_id="i2",
                            event_time=base_t), 5)
        stats = clean_persisted_events(
            storage, 5, EventWindow(duration="7 days", remove_duplicates=True,
                                    compress_properties=True))
        assert stats["before"] == 7
        events = list(le.find(5))
        assert stats["after"] == len(events) == 2
        sets = [e for e in events if e.event == "$set"]
        assert len(sets) == 1 and sets[0].properties.to_dict() == {"b": 2}
        assert len([e for e in events if e.event == "view"]) == 1

    def test_old_property_events_exempt_from_window(self, storage):
        le = storage.get_l_events()
        le.init(6)
        le.insert(Event(event="$set", entity_type="user", entity_id="u1",
                        properties={"plan": "pro"},
                        event_time=utcnow() - dt.timedelta(days=30)), 6)
        clean_persisted_events(storage, 6, EventWindow(duration="7 days"))
        assert le.aggregate_properties(6, "user")["u1"].to_dict() == {"plan": "pro"}

    def test_parse_duration(self):
        assert parse_duration(90) == 90
        assert parse_duration("2 days") == 172800
        assert parse_duration("1 hour") == 3600
        with pytest.raises(ValueError):
            parse_duration("fortnight")


def mixed_events(seed=0):
    """Regular events over 20 days (with exact duplicates) and property
    churn ($set/$unset/$delete) on users and items."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(160):
        t = NOW - dt.timedelta(days=float(rng.uniform(0, 20)))
        kind = rng.choice(["rate", "buy", "view", "set", "unset", "delete", "dup"])
        u, i = f"u{rng.integers(8)}", f"i{rng.integers(6)}"
        if kind in ("rate", "buy", "view"):
            props = {"rating": float(rng.integers(1, 6))} if kind == "rate" else {}
            out.append(dict(event=kind, entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties=props, event_time=t))
        elif kind == "dup" and out:
            out.append(dict(out[-1]))
        elif kind == "set":
            et = rng.choice(["user", "item"])
            out.append(dict(event="$set", entity_type=et, entity_id=u if et == "user" else i,
                            properties={"k": int(rng.integers(3)), f"p{rng.integers(3)}": 1},
                            event_time=t))
        elif kind == "unset":
            out.append(dict(event="$unset", entity_type="user", entity_id=u,
                            properties={"k": 0}, event_time=t))
        elif kind == "delete":
            out.append(dict(event="$delete", entity_type="item", entity_id=i, event_time=t))
    return out


def content(events):
    return sorted(
        (e.event, e.entity_type, e.entity_id, e.target_entity_type or "",
         e.target_entity_id or "", repr(sorted(e.properties.to_dict().items())),
         e.event_time.timestamp())
        for e in events)


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("window", [
    dict(duration="7 days"),
    dict(duration=86400 * 12, remove_duplicates=True),
    dict(compress_properties=True),
    dict(duration="10 days", remove_duplicates=True, compress_properties=True),
])
def test_cleaning_leaves_what_the_jax_package_leaves(tmp_path, kind, window):
    name = "C" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": kind}
    if kind == "sqlite":
        env[f"PIO_STORAGE_SOURCES_{name}_PATH"] = str(tmp_path / "port.db")
    jenv = dict(env)
    if kind == "sqlite":
        jenv[f"PIO_STORAGE_SOURCES_{name}_PATH"] = str(tmp_path / "jax.db")
    port, ref = Storage(env=env), JaxStorage(env=jenv)
    events = mixed_events()
    try:
        for s, ev_mod in ((port, port_event), (ref, jax_event)):
            s.get_l_events().init(3)
            s.get_l_events().insert_batch([ev_mod.Event(**d) for d in events], 3)
        got = clean_persisted_events(port, 3, EventWindow(**window), now=NOW)
        want = jax_sc.clean_persisted_events(ref, 3, jax_sc.EventWindow(**window), now=NOW)
        assert got == want and got["after"] < got["before"]
        assert content(port.get_l_events().find(3)) == content(ref.get_l_events().find(3))
        for et in ("user", "item"):
            a = port.get_l_events().aggregate_properties(3, et)
            b = ref.get_l_events().aggregate_properties(3, et)
            assert {k: v.to_dict() for k, v in a.items()} == {k: v.to_dict() for k, v in b.items()}
    finally:
        port_sqlite.close_all_dbs()


def test_recommendation_data_source_cleans_before_reading():
    name = "R" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    now = utcnow()
    events = [dict(d, event_time=now - (NOW - d["event_time"])) for d in mixed_events(1)]
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, "CleanApp"))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in events], app_id)
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    try:
        params = dict(appName="CleanApp", eventWindow={"duration": "5 days",
                                                       "removeDuplicates": True})
        td = rec.RecommendationDataSource(rec.DataSourceParams(**params)).read_training(None)
        jtd = jax_rec.RecommendationDataSource(
            jax_rec.DataSourceParams(**params)).read_training(None)
        assert 0 < len(td.interactions) < sum(e["event"] in ("rate", "buy") for e in events)
        for col in ("user", "item", "rating"):
            np.testing.assert_array_equal(np.sort(getattr(td.interactions, col)),
                                          np.sort(getattr(jtd.interactions, col)))
        assert sorted(td.interactions.item_map.keys()) == sorted(jtd.interactions.item_map.keys())
    finally:
        port_store.set_storage(None)
        jax_store.set_storage(None)
