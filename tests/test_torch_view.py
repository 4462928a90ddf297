"""The port's DataView (``data/view.py``), ``EventBatch.to_dataframe`` and
``LazyJsonProperties``, held against the JAX package's on the same events.

Both packages open ONE store: the metadata on a shared sqlite file and the
events either on a shared parquet directory (the port writes it, both
read it) or, for ``memory``, the same seeded events in each package's own
memory source. ``view.create`` (the default flat columns, a conversion, a
time window, the cache and its key), ``sql``/``events_sql`` and
``to_dataframe`` give DataFrames equal to the JAX package's
(``pandas.testing.assert_frame_equal``); the error cases raise alike.
"""

import datetime as dt
import json
import uuid

import numpy as np
import pandas as pd
import pytest

from predictionio_tpu.data import batch as jax_batch
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data import view as jax_view
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu_torch.data import batch as port_batch
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data import view as port_view
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import memory as port_memory
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 2, 1, tzinfo=UTC)
APP = "viewapp"


def seed_events(E):
    out = []
    for u in range(4):
        for i in range(u + 1):
            out.append(E(event="rate", entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{i}",
                         properties={"rating": float(i + 1), "note": "é"},
                         event_time=T0 + dt.timedelta(minutes=u),
                         event_id=f"r{u}-{i}", creation_time=T0 + dt.timedelta(hours=u, seconds=i)))
    out.append(E(event="$set", entity_type="user", entity_id="u0", properties={"vip": True},
                 event_time=T0, event_id="s0", creation_time=T0))
    return out


@pytest.fixture(params=["parquet", "memory"])
def bound(request, tmp_path):
    """(port storage, JAX storage) bound as each package's ambient store,
    holding the same app and events."""
    name = "V" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}DB_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{name}DB_PATH": str(tmp_path / "meta.sqlite"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name + "DB",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name + "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name}
    if request.param == "parquet":
        env.update({f"PIO_STORAGE_SOURCES_{name}_TYPE": "parquet",
                    f"PIO_STORAGE_SOURCES_{name}_PATH": str(tmp_path / "events")})
    else:
        env[f"PIO_STORAGE_SOURCES_{name}_TYPE"] = "memory"
    port, jax = Storage(env=env), JaxStorage(env=env)
    app_id = port.get_meta_data_apps().insert(App(0, APP))
    port.get_l_events().insert_batch(seed_events(Event), app_id)
    if request.param == "memory":
        jax.get_l_events().insert_batch(seed_events(JaxEvent), app_id)
    port_store.set_storage(port)
    jax_store.set_storage(jax)
    try:
        yield port, jax, app_id
    finally:
        port_store.set_storage(None)
        jax_store.set_storage(None)
        port_memory.reset_store(name)
        jax_memory.reset_store(name)
        port_sqlite.close_all_dbs()
        jax_sqlite.close_all_dbs()


def _eq(a, b):
    pd.testing.assert_frame_equal(a, b)


CONVERSIONS = {
    "default": None,
    "rates": lambda e: {"u": e.entity_id, "i": e.target_entity_id,
                        "r": e.properties.get("rating")} if e.event == "rate" else None,
    "events": lambda e: {"e": e.event, "t": e.event_time.timestamp()},
}


@pytest.mark.parametrize("conv", sorted(CONVERSIONS))
def test_create_equals_jax(bound, conv):
    c = CONVERSIONS[conv]
    _eq(port_view.create(APP, conversion=c), jax_view.create(APP, conversion=c))
    window = dict(start_time=T0 + dt.timedelta(minutes=2),
                  until_time=T0 + dt.timedelta(minutes=3, seconds=30), cache=False)
    got, want = port_view.create(APP, conversion=c, **window), jax_view.create(
        APP, conversion=c, **window)
    _eq(got, want)
    assert len(got) == 7  # u2's three rates at minute 2, u3's four at minute 3


def test_default_view_has_the_jax_columns(bound):
    df = port_view.create(APP)
    assert len(df) == 11 and list(df.columns) == list(jax_view._DEFAULT_COLUMNS)
    assert set(df["entityId"]) == {"u0", "u1", "u2", "u3"}


def test_cache_roundtrip_and_key_equal_jax(bound, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    until = T0 + dt.timedelta(hours=1)
    conv = lambda e: {"e": e.event}  # noqa: E731
    df1 = port_view.create(APP, until_time=until, conversion=conv, name="v")
    cached = sorted(p.name for p in (tmp_path / "base" / "view").glob("*.parquet"))
    assert len(cached) == 1
    # the JAX view reads the port's cache file: one key for both packages
    jax_store.set_storage(None)
    _eq(jax_view.create(APP, until_time=until, conversion=conv, name="v"), df1)
    port_store.set_storage(None)  # the second port call must come from the cache
    _eq(port_view.create(APP, until_time=until, conversion=conv, name="v"), df1)
    assert sorted(p.name for p in (tmp_path / "base" / "view").glob("*.parquet")) == cached


def test_unbounded_and_future_windows_are_not_cached(bound, tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.event import utcnow

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    port_view.create(APP)
    port_view.create(APP, until_time=utcnow() + dt.timedelta(days=1))
    assert not (tmp_path / "base" / "view").exists()


@pytest.mark.parametrize("fn", [
    lambda e: {"u": e.entity_id}, lambda e: {"u": e.target_entity_id},
    lambda e: {"k": [x for x in (1, 2)], "f": (lambda y: y + 1)(2)}, len, None,
])
def test_conversion_hash_equals_jax(fn):
    assert port_view._conversion_hash(fn) == jax_view._conversion_hash(fn)


def test_empty_app_default_view_has_columns(bound):
    port, jax, _ = bound
    port.get_meta_data_apps().insert(App(0, "emptyapp"))
    q = "SELECT COUNT(*) AS n FROM events"
    _eq(port_view.events_sql("emptyapp", q), jax_view.events_sql("emptyapp", q))
    assert list(port_view.events_sql("emptyapp", q)["n"]) == [0]


@pytest.mark.parametrize("query", [
    "SELECT u, COUNT(*) AS n FROM rates GROUP BY u ORDER BY n DESC",
    "SELECT title, COUNT(*) AS n FROM rates JOIN names USING (i) GROUP BY title ORDER BY title",
])
def test_sql_equals_jax(bound, query):
    names = pd.DataFrame({"i": ["i0", "i1"], "title": ["zero", "one"]})
    conv = CONVERSIONS["rates"]
    got = port_view.sql(query, rates=port_view.create(APP, conversion=conv), names=names)
    want = jax_view.sql(query, rates=jax_view.create(APP, conversion=conv), names=names)
    _eq(got, want)
    assert len(got) > 1


def test_events_sql_equals_jax(bound):
    q = "SELECT event, COUNT(*) AS n, SUM(eventTime) AS t FROM events GROUP BY event ORDER BY event"
    got = port_view.events_sql(APP, q)
    _eq(got, jax_view.events_sql(APP, q))
    assert list(got["event"]) == ["$set", "rate"] and list(got["n"]) == [1, 10]


@pytest.mark.parametrize("call,exc,match", [
    (lambda v: v.sql("SELECT 1"), ValueError, "at least one"),
    (lambda v: v.sql("SELECT * FROM views", pd.DataFrame({"x": [1]})), TypeError, "views"),
    (lambda v: v.sql("SELECT * FROM views", [1]), TypeError, "mapping"),
    (lambda v: v.sql("SELECT * FROM t", t=pd.DataFrame()), ValueError, "no columns"),
])
def test_sql_errors_equal_jax(call, exc, match):
    for v in (port_view, jax_view):
        with pytest.raises(exc, match=match):
            call(v)


def test_to_dataframe_equals_jax(bound):
    port, jax, app_id = bound
    got = port.get_p_events().find(app_id).to_dataframe()
    want = jax.get_p_events().find(app_id).to_dataframe()
    got_props = [dict(p) for p in got.pop("properties")]
    want_props = [dict(p) for p in want.pop("properties")]
    _eq(got, want)
    assert got_props == want_props and len(got) == 11


def test_lazy_json_properties_equal_jax():
    raw = np.array([json.dumps({"a": k, "b": "é" * k}) for k in range(6)] + [""], dtype=object)
    got, want = port_batch.LazyJsonProperties(raw), jax_batch.LazyJsonProperties(raw)
    assert len(got) == len(want) == 7
    assert [got[k] for k in range(7)] == [want[k] for k in range(7)]
    assert got[1:5] == want[1:5] and got[6] == {} == want[6]
    # decode never caches; item access does
    fresh = port_batch.LazyJsonProperties(raw)
    assert fresh.decode(3) == want.decode(3) and fresh._cache == {}
    fresh[3]["mutated"] = True
    assert fresh[3]["mutated"] and "mutated" not in fresh.decode(3)
    idx = np.array([5, 0, 2])
    assert list(got.subset(idx)) == list(want.subset(idx))
    assert isinstance(got.subset(idx), port_batch.LazyJsonProperties)


def test_promoted_columns_serve_property_column_without_json():
    raw = np.array(['{"r": 9.0}', '{"r": 8.0}', "{}"], dtype=object)
    kw = dict(event=np.array(["rate"] * 3, object), entity_type=np.array(["user"] * 3, object),
              entity_id=np.array(["u1", "u2", "u3"], object),
              target_entity_type=np.array(["item", None, "item"], object),
              target_entity_id=np.array(["i1", None, "i2"], object),
              event_time=np.arange(3.0))
    num = {"r": np.array([1.0, np.nan, 3.0])}
    got = port_batch.EventBatch(properties=port_batch.LazyJsonProperties(raw),
                                numeric_properties=num, **kw)
    want = jax_batch.EventBatch(properties=jax_batch.LazyJsonProperties(raw),
                                numeric_properties=num, **kw)
    # the promoted column wins over the JSON (the storage's own promise)
    assert got.property_column("r", 7.0).tolist() == want.property_column("r", 7.0).tolist() == [
        1.0, 7.0, 3.0]
    sel = np.array([True, False, True])
    assert got.select(sel).numeric_properties["r"].tolist() == [1.0, 3.0]
    gi, wi = got.interactions(rating_key="r"), want.interactions(rating_key="r")
    assert gi.rating.tolist() == wi.rating.tolist() == [1.0, 3.0]
    assert [e.properties.to_dict() for e in got] == [e.properties.to_dict() for e in want]
