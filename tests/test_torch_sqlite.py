"""The port's sqlite store against the JAX package's, on the CPU.

* Every DAO of ``predictionio_tpu_torch.data.storage.sqlite`` answers the
  same operation sequence as its JAX counterpart, each on its own file:
  apps, access keys, channels, events (insert, get, delete, ``find`` with
  each filter, ``reversed`` and ``limit``, the order of equal times),
  ``find_interactions``' arrays and id maps, engine instances, models and
  sequences.
* One schema: a ``pio.db`` written by either package is read by the other
  (events compared by content, since each package draws its own ids).
* Two processes against one file: concurrent writers lose nothing and
  draw no sequence value twice.
* The zero-config default: no ``PIO_STORAGE_SOURCES_*`` means source
  ``DEFAULT``, type sqlite, ``default.sqlite`` under ``PIO_FS_BASEDIR``.
* What waits for a later ROADMAP item raises naming it.
"""

import dataclasses
import datetime as dt
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_767_225_600.0
PACKAGES = {"port": (port_event, port_base, Storage), "jax": (jax_event, jax_base, JaxStorage)}


def _env(path):
    name = "SQ" + uuid.uuid4().hex[:8].upper()
    return {f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
            f"PIO_STORAGE_SOURCES_{name}_PATH": str(path)}


@pytest.fixture()
def pair(tmp_path):
    """One Storage per package, each on its own sqlite file."""
    stores = {k: PACKAGES[k][2](env=_env(tmp_path / f"{k}.db")) for k in PACKAGES}
    yield stores
    port_sqlite.close_all_dbs()
    jax_sqlite.close_all_dbs()


def _event_dicts(n=60, seed=0):
    """Rate/buy/view events with pinned ids, some sharing one event time,
    one with no target (a $set)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        name = ("rate", "buy", "view")[k % 3]
        d = dict(event=name, entity_type="user", entity_id=f"u{int(rng.integers(6))}",
                 target_entity_type="item", target_entity_id=f"i{int(rng.integers(9))}",
                 event_time=T0 + (k // 2), creation_time=T0 + k, event_id=f"e{k:03d}")
        if name == "rate":
            d["properties"] = {"rating": float(rng.integers(1, 6)), "note": "ü"}
        out.append(d)
    out.append(dict(event="$set", entity_type="user", entity_id="u1",
                    properties={"age": 30}, event_time=T0 + 7, creation_time=T0,
                    event_id="eset"))
    return out


def _load(stores, dicts, app_name="A"):
    ids = {}
    for k, s in stores.items():
        ev, b, _ = PACKAGES[k]
        app_id = s.get_meta_data_apps().insert(b.App(0, app_name))
        s.get_l_events().insert_batch([ev.Event(**d) for d in dicts], app_id)
        ids[k] = app_id
    assert ids["port"] == ids["jax"]
    return ids["port"]


def _same(fn):
    """Run ``fn(storage, package)`` on both and require equal results."""
    def run(stores):
        got = {k: fn(s, PACKAGES[k]) for k, s in stores.items()}
        assert got["port"] == got["jax"], got
        return got["port"]
    return run


def _dicts(events):
    return [e.to_dict() for e in events]


class TestDaosMatchJax:
    def test_apps(self, pair):
        def ops(s, pkg):
            _, b, _ = pkg
            apps = s.get_meta_data_apps()
            out = [apps.insert(b.App(0, "a", "first")), apps.insert(b.App(0, "b")),
                   apps.insert(b.App(0, "a")), apps.insert(b.App(7, "c"))]
            out.append(apps.update(b.App(2, "bb", "renamed")))
            out.append(apps.update(b.App(99, "x")))
            out.append(apps.delete(1))
            out.append(apps.delete(1))
            out.append([dataclasses.asdict(a) for a in apps.get_all()])
            out.append(apps.get(2) and dataclasses.asdict(apps.get(2)))
            out.append(apps.get_by_name("c") and dataclasses.asdict(apps.get_by_name("c")))
            out.append(apps.get(1))
            return out
        _same(ops)(pair)

    def test_access_keys_and_channels(self, pair):
        def ops(s, pkg):
            _, b, _ = pkg
            keys, chans = s.get_meta_data_access_keys(), s.get_meta_data_channels()
            out = [keys.insert(b.AccessKey("k1", 1, [])), keys.insert(b.AccessKey("k2", 1, ["rate"])),
                   keys.insert(b.AccessKey("k1", 2, [])), keys.insert(b.AccessKey("k3", 2, ["a", "b"]))]
            generated = keys.insert(b.AccessKey("", 3, []))
            out.append(len(generated) > 40 and generated[0] not in "-_")
            out.append(keys.update(b.AccessKey("k2", 1, ["rate", "buy"])))
            out.append(keys.delete("k3"))
            out.append(keys.delete("k3"))
            out.append(sorted(dataclasses.asdict(k)["key"] for k in keys.get_all()
                              if k.key != generated))
            out.append([dataclasses.asdict(k) for k in keys.get_by_app_id(1)])
            out.append(dataclasses.asdict(keys.get("k2")))
            out.append(keys.get("nope"))
            out += [chans.insert(b.Channel(0, "web", 1)), chans.insert(b.Channel(0, "bad name", 1)),
                    chans.insert(b.Channel(0, "x" * 17, 1)), chans.insert(b.Channel(5, "app", 1)),
                    chans.insert(b.Channel(5, "dup", 1)), chans.insert(b.Channel(0, "m", 2))]
            out.append([dataclasses.asdict(c) for c in chans.get_by_app_id(1)])
            out.append(chans.delete(5))
            out.append(chans.delete(5))
            out.append(chans.get(1) and dataclasses.asdict(chans.get(1)))
            return out
        _same(ops)(pair)

    def test_event_crud(self, pair):
        app_id = _load(pair, _event_dicts())

        def ops(s, pkg):
            ev, _, _ = pkg
            le = s.get_l_events()
            out = [le.get("e004", app_id).to_dict(), le.get("e004", app_id, 3),
                   le.delete("e004", app_id), le.delete("e004", app_id),
                   le.get("e004", app_id)]
            out.append(le.insert(ev.Event(event="rate", entity_type="user", entity_id="u9",
                                          target_entity_type="item", target_entity_id="i1",
                                          event_time=T0, creation_time=T0, event_id="x1"),
                                 app_id, 4))
            out.append(_dicts(le.find(app_id, 4)))
            out.append(le.batch_insert([ev.Event(event="v", entity_type="user", entity_id="a",
                                                 event_id="x2")], app_id, 4))
            out.append(le.remove(app_id, 4))
            out.append(_dicts(le.find(app_id, 4)))
            out.append(le.insert_batch([], app_id))
            out.append(len(list(le.find(app_id))))
            return out
        _same(ops)(pair)

    @pytest.mark.parametrize("filters", [
        {},
        {"start_time": dt.datetime.fromtimestamp(T0 + 5, dt.timezone.utc)},
        {"until_time": dt.datetime.fromtimestamp(T0 + 9, dt.timezone.utc)},
        # a naive filter time is UTC, never local
        {"start_time": dt.datetime(2026, 1, 1, 0, 0, 3), "until_time": dt.datetime(2026, 1, 1, 0, 0, 20)},
        {"entity_type": "user", "entity_id": "u2"},
        {"event_names": ["rate", "buy"]},
        {"event_names": []},
        {"target_entity_type": "item", "target_entity_id": "i3"},
        {"target_entity_type": "None"},
        {"target_entity_id": "None"},
        {"limit": 7},
        {"limit": 0},
        {"limit": -1},
        {"reversed": True},
        {"entity_type": "user", "entity_id": "u1", "reversed": True, "limit": 5},
    ], ids=lambda f: "-".join(sorted(f)) or "all")
    def test_event_find(self, pair, filters):
        app_id = _load(pair, _event_dicts())
        got = _same(lambda s, pkg: _dicts(s.get_l_events().find(app_id, **filters)))(pair)
        if not filters:
            assert len(got) == 61
        batch = _same(lambda s, pkg: [
            list(getattr(s.get_p_events().find(app_id, **{
                k: v for k, v in filters.items() if k not in ("limit", "reversed")}), c))
            for c in ("event", "entity_id", "target_entity_id", "event_time")])(pair)
        assert len(batch[0]) >= len(got) or "limit" in filters

    @pytest.mark.parametrize("read", [
        dict(entity_type="user", event_names=["rate"], target_entity_type="item",
             rating_key="rating"),
        dict(entity_type="user", event_names=["buy", "view"], target_entity_type="item",
             default_rating=4.0),
    ])
    def test_find_interactions(self, pair, read):
        app_id = _load(pair, _event_dicts(n=300, seed=3))

        def ops(s, pkg):
            inter = s.get_p_events().find_interactions(app_id, **read)
            return ([a.tolist() for a in (inter.user, inter.item, inter.rating, inter.t)]
                    + [[m.inverse[k] for k in range(len(m))] for m in (inter.user_map, inter.item_map)]
                    + [str(a.dtype) for a in (inter.user, inter.item, inter.rating, inter.t)])
        got = _same(ops)(pair)
        assert len(got[0]) > 0

    def test_p_events_write_and_delete(self, pair):
        app_id = _load(pair, _event_dicts())

        def ops(s, pkg):
            ev, _, _ = pkg
            pe = s.get_p_events()
            pe.write([ev.Event(event="w", entity_type="user", entity_id=f"w{k}", event_id=f"w{k}",
                               event_time=T0 + k, creation_time=T0) for k in range(5)], app_id, 2)
            pe.delete(["w1", "w3", "nope"], app_id, 2)
            return list(pe.find(app_id, 2).entity_id)
        assert _same(ops)(pair) == ["w0", "w2", "w4"]

    def test_engine_instances_models_sequences(self, pair):
        def inst(b, iid, status, start, variant="default"):
            t = dt.datetime.fromtimestamp(T0 + start, dt.timezone.utc)
            return b.EngineInstance(
                id=iid, status=status, start_time=t, end_time=t, engine_id="eng",
                engine_version="1", engine_variant=variant, engine_factory="f.F", batch="b",
                env={"A": "1"}, mesh_conf={"m": 2}, data_source_params='{"appName": "A"}',
                preparator_params="{}", algorithms_params="[]", serving_params="{}")

        def ops(s, pkg):
            _, b, _ = pkg
            ei, models, seqs = (s.get_meta_data_engine_instances(), s.get_model_data_models(),
                                s.get_meta_data_sequences())
            out = [ei.insert(inst(b, "i1", "COMPLETED", 1)), ei.insert(inst(b, "i2", "COMPLETED", 5)),
                   ei.insert(inst(b, "i3", "TRAINING", 9)), ei.insert(inst(b, "i4", "COMPLETED", 7, "v2"))]
            generated = ei.insert(inst(b, "", "INIT", 0))
            out.append(len(generated))
            out.append([i.id for i in ei.get_completed("eng", "1", "default")])
            out.append(ei.get_latest_completed("eng", "1", "default").id)
            out.append(ei.get_latest_completed("eng", "1", "nope"))
            up = inst(b, "i3", "COMPLETED", 9)
            out.append(ei.update(up))
            out.append(ei.update(inst(b, "zz", "COMPLETED", 9)))
            out.append(dataclasses.asdict(ei.get_latest_completed("eng", "1", "default")))
            out.append(ei.delete("i3"))
            out.append(ei.delete("i3"))
            out.append(sorted(i.id for i in ei.get_all() if i.id != generated))
            out.append(ei.get("nope"))
            models.insert(b.Model("m1", b"\x00blob"))
            models.insert(b.Model("m1", b"\x01new"))
            out.append(dataclasses.asdict(models.get("m1")))
            models.delete("m1")
            out.append(models.get("m1"))
            out.append([seqs.gen_next("a"), seqs.gen_next("a"), seqs.gen_next("b"), seqs.gen_next("a")])
            return out
        _same(ops)(pair)


def _write_everything(storage, pkg):
    """Apps, keys, a channel, events in two namespaces, an instance, a model."""
    ev, b, _ = pkg
    app_id = storage.get_meta_data_apps().insert(b.App(0, "Shared", "one file"))
    storage.get_meta_data_access_keys().insert(b.AccessKey("key-1", app_id, ["rate"]))
    cid = storage.get_meta_data_channels().insert(b.Channel(0, "web", app_id))
    le = storage.get_l_events()
    dicts = [{k: v for k, v in d.items() if k != "event_id"} for d in _event_dicts(n=40)]
    le.insert_batch([ev.Event(**d) for d in dicts], app_id)
    le.insert_batch([ev.Event(**d) for d in dicts[:5]], app_id, cid)
    t = dt.datetime.fromtimestamp(T0, dt.timezone.utc)
    storage.get_meta_data_engine_instances().insert(b.EngineInstance(
        id="inst", status="COMPLETED", start_time=t, end_time=t, engine_id="e",
        engine_version="v", engine_variant="default", engine_factory="f.F"))
    storage.get_model_data_models().insert(b.Model("inst", b"sealed"))
    return app_id, cid


def _read_everything(storage, app_id, cid):
    def content(events):
        return sorted(
            ({k: v for k, v in e.to_dict().items() if k != "eventId"} for e in events),
            key=lambda d: (d["eventTime"], d["creationTime"], d["entityId"]))
    return {
        "app": dataclasses.asdict(storage.get_meta_data_apps().get_by_name("Shared")),
        "key": dataclasses.asdict(storage.get_meta_data_access_keys().get("key-1")),
        "channels": [dataclasses.asdict(c)
                     for c in storage.get_meta_data_channels().get_by_app_id(app_id)],
        "events": content(storage.get_l_events().find(app_id)),
        "channel_events": content(storage.get_l_events().find(app_id, cid)),
        "instance": dataclasses.asdict(
            storage.get_meta_data_engine_instances().get_latest_completed("e", "v", "default")),
        "model": storage.get_model_data_models().get("inst").models,
    }


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_file_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    env = _env(tmp_path / "pio.db")
    src = PACKAGES[writer][2](env=env)
    app_id, cid = _write_everything(src, PACKAGES[writer])
    want = _read_everything(src, app_id, cid)
    (port_sqlite if writer == "port" else jax_sqlite).close_all_dbs()
    got = _read_everything(PACKAGES[reader][2](env=env), app_id, cid)
    port_sqlite.close_all_dbs()
    jax_sqlite.close_all_dbs()
    assert len(got["events"]) == 41 and len(got["channel_events"]) == 5
    assert got == want


def test_schemas_are_identical():
    assert port_sqlite._SCHEMA == jax_sqlite._SCHEMA


_WRITER = """
import sys
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage
path, tag = sys.argv[1], sys.argv[2]
s = Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": "sqlite", "PIO_STORAGE_SOURCES_X_PATH": path})
le, seq = s.get_l_events(), s.get_meta_data_sequences()
values = []
for b in range(10):
    le.insert_batch([Event(event="view", entity_type="user", entity_id=f"{tag}{b}-{k}")
                     for k in range(20)], 1)
    values.append(seq.gen_next("shared"))
print(" ".join(map(str, values)))
"""


def test_two_processes_share_one_file(tmp_path):
    path = str(tmp_path / "shared.db")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, path, tag], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for tag in ("a", "b")]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    values = [int(v) for out, _ in outs for v in out.split()]
    assert sorted(values) == list(range(1, 21))
    s = Storage(env={"PIO_STORAGE_SOURCES_Y_TYPE": "sqlite", "PIO_STORAGE_SOURCES_Y_PATH": path})
    ids = [e.entity_id for e in s.get_l_events().find(1)]
    port_sqlite.close_all_dbs()
    assert len(ids) == len(set(ids)) == 400


def test_zero_config_default_is_sqlite_under_the_base_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    port, ref = Storage(env={}), JaxStorage(env={})
    assert port.repository_bindings() == ref.repository_bindings() == {
        r: ("DEFAULT", "sqlite") for r in ("METADATA", "EVENTDATA", "MODELDATA")}
    assert isinstance(port.get_meta_data_apps(), port_sqlite.SqliteApps)
    assert port.verify_all_data_objects() and ref.verify_all_data_objects()
    app_id = port.get_meta_data_apps().insert(port_base.App(0, "Zero"))
    assert (tmp_path / "default.sqlite").exists()
    assert ref.get_meta_data_apps().get(app_id).name == "Zero"
    port_sqlite.close_all_dbs()
    jax_sqlite.close_all_dbs()


def test_waiting_parts_name_their_roadmap_item(tmp_path):
    s = Storage(env=_env(tmp_path / "w.db"))
    # the sharded read is ported (tests/test_torch_sharded_ingest.py holds it
    # against the JAX package's sqlite store): on an empty app every shard is empty
    for key in ("row", "entity", "target"):
        assert len(s.get_p_events().find(1, shard=(1, 2), shard_key=key)) == 0
    assert len(s.get_p_events().find(1, shard=(0, 1))) == 0  # one shard is the whole read
    # free-text search is ported (tests/test_torch_storage_conformance.py
    # holds it against the JAX sqlite driver): nothing matches an empty app
    assert s.get_l_events().search(1, "x") == []
    # evaluation instances are ported: a round trip on the JAX schema
    ev = s.get_meta_data_evaluation_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    rec = port_base.EvaluationInstance(id="", status=ev.STATUS_INIT, start_time=now, end_time=now,
                                  evaluation_class="E", env={"a": "1"})
    iid = ev.insert(rec)
    rec.status, rec.evaluator_results_json = ev.STATUS_COMPLETED, '{"bestScore": 1}'
    assert ev.update(rec) and ev.get(iid) == rec
    assert [i.id for i in ev.get_completed()] == [iid] and ev.delete(iid) and ev.get(iid) is None
    port_sqlite.close_all_dbs()


def test_close_db_evicts_and_reopens(tmp_path):
    path = str(tmp_path / "c.db")
    db = port_sqlite.get_db(path)
    assert port_sqlite.get_db(path) is db
    port_sqlite.close_db(path)
    again = port_sqlite.get_db(path)
    assert again is not db
    port_sqlite.close_db(db)  # a stale handle leaves the live one alone
    assert port_sqlite.get_db(path) is again
    port_sqlite.close_db(again)
    # closing checkpoints the WAL into the file
    assert not os.path.exists(path + "-wal") or os.path.getsize(path + "-wal") == 0


@pytest.mark.parametrize("filters", [
    {"entity_type": "user", "entity_id": "u1"},
    {"entity_type": "user", "entity_id": "u2", "event_names": ["buy", "view"],
     "target_entity_type": "item", "limit": 3, "reversed": True},
    {"entity_id": "u3", "limit": 0},
], ids=lambda f: "-".join(sorted(f)))
def test_one_entitys_rows_come_from_the_entity_index(pair, filters, monkeypatch):
    """A read of one entity's rows (a template's live history or seen-set)
    walks ``idx_events_entity``, not the whole app in time order, and
    returns what the JAX package's sqlite DAO returns."""
    app_id = _load(pair, _event_dicts(n=300, seed=5))
    le = pair["port"].get_l_events()
    ran = []
    real = le._all
    monkeypatch.setattr(le, "_all", lambda sql, params=(): ran.append((sql, params)) or real(sql, params))
    got = _dicts(le.find(app_id, **filters))
    monkeypatch.undo()
    want = _dicts(pair["jax"].get_l_events().find(app_id, **filters))
    assert got == want and (filters.get("limit") == 0 or got)
    sql, params = ran[-1]
    plan = le.conn.execute(f"EXPLAIN QUERY PLAN {sql}", params).fetchall()
    assert any("idx_events_entity" in str(row) for row in plan), plan
