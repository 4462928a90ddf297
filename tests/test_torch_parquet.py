"""The port's columnar event store (``data/storage/parquet.py``) held
against the JAX package's parquet driver on the same seeded events.

* Each package reads the other's stores: parts, WALs, deletes, compaction
  (by either package), promoted and mixed-promotion parts; rows, columnar
  batches and promoted columns agree.
* The JAX ``_part_time_range`` prunes port-written parts (their DOUBLE
  statistics), and the port prunes JAX-written ones.
* ``find_interactions`` is bit-equal with equal ``BiMap`` order, with and
  without ``rating_key``, under every ``shard_key``, over several parts.
* The committed store the JAX driver wrote with pyarrow
  (``tests/torch_data/jax_parquet_store``: several row groups, a
  dictionary→PLAIN fallback, a Null column, a WAL) reads equal to its
  ``.npz``.
* The cases of ``tests/test_maintenance.py`` (compaction, promotion) and
  ``tests/test_parquet_scale.py`` (time pruning, two writer processes on
  one directory — here one of each package) on the port.
* ``native.scan_numeric_props`` gives the JAX scanner's declines and
  columns on every case of ``tests/test_native.py``.
* The 1/N sharded read over a parquet source equals the JAX package's.
* A port-written part of a quickstart-shaped store is within 1.5x of the
  JAX (pyarrow) part's size.
"""

import datetime as dt
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from predictionio_tpu import native as jax_native
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import parquet as jpq
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel import ingest as jax_ingest
from predictionio_tpu_torch import native
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import parquet as ppq
from predictionio_tpu_torch.data.storage import parquet_format as pqf
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.parallel import ingest

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "torch_data" / "jax_parquet_store"
PKG = {"jax": (jpq, JaxEvent), "port": (ppq, Event)}


def events(E, n, seed=0, start=0, users=400, items=150):
    """Rates with ratings (some as strings), buys, $set events without a
    target, non-ASCII ids; ids and times deterministic."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("rate", "rate", "buy", "$set")[k % 4]
        target = None if kind == "$set" else f"ï{int(rng.zipf(1.3)) % items}"
        props = ({"rating": float(rng.integers(1, 6))} if kind == "rate" else
                 {"rating": "4", "tag": "x y"} if kind == "buy" else {"plan": "pro"})
        out.append(E(event=kind, entity_type="user", entity_id=f"u{int(rng.integers(users))}é",
                     target_entity_type=None if target is None else "item",
                     target_entity_id=target, properties=props,
                     event_time=T0 + dt.timedelta(seconds=int(rng.integers(0, 10 ** 6))),
                     event_id=f"e{start + k:06d}",
                     creation_time=T0 + dt.timedelta(seconds=start + k)))
    return out


def _inter(i):
    return (i.user.dtype.str, i.user.tolist(), i.item.tolist(), i.rating.tolist(),
            i.rating.dtype.str, i.t.tolist(),
            [i.user_map.inverse[k] for k in range(len(i.user_map))],
            [i.item_map.inverse[k] for k in range(len(i.item_map))])


def _rows(evs):
    return [json.dumps(e.to_dict(), sort_keys=True) for e in evs]


def _batch(b):
    num = {k: np.asarray(v).tolist() for k, v in (b.numeric_properties or {}).items()}
    return (b.event_id.tolist(), b.event.tolist(), b.entity_id.tolist(),
            b.target_entity_id.tolist(), b.event_time.tolist(), b.creation_time.tolist(),
            [dict(p) for p in b.properties], [tuple(t) for t in b.tags], b.pr_id.tolist(),
            json.dumps(num, sort_keys=True))


FINDS = [
    {},
    {"rating_key": "rating"},
    {"rating_key": "rating", "default_rating": 2.5, "event_names": ["rate"],
     "entity_type": "user", "target_entity_type": "item"},
    {"event_names": ["buy"], "default_rating": 4.0},
    {"shard": (1, 3), "shard_key": "row"},
    {"shard": (0, 3), "shard_key": "entity", "rating_key": "rating"},
    {"shard": (2, 3), "shard_key": "target"},
    {"shard": (0, 2), "shard_key": "target", "event_names": ["rate", "buy"]},
    {"entity_type": "nobody"},
]


def _store(writer, root, n_bulk=(12_000, 10_500), wal=300, promoted=True):
    """Two bulk parts (≥ DIRECT_PART_THRESHOLD), an unpromoted part when
    ``promoted`` is False, WAL inserts and deletes, by ``writer``."""
    mod, E = PKG[writer]
    pe, le = mod.ParquetPEvents(path=str(root)), mod.ParquetLEvents(path=str(root))
    start = 0
    for seed, n in enumerate(n_bulk):
        pe.write(events(E, n, seed=seed, start=start), 1)
        start += n
    if not promoted:
        ns = mod._Namespace(str(root), 1, None)
        cols = {k: v[:2000] for k, v in ns.read_columns().items()
                if not k.startswith("numeric:")}
        cols["id"] = np.array([f"x{k:05d}" for k in range(2000)], dtype=object)
        ns.write_part(cols)  # NOT promoted: the JSON path must win
    le.insert_batch(events(E, wal, seed=9, start=start), 1)
    le.delete("e000003", 1)
    pe.delete(["e000010", f"e{start + 5:06d}"], 1)
    return root


@pytest.mark.parametrize("promoted", [True, False], ids=["promoted", "mixed"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(tmp_path, writer, promoted):
    root = _store(writer, tmp_path / "pq", promoted=promoted)
    for compactor in (None, "jax", "port"):
        if compactor:
            PKG[compactor][0]._Namespace(str(root), 1, None).compact(force=True)
            assert not PKG[compactor][0]._Namespace(str(root), 1, None).wal_paths()
        jl, pl = jpq.ParquetLEvents(path=str(root)), ppq.ParquetLEvents(path=str(root))
        assert _rows(pl.find(1)) == _rows(jl.find(1))
        kw = dict(start_time=T0 + dt.timedelta(days=3), until_time=T0 + dt.timedelta(days=8),
                  event_names=["rate"], reversed=True, limit=50)
        assert _rows(pl.find(1, **kw)) == _rows(jl.find(1, **kw))
        assert _rows(pl.find(1, target_entity_id="None", limit=20)) == _rows(
            jl.find(1, target_entity_id="None", limit=20))
        for eid in ("e000004", "e000003", "e000011", "nope"):
            a, b = pl.get(eid, 1), jl.get(eid, 1)
            assert (a is None and b is None) or _rows([a]) == _rows([b]), eid
        jb, pb = (jpq.ParquetPEvents(path=str(root)).find(1),
                  ppq.ParquetPEvents(path=str(root)).find(1))
        assert _batch(pb) == _batch(jb)
        assert np.array_equal(pb.property_column("rating", 1.0), jb.property_column("rating", 1.0))
        assert ppq._Namespace(str(root), 1, None).all_ids() == jpq._Namespace(
            str(root), 1, None).all_ids()
    assert len(pb) == 12_000 + 10_500 + 300 + (2000 if not promoted else 0) - 3


@pytest.mark.parametrize("kw", FINDS, ids=[json.dumps(k, sort_keys=True) for k in FINDS])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_find_interactions_is_bit_equal_with_the_same_maps(tmp_path, writer, kw):
    root = _store(writer, tmp_path / "pq", promoted=writer == "jax")
    # fold the WAL first (each driver's find_interactions would), then read
    # the same parts with both
    ppq._Namespace(str(root), 1, None).compact(force=True)
    ppq.ParquetPEvents(path=str(root)).write(events(Event, 10_000, seed=5, start=90_000), 1)
    got = ppq.ParquetPEvents(path=str(root)).find_interactions(1, **kw)
    want = jpq.ParquetPEvents(path=str(root)).find_interactions(1, **kw)
    assert _inter(got) == _inter(want)
    assert len(ppq._Namespace(str(root), 1, None).part_paths()) == 2


def _shard_maps(mod, root, key, n):
    pe = mod.ParquetPEvents(path=str(root))
    return [_inter(pe.find_interactions(1, shard=(p, n), shard_key=key)) for p in range(n)]


@pytest.mark.parametrize("key", ["row", "entity", "target"])
def test_shards_cover_and_match_jax(tmp_path, key):
    root = _store("port", tmp_path / "pq", wal=0)
    got, want = _shard_maps(ppq, root, key, 3), _shard_maps(jpq, root, key, 3)
    assert got == want
    full = ppq.ParquetPEvents(path=str(root)).find_interactions(1)
    assert sum(len(g[1]) for g in got) == len(full)


def _load_expected():
    d = np.load(REPO / "tests" / "torch_data" / "jax_parquet_store.npz")

    def col(key):
        v = d[key]
        if key + "__null" in d.files:
            out = v.astype(object)
            out[d[key + "__null"]] = None
            return out
        return v
    cols = {k[4:].replace("__", ":"): col(k) for k in d.files
            if k.startswith("col:") and not k.endswith("__null")}
    finds = {name: tuple(d[f"{name}:{f}"] for f in ("user", "item", "rating", "t",
                                                    "user_ids", "item_ids"))
             for name in ("plain", "rated")}
    return cols, finds


def test_the_committed_jax_store_reads_equal_to_its_npz(tmp_path):
    """pyarrow's files (row groups of 500, id/entity/properties chunks that
    fall back to PLAIN, a Null pr_id, a WAL with a delete) read in the port
    equal to what the JAX driver read from them."""
    import pyarrow.parquet as pq

    root = tmp_path / "store"
    shutil.copytree(FIXTURE, root)
    parts = ppq._Namespace(str(root), 1, None).part_paths()
    assert len(parts) == 2 and ppq._Namespace(str(root), 1, None).wal_paths()
    for p in parts:
        meta = pq.read_metadata(p)
        assert meta.num_row_groups > 1
        enc = set(meta.row_group(0).column(meta.schema.names.index("id")).encodings)
        assert {"PLAIN", "RLE_DICTIONARY"} <= enc
        assert pqf.ParquetFile(p).column("pr_id").kind == "null"
    want_cols, finds = _load_expected()
    got = ppq._Namespace(str(root), 1, None).read_columns()
    assert sorted(got) == sorted(want_cols)
    for c, v in want_cols.items():
        if v.dtype.kind == "f":
            assert np.array_equal(got[c], v, equal_nan=True), c
        else:
            assert list(got[c]) == list(v), c
    for name, kw in (("plain", {}), ("rated", {"rating_key": "rating", "event_names": ["rate", "buy"],
                                               "entity_type": "user",
                                               "target_entity_type": "item"})):
        copy = tmp_path / name
        shutil.copytree(FIXTURE, copy)
        i = ppq.ParquetPEvents(path=str(copy)).find_interactions(1, **kw)
        u, it, r, t, uids, iids = finds[name]
        assert np.array_equal(i.user, u) and np.array_equal(i.item, it), name
        assert np.array_equal(i.rating, r) and np.array_equal(i.t, t), name
        assert [i.user_map.inverse[k] for k in range(len(i.user_map))] == list(uids)
        assert [i.item_map.inverse[k] for k in range(len(i.item_map))] == list(iids)


# -- time pruning -------------------------------------------------------------


def _day_parts(writer, root):
    """Three parts, one a day-range (1-2, 11-12, 21-22 January)."""
    mod, E = PKG[writer]
    ns = mod._Namespace(str(root), 1, None)
    for base_day in (1, 11, 21):
        evs = [E(event="rate", entity_type="user", entity_id=f"u{i}", target_entity_type="item",
                 target_entity_id=f"i{i % 7}", properties={"rating": float(i % 5 + 1)},
                 event_time=dt.datetime(2026, 1, base_day + i % 2, 12, tzinfo=UTC),
                 event_id=f"d{base_day}-{i}") for i in range(40)]
        cols = {c: np.array([mod._event_to_row(e, e.event_id)[c] for e in evs],
                            dtype=np.float64 if c in ("event_time", "creation_time") else object)
                for c in mod._SCHEMA_COLS}
        ns.write_part(ns.promote_numeric(cols))
    return ns


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_time_ranged_reads_prune_the_other_packages_parts(tmp_path, monkeypatch, writer, reader):
    import pyarrow.parquet as pq

    root = tmp_path / "pq"
    ns = _day_parts(writer, root)
    ranges = [PKG[reader][0]._part_time_range(p) for p in ns.part_paths()]
    assert ranges == [(dt.datetime(2026, 1, d, 12, tzinfo=UTC).timestamp(),
                       dt.datetime(2026, 1, d + 1, 12, tzinfo=UTC).timestamp())
                      for d in (1, 11, 21)]
    opened = []
    if reader == "jax":
        real = pq.read_table
        monkeypatch.setattr(pq, "read_table", lambda p, *a, **k: (opened.append(str(p)),
                                                                  real(p, *a, **k))[1])
    else:
        real_init = pqf.ParquetFile.__init__

        def counting(self, path):
            opened.append(str(path))
            real_init(self, path)
        monkeypatch.setattr(pqf.ParquetFile, "__init__", counting)
    le = PKG[reader][0].ParquetLEvents(path=str(root))
    mid = list(le.find(1, start_time=dt.datetime(2026, 1, 11, tzinfo=UTC),
                       until_time=dt.datetime(2026, 1, 13, tzinfo=UTC)))
    assert len(mid) == 40
    read = {os.path.basename(p) for p in opened if p.endswith(".parquet")}
    assert read == {"events-000001.parquet"}, read
    opened.clear()
    assert len(list(le.find(1))) == 120
    assert len({p for p in opened if p.endswith(".parquet")}) == 3


def test_pruning_never_skips_wal_rows(tmp_path):
    le = ppq.ParquetLEvents(path=str(tmp_path / "pq"))
    le.insert(Event(event="rate", entity_type="user", entity_id="u0", target_entity_type="item",
                    target_entity_id="i0", event_time=dt.datetime(2026, 1, 15, 12, tzinfo=UTC)), 1)
    got = list(le.find(1, start_time=dt.datetime(2026, 1, 14, tzinfo=UTC),
                       until_time=dt.datetime(2026, 1, 16, tzinfo=UTC)))
    assert len(got) == 1


# -- the maintenance cases ------------------------------------------------------


def _ev(event, eid, t_offset_s=0, props=None, target=None):
    return Event(event=event, entity_type="user", entity_id=eid,
                 target_entity_type="item" if target else None, target_entity_id=target,
                 properties=props or {},
                 event_time=T0 + dt.timedelta(seconds=t_offset_s))


def test_wal_folds_into_part_and_reads_survive(tmp_path):
    le = ppq.ParquetLEvents(path=str(tmp_path))
    le.init(1)
    ids = le.batch_insert([_ev("buy", f"u{i}", t_offset_s=-i, target="i1") for i in range(20)], 1)
    le.delete(ids[0], 1)
    ns = ppq._Namespace(str(tmp_path), 1, None)
    assert ns.part_paths() == []  # below threshold: still WAL-only
    ns.compact(force=True)
    assert len(ns.part_paths()) == 1
    assert not ns.read_wal()
    events_ = list(le.find(1))
    assert len(events_) == 19
    assert ids[0] not in {e.event_id for e in events_}
    batch = ppq.ParquetPEvents(path=str(tmp_path)).find(1, event_names=["buy"])
    assert len(batch) == 19
    assert batch.properties[0] == {}
    le.insert(_ev("buy", "u99", target="i1"), 1)
    assert len(list(le.find(1))) == 20


def test_compaction_keeps_the_last_row_of_a_duplicated_id(tmp_path):
    """A part that survived a half-finished delete pass duplicates rows:
    compaction keeps the last row per id, as the JAX driver does."""
    ns = ppq._Namespace(str(tmp_path), 1, None)
    le = ppq.ParquetLEvents(path=str(tmp_path))
    le.insert_batch([_ev("rate", "u1", props={"r": 1}, target="i1")], 1)
    (eid,) = [e.event_id for e in le.find(1)]
    ns.compact(force=True)
    part = ns.part_paths()[0]
    shutil.copy(part, part.replace("000000", "000001"))  # the crash's duplicate
    le.insert(Event(event="rate", entity_type="user", entity_id="u1", target_entity_type="item",
                    target_entity_id="i1", properties={"r": 2}, event_id=eid,
                    event_time=T0), 1)
    jns = jpq._Namespace(str(tmp_path), 1, None)
    before = [_rows(m.ParquetLEvents(path=str(tmp_path)).find(1)) for m in (ppq, jpq)]
    assert before[0] == before[1] and len(before[0]) == 3
    ns.compact(force=True)
    rows = list(le.find(1))
    assert len(rows) == 1 and rows[0].properties.to_dict() == {"r": 2}
    assert _rows(jpq.ParquetLEvents(path=str(tmp_path)).find(1)) == _rows(rows)
    assert len(jns.part_paths()) == 1


def test_mixed_parts_fall_back_to_json(tmp_path):
    pe = ppq.ParquetPEvents(path=str(tmp_path))
    ns = ppq._Namespace(str(tmp_path), 1, None)
    row = ppq._event_to_row(_ev("rate", "u1", props={"rating": 5.0}), "e1")
    cols = {c: (np.array([row[c]], np.float64) if c in ("event_time", "creation_time")
                else np.array([row[c]], object)) for c in ppq._SCHEMA_COLS}
    ns.write_part(cols)  # NOT promoted
    pe.write([_ev("rate", f"u{i}", props={"rating": 3.0}) for i in range(10_001)], 1)
    batch = pe.find(1)
    ratings = batch.property_column("rating", 1.0)
    assert 5.0 in ratings and 1.0 not in ratings
    assert batch.numeric_properties is None


def test_string_numbers_promote_consistently(tmp_path):
    pe = ppq.ParquetPEvents(path=str(tmp_path))
    evs = [_ev("rate", f"u{i}", props={"rating": "4.5"}, target="i1") for i in range(6000)]
    evs += [_ev("rate", f"v{i}", props={"rating": 2.0}, target="i2") for i in range(6000)]
    pe.write(evs, 1)
    batch = pe.find(1)
    assert batch.numeric_properties and "rating" in batch.numeric_properties
    assert set(np.unique(batch.property_column("rating", 1.0))) == {4.5, 2.0}
    # select/filter carry the promoted columns and the lazy properties
    sub = batch.filter_events(["rate"]).select(np.arange(len(batch)) % 2 == 0)
    assert set(sub.numeric_properties) == {"rating"} and len(sub) == 6000
    assert type(sub.properties).__name__ == "LazyJsonProperties"
    inter = sub.interactions(rating_key="rating")
    assert set(np.unique(inter.rating)) == {4.5, 2.0}


# -- two writer processes, one of each package --------------------------------

WRITER = r"""
import datetime as dt, sys
sys.path.insert(0, {repo!r})
pkg, root, tag, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
if pkg == "port":
    sys.modules["jax"] = None
    sys.modules["predictionio_tpu"] = None
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.parquet import ParquetLEvents, _Namespace
else:
    from predictionio_tpu.data.event import Event
    from predictionio_tpu.data.storage.parquet import ParquetLEvents, _Namespace
le = ParquetLEvents(path=root)
for i in range(n):
    le.insert(Event(event="rate", entity_type="user", entity_id=f"{{tag}}-{{i}}",
                    target_entity_type="item", target_entity_id="x",
                    event_time=dt.datetime(2026, 1, 5, tzinfo=dt.timezone.utc)), 1)
    if i % 25 == 0:  # interleave compactions with the other writer's appends
        _Namespace(root, 1, None).compact(force=True)
print("done", tag)
""".format(repo=str(REPO))


def test_two_processes_one_directory_no_loss(tmp_path):
    """A port writer and a JAX writer process plus this reading and
    compacting process on one directory: every event survives once."""
    root = str(tmp_path / "shared")
    n = 100
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, pkg, root, f"w{k}", str(n)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for k, pkg in enumerate(("port", "jax"))]
    ns = ppq._Namespace(root, 1, None)
    reader = ppq.ParquetLEvents(path=root)
    deadline = time.time() + 120
    while any(p.poll() is None for p in procs):
        if ns.exists():
            ns.compact(force=True)
            rows = list(reader.find(1, limit=-1))
            assert len(rows) == len({e.event_id for e in rows})
        if time.time() > deadline:
            for p in procs:
                p.kill()
            pytest.fail("writer processes did not finish")
        time.sleep(0.05)
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    ns.compact(force=True)
    got = {e.entity_id for e in reader.find(1, limit=-1)}
    assert got == {f"w{k}-{i}" for k in range(2) for i in range(n)}
    assert len(list(reader.find(1, limit=-1))) == 2 * n
    assert _rows(jpq.ParquetLEvents(path=root).find(1)) == _rows(reader.find(1))


# -- the host scanner vs the JAX scanner ------------------------------------------


def _fuzz_rows():
    rng = np.random.default_rng(0)
    keys = ["k%d" % i for i in range(8)] + ["ключ", "k w s"]
    rows = []
    for _ in range(500):
        row = {}
        for k in keys:
            r = rng.random()
            if r < 0.4:
                continue
            elif r < 0.7:
                row[k] = float(rng.normal() * 10.0 ** float(rng.integers(-3, 6)))
            elif r < 0.8:
                row[k] = int(rng.integers(-(2 ** 40), 2 ** 40))
            elif r < 0.9:
                row[k] = bool(rng.random() < 0.5)
            elif r < 0.95:
                row[k] = "lbl%d" % int(rng.integers(100))
            else:
                row[k] = {"nested": 1} if r < 0.975 else None
        rows.append(row)
    return [json.dumps(r) for r in rows]


_UNI = [{"prix€": 9.5, 'quo"te': 1, "tab\tkey": 2, "日本語": 3}, {"prix€": 1.5, "日本語": 4}]
SCAN_CASES = {
    "numbers_bools_missing": [json.dumps(r) for r in (
        {"rating": 4.5, "count": 3, "flag": True}, {"rating": -1e-3, "flag": False},
        {"count": 12345678901234}, {}, {"rating": 0})],
    "rejected_kinds": [json.dumps({"a": 1, "b": None, "c": {"x": 1}, "d": [1, 2]}),
                       json.dumps({"a": 2.5, "b": 3, "c": 1, "d": 2})],
    "unicode_keys": [json.dumps(r) for r in _UNI],
    "unicode_keys_raw": [json.dumps(r, ensure_ascii=False) for r in _UNI],
    "duplicate_1": ['{"a": 1, "a": 2}'], "duplicate_2": ['{"a": null, "a": 3}'],
    "duplicate_3": ['{"a": "x(", "a": 3}'],
    "number_formats": [json.dumps(r) for r in (
        {"x": 1e308, "y": -0.0, "z": 2e-308},
        {"x": 1.7976931348623157e308, "y": 3.141592653589793, "z": 1e5})],
    "empty_and_whitespace": ["", "{}", '  {"a": 1}  ', '{"a": 2}'],
    "fuzz": _fuzz_rows(),
    "maybe_coercible": ['{"a": "3"}'],
    **{f"maybe_coercible_{k}": ['{"a": %s}' % s] for k, s in enumerate(
        ('"inf"', '"-Infinity"', '" nan "', '"1_0"', '""'))},
    "never_coercible": ['{"label": "category x", "rating": 4.0}',
                        '{"label": "wid/get#9", "rating": 2.0}'],
    "malformed": ['{"a": 1}', '{"a": '],
    "nan_literal": ['{"a": NaN}'],
    **{f"non_json_number_{k}": ['{"a": %s}' % lit] for k, lit in enumerate(
        ("-0x10", "0x10", "1.", ".5", "-inf", "Infinity", "01", "+1", "1e", "1e+"))},
    "whitespace_only": ["   ", '{"a":1}'],
    "empty_cell": ["", '{"a":1}'],
    "non_ascii_value": ['{"a": "٣"}'],
    "trailing_garbage": ["{}x", '{"a":1}'],
    "overflowing_int": ['{"a": %d}' % (10 ** 400)],
    "overflowing_float": ['{"a": 1e999}'],
    "no_rows": [],
    "null_cell": ['{"a": 1}', None],
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_host_scanner_declines_and_columns_equal_jax(case):
    props = np.array(SCAN_CASES[case], dtype=object)
    got = native.scan_numeric_props(props)
    want = jax_native.scan_numeric_props(props)
    assert (got is None) == (want is None), (got, want)
    if want is not None:
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])  # NaN == NaN here


def test_promote_numeric_uses_the_host_scanner(monkeypatch):
    rows = [{"rating": float(i % 5), "label": "x%d" % i, "ok": i % 2 == 0} for i in range(50)]
    cols = {"properties": np.array([json.dumps(r) for r in rows], object)}
    calls = []
    real = native.scan_numeric_props

    def spy(props):
        out = real(props)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(native, "scan_numeric_props", spy)
    with_native = ppq._Namespace.promote_numeric(dict(cols))
    assert calls == [True]
    monkeypatch.setattr(native, "scan_numeric_props", lambda props: None)
    with_python = ppq._Namespace.promote_numeric(dict(cols))
    assert set(with_native) == set(with_python) == set(jpq._Namespace.promote_numeric(dict(cols)))
    for k in ("numeric:rating", "numeric:ok"):
        np.testing.assert_array_equal(with_native[k], with_python[k])
    assert "numeric:label" not in with_native


def test_a_failed_host_build_raises_naming_the_compiler_output(monkeypatch, tmp_path):
    """No PIO_NATIVE switch and no silent Python path: a build that fails
    raises KernelError with the compiler's output."""
    from predictionio_tpu_torch.ops import _build

    src = tmp_path / "host"
    src.mkdir()
    (src / "jsonprops.cpp").write_text("this is not C++\n")
    shutil.copy(_build.HOST_CSRC / "snappy.cpp", src / "snappy.cpp")
    monkeypatch.setattr(_build, "HOST_CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "host_build_log", {})
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PIO_NATIVE", "0")  # has no effect in the port
    with pytest.raises(_build.KernelError, match="g\\+\\+ failed for host/jsonprops.cpp"):
        native.scan_numeric_props(np.array(["{}"], object))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelError, match="no C\\+\\+ compiler"):
        native.load("snappy")


# -- the 1/N sharded read over parquet ----------------------------------------


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
def test_read_sharded_interactions_over_parquet_equals_jax(tmp_path, n):
    name = "PQ" + uuid.uuid4().hex[:6].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}DB_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{name}DB_PATH": str(tmp_path / "meta.sqlite"),
           f"PIO_STORAGE_SOURCES_{name}_TYPE": "parquet",
           f"PIO_STORAGE_SOURCES_{name}_PATH": str(tmp_path / "events"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name + "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name + "DB"}
    port, jax = Storage(env=env), JaxStorage(env=env)
    try:
        app_id = port.get_meta_data_apps().insert(App(0, "S"))
        port.get_p_events().write(events(Event, 11_000, seed=3), app_id)
        port.get_l_events().insert_batch(events(Event, 200, seed=4, start=50_000), app_id)
        ppq._Namespace(str(tmp_path / "events"), app_id, None).compact(force=True)
        kw = dict(entity_type="user", event_names=["rate"], target_entity_type="item",
                  rating_key="rating")
        parts = [kw, dict(entity_type="user", event_names=["buy"], target_entity_type="item",
                          default_rating=4.0)]
        run = uuid.uuid4().hex[:8]
        got = _threads(lambda p: ingest.read_sharded_interactions(
            port, app_id, run_key="port" + run, process_index=p, num_processes=n,
            parts=parts), n)
        want = _threads(lambda p: jax_ingest.read_sharded_interactions(
            jax, app_id, run_key="jax" + run, process_index=p, num_processes=n,
            parts=parts), n)
        for g, w in zip(got, want):
            assert list(g.user_map.keys()) == list(w.user_map.keys())
            assert list(g.item_map.keys()) == list(w.item_map.keys())
            assert np.array_equal(g.user_counts, w.user_counts)
            assert g.dataset_digest == w.dataset_digest != 0
            for side in ("user_rows", "item_rows"):
                a, b = getattr(g, side), getattr(w, side)
                for f in ("user", "item", "rating", "t"):
                    assert np.array_equal(getattr(a, f), getattr(b, f)), (side, f)
        got[0].cleanup()
    finally:
        port_sqlite.close_all_dbs()
        jax_sqlite.close_all_dbs()


def test_a_quickstart_part_stays_within_one_and_a_half_of_pyarrows(tmp_path):
    """The same 20,000 quickstart-shaped events written as one bulk part by
    each package: the port's file is at most 1.5x the pyarrow one."""
    sizes = {}
    for pkg, (mod, E) in PKG.items():
        rng = np.random.default_rng(7)
        evs = [E(event="rate", entity_type="user", entity_id=f"{int(rng.integers(6040))}",
                 target_entity_type="item", target_entity_id=f"{int(rng.integers(3706))}",
                 properties={"rating": float(rng.integers(1, 6))},
                 event_time=T0 + dt.timedelta(seconds=k)) for k in range(20_000)]
        mod.ParquetPEvents(path=str(tmp_path / pkg)).write(evs, 1)
        (part,) = mod._Namespace(str(tmp_path / pkg), 1, None).part_paths()
        sizes[pkg] = os.path.getsize(part)
    assert sizes["port"] <= 1.5 * sizes["jax"], sizes
