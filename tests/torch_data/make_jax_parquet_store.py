"""Regenerate ``jax_parquet_store/`` and ``jax_parquet_store.npz``.

The store is written by the JAX package's parquet driver through pyarrow:
two parts and a WAL holding inserts and a delete, a promoted ``rating``
(``pnum_rating``), an all-``None`` ``pr_id`` (pyarrow's ``optional int32
(Null)``), several row groups a part (``row_group_size`` forced to 500)
and id and properties chunks that fall back from dictionary to ``PLAIN``
partway (``dictionary_pagesize_limit`` forced to 1 KiB). The ``.npz``
holds what the JAX driver reads from it: every column of ``read_columns``
and the ``find_interactions`` arrays and id orders, with and without
``rating_key`` (computed on a copy: ``find_interactions`` compacts).

Run from the repository root, with jax's package and pyarrow importable:

    python tests/torch_data/make_jax_parquet_store.py

String columns are stored in the ``.npz`` as unicode arrays with a null
mask beside them (``<name>`` and ``<name>__null``), so it loads without
pickle.
"""

from __future__ import annotations

import datetime as dt
import functools
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import pyarrow.parquet as pq  # noqa: E402

from predictionio_tpu.data.event import Event  # noqa: E402
from predictionio_tpu.data.storage import parquet  # noqa: E402

STORE = os.path.join(HERE, "jax_parquet_store")
EXPECTED = os.path.join(HERE, "jax_parquet_store.npz")
APP = 1
UTC = dt.timezone.utc
T0 = dt.datetime(2026, 3, 1, tzinfo=UTC)
FINDS = {"plain": {}, "rated": {"rating_key": "rating", "event_names": ["rate", "buy"],
                                "entity_type": "user", "target_entity_type": "item"}}


def events(seed: int, n: int, start: int) -> list[Event]:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("rate", "rate", "buy", "$set")[k % 4]
        target = None if kind == "$set" else f"item-{int(rng.zipf(1.4)) % 400}"
        props = ({"rating": float(rng.integers(1, 6))} if kind == "rate"
                 else {"price": round(float(rng.random()) * 50, 2), "note": f"n{k}"}
                 if kind == "buy" else {"plan": ["free", "pro"][k % 2], "age": int(rng.integers(18, 80))})
        out.append(Event(
            event=kind, entity_type="user", entity_id=f"user-{int(rng.integers(0, 700))}-ü",
            target_entity_type=None if target is None else "item", target_entity_id=target,
            properties=props, event_time=T0 + dt.timedelta(seconds=int(rng.integers(0, 86_400 * 30))),
            event_id=f"ev-{start + k:06d}", creation_time=T0 + dt.timedelta(seconds=start + k)))
    return out


def _flat(cols: dict, prefix: str, out: dict) -> None:
    for c, v in cols.items():
        key = prefix + c.replace(":", "__")
        if v.dtype == object:
            out[key] = np.array(["" if x is None else x for x in v], dtype=str)
            out[key + "__null"] = np.array([x is None for x in v], dtype=bool)
        else:
            out[key] = np.asarray(v)


def main() -> None:
    real_write = pq.write_table
    pq.write_table = functools.partial(real_write, row_group_size=500,
                                       dictionary_pagesize_limit=1024)
    try:
        shutil.rmtree(STORE, ignore_errors=True)
        ns = parquet._Namespace(STORE, APP, None)
        for seed, start, n in ((1, 0, 1500), (2, 1500, 1200)):
            batch = events(seed, n, start)
            cols = {c: np.array([parquet._event_to_row(e, e.event_id)[c] for e in batch],
                                dtype=np.float64 if c in ("event_time", "creation_time") else object)
                    for c in parquet._SCHEMA_COLS}
            ns.write_part(ns.promote_numeric(cols))
        le = parquet.ParquetLEvents(path=STORE)
        le.insert_batch(events(3, 60, 2700), APP)
        le.delete("ev-000007", APP)
        le.delete("ev-002705", APP)
    finally:
        pq.write_table = real_write
    for p in ns.part_paths():
        meta = pq.read_metadata(p)
        assert meta.num_row_groups > 1, p
        for c in ("id", "entity_id", "properties"):
            enc = set(meta.row_group(0).column(meta.schema.names.index(c)).encodings)
            assert {"PLAIN", "RLE_DICTIONARY"} <= enc, (p, c, enc)
    out: dict = {}
    _flat(ns.read_columns(), "col:", out)
    for name, kw in FINDS.items():
        scratch = tempfile.mkdtemp()
        try:
            copy = os.path.join(scratch, "store")
            shutil.copytree(STORE, copy)
            inter = parquet.ParquetPEvents(path=copy).find_interactions(APP, **kw)
        finally:
            shutil.rmtree(scratch)
        out[f"{name}:user"], out[f"{name}:item"] = inter.user, inter.item
        out[f"{name}:rating"], out[f"{name}:t"] = inter.rating, inter.t
        out[f"{name}:user_ids"] = np.array(
            [inter.user_map.inverse[i] for i in range(len(inter.user_map))], dtype=str)
        out[f"{name}:item_ids"] = np.array(
            [inter.item_map.inverse[i] for i in range(len(inter.item_map))], dtype=str)
    np.savez_compressed(EXPECTED, **out)
    os.remove(os.path.join(STORE, f".{ns.name}.lock"))  # made by the parts lock
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(STORE) for f in fs)
    print(f"wrote {STORE} ({size} bytes) and {EXPECTED} ({os.path.getsize(EXPECTED)} bytes)")


if __name__ == "__main__":
    main()
