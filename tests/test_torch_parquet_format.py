"""The port's Parquet codec (``data/storage/parquet_format.py``) and its
snappy host library, with pyarrow as the arbiter.

* pyarrow writes (snappy and uncompressed; small ``row_group_size``,
  ``data_page_size`` and ``dictionary_pagesize_limit``; nulls; Null-typed
  columns; empty tables; non-ASCII strings; NaN in doubles) and the port
  reads the same columns, as arrays and as codes plus a dictionary;
* the port writes and pyarrow reads an equal table with the same types,
  and the min/max statistics pyarrow reports (NaN left out);
* the snappy library round-trips, decodes what pyarrow's snappy writes and
  writes what pyarrow's decodes;
* a truncated page, a corrupt snappy stream, a ZSTD file, v2 data pages, a
  nested column and an unsupported physical type each raise, naming it.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu_torch import native
from predictionio_tpu_torch.data.storage import parquet_format as pf

SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture,
                                           HealthCheck.too_slow])

TEXT = st.text(alphabet=st.sampled_from(list("abcxyz019 _-\"\\{}:") + ["ü", "日", "ï", "€", "😀"]),
               max_size=12)


@st.composite
def tables(draw):
    n = draw(st.integers(0, 80))
    pool = draw(st.lists(TEXT, min_size=1, max_size=30))
    cols = {}
    for k in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(["string", "string", "double", "null"]))
        if kind == "string":
            null_p = draw(st.sampled_from([0.0, 0.2, 1.0]))
            vals = [None if draw(st.floats(0, 1)) < null_p else draw(st.sampled_from(pool))
                    for _ in range(n)]
            cols[f"s{k}"] = np.array(vals, dtype=object)
        elif kind == "double":
            vals = draw(st.lists(st.one_of(st.floats(allow_nan=False, width=64), st.just(np.nan)),
                                 min_size=n, max_size=n))
            cols[f"d{k}"] = np.array(vals, dtype=np.float64)
        else:
            cols[f"n{k}"] = np.full(n, None, dtype=object)
    return cols


KNOBS = st.fixed_dictionaries({
    "compression": st.sampled_from(["snappy", "none"]),
    "row_group_size": st.sampled_from([1, 7, 64, 1 << 20]),
    "data_page_size": st.sampled_from([16, 200, 1 << 20]),
    "dictionary_pagesize_limit": st.sampled_from([8, 100, 1 << 20]),
})


def _same(got, want):
    if got.dtype.kind == "f":
        return np.array_equal(got, want.astype(np.float64), equal_nan=True)
    return list(got) == list(want)


def _arrow(cols):
    return pa.table({k: pa.array(v, type=pa.null()) if all(x is None for x in v) and v.dtype == object
                     else v for k, v in cols.items()})


@SETTINGS
@given(cols=tables(), knobs=KNOBS, use_dictionary=st.booleans())
def test_pyarrow_writes_the_port_reads(tmp_path, cols, knobs, use_dictionary):
    path = str(tmp_path / "a.parquet")
    table = _arrow(cols)
    pq.write_table(table, path, use_dictionary=use_dictionary, **knobs)
    f = pf.ParquetFile(path)
    assert f.names == list(cols) and f.num_rows == table.num_rows
    for name in cols:
        want = table.column(name).to_numpy(zero_copy_only=False)
        assert _same(f.read_column(name), want), name
        if f.column(name).kind in ("string", "null"):
            codes, values = f.read_codes(name)
            table_ = np.array(values + [None], dtype=object)
            assert list(table_[codes]) == list(want)
            assert len(values) == len(set(values))


@SETTINGS
@given(cols=tables(), knobs=KNOBS)
def test_the_port_writes_pyarrow_reads(tmp_path, cols, knobs):
    path = str(tmp_path / "b.parquet")
    pf.write_table(path, cols, **knobs)
    got = pq.read_table(path)
    want = _arrow(cols)
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    for name in cols:
        assert _same(got.column(name).to_numpy(zero_copy_only=False), cols[name]), name
    meta = pq.read_metadata(path)
    rgs = knobs["row_group_size"]
    for r in range(meta.num_row_groups):
        for c, name in enumerate(cols):
            if not name.startswith("d"):
                continue
            part = cols[name][r * rgs:(r + 1) * rgs]
            stats = meta.row_group(r).column(c).statistics
            finite = part[~np.isnan(part)]
            if len(finite):
                assert stats.has_min_max
                assert (stats.min, stats.max) == (finite.min(), finite.max())
            else:
                assert stats is None or not stats.has_min_max
    # and the port reads its own file back
    f = pf.ParquetFile(path)
    for name in cols:
        assert _same(f.read_column(name), cols[name]), name


def test_a_chunk_that_falls_back_from_dictionary_to_plain(tmp_path):
    """pyarrow stops dictionary-encoding a chunk once the dictionary passes
    ``dictionary_pagesize_limit``: the chunk holds dictionary pages, then
    PLAIN ones, and the port reads both."""
    rng = np.random.default_rng(0)
    vals = np.array([f"id-{int(x)}-ü" for x in rng.integers(0, 5000, 20_000)], dtype=object)
    vals[::17] = None
    path = str(tmp_path / "fallback.parquet")
    pq.write_table(pa.table({"v": vals, "t": rng.random(20_000)}), path,
                   dictionary_pagesize_limit=4096, data_page_size=2048, row_group_size=8000)
    meta = pq.read_metadata(path)
    encodings = set(meta.row_group(0).column(0).encodings)
    assert {"RLE_DICTIONARY", "PLAIN"} <= encodings and meta.num_row_groups == 3
    f = pf.ParquetFile(path)
    assert list(f.read_column("v")) == list(vals)
    codes, values = f.read_codes("v")
    assert list(np.array(values + [None], object)[codes]) == list(vals)


def test_the_port_falls_back_to_plain_past_its_dictionary_limit(tmp_path):
    vals = np.array([f"u{k}" for k in range(3000)], dtype=object)
    path = str(tmp_path / "plain.parquet")
    pf.write_table(path, {"v": vals}, dictionary_pagesize_limit=1000)
    assert set(pq.read_metadata(path).row_group(0).column(0).encodings) == {"PLAIN", "RLE"}
    pf.write_table(path, {"v": vals})
    assert "RLE_DICTIONARY" in pq.read_metadata(path).row_group(0).column(0).encodings
    assert pq.read_table(path).column("v").to_pylist() == list(vals)


def test_empty_and_all_null_tables(tmp_path):
    path = str(tmp_path / "e.parquet")
    pf.write_table(path, {"s": np.empty(0, object), "d": np.empty(0)})
    t = pq.read_table(path)
    assert t.num_rows == 0 and t.schema.types == [pa.null(), pa.float64()]
    pq.write_table(pa.table({"s": pa.array([], pa.string())}), path)
    assert len(pf.ParquetFile(path).read_column("s")) == 0
    pf.write_table(path, {"n": np.full(5, None, object)})
    assert str(pq.ParquetFile(path).schema.column(0).logical_type) == "Null"
    assert pq.read_table(path).column("n").null_count == 5


@SETTINGS
@given(data=st.binary(max_size=5000) | st.builds(lambda s, k: s * k, st.binary(max_size=20),
                                                  st.integers(0, 400)))
def test_snappy_round_trips_and_agrees_with_pyarrow(data):
    z = native.snappy_compress(data)
    assert native.snappy_decompress(z, len(data)) == data
    assert pa.decompress(z, decompressed_size=len(data), codec="snappy", asbytes=True) == data
    assert native.snappy_decompress(pa.compress(data, codec="snappy", asbytes=True)) == data


def test_snappy_across_fragments():
    rng = np.random.default_rng(1)
    data = (rng.integers(0, 3, 400_000, dtype=np.uint8).tobytes()
            + b"abcdefgh" * 20_000 + rng.bytes(70_000))
    z = native.snappy_compress(data)
    assert len(z) < len(data) and native.snappy_decompress(z) == data
    assert native.snappy_decompress(pa.compress(data, codec="snappy", asbytes=True)) == data


@pytest.mark.parametrize("bad", [
    lambda z: z[:-3],                        # truncated
    lambda z: z[:1] + b"\x3e" + z[2:],       # a copy past the start
    lambda z: b"\xff\xff\xff\xff\xff\xff",   # no valid length
    lambda z: z + b"\x00x",                  # an element past the declared end
])
def test_a_corrupt_snappy_stream_raises(bad):
    z = native.snappy_compress(b"hello hello hello hello world" * 10)
    with pytest.raises(ValueError, match="corrupt snappy"):
        native.snappy_decompress(bad(z))


def _part(tmp_path, **kw):
    path = str(tmp_path / "p.parquet")
    vals = np.array([f"value-{k % 50}" for k in range(2000)], dtype=object)
    pq.write_table(pa.table({"s": vals, "d": np.arange(2000.0)}), path, **kw)
    return path


def test_a_truncated_page_raises(tmp_path):
    path = _part(tmp_path, compression="none", use_dictionary=False, write_page_index=False)
    meta = pq.read_metadata(path)
    col = meta.row_group(0).column(1)
    raw = bytearray(open(path, "rb").read())
    # cut the last column's data page short, keeping the footer after it
    cut = col.data_page_offset + col.total_compressed_size // 2
    end = col.data_page_offset + col.total_compressed_size
    footer_start = len(raw) - 8 - int.from_bytes(raw[-8:-4], "little")
    assert end == footer_start
    tampered = bytes(raw[:cut]) + bytes(raw[end:])
    with open(path, "wb") as f:
        f.write(tampered)
    with pytest.raises(pf.ParquetError, match="truncated|past"):
        pf.ParquetFile(path).read_column("d")


def test_a_truncated_file_raises(tmp_path):
    path = _part(tmp_path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-100])
    with pytest.raises(pf.ParquetError, match="magic"):
        pf.ParquetFile(path)


def test_a_corrupt_snappy_page_raises(tmp_path):
    path = _part(tmp_path, compression="snappy", use_dictionary=False)
    meta = pq.read_metadata(path)
    col = meta.row_group(0).column(1)
    raw = bytearray(open(path, "rb").read())
    start = col.data_page_offset
    # flip bytes inside the compressed page body, after its header
    for k in range(40, 60):
        raw[start + k] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(pf.ParquetError):
        pf.ParquetFile(path).read_column("d")


@pytest.mark.parametrize("kw,what", [
    ({"compression": "zstd"}, "ZSTD"),
    ({"compression": "gzip"}, "GZIP"),
    ({"data_page_version": "2.0"}, "v2"),
])
def test_outside_the_subset_raises_naming_it(tmp_path, kw, what):
    path = _part(tmp_path, **kw)
    with pytest.raises(pf.ParquetError, match=what):
        pf.ParquetFile(path).read_column("s")


def test_nested_and_other_types_raise(tmp_path):
    path = str(tmp_path / "n.parquet")
    pq.write_table(pa.table({"l": pa.array([[1, 2], [3]])}), path)
    with pytest.raises(pf.ParquetError, match="nested|repeated"):
        pf.ParquetFile(path)
    pq.write_table(pa.table({"b": pa.array([True, False]), "f": pa.array([1.0, 2.0], pa.float32()),
                             "i": pa.array([1, None], pa.int64())}), path)
    f = pf.ParquetFile(path)
    for name, what in (("b", "BOOLEAN"), ("f", "FLOAT")):
        with pytest.raises(pf.ParquetError, match=what):
            f.read_column(name)
    assert list(f.read_column("i")) == [1, None]
    with pytest.raises(TypeError):
        pf.write_table(path, {"x": np.array([1, "a"], dtype=object)})


def test_a_part_size_stays_near_pyarrows(tmp_path):
    """A file the port writes stays within 1.5x of pyarrow's for the same
    columns (the quickstart part's own check is in test_torch_parquet)."""
    rng = np.random.default_rng(2)
    n = 50_000
    cols = {"id": np.array([f"{k:032x}" for k in rng.permutation(n)], object),
            "u": np.array([f"u{int(x)}" for x in rng.integers(0, 6000, n)], object),
            "p": np.array(['{"rating": %d.0}' % x for x in rng.integers(1, 6, n)], object),
            "t": np.sort(rng.random(n) * 1e9), "n": np.full(n, None, object)}
    pf.write_table(str(tmp_path / "port.parquet"), cols)
    pq.write_table(_arrow(cols), str(tmp_path / "pa.parquet"))
    ours, theirs = (os.path.getsize(tmp_path / f) for f in ("port.parquet", "pa.parquet"))
    assert ours <= 1.5 * theirs, (ours, theirs)
