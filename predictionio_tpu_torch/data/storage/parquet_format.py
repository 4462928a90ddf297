"""The port's Parquet codec: the flat subset of Apache Parquet that the
columnar event store (``parquet.py``) reads and writes, without pyarrow.

The JAX package's driver stores parts through pyarrow; the port keeps its
own copy of what it needs, as it does for the postgres wire protocol. The
subset, as the public format specification (``parquet.thrift``) defines it:

* the footer (``FileMetaData``, ``RowGroup``, ``ColumnChunk``,
  ``ColumnMetaData``, ``Statistics``) and page headers (``PageHeader``,
  ``DataPageHeader``, ``DictionaryPageHeader``) in the Thrift compact
  protocol; a field the reader does not know is skipped by its wire type
  (pyarrow also writes size statistics, page-index offsets,
  ``column_orders`` and an ``ARROW:schema`` key-value);
* flat columns only, ``optional`` or ``required``: ``BYTE_ARRAY`` with the
  ``String`` logical type, ``DOUBLE``, ``INT32``, ``INT64``, and ``INT32``
  with the ``Null`` logical type (a column that is all ``None``);
* data pages v1: definition levels in the RLE/bit-packed hybrid with a
  4-byte length (max level 1), values ``PLAIN`` or dictionary indices
  (``RLE_DICTIONARY``/``PLAIN_DICTIONARY``) after a dictionary page; a
  chunk may switch from dictionary to ``PLAIN`` partway (pyarrow does once
  its dictionary passes ``dictionary_pagesize_limit``);
* codecs ``UNCOMPRESSED`` and ``SNAPPY`` (``native.snappy_*``, the host
  library ``csrc/host/snappy.cpp``).

Anything else raises :class:`ParquetError` naming it: another codec, data
pages v2, nested or repeated columns, another physical type or encoding, a
truncated page. The reader never returns columns it could not read whole.

:class:`ParquetFile` reads a column as a numpy array (``object`` for
strings and Null, ``float64`` for doubles) or as codes plus a dictionary
(:meth:`ParquetFile.read_codes`), so an id column of millions of rows never
becomes millions of Python strings. :func:`write_table` writes what pyarrow
reads back as the same table with the same types (``optional binary
(String)``, ``optional double``, ``optional int32 (Null)``): ``SNAPPY``
pages, ``RLE_DICTIONARY`` with a ``PLAIN`` fallback, and ``Statistics``
(min/max, NaN left out) on every ``DOUBLE`` chunk, which the JAX driver's
part pruning reads.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Sequence

import numpy as np

MAGIC = b"PAR1"

# Thrift compact protocol wire types
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, _STRUCT = range(13)

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
_TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
               "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, RLE_DICTIONARY = 0, 2, 3, 4, 8
_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                   5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                   7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
UNCOMPRESSED, SNAPPY = 0, 1
_CODEC_NAMES = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD", "LZ4_RAW")
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
_UTF8 = 0  # ConvertedType UTF8
_LT_STRING, _LT_NULL = 1, 11  # LogicalType union members

CREATED_BY = "predictionio_tpu_torch parquet_format version 1.0.0"


class ParquetError(ValueError):
    """A file or page this codec cannot read whole: corrupt, truncated, or
    outside the subset (the message names the feature)."""


# -- Thrift compact protocol ---------------------------------------------------


class _Reader:
    """Decodes compact-protocol structs into ``{field id: value}`` dicts,
    nested structs as dicts and lists as lists; self-describing, so a field
    this codec does not know is read by its wire type and ignored."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def _byte(self) -> int:
        if self.pos >= self.end:
            raise ParquetError("truncated Thrift header")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = out = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ParquetError("corrupt Thrift varint")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def _bytes(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise ParquetError("truncated Thrift header")
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def value(self, t: int):
        if t in (_TRUE, _FALSE):
            return t == _TRUE
        if t == _BYTE:
            b = self._byte()
            return b - 256 if b > 127 else b
        if t in (_I16, _I32, _I64):
            return self.zigzag()
        if t == _DOUBLE:
            return struct.unpack("<d", self._bytes(8))[0]
        if t == _BINARY:
            return self._bytes(self.varint())
        if t in (_LIST, _SET):
            h = self._byte()
            size, et = h >> 4, h & 0x0F
            if size == 15:
                size = self.varint()
            if et in (_TRUE, _FALSE):  # list booleans: one byte each
                return [self._byte() == _TRUE for _ in range(size)]
            return [self.value(et) for _ in range(size)]
        if t == _MAP:
            size = self.varint()
            if not size:
                return {}
            kv = self._byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(size)}
        if t == _STRUCT:
            return self.struct()
        raise ParquetError(f"corrupt Thrift: wire type {t}")

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            b = self._byte()
            if b == _STOP:
                return out
            t, delta = b & 0x0F, b >> 4
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(t)
            last = fid


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz(v: int) -> bytes:
    return _varint((v << 1) ^ (v >> 63))


def _w_value(t: int, v) -> bytes:
    if t in (_I16, _I32, _I64):
        return _zz(int(v))
    if t == _BINARY:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _varint(len(b)) + b
    if t == _DOUBLE:
        return struct.pack("<d", v)
    if t == _LIST:
        et, items = v
        head = bytes([(len(items) << 4) | et]) if len(items) < 15 else (
            bytes([0xF0 | et]) + _varint(len(items)))
        return head + b"".join(_w_value(et, x) for x in items)
    if t == _STRUCT:
        return _w_struct(v)
    raise ValueError(f"no writer for wire type {t}")


def _w_struct(fields: Sequence[tuple]) -> bytes:
    """``fields`` = (id, wire type, value) in ascending id order; a bool is
    (id, _TRUE, value); a list is (id, _LIST, (element type, items)); a
    struct is (id, _STRUCT, [fields])."""
    out, last = bytearray(), 0
    for fid, t, v in fields:
        if t in (_TRUE, _FALSE):
            t, v = (_TRUE if v else _FALSE), None
        delta = fid - last
        out += bytes([(delta << 4) | t]) if 0 < delta <= 15 else bytes([t]) + _zz(fid)
        if v is not None:
            out += _w_value(t, v)
        last = fid
    out.append(_STOP)
    return bytes(out)


# -- the RLE/bit-packed hybrid -------------------------------------------------


def _unpack_bits(raw: np.ndarray, width: int, count: int) -> np.ndarray:
    if width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(raw, bitorder="little")[: count * width].reshape(count, width)
    out = bits[:, 0].astype(np.int64)
    for b in range(1, width):
        out |= bits[:, b].astype(np.int64) << b
    return out


def _decode_hybrid(buf, pos: int, end: int, width: int, n: int) -> np.ndarray:
    """``n`` values of ``width`` bits from the hybrid runs in buf[pos:end]."""
    out = np.empty(n, np.int64)
    arr = np.frombuffer(buf, np.uint8)
    filled = 0
    vbytes = (width + 7) // 8
    r = _Reader(buf, pos, end)
    while filled < n:
        try:
            header = r.varint()
        except ParquetError:
            raise ParquetError("truncated page: RLE/bit-packed levels end early") from None
        if header & 1:
            count = (header >> 1) * 8
            nbytes = (header >> 1) * width
            if r.pos + nbytes > end:
                raise ParquetError("truncated page: bit-packed run past its end")
            take = min(count, n - filled)
            out[filled:filled + take] = _unpack_bits(arr[r.pos:r.pos + nbytes], width, count)[:take]
            r.pos += nbytes
        else:
            count = header >> 1
            if r.pos + vbytes > end or count == 0:
                raise ParquetError("truncated page: RLE run past its end")
            val = int.from_bytes(bytes(buf[r.pos:r.pos + vbytes]), "little")
            r.pos += vbytes
            take = min(count, n - filled)
            out[filled:filled + take] = val
        filled += take
    return out


def _encode_bitpacked(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of every value (padded to a group of 8)."""
    n = len(values)
    groups = (n + 7) // 8
    v = np.zeros(groups * 8, np.int64)
    v[:n] = values
    bits = np.empty((len(v), width), np.uint8)
    for b in range(width):
        bits[:, b] = (v >> b) & 1
    return _varint((groups << 1) | 1) + np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _encode_levels(defined: np.ndarray) -> bytes:
    """Definition levels (max 1) with their 4-byte length: one RLE run
    when every row agrees, else one bit-packed run."""
    n = len(defined)
    if n and (defined.all() or not defined.any()):
        body = _varint(n << 1) + bytes([1 if defined[0] else 0])
    elif n == 0:
        body = b""
    else:
        body = _encode_bitpacked(defined.astype(np.int64), 1)
    return struct.pack("<I", len(body)) + body


# -- PLAIN values ---------------------------------------------------------------


def _plain_byte_arrays(buf, pos: int, end: int, n: int) -> tuple[list, int]:
    out = [None] * n
    unpack = struct.unpack_from
    for i in range(n):
        if pos + 4 > end:
            raise ParquetError("truncated page: PLAIN byte array past its end")
        (ln,) = unpack("<I", buf, pos)
        pos += 4
        if pos + ln > end:
            raise ParquetError("truncated page: PLAIN byte array past its end")
        out[i] = bytes(buf[pos:pos + ln])
        pos += ln
    return out, pos


_FIXED = {DOUBLE: np.dtype("<f8"), INT32: np.dtype("<i4"), INT64: np.dtype("<i8")}


def _plain_values(ptype: int, buf, pos: int, end: int, n: int):
    """``n`` PLAIN values: a list of bytes for BYTE_ARRAY, else an array."""
    if ptype == BYTE_ARRAY:
        return _plain_byte_arrays(buf, pos, end, n)[0]
    dt = _FIXED.get(ptype)
    if dt is None:
        raise ParquetError(f"physical type {_TYPE_NAMES[ptype]} is outside the codec's subset")
    if pos + n * dt.itemsize > end:
        raise ParquetError("truncated page: PLAIN values past its end")
    return np.frombuffer(buf, dt, n, pos)


def _plain_encode_strings(values: Sequence[bytes]) -> bytes:
    pack = struct.Struct("<I").pack
    return b"".join(pack(len(v)) + v for v in values)


# -- reading -------------------------------------------------------------------


def _decompress(codec: int, body, size: int) -> bytes:
    if codec == UNCOMPRESSED:
        if len(body) != size:
            raise ParquetError("corrupt page: sizes disagree")
        return body
    if codec == SNAPPY:
        from predictionio_tpu_torch import native

        try:
            return native.snappy_decompress(body, size)
        except ValueError as e:
            raise ParquetError(f"corrupt SNAPPY page: {e}") from None
    name = _CODEC_NAMES[codec] if 0 <= codec < len(_CODEC_NAMES) else str(codec)
    raise ParquetError(f"compression codec {name} is outside the codec's subset "
                       "(UNCOMPRESSED, SNAPPY)")


class Column:
    """One leaf of the schema."""

    __slots__ = ("name", "index", "ptype", "optional", "logical")

    def __init__(self, name, index, ptype, optional, logical):
        self.name, self.index, self.ptype = name, index, ptype
        self.optional, self.logical = optional, logical

    @property
    def kind(self) -> str:
        """``string``, ``null``, ``double``, ``int32`` or ``int64``."""
        if self.logical == "null":
            return "null"
        if self.ptype == BYTE_ARRAY:
            return "string"
        return _TYPE_NAMES[self.ptype].lower()


class ParquetFile:
    """The footer of one file, and its columns read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 12:
                raise ParquetError(f"{path}: too short for a Parquet file")
            if f.read(4) != MAGIC:
                raise ParquetError(f"{path}: no Parquet magic at the start")
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] != MAGIC:
                raise ParquetError(f"{path}: no Parquet magic at the end (truncated?)")
            (flen,) = struct.unpack("<I", tail[:4])
            if flen > size - 12:
                raise ParquetError(f"{path}: footer length past the file")
            f.seek(size - 8 - flen)
            meta = _Reader(f.read(flen)).struct()
        if 8 in meta or 9 in meta:
            raise ParquetError(f"{path}: encrypted files are outside the codec's subset")
        schema = meta.get(2) or []
        if not schema:
            raise ParquetError(f"{path}: empty schema")
        self.num_rows = int(meta.get(3, 0))
        self.columns: list[Column] = []
        if schema[0].get(5, 0) != len(schema) - 1:
            raise ParquetError(f"{path}: nested columns are outside the codec's subset")
        for i, el in enumerate(schema[1:]):
            name = el[4].decode()
            if el.get(5):
                raise ParquetError(f"{path}: column {name!r} is nested (a group), "
                                   "outside the codec's subset")
            rep = el.get(3, REQUIRED)
            if rep == REPEATED:
                raise ParquetError(f"{path}: column {name!r} is repeated, outside the "
                                   "codec's subset")
            lt = el.get(10) or {}
            logical = "null" if _LT_NULL in lt else "string" if (
                _LT_STRING in lt or el.get(6) == _UTF8) else None
            self.columns.append(Column(name, i, el.get(1), rep == OPTIONAL, logical))
        self.names = [c.name for c in self.columns]
        self._by_name = {c.name: c for c in self.columns}
        self.row_groups = []
        for rg in meta.get(4) or []:
            chunks = rg.get(1) or []
            if len(chunks) != len(self.columns):
                raise ParquetError(f"{path}: a row group's chunks disagree with the schema")
            self.row_groups.append({"num_rows": int(rg.get(3, 0)),
                                    "chunks": [c.get(3) or {} for c in chunks],
                                    "file_paths": [c.get(1) for c in chunks]})

    def column(self, name: str) -> Column:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"{self.path}: no column {name!r}") from None

    def statistics(self, name: str) -> list:
        """Per row group (min, max) of a DOUBLE column from the chunk
        statistics (``min_value``/``max_value``, else the deprecated
        ``min``/``max``); None for a row group without them."""
        col = self.column(name)
        out = []
        for rg in self.row_groups:
            st = rg["chunks"][col.index].get(12)
            if not st or col.ptype != DOUBLE:
                out.append(None)
                continue
            lo, hi = st.get(6, st.get(2)), st.get(5, st.get(1))
            if lo is None or hi is None:
                out.append(None)
                continue
            out.append((struct.unpack("<d", lo)[0], struct.unpack("<d", hi)[0]))
        return out

    # -- pages -------------------------------------------------------------
    def _chunk_pages(self, f, col: Column, rg: dict):
        """Yield (kind, payload) per page of one chunk: ("dict", values) or
        ("data", (defined bool array, values or dictionary indices, is_dict))."""
        if rg["file_paths"][col.index]:
            raise ParquetError(f"{self.path}: chunks in other files are outside the subset")
        md = rg["chunks"][col.index]
        ptype = md.get(1)
        if ptype != col.ptype:
            raise ParquetError(f"{self.path}: column {col.name!r} chunk type disagrees")
        codec = md.get(4, UNCOMPRESSED)
        total = int(md.get(5, 0))
        start = md.get(11) if md.get(11) is not None else md.get(9)
        if start is None:
            raise ParquetError(f"{self.path}: column {col.name!r} has no page offset")
        f.seek(start)
        buf = f.read(int(md.get(7, 0)))
        pos, seen = 0, 0
        while seen < total:
            r = _Reader(buf, pos)
            try:
                hdr = r.struct()
            except ParquetError:
                raise ParquetError(f"{self.path}: truncated page header in column "
                                   f"{col.name!r}") from None
            pos = r.pos
            ptype_page, usize, csize = hdr.get(1), hdr.get(2, 0), hdr.get(3, 0)
            if pos + csize > len(buf):
                raise ParquetError(f"{self.path}: truncated page in column {col.name!r}")
            body = buf[pos:pos + csize]
            pos += csize
            if ptype_page == INDEX_PAGE:
                continue
            if ptype_page == DATA_PAGE_V2:
                raise ParquetError(f"{self.path}: data page v2 in column {col.name!r} is "
                                   "outside the codec's subset")
            page = _decompress(codec, body, usize)
            if ptype_page == DICTIONARY_PAGE:
                dh = hdr.get(7) or {}
                enc = dh.get(2, PLAIN)
                if enc not in (PLAIN, PLAIN_DICTIONARY):
                    raise ParquetError(f"dictionary page encoding {_ENCODING_NAMES.get(enc, enc)}")
                yield "dict", _plain_values(col.ptype, page, 0, len(page), int(dh.get(1, 0)))
                continue
            if ptype_page != DATA_PAGE:
                raise ParquetError(f"{self.path}: page type {ptype_page} in column "
                                   f"{col.name!r}")
            dh = hdr.get(5) or {}
            n = int(dh.get(1, 0))
            enc = dh.get(2, PLAIN)
            p = 0
            if col.optional:
                if dh.get(3, RLE) != RLE:
                    raise ParquetError(f"definition level encoding "
                                       f"{_ENCODING_NAMES.get(dh.get(3), dh.get(3))} is "
                                       "outside the codec's subset")
                if len(page) < 4:
                    raise ParquetError(f"{self.path}: truncated page in column {col.name!r}")
                (ln,) = struct.unpack_from("<I", page, 0)
                if 4 + ln > len(page):
                    raise ParquetError(f"{self.path}: truncated page in column {col.name!r}")
                defined = _decode_hybrid(page, 4, 4 + ln, 1, n).astype(bool)
                p = 4 + ln
            else:
                defined = np.ones(n, bool)
            present = int(defined.sum())
            if enc == PLAIN:
                vals = _plain_values(col.ptype, page, p, len(page), present)
                yield "data", (defined, vals, False)
            elif enc in (RLE_DICTIONARY, PLAIN_DICTIONARY):
                if p >= len(page) and present:
                    raise ParquetError(f"{self.path}: truncated page in column {col.name!r}")
                width = page[p] if p < len(page) else 0
                if width > 32:
                    raise ParquetError(f"{self.path}: corrupt dictionary index width {width}")
                idx = (_decode_hybrid(page, p + 1, len(page), width, present)
                       if present else np.empty(0, np.int64))
                yield "data", (defined, idx, True)
            else:
                raise ParquetError(f"value encoding {_ENCODING_NAMES.get(enc, enc)} in column "
                                   f"{col.name!r} is outside the codec's subset")
            seen += n

    def _check_type(self, col: Column) -> None:
        if col.logical != "null" and col.ptype not in (BYTE_ARRAY, DOUBLE, INT32, INT64):
            raise ParquetError(f"{self.path}: column {col.name!r} has physical type "
                               f"{_TYPE_NAMES[col.ptype]}, outside the codec's subset")

    def read_column(self, name: str) -> np.ndarray:
        """The whole column: ``object`` (str or None) for strings and Null,
        ``float64`` (NaN where null) for doubles, ``int64`` for integers
        without nulls (``object`` with None where there are)."""
        col = self.column(name)
        self._check_type(col)
        if col.logical == "null":
            self._count_rows(col)
            return np.full(self.num_rows, None, dtype=object)
        if col.ptype == BYTE_ARRAY:
            codes, values = self.read_codes(name)
            table = np.empty(len(values) + 1, dtype=object)
            table[:-1] = values
            table[-1] = None
            return table[codes]
        parts, defs = [], []
        with open(self.path, "rb") as f:
            for rg in self.row_groups:
                dictionary = None
                for kind, payload in self._chunk_pages(f, col, rg):
                    if kind == "dict":
                        dictionary = np.asarray(payload)
                        continue
                    defined, vals, is_dict = payload
                    if is_dict:
                        if dictionary is None or (len(vals) and vals.max() >= len(dictionary)):
                            raise ParquetError(f"{self.path}: dictionary index past the "
                                               f"dictionary in column {name!r}")
                        vals = dictionary[vals]
                    defs.append(defined)
                    parts.append(np.asarray(vals))
        defined = np.concatenate(defs) if defs else np.zeros(0, bool)
        self._check_length(col, defined)
        present = np.concatenate(parts) if parts else np.zeros(0, _FIXED[col.ptype])
        if col.ptype == DOUBLE:
            out = np.full(len(defined), np.nan)
            out[defined] = present
            return out
        if defined.all():
            return present.astype(np.int64)
        out = np.full(len(defined), None, dtype=object)
        out[defined] = present.astype(np.int64).astype(object)
        return out

    def read_codes(self, name: str) -> tuple[np.ndarray, list]:
        """A string (or Null) column as (codes int64, values list[str]):
        ``values[codes[i]]`` is row i, code -1 a null. Values are numbered
        in the order of their first appearance in the dictionaries and
        PLAIN pages, chunk by chunk; no Python string is made per row."""
        col = self.column(name)
        self._check_type(col)
        if col.logical == "null":
            self._count_rows(col)
            return np.full(self.num_rows, -1, np.int64), []
        if col.ptype != BYTE_ARRAY:
            raise ParquetError(f"{self.path}: column {name!r} is not a string column")
        index: dict[bytes, int] = {}
        out, defs = [], []
        with open(self.path, "rb") as f:
            for rg in self.row_groups:
                lut = None
                for kind, payload in self._chunk_pages(f, col, rg):
                    if kind == "dict":
                        lut = np.fromiter((index.setdefault(v, len(index)) for v in payload),
                                          np.int64, len(payload))
                        continue
                    defined, vals, is_dict = payload
                    if is_dict:
                        if lut is None or (len(vals) and vals.max() >= len(lut)):
                            raise ParquetError(f"{self.path}: dictionary index past the "
                                               f"dictionary in column {name!r}")
                        codes = lut[vals]
                    else:
                        page_codes, distinct = _factorize(vals)
                        lut_page = np.fromiter(
                            (index.setdefault(v, len(index)) for v in distinct), np.int64,
                            len(distinct))
                        codes = lut_page[page_codes] if len(vals) else page_codes
                    full = np.full(len(defined), -1, np.int64)
                    full[defined] = codes
                    out.append(full)
                    defs.append(defined)
        codes = np.concatenate(out) if out else np.zeros(0, np.int64)
        self._check_length(col, np.concatenate(defs) if defs else np.zeros(0, bool))
        try:
            values = [v.decode("utf-8") for v in index]
        except UnicodeDecodeError:
            raise ParquetError(f"{self.path}: column {name!r} holds invalid UTF-8") from None
        return codes, values

    def _count_rows(self, col: Column) -> None:
        """Read a Null column's pages anyway: a truncated or unreadable
        chunk raises here too, never passes as all-None."""
        defs = []
        with open(self.path, "rb") as f:
            for rg in self.row_groups:
                for kind, payload in self._chunk_pages(f, col, rg):
                    if kind == "data":
                        defs.append(payload[0])
        defined = np.concatenate(defs) if defs else np.zeros(0, bool)
        self._check_length(col, defined)
        if defined.any():
            raise ParquetError(f"{self.path}: Null column {col.name!r} holds values")

    def _check_length(self, col: Column, defined: np.ndarray) -> None:
        if len(defined) != self.num_rows:
            raise ParquetError(f"{self.path}: column {col.name!r} has {len(defined)} values "
                               f"for {self.num_rows} rows")
        if not col.optional and not defined.all():
            raise ParquetError(f"{self.path}: required column {col.name!r} has nulls")


# -- writing -------------------------------------------------------------------


def _kind_of(values: np.ndarray) -> str:
    """``double``, ``null`` or ``string``; the values of a string column
    are checked to be str when its dictionary is built (each distinct value
    once)."""
    if values.dtype.kind == "f":
        return "double"
    if values.dtype != object:
        raise TypeError(f"column of dtype {values.dtype}: the writer takes float64 or "
                        "object (str or None)")
    return "string" if np.not_equal(values, None).any() else "null"


def _factorize(values) -> tuple[np.ndarray, list]:
    """(codes, distinct values in first-occurrence order) without a Python
    loop per value: ``dict.fromkeys`` keeps the first-seen order."""
    index = {v: k for k, v in enumerate(dict.fromkeys(values))}
    codes = np.fromiter(map(index.__getitem__, values), np.int64, len(values))
    return codes, list(index)


def _page_header(page_type: int, usize: int, csize: int, sub: list) -> bytes:
    fid = 5 if page_type == DATA_PAGE else 7
    return _w_struct([(1, _I32, page_type), (2, _I32, usize), (3, _I32, csize),
                      (fid, _STRUCT, sub)])


class _ChunkWriter:
    """Pages of one column chunk, appended to the file's buffer."""

    def __init__(self, compression: int, data_page_size: int):
        self.compression = compression
        self.data_page_size = data_page_size
        self.pages: list[bytes] = []
        self.usize = 0
        self.encodings: list[int] = []
        self.dict_len = 0  # bytes of the dictionary page incl. its header

    def page(self, page_type: int, body: bytes, sub: list) -> None:
        if self.compression == SNAPPY:
            from predictionio_tpu_torch import native

            comp = native.snappy_compress(body)
        else:
            comp = body
        hdr = _page_header(page_type, len(body), len(comp), sub)
        self.pages.append(hdr + comp)
        self.usize += len(hdr) + len(body)


def _cuts(sizes: np.ndarray, limit: int) -> list[tuple[int, int]]:
    """Row ranges whose summed ``sizes`` stay near ``limit`` (≥ 1 row)."""
    n = len(sizes)
    if n == 0:
        return [(0, 0)]
    csum = np.cumsum(sizes)
    out, lo, base = [], 0, 0
    while lo < n:
        hi = int(np.searchsorted(csum, base + limit, side="right"))
        hi = max(hi, lo + 1)
        out.append((lo, min(hi, n)))
        base = csum[min(hi, n) - 1]
        lo = hi
    return out


def _write_chunk(values: np.ndarray, kind: str, cw: _ChunkWriter, dict_limit: int) -> dict:
    """Write one chunk's pages; returns what its ColumnMetaData needs."""
    n = len(values)
    stats: list = []
    if kind == "null":  # one page: its levels are one RLE run, no values
        cw.page(DATA_PAGE, _encode_levels(np.zeros(n, bool)),
                [(1, _I32, n), (2, _I32, PLAIN), (3, _I32, RLE), (4, _I32, RLE)])
        cw.encodings = [PLAIN, RLE]
        return {"ptype": INT32, "stats": [(3, _I64, n)]}
    if kind == "double":
        vals = np.ascontiguousarray(values, dtype="<f8")
        defined = np.ones(n, bool)
        for lo, hi in _cuts(np.full(n, 8), cw.data_page_size):
            body = _encode_levels(defined[lo:hi]) + vals[lo:hi].tobytes()
            cw.page(DATA_PAGE, body,
                    [(1, _I32, hi - lo), (2, _I32, PLAIN), (3, _I32, RLE), (4, _I32, RLE)])
        cw.encodings = [PLAIN, RLE]
        finite = vals[~np.isnan(vals)]
        if len(finite):
            lo_v, hi_v = float(finite.min()), float(finite.max())
            lo_v = -0.0 if lo_v == 0 else lo_v  # the spec's signed-zero rule
            hi_v = 0.0 if hi_v == 0 else hi_v
            lo_b, hi_b = struct.pack("<d", lo_v), struct.pack("<d", hi_v)
            stats = [(1, _BINARY, hi_b), (2, _BINARY, lo_b), (3, _I64, 0),
                     (5, _BINARY, hi_b), (6, _BINARY, lo_b)]
        else:
            stats = [(3, _I64, 0)]
        return {"ptype": DOUBLE, "stats": stats}
    # strings: a dictionary in first-occurrence order, unless it passes
    # dict_limit bytes, then PLAIN
    defined = np.not_equal(values, None)
    codes, distinct = _factorize(values[defined])
    bad = next((v for v in distinct if type(v) is not str), None)
    if bad is not None:
        raise TypeError(f"object column holds {type(bad).__name__}: the writer takes "
                        "str or None")
    uniq = [v.encode("utf-8") for v in distinct]
    dict_bytes = sum(map(len, uniq)) + 4 * len(uniq)
    row_of_present = np.flatnonzero(defined)
    if dict_bytes <= dict_limit and len(uniq):
        cw.page(DICTIONARY_PAGE, _plain_encode_strings(uniq),
                [(1, _I32, len(uniq)), (2, _I32, PLAIN)])
        cw.dict_len = len(cw.pages[0])
        width = max(1, int(len(uniq) - 1).bit_length())
        cuts = _cuts(np.full(n, width / 8 + 0.125), cw.data_page_size)
        starts = np.searchsorted(row_of_present, [lo for lo, _ in cuts])
        for (lo, hi), s in zip(cuts, starts):
            e = s + int(defined[lo:hi].sum())
            body = _encode_levels(defined[lo:hi]) + bytes([width]) + (
                _encode_bitpacked(codes[s:e], width) if e > s else b"")
            cw.page(DATA_PAGE, body, [(1, _I32, hi - lo), (2, _I32, RLE_DICTIONARY),
                                      (3, _I32, RLE), (4, _I32, RLE)])
        cw.encodings = [PLAIN, RLE, RLE_DICTIONARY]
    else:
        enc = [uniq[c] for c in codes]
        sizes = np.zeros(n)
        sizes[defined] = np.fromiter(map(len, enc), np.int64, len(enc)) + 4
        starts_all = np.concatenate([[0], np.cumsum(defined)])
        for lo, hi in _cuts(sizes + 0.125, cw.data_page_size):
            s, e = int(starts_all[lo]), int(starts_all[hi])
            body = _encode_levels(defined[lo:hi]) + _plain_encode_strings(enc[s:e])
            cw.page(DATA_PAGE, body, [(1, _I32, hi - lo), (2, _I32, PLAIN), (3, _I32, RLE),
                                      (4, _I32, RLE)])
        cw.encodings = [PLAIN, RLE]
    return {"ptype": BYTE_ARRAY, "stats": [(3, _I64, n - int(defined.sum()))]}


def write_table(
    path: str,
    columns: dict[str, np.ndarray],
    row_group_size: int = 1 << 20,
    data_page_size: int = 1 << 20,
    dictionary_pagesize_limit: int = 1 << 20,
    compression: str = "snappy",
) -> None:
    """Write ``columns`` (name → float64 or object array, all one length)
    as one Parquet file, in column order; pyarrow's defaults for the sizes.
    An object column of str and None is ``optional binary (String)``, one
    of only None ``optional int32 (Null)``, a float64 one ``optional
    double`` (NaN is a value, not a null, as ``pa.table`` makes it)."""
    codec = {"snappy": SNAPPY, "none": UNCOMPRESSED, "uncompressed": UNCOMPRESSED}.get(
        compression.lower())
    if codec is None:
        raise ParquetError(f"compression {compression!r} is outside the codec's subset")
    names = list(columns)
    arrays = [np.asarray(columns[c]) for c in names]
    lengths = {len(a) for a in arrays}
    if len(lengths) > 1:
        raise ValueError(f"columns of different lengths {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    kinds = [_kind_of(a) for a in arrays]
    schema = [[(4, _BINARY, "schema"), (5, _I32, len(names))]]
    for name, kind in zip(names, kinds):
        el = [(1, _I32, {"double": DOUBLE, "null": INT32, "string": BYTE_ARRAY}[kind]),
              (3, _I32, OPTIONAL), (4, _BINARY, name)]
        if kind == "string":
            el += [(6, _I32, _UTF8), (10, _STRUCT, [(_LT_STRING, _STRUCT, [])])]
        elif kind == "null":
            el += [(10, _STRUCT, [(_LT_NULL, _STRUCT, [])])]
        schema.append(el)
    out = bytearray(MAGIC)
    row_groups = []
    bounds = [(lo, min(lo + row_group_size, n)) for lo in range(0, n, max(1, row_group_size))]
    for ordinal, (lo, hi) in enumerate(bounds):
        chunks, total_u, total_c, first = [], 0, 0, None
        for name, kind, arr in zip(names, kinds, arrays):
            cw = _ChunkWriter(codec, data_page_size)
            meta = _write_chunk(arr[lo:hi], kind, cw, dictionary_pagesize_limit)
            start = len(out)
            first = start if first is None else first
            blob = b"".join(cw.pages)
            out += blob
            cmd = [(1, _I32, meta["ptype"]), (2, _LIST, (_I32, cw.encodings)),
                   (3, _LIST, (_BINARY, [name])), (4, _I32, codec), (5, _I64, hi - lo),
                   (6, _I64, cw.usize), (7, _I64, len(blob)),
                   (9, _I64, start + cw.dict_len)]
            if cw.dict_len:
                cmd.append((11, _I64, start))
            cmd.append((12, _STRUCT, meta["stats"]))
            chunks.append([(2, _I64, start), (3, _STRUCT, cmd)])
            total_u += cw.usize
            total_c += len(blob)
        row_groups.append([(1, _LIST, (_STRUCT, chunks)), (2, _I64, total_u),
                           (3, _I64, hi - lo), (5, _I64, first), (6, _I64, total_c),
                           (7, _I16, ordinal)])
    footer = _w_struct([
        (1, _I32, 2),
        (2, _LIST, (_STRUCT, schema)),
        (3, _I64, n),
        (4, _LIST, (_STRUCT, row_groups)),
        (6, _BINARY, CREATED_BY),
        (7, _LIST, (_STRUCT, [[(1, _STRUCT, [])] for _ in names])),
    ])
    out += footer + struct.pack("<I", len(footer)) + MAGIC
    with open(path, "wb") as f:
        f.write(out)
