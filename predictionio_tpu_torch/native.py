"""ctypes bindings of the port's host libraries (``csrc/host/``).

Counterpart of ``predictionio_tpu/native.py``. The compute plane is
PyTorch and CUDA; these libraries cover the data plane's CPU-bound hot
spots on the host:

* the columnar JSON property scan behind ``parquet.promote_numeric``
  (tens of millions of small JSON objects per compaction, where a per-row
  ``json.loads`` costs minutes): :func:`scan_numeric_props`;
* raw snappy, the page codec of the Parquet reader and writer
  (``data/storage/parquet_format.py``): :func:`snappy_compress`,
  :func:`snappy_decompress`.

Design rules:

* Pure C ABI loaded with ctypes. Each library is built with ``g++`` at
  first use by ``ops/_build.build_host`` into ``build/torch_kernels/``.
  A build that fails, or a machine without a compiler, raises
  ``KernelError`` with the compiler's output: there is no switch to turn
  the libraries off and no silent Python path (ROADMAP §3 logs both
  differences from the JAX package).
* The scanner is STRICT, as in the JAX package: anything surprising
  (malformed JSON, nulls, duplicate keys, string-typed numerics) makes it
  *decline* the whole batch (``None``), and the caller runs its
  exact-semantics Python path. That is the JAX package's semantics, not a
  fallback: the scanner may only ever return columns the Python path
  would return bit for bit.
* Snappy is never strict in that sense: a corrupt stream raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from predictionio_tpu_torch.ops._build import KernelError, host_library

_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()

_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p


def _bind_props(lib: ctypes.CDLL) -> None:
    lib.pio_props_scan.restype = ctypes.c_void_p
    lib.pio_props_scan.argtypes = [_PTR, ctypes.POINTER(_I64), _I64]
    lib.pio_props_nkeys.restype = _I64
    lib.pio_props_nkeys.argtypes = [ctypes.c_void_p]
    lib.pio_props_key_name.restype = ctypes.c_char_p
    lib.pio_props_key_name.argtypes = [ctypes.c_void_p, _I64]
    lib.pio_props_key_flags.restype = ctypes.c_int32
    lib.pio_props_key_flags.argtypes = [ctypes.c_void_p, _I64]
    lib.pio_props_key_column.restype = ctypes.POINTER(ctypes.c_double)
    lib.pio_props_key_column.argtypes = [ctypes.c_void_p, _I64]
    lib.pio_props_free.argtypes = [ctypes.c_void_p]


def _bind_snappy(lib: ctypes.CDLL) -> None:
    lib.pio_snappy_max_compressed_length.restype = _I64
    lib.pio_snappy_max_compressed_length.argtypes = [_I64]
    for fn in (lib.pio_snappy_compress, lib.pio_snappy_decompress):
        fn.restype = _I64
        fn.argtypes = [_PTR, _I64, _PTR, _I64]
    lib.pio_snappy_uncompressed_length.restype = _I64
    lib.pio_snappy_uncompressed_length.argtypes = [_PTR, _I64]


_BINDERS = {"jsonprops": _bind_props, "snappy": _bind_snappy}


def load(name: str = "jsonprops") -> ctypes.CDLL:
    """The host library ``csrc/host/<name>.cpp``, built on first use
    (``jsonprops`` by default, the JAX ``native.load``'s library)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            path = host_library(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"host library {path} did not load: {e}") from e
            _BINDERS[name](lib)
            _libs[name] = lib
    return lib


def _addr(buf) -> int:
    """Address of a writable or read-only contiguous byte buffer."""
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


_SNAPPY_ERRORS = {
    -1: "no valid length header",
    -2: "declared length exceeds the expected size",
    -3: "truncated stream",
    -4: "copy offset out of range",
    -5: "element past the declared length",
    -6: "stream ends short of its declared length",
}


def snappy_compress(data) -> bytes:
    """Raw snappy of ``data`` (bytes-like)."""
    lib = load("snappy")
    src = memoryview(data).cast("B")
    n = src.nbytes
    cap = lib.pio_snappy_max_compressed_length(n)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    got = lib.pio_snappy_compress(_addr(src) if n else None, n, out.ctypes.data, cap)
    if got < 0:
        raise KernelError(f"snappy compression failed ({got})")
    return out[:got].tobytes()


def snappy_decompress(data, expected: Optional[int] = None) -> bytes:
    """Inflate one raw snappy stream; ``expected`` (the page header's
    uncompressed size) must equal the length the stream declares. Raises
    ``ValueError`` on a corrupt or truncated stream."""
    lib = load("snappy")
    src = memoryview(data).cast("B")
    n = src.nbytes
    addr = _addr(src) if n else None
    want = lib.pio_snappy_uncompressed_length(addr, n)
    if want < 0:
        raise ValueError(f"corrupt snappy stream: {_SNAPPY_ERRORS[-1]}")
    if expected is not None and want != expected:
        raise ValueError(
            f"corrupt snappy stream: declares {want} bytes, the page {expected}")
    out = np.empty(max(want, 1), dtype=np.uint8)
    got = lib.pio_snappy_decompress(addr, n, out.ctypes.data, want)
    if got < 0:
        raise ValueError(f"corrupt snappy stream: {_SNAPPY_ERRORS.get(got, got)}")
    return out[:got].tobytes()


def scan_numeric_props(props) -> Optional[dict[str, np.ndarray]]:
    """Columnar float64 columns for promotable numeric property keys.

    ``props`` is a sequence of JSON-object strings (one per row). Returns
    {key: (nrows,) float64 array, NaN where absent} covering exactly the
    keys whose present values are all JSON numbers or booleans — the
    subset where C and Python coercion agree bit-for-bit. Keys with
    null/object/array values, or strings that provably cannot coerce with
    ``float`` (most labels/ids), are rejected exactly as the Python path
    rejects them. Returns None — the scanner declines and the caller runs
    its Python path — when any row fails to parse, any cell is null or not
    a string, or a string value MIGHT be float-coercible (e.g. ``"3"``:
    Python's coercion semantics must decide).
    """
    lib = load("jsonprops")
    n = len(props)
    encoded = []
    for p in props:
        if not isinstance(p, str):
            return None
        try:
            encoded.append(p.encode("utf-8"))
        except UnicodeEncodeError:  # a lone surrogate: not JSON text
            return None
    # one contiguous UTF-8 buffer + int64 offsets: the layout the C ABI
    # takes. The sentinel "{}" row guarantees any malformed trailing
    # number in the last real row terminates inside the buffer.
    encoded.append(b"{}")
    offsets = np.zeros(n + 2, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, encoded), dtype=np.int64, count=n + 1),
              out=offsets[1:])
    buf = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    handle = lib.pio_props_scan(
        buf.ctypes.data,
        offsets.ctypes.data_as(ctypes.POINTER(_I64)),
        n,
    )
    if not handle:
        return None
    try:
        out: dict[str, np.ndarray] = {}
        for i in range(lib.pio_props_nkeys(handle)):
            flags = lib.pio_props_key_flags(handle, i)
            if flags & 1:  # saw a string value: Python coercion semantics
                return None
            if flags & 2:  # null/object/array: key is not promotable
                continue
            name = lib.pio_props_key_name(handle, i).decode("utf-8")
            col_ptr = lib.pio_props_key_column(handle, i)
            if not col_ptr:  # defensive: a clean key always has a column
                return None
            out[name] = np.ctypeslib.as_array(col_ptr, shape=(n,)).copy()
        return out
    finally:
        lib.pio_props_free(handle)
