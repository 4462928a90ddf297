"""The ALS training kernels' wrappers and their plain PyTorch versions:
the dense solver's normal equations (kernel 2), the row gather (kernel 3)
and the segment solver's normal equations (kernel 3's redesign).

**Kernel 2** replaces the Pallas kernel ``predictionio_tpu/ops/train_kernel.py``
``_train_contract_kernel``, reached through ``fused_train_normal_eq``: per
bucket of the dense solver, gather the opposite factors ``V[idx]``
(int8 rows times their per-row scale) and accumulate ``A``, ``b`` and
``cnt``. The kernel is ``csrc/train_normal_eq.cu``, built with ``nvcc`` for
``sm_90a`` at first use (``ops/_build.py``) and called through ``ctypes``;
its source note says what bounds it and how it is laid out. In short: a
warp sums a row's live slots, 32 at a time, into its share of the row's
sums (explicit A only for i ≤ j, stored twice); rows of at most
:data:`NARROW_MAX` slots take a warp each, wider rows a block each, cut into
parts when the bucket has few rows and summed in part order by a second
grid (:func:`dense_plan`), so every sum has one order and one seed gives
one model.

**Kernel 3** replaces ``_gather_rows_kernel``, reached through
``fused_gather_rows``: ``V[idx]`` widened to float32 (int8 rows times their
scale). The kernel is ``csrc/gather_rows.cu``, one thread per output value.
It is the one-to-one counterpart of the TPU kernel; the segment solver's
path no longer calls it.

**The segment normal equations** (:func:`fused_segment_normal_eq`) are
kernel 3 redesigned for the card together with the chunk body it fed
(``models/als.py:_half_step_local``'s scan): one launch a half-step of
``csrc/segment_normal_eq.cu`` gathers V's rows itself and sums each
entity's outer products, right-hand sides and counts in the JAX package's
order (chunk by chunk, stream order within a chunk), over the stream sorted
by entity once per side (:func:`segment_layout`). No atomics: it equals
its plain version, :func:`segment_normal_eq_reference` (the scan's body per
chunk, ``index_add_`` into zeros), bit for bit.

:func:`fused_train_normal_eq`, :func:`fused_gather_rows` and
:func:`fused_segment_normal_eq` route by device and nothing else:

* tensors on the CPU take :func:`train_normal_eq_reference`,
  :func:`gather_rows_reference` and :func:`segment_normal_eq_reference`,
  the plain versions the CPU tests run;
* tensors on a CUDA device launch the kernel, or raise on a device, dtype,
  shape or contiguity the kernel does not take, or on a CUDA error.

On either device a rank above :data:`MAX_RANK` raises in the dense normal
equations, and one above :data:`MAX_SEGMENT_RANK` in the segment ones; the
gather takes any rank while n·k stays within :data:`MAX_ELEMENTS`. There is
no ``try`` that falls back and no environment variable that picks the plain
version on the card: on the card V is read through L2, so the JAX
package's VMEM budget and its demotion to the XLA path (``fits_vmem``,
``models/als.py:675-693``) have no counterpart for any of them.
:data:`launches` counts kernel 2's launches (one per call: one or two CUDA
grids), :data:`gather_launches` kernel 3's and :data:`segment_launches` the
segment kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.ops.score_kernel import LaunchCounter
from predictionio_tpu_torch.ops.segment import segment_sum

# The grain of a wide row's parts, in slots, and the largest rank the kernel
# takes (the C source's TILE and MAX_RANK).
TILE = 64
MAX_RANK = 64
# Widest row a warp takes alone; wider rows take a block.
NARROW_MAX = 512
# Slots one thread block takes of a row before the row is cut into parts,
# and the blocks per SM a launch aims for when it cuts wide rows.
SEG_MIN = 2048
BLOCKS_PER_SM = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = LaunchCounter()
gather_launches = LaunchCounter()
segment_launches = LaunchCounter()

# Kernel 3: the most values (n·k) one call writes (the C source's
# MAX_ELEMENTS: its flat index is 32-bit).
MAX_ELEMENTS = 2**31 - 1


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX converts a weakly typed scalar
    before it multiplies a float32 array."""
    return float(np.float32(x))


def train_normal_eq_reference(
    idx: torch.Tensor,
    rat: torch.Tensor,
    msk: torch.Tensor,
    V: torch.Tensor,
    v_scale: Optional[torch.Tensor] = None,
    *,
    implicit: bool = False,
    alpha: float = 1.0,
    accumulate: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: the JAX package's reference math
    (``models/als.py:644-665``) with its cast points.

    int8 dequantizes before the gather; bf16 keeps the gathered rows and the
    weights in bf16, rounds their elementwise products to bf16, and forms
    the contractions as float32 products (exact for bf16 operands) summed in
    float32, which is what ``preferred_element_type=f32`` asks of XLA. An
    index outside ``[0, n_opp)`` is clamped, as XLA's gather clamps it. On
    the card the contractions run in full float32 (TF32 off for the call).
    ``accumulate=torch.float64`` forms the same operands and sums them in
    float64 (``A`` and ``b`` come back in float64): the near-exact sums the
    checks measure the kernel and this version against.
    """
    f32, acc = torch.float32, accumulate
    opp = V if v_scale is None else V.to(f32) * v_scale
    Vg = opp[idx.long().clamp(0, V.shape[0] - 1)]  # (n_b, D, k), compute dtype
    cd = Vg.dtype
    w = msk.to(cd)
    a = _f32(alpha)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if implicit:
            # A_u += Σ α·r · v vᵀ ;  b_u += Σ (1+α·r) · v   (p=1, c=1+αr)
            cw = (a * rat).to(cd) * w
            A = torch.einsum("edk,edl->ekl", (Vg * cw[:, :, None]).to(acc), Vg.to(acc))
            b = torch.einsum(
                "edk,ed->ek", Vg.to(acc), ((1.0 + a * rat).to(cd) * w).to(acc)
            )
            cnt = torch.zeros(idx.shape[0], dtype=f32, device=idx.device)
        else:
            W = (Vg * w[:, :, None]).to(acc)
            A = torch.einsum("edk,edl->ekl", W, W)
            b = torch.einsum("edk,ed->ek", W, rat.to(cd).to(acc))
            cnt = msk.sum(-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return A, b, cnt


_lib = None
_lib_lock = threading.Lock()


def _library():
    """The built kernel library (built on first use, once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from predictionio_tpu_torch.ops import _build

            lib = ctypes.CDLL(str(_build.library("train_normal_eq")))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_train_normal_eq.argtypes = (
                [p] * 9 + [i] * 9 + [ctypes.c_float, p]
            )
            lib.pio_train_normal_eq.restype = i
            lib.pio_train_normal_eq_limits.argtypes = [p, p]
            lib.pio_train_normal_eq_limits.restype = i
            lib.pio_train_error_string.argtypes = [i]
            lib.pio_train_error_string.restype = ctypes.c_char_p
            tile, max_rank = ctypes.c_int(), ctypes.c_int()
            lib.pio_train_normal_eq_limits(ctypes.byref(tile), ctypes.byref(max_rank))
            if (tile.value, max_rank.value) != (TILE, MAX_RANK):
                raise KernelError("train_normal_eq.cu TILE/MAX_RANK disagree with Python")
            _lib = lib
        return _lib


def split_plan(n_b: int, D: int, n_sm: int) -> tuple[int, int]:
    """``(splits, seg)``: each row's D slots cut into ``splits`` parts of
    ``seg`` slots (a TILE multiple). A row is cut only when it is wider than
    :data:`SEG_MIN` and the bucket has too few rows to give the card's
    ``n_sm`` SMs :data:`BLOCKS_PER_SM` blocks each."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // n_b))
    splits = max(1, min(-(-D // SEG_MIN), want))
    seg = -(-(-(-D // splits)) // TILE) * TILE
    return -(-D // seg), seg


def dense_plan(n_b: int, D: int, n_sm: int) -> tuple[bool, int, int]:
    """``(narrow, splits, seg)``: how the kernel deals one bucket's rows.
    Rows of at most :data:`NARROW_MAX` slots take a warp each, eight to a
    block (``narrow``, one part of D slots); wider rows take a block each,
    cut by :func:`split_plan`."""
    if D <= NARROW_MAX:
        return True, 1, D
    return (False, *split_plan(n_b, D, n_sm))


def _check(t: Optional[torch.Tensor], name: str, device, dtypes, shape) -> None:
    if t is None:
        return
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise KernelError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise KernelError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise KernelError(f"{name} must be contiguous")


def fused_train_normal_eq(
    idx: torch.Tensor,
    rat: torch.Tensor,
    msk: torch.Tensor,
    V: torch.Tensor,
    v_scale: Optional[torch.Tensor] = None,
    *,
    implicit: bool = False,
    alpha: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bucket's normal equations: ``(A (n_b, k, k), b (n_b, k),
    cnt (n_b,))``, all float32.

    ``idx`` (n_b, D) int32 holds opposite-entity rows, ``rat`` and ``msk``
    (n_b, D) float32 the ratings and the 1/0 slot mask. ``V`` (n_opp, k) is
    f32, bf16 or int8; int8 needs ``v_scale`` (n_opp, 1) f32. A masked slot
    contributes exactly zero whatever its idx; implicit gives ``cnt = 0``.
    """
    n_opp, k = V.shape
    if not 1 <= k <= MAX_RANK:
        raise KernelError(
            f"rank {k} is outside the training kernel's range 1..{MAX_RANK}"
        )
    device = V.device
    if device.type == "cpu":
        return train_normal_eq_reference(
            idx, rat, msk, V, v_scale, implicit=implicit, alpha=alpha
        )
    if device.type != "cuda":
        raise KernelError(f"no training kernel for device {device}")
    if V.dtype not in _DTYPE_CODE:
        raise KernelError(f"V dtype {V.dtype} not supported")
    if (V.dtype == torch.int8) != (v_scale is not None):
        raise KernelError("v_scale goes with int8 V, and only with it")
    if idx.dim() != 2 or idx.shape[0] == 0 or idx.shape[1] == 0:
        raise KernelError(f"idx must be a non-empty (n_b, D) matrix, got {tuple(idx.shape)}")
    n_b, D = idx.shape
    _check(idx, "idx", device, (torch.int32,), (n_b, D))
    _check(rat, "rat", device, (torch.float32,), (n_b, D))
    _check(msk, "msk", device, (torch.float32,), (n_b, D))
    _check(V, "V", device, (V.dtype,), (n_opp, k))
    _check(v_scale, "v_scale", device, (torch.float32,), (n_opp, 1))
    lib = _library()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    narrow, splits, seg = dense_plan(n_b, D, n_sm)
    A = torch.empty((n_b, k, k), dtype=torch.float32, device=device)
    b = torch.empty((n_b, k), dtype=torch.float32, device=device)
    cnt = torch.empty((n_b,), dtype=torch.float32, device=device)
    parts = None
    if splits > 1:
        parts = torch.empty((n_b, splits, k * k + k + 1), dtype=torch.float32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_train_normal_eq(
            ptr(idx), ptr(rat), ptr(msk), ptr(V), ptr(v_scale), ptr(A), ptr(b),
            ptr(cnt), ptr(parts), n_b, D, n_opp, k, int(narrow), splits, seg,
            _DTYPE_CODE[V.dtype], int(bool(implicit)), _f32(alpha), stream,
        )
    if rc != 0:
        msg = lib.pio_train_error_string(rc).decode()
        raise KernelError(f"train_normal_eq kernel launch failed: {msg} ({rc})")
    launches.bump()
    return A, b, cnt


# -- kernel 3: the segment solver's row gather --------------------------------


def gather_rows_reference(
    V: torch.Tensor, idx: torch.Tensor, v_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's plain PyTorch version, the JAX package's reference math
    (``models/als.py:480-488,497``): dequantize V (int8 times its per-row
    scale), gather the rows (an index outside ``[0, n_opp)`` clamped, as
    XLA's gather clamps it), widen to float32."""
    opp = V if v_scale is None else V.float() * v_scale
    return opp[idx.long().clamp(0, V.shape[0] - 1)].float()


_gather_lib = None


def _gather_library():
    """The built gather library (built on first use, once per process)."""
    global _gather_lib
    with _lib_lock:
        if _gather_lib is None:
            from predictionio_tpu_torch.ops import _build

            lib = ctypes.CDLL(str(_build.library("gather_rows")))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_gather_rows.argtypes = [p] * 4 + [i] * 4 + [p]
            lib.pio_gather_rows.restype = i
            lib.pio_gather_rows_limits.argtypes = [p]
            lib.pio_gather_rows_limits.restype = i
            lib.pio_gather_rows_error_string.argtypes = [i]
            lib.pio_gather_rows_error_string.restype = ctypes.c_char_p
            most = ctypes.c_longlong()
            lib.pio_gather_rows_limits(ctypes.byref(most))
            if most.value != MAX_ELEMENTS:
                raise KernelError("gather_rows.cu MAX_ELEMENTS disagrees with Python")
            _gather_lib = lib
        return _gather_lib


def fused_gather_rows(
    V: torch.Tensor, idx: torch.Tensor, v_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``V[idx]`` widened to float32: ``(n, k)``.

    ``V`` (n_opp, k) is f32, bf16 or int8; int8 needs ``v_scale`` (n_opp, 1)
    f32, and only int8 takes one. ``idx`` (n,) int32; an index outside
    ``[0, n_opp)`` is clamped. The result equals :func:`gather_rows_reference`
    bit for bit on either device. ``n = 0`` returns an empty ``(0, k)`` tensor
    and launches nothing.
    """
    if V.dim() != 2 or V.shape[0] == 0 or V.shape[1] == 0:
        raise KernelError(f"V must be a non-empty (n_opp, k) matrix, got {tuple(V.shape)}")
    if V.dtype not in _DTYPE_CODE:
        raise KernelError(f"V dtype {V.dtype} not supported")
    if (V.dtype == torch.int8) != (v_scale is not None):
        raise KernelError("v_scale goes with int8 V, and only with it")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise KernelError(f"idx must be a (n,) int32 vector, got {idx.dtype} {tuple(idx.shape)}")
    n_opp, k = V.shape
    (n,) = idx.shape
    if n * k > MAX_ELEMENTS:
        raise KernelError(f"{n} rows of rank {k} exceed the gather kernel's {MAX_ELEMENTS} values")
    device = V.device
    if device.type == "cpu":
        return gather_rows_reference(V, idx, v_scale)
    if device.type != "cuda":
        raise KernelError(f"no gather kernel for device {device}")
    _check(idx, "idx", device, (torch.int32,), (n,))
    _check(V, "V", device, (V.dtype,), (n_opp, k))
    _check(v_scale, "v_scale", device, (torch.float32,), (n_opp, 1))
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _gather_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_gather_rows(
            idx.data_ptr(), V.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(), out.data_ptr(),
            n, n_opp, k, _DTYPE_CODE[V.dtype], stream,
        )
    if rc != 0:
        msg = lib.pio_gather_rows_error_string(rc).decode()
        raise KernelError(f"gather_rows kernel launch failed: {msg} ({rc})")
    gather_launches.bump()
    return out


# -- the segment solver's normal equations (kernel 3 redesigned) ---------------

# The largest rank the segment kernel takes (the C source's MAX_RANK).
MAX_SEGMENT_RANK = 1024
# An entity with at least this many slots, and more than one run, is reduced by a
# whole block (its runs spread over the block's warps), the others by one warp.
HEAVY_SLOTS = 4096
# The most slots a stream may hold: the layout's offsets are int32.
MAX_SLOTS = 2**31 - 1


@dataclasses.dataclass
class SegmentLayout:
    """One side's rating stream laid out for :func:`fused_segment_normal_eq`.

    The real slots sorted by entity, stably: each entity's slots keep their
    stream order and fall into runs, one for each chunk of ``chunk`` slots
    that holds any, in chunk order. Padding (mask 0) is dropped: it adds
    only ±0 to any sum. All offsets are int32. ``stream`` keeps the stream
    in its own order, ``(local, other, rating, mask)``, for the plain
    version; it is kept only on the CPU.
    """

    other: torch.Tensor  # (nnz,) int32, the opposite entity of each sorted slot
    rating: torch.Tensor  # (nnz,) float32
    run_offsets: torch.Tensor  # (n_runs + 1,) int32, slot offsets of the runs
    entity_runs: torch.Tensor  # (n_entity + 1,) int32, run offsets of the entities
    heavy: torch.Tensor  # (n_heavy,) int32, entities a block reduces, by id
    light: torch.Tensor  # (n_light,) int32, entities a warp reduces, most slots first
    n_entity: int
    chunk: int
    stream: Optional[tuple] = None


def segment_layout(
    local: torch.Tensor,
    other: torch.Tensor,
    rating: torch.Tensor,
    mask: torch.Tensor,
    n_entity: int,
    *,
    chunk: int,
) -> SegmentLayout:
    """Sort one side's padded stream by entity for the segment kernel, on the
    stream's own device (``torch.sort(stable=True)``). ``local`` and
    ``other`` are int32, ``rating`` and ``mask`` float32 with mask 1 for a
    real slot and 0 for padding; ``chunk`` is the half-step's chunk (the
    JAX package's ``min(length, _CHUNK)``), which sets the runs."""
    length = local.shape[0]
    if length > MAX_SLOTS:
        raise KernelError(
            f"{length} slots exceed the segment kernel's {MAX_SLOTS} (its offsets are int32)"
        )
    if not bool(((mask == 0) | (mask == 1)).all()):
        raise KernelError("the segment layout takes a 0/1 mask")
    device = local.device
    # intermediates are freed as soon as they are used: on the card this
    # runs beside the other side's layout
    real = torch.nonzero(mask).squeeze(1)
    entity, order = torch.sort(local[real], stable=True)
    pos = real[order]
    del real, order
    nnz = pos.shape[0]
    if nnz and (int(entity[0]) < 0 or int(entity[-1]) >= n_entity):
        raise KernelError(f"entity ids must lie in [0, {n_entity})")
    other_s, rating_s = other[pos].to(torch.int32), rating[pos].to(torch.float32)
    run_chunk = torch.div(pos, chunk, rounding_mode="floor")
    del pos
    new_run = torch.ones(nnz, dtype=torch.bool, device=device)
    new_run[1:] = (entity[1:] != entity[:-1]) | (run_chunk[1:] != run_chunk[:-1])
    del run_chunk
    starts = torch.nonzero(new_run).squeeze(1)
    del new_run
    runs = torch.bincount(entity[starts], minlength=n_entity)
    slots = torch.bincount(entity, minlength=n_entity)
    del entity
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    is_heavy = (slots >= HEAVY_SLOTS) & (runs > 1)
    light = torch.nonzero(~is_heavy).squeeze(1)
    light = light[torch.sort(slots[light], descending=True, stable=True).indices]
    return SegmentLayout(
        other=other_s,
        rating=rating_s,
        run_offsets=torch.cat([starts, zero + nnz]).to(torch.int32),
        entity_runs=torch.cat([zero, torch.cumsum(runs, 0)]).to(torch.int32),
        heavy=torch.nonzero(is_heavy).squeeze(1).to(torch.int32),
        light=light.to(torch.int32),
        n_entity=n_entity,
        chunk=chunk,
        stream=(local, other, rating, mask) if device.type == "cpu" else None,
    )


def segment_normal_eq_reference(
    local: torch.Tensor,
    other: torch.Tensor,
    rating: torch.Tensor,
    mask: torch.Tensor,
    n_entity: int,
    V: torch.Tensor,
    v_scale: Optional[torch.Tensor] = None,
    *,
    implicit: bool = False,
    alpha: float = 1.0,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The segment kernel's plain PyTorch version: the JAX package's scan body
    (``models/als.py:484-507``) chunk by chunk over the stream in its own
    order. Per chunk of ``chunk`` slots gather the rows (float32), add the
    chunk's outer products, right-hand sides and counts into A, b and cnt,
    every operation float32 (no TF32: there is no matrix product). As in
    the JAX package the carry is ``A = A + segment_sum(chunk)``, not an add
    into A in place: with more than one chunk the in-place form sums in
    another order. On the CPU ``index_add_`` adds in stream order, as JAX
    does; on the card it adds with float atomics, in no fixed order."""
    n, k = n_entity, V.shape[1]
    alpha = _f32(alpha)
    L = local.shape[0]
    chunk = min(L, chunk)
    A = torch.zeros((n, k, k), dtype=torch.float32, device=V.device)
    b = torch.zeros((n, k), dtype=torch.float32, device=V.device)
    cnt = torch.zeros((n,), dtype=torch.float32, device=V.device)
    for s in range(0, L, chunk):
        lo, ot = local[s: s + chunk], other[s: s + chunk]
        rt, w = rating[s: s + chunk], mask[s: s + chunk]
        vs = gather_rows_reference(V, ot, v_scale)  # (chunk, k) f32
        if implicit:
            # A_u += Σ α·r · v vᵀ ;  b_u += Σ (1+α·r) · v   (p=1, c=1+αr)
            cw = alpha * rt * w
            outer = vs[:, :, None] * (vs * cw[:, None])[:, None, :]
            A = A + segment_sum(outer, lo, n)
            b = b + segment_sum(vs * ((1.0 + alpha * rt) * w)[:, None], lo, n)
        else:
            vsw = vs * w[:, None]
            outer = vsw[:, :, None] * vsw[:, None, :]
            A = A + segment_sum(outer, lo, n)
            cnt = cnt + segment_sum(w, lo, n)
            b = b + segment_sum(vsw * rt[:, None], lo, n)
    return A, b, cnt


_segment_lib = None


def _segment_library():
    """The built segment library (built on first use, once per process)."""
    global _segment_lib
    with _lib_lock:
        if _segment_lib is None:
            from predictionio_tpu_torch.ops import _build

            lib = ctypes.CDLL(str(_build.library("segment_normal_eq")))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_segment_normal_eq.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, p]
            lib.pio_segment_normal_eq.restype = i
            lib.pio_segment_normal_eq_limits.argtypes = [p]
            lib.pio_segment_normal_eq_limits.restype = i
            lib.pio_segment_error_string.argtypes = [i]
            lib.pio_segment_error_string.restype = ctypes.c_char_p
            rank = ctypes.c_int()
            lib.pio_segment_normal_eq_limits(ctypes.byref(rank))
            if rank.value != MAX_SEGMENT_RANK:
                raise KernelError("segment_normal_eq.cu MAX_RANK disagrees with Python")
            _segment_lib = lib
        return _segment_lib


def fused_segment_normal_eq(
    layout: SegmentLayout,
    V: torch.Tensor,
    v_scale: Optional[torch.Tensor] = None,
    *,
    implicit: bool = False,
    alpha: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One segment half-step's normal equations: ``(A (n, k, k), b (n, k),
    cnt (n,))``, float32, n = ``layout.n_entity``.

    ``V`` (n_opp, k) is f32, bf16 or int8; int8 needs ``v_scale`` (n_opp, 1)
    f32, and only int8 takes one. An opposite id outside ``[0, n_opp)`` is
    clamped, as XLA's gather clamps it. Implicit gives ``cnt = 0``. On CPU
    tensors the plain version sums ``layout.stream``; on a CUDA card one
    launch sums the sorted layout, and the two are equal bit for bit.
    """
    if V.dim() != 2 or V.shape[0] == 0 or V.shape[1] == 0:
        raise KernelError(f"V must be a non-empty (n_opp, k) matrix, got {tuple(V.shape)}")
    if V.dtype not in _DTYPE_CODE:
        raise KernelError(f"V dtype {V.dtype} not supported")
    if (V.dtype == torch.int8) != (v_scale is not None):
        raise KernelError("v_scale goes with int8 V, and only with it")
    n_opp, k = V.shape
    if k > MAX_SEGMENT_RANK:
        raise KernelError(
            f"rank {k} is outside the segment kernel's range 1..{MAX_SEGMENT_RANK}")
    n = layout.n_entity
    device = V.device
    if device.type == "cpu":
        if layout.stream is None:
            raise KernelError("V is on the CPU but the layout was built on another device")
        return segment_normal_eq_reference(
            *layout.stream, n, V, v_scale, implicit=implicit, alpha=alpha, chunk=layout.chunk)
    if device.type != "cuda":
        raise KernelError(f"no segment kernel for device {device}")
    nnz = layout.other.shape[0]
    n_runs = layout.run_offsets.shape[0] - 1
    _check(layout.other, "other", device, (torch.int32,), (nnz,))
    _check(layout.rating, "rating", device, (torch.float32,), (nnz,))
    _check(layout.run_offsets, "run_offsets", device, (torch.int32,), (n_runs + 1,))
    _check(layout.entity_runs, "entity_runs", device, (torch.int32,), (n + 1,))
    n_heavy, n_light = layout.heavy.shape[0], layout.light.shape[0]
    _check(layout.heavy, "heavy", device, (torch.int32,), (n_heavy,))
    _check(layout.light, "light", device, (torch.int32,), (n_light,))
    if n_heavy + n_light != n:
        raise KernelError(f"heavy and light list {n_heavy + n_light} entities, expected {n}")
    _check(V, "V", device, (V.dtype,), (n_opp, k))
    _check(v_scale, "v_scale", device, (torch.float32,), (n_opp, 1))
    A = torch.empty((n, k, k), dtype=torch.float32, device=device)
    b = torch.empty((n, k), dtype=torch.float32, device=device)
    cnt = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return A, b, cnt
    lib = _segment_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_segment_normal_eq(
            ptr(layout.other), ptr(layout.rating), ptr(layout.run_offsets),
            ptr(layout.entity_runs), ptr(layout.heavy), ptr(layout.light), ptr(V),
            ptr(v_scale), ptr(A), ptr(b), ptr(cnt), n_heavy, n_light, n_opp, k,
            _DTYPE_CODE[V.dtype], int(bool(implicit)), _f32(alpha), stream,
        )
    if rc != 0:
        msg = lib.pio_segment_error_string(rc).decode()
        raise KernelError(f"segment_normal_eq kernel launch failed: {msg} ({rc})")
    segment_launches.bump()
    return A, b, cnt
