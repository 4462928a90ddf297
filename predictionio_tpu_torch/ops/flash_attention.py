"""Exact softmax attention, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Replaces the three Pallas kernels of ``predictionio_tpu/ops/flash_attention.py``:

* ``_flash_kernel`` (the forward), reached through ``_flash_2d_res`` from
  ``flash_attention`` (every SASRec layer at a flash-eligible length) and
  ``flash_block_fwd`` (one block pair of ring attention), by
  ``csrc/flash_fwd.cu``: a block per (batch·head, query tile, split of the
  tile's keys) from :func:`split_plan`, a warp per 16 rows keeping the
  online-softmax state (m, l, acc) in mma fragments, key/value tiles staged
  by ``cp.async``, products on the tensor cores in the 3xTF32 form; the
  last block of a split tile merges the splits' partials in split order;
* ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the recomputation-form
  backward), reached through ``_flash_2d_bwd`` from the custom VJP and
  ``flash_block_bwd``, by ``csrc/flash_bwd.cu``: one block per (batch·head,
  query tile of :func:`dq_plan`'s rows, 64-column slice of the head) for dq
  and one per (batch·head, 64-key tile, 64-column slice) for dk and dv, each
  looping over the other axis, so no sum crosses blocks; both run their
  products on the tensor cores in the 3xTF32 form.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use
(``ops/_build.py``) and called through ``ctypes``; each source note says
what bounds it and how it is laid out. :class:`_FlashAttention` is the
``torch.autograd.Function`` that ``flash_attention`` returns through: its
forward is :func:`flash_block_fwd`, its backward :func:`flash_block_bwd`.

What it computes is the TPU kernel's definition: ``s = (q·scale) kᵀ``, the
causal mask by absolute position (``q_pos >= k_pos``, also for
``T_q != T_kv``), masked scores set to ``NEG_INF`` = -1e30, softmax with
float32 accumulators, ``o = acc / max(l, 1e-30)`` in q's dtype and
``lse = m + log(max(l, 1e-30))`` in float32.

The wrappers route by device and nothing else:

* tensors on the CPU take :func:`flash_attention_reference`, the plain
  version (the dense softmax, also what ``parallel/ring.full_attention``
  computes);
* tensors on a CUDA device launch the kernel, or raise on a dtype, head
  width, shape or contiguity the kernel does not take, or on a CUDA error.

There is no ``try`` that falls back and no environment variable that picks
the plain version on the card. :data:`launches`, :data:`bwd_dq_launches`
and :data:`bwd_dkv_launches` count each kernel's launches (one per call,
whatever the batch·head count).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.ops.score_kernel import LaunchCounter

NEG_INF = -1e30
# The JAX package's default blocks: the lengths it refuses at them are
# refused here too (``flash_attention``'s ValueError).
BLOCK_Q = 128
BLOCK_K = 128
# Rows of a query and of a key/value tile in the kernel, and the widest head
# it takes (the C source's TILE and MAX_HEAD).
TILE = 64
MAX_HEAD = 256
# The forward's smallest query tile (one warp's rows), and the most splits
# :func:`split_plan` cuts a tile's keys into.
MIN_Q_ROWS = 16
MAX_SPLITS = 8

launches = LaunchCounter()  # the forward kernel (4)
bwd_dq_launches = LaunchCounter()  # the backward's dq kernel (5)
bwd_dkv_launches = LaunchCounter()  # the backward's dk/dv kernel (6)


def use_flash_default(t: int, device) -> bool:
    """The JAX package's shape policy for the flash path: long 128-aligned
    blocks on the accelerator; short blocks and the CPU stay dense."""
    return t >= 256 and t % BLOCK_Q == 0 and torch.device(device).type == "cuda"


def _tile_keys(t_q: int, t_kv: int, causal: bool, q_rows: int) -> list[int]:
    """Keys some row of each query tile of ``q_rows`` rows sees, tile 0
    first: all of them, or under a causal mask those up to its last row."""
    return [min(t_kv, q0 + q_rows, t_q) if causal else t_kv for q0 in range(0, t_q, q_rows)]


def plan_blocks(n_bh: int, t_q: int, t_kv: int, causal: bool, q_rows: int, ks: int):
    """The forward kernel's grid in launch order, one ``(bh, query tile,
    split, first key, end key)`` a block: the last (heaviest) query tiles
    first, then split, then batch·head, as ``csrc/flash_fwd.cu`` maps
    ``blockIdx.x``."""
    keys = _tile_keys(t_q, t_kv, causal, q_rows)
    return [(bh, qt, split, split * ks, min(keys[qt], (split + 1) * ks))
            for qt in reversed(range(len(keys)))
            for split in range(-(-keys[qt] // ks))
            for bh in range(n_bh)]


@functools.lru_cache(maxsize=256)
def split_plan(n_bh: int, t_q: int, t_kv: int, causal: bool, n_sm: int) -> tuple[int, int, int]:
    """``(q_rows, ks, blocks)``: the forward kernel's query-tile rows, keys a
    split and grid for one call.

    When 64-row query tiles alone give the card's ``n_sm`` SMs half a block
    each or more, a tile's keys are one split. Otherwise tiles shrink to
    :data:`MIN_Q_ROWS` rows (a warp) and their keys are cut into runs of
    ``ks`` keys, the longest of ``t_kv``, 256, 128, 64, 32 and 16 that gives
    ``n_sm // 2`` blocks (at most :data:`MAX_SPLITS` splits a tile). A run
    of ``ks`` starts at a multiple of ``ks``, so every row of a 16-row tile
    sees the first key of each of its splits.
    """
    n_qt = -(-t_q // TILE)
    if n_bh * n_qt >= n_sm // 2:
        return TILE, t_kv, n_bh * n_qt
    keys = _tile_keys(t_q, t_kv, causal, MIN_Q_ROWS)

    def blocks(ks):
        return n_bh * sum(-(-n // ks) for n in keys)

    ks = t_kv
    for cand in (t_kv, 256, 128, 64, 32, MIN_Q_ROWS):
        if cand > t_kv:
            continue
        if -(-t_kv // cand) > MAX_SPLITS:
            break
        ks = cand
        if blocks(ks) >= n_sm // 2:
            break
    return MIN_Q_ROWS, ks, blocks(ks)


# dq's column slice a block accumulates and the keys a warp takes from a
# staged chunk (the C source's DQ_SLICE and DQ_KT); a head wider than
# DQ_WIDE_HEAD keeps 64-row tiles, whose staged keys fit in shared memory
DQ_SLICE = 64
DQ_KT = 32
DQ_WIDE_HEAD = 128


@functools.lru_cache(maxsize=256)
def dq_plan(n_bh: int, t_q: int, d: int, n_sm: int) -> tuple[int, int]:
    """``(q_rows, blocks)``: the dq kernel's query-tile rows and grid.

    A block is four warps over ``q_rows`` rows and one 64-column slice of
    the head: ``q_rows // 16`` row groups times ``64 // q_rows`` key groups
    (:func:`dq_warp_keys`). Tiles of 64 rows when they give each of the
    card's ``n_sm`` SMs a block, else 32, else 16: fewer rows a block and
    more key groups, so a long sequence at a small batch·head count still
    fills the card. A head wider than :data:`DQ_WIDE_HEAD` takes 64: more
    key groups would not fit its staged keys in shared memory.
    """
    n_js = -(-d // DQ_SLICE)
    q_rows = TILE
    if d <= DQ_WIDE_HEAD:
        while q_rows > MIN_Q_ROWS and n_bh * -(-t_q // q_rows) * n_js < n_sm:
            q_rows //= 2
    return q_rows, n_bh * -(-t_q // q_rows) * n_js


def dq_warp_keys(t_q: int, t_kv: int, causal: bool, q_rows: int, qt: int, warp: int):
    """The key runs ``[k_begin, k_end)`` warp ``warp`` of query tile ``qt``
    sums dq over, in its order, and its rows ``[r_begin, r_end)``.

    Warp w owns row group ``w % R`` (R = ``q_rows // 16``) and key group
    ``w // R``: 32 keys of every staged chunk of ``32 · (4 // R)`` keys, cut
    at the keys some row of the tile sees and, in 8-key steps, at the
    warp's last row under a causal mask. The kernel adds the key groups'
    sums in group order.
    """
    n_rg = q_rows // MIN_Q_ROWS
    rg, kg = warp % n_rg, warp // n_rg
    q0 = qt * q_rows
    nq = min(q_rows, t_q - q0)
    r_begin, r_end = q0 + MIN_Q_ROWS * rg, q0 + min(MIN_Q_ROWS * (rg + 1), nq)
    if r_begin >= r_end:
        return (r_begin, r_begin), []
    visible = min(t_kv, q0 + nq) if causal else t_kv
    chunk = DQ_KT * (4 // n_rg)
    runs = []
    for c0 in range(0, visible, chunk):
        k0 = c0 + DQ_KT * kg
        if k0 >= visible:
            continue
        steps = min(DQ_KT // 8, -(-(visible - k0) // 8))
        if causal:
            steps = 0 if r_end - 1 < k0 else min(steps, (r_end - 1 - k0) // 8 + 1)
        if steps:
            runs.append((k0, min(k0 + 8 * steps, visible)))
    return (r_begin, r_end), runs


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX converts a weakly typed scalar."""
    return float(np.float32(x))


def _check_lengths(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The JAX function's refusals at its default blocks, plus the shapes
    and head width the port takes; the same on every device."""
    if q.dim() < 2 or k.dim() != q.dim() or v.shape != k.shape:
        raise KernelError(
            f"q, k, v must be (..., T, D) of one rank with k and v alike, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        raise KernelError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ outside the length"
        )
    t_q, t_kv, d = q.shape[-2], k.shape[-2], q.shape[-1]
    block_q, block_k = min(BLOCK_Q, t_q), min(BLOCK_K, t_kv)
    if t_q == 0 or t_kv == 0 or t_q % block_q or t_kv % block_k:
        raise KernelError(
            f"sequence lengths ({t_q}, {t_kv}) must divide block sizes "
            f"({block_q}, {block_k})"
        )
    if not 1 <= d <= MAX_HEAD:
        raise KernelError(f"head width {d} is outside the flash kernel's range 1..{MAX_HEAD}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain dense version: ``(o (..., T_q, D) in q's dtype,
    lse (..., T_q) float32, float64 for float64 inputs)``.

    Computes in float32 (float64 for float64 inputs): ``s = (q·scale) kᵀ``,
    masked scores ``NEG_INF``, ``m`` the row max, ``l = Σ exp(s - m)``
    clamped at 1e-30, as the TPU kernel finalizes (``:91-96``). On the card
    the two products run in full float32 (TF32 off for the call).
    """
    d = q.shape[-1]
    scale = _f32(scale if scale is not None else 1.0 / (d**0.5))
    work = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = (x.to(work) for x in (q, k, v))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = (qf * scale) @ kf.transpose(-1, -2)
        if causal:
            t_q, t_kv = s.shape[-2], s.shape[-1]
            q_pos = torch.arange(t_q, device=s.device)[:, None]
            k_pos = torch.arange(t_kv, device=s.device)[None, :]
            s = s.masked_fill(q_pos < k_pos, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = (p @ vf) / l
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, in the TPU kernels' recomputation form:
    ``(dq, dk, dv)`` in the inputs' dtypes.

    Computes in float32 (float64 for float64 inputs): ``delta = Σ_d do·o``,
    ``s = (q·scale) kᵀ`` with the causal mask by absolute position set to
    ``NEG_INF``, ``p = exp(s - lse)``, ``dp = do vᵀ``, ``ds = p ⊙ (dp -
    delta)``, ``dq = (ds k)·scale``, ``dk = (dsᵀ q)·scale``, ``dv = pᵀ do``.
    ``o`` and ``lse`` may be the global (all-blocks) forward results, so
    ``p`` is this block's share of the globally normalized probabilities.
    On the card the products run in full float32 (TF32 off for the call).
    """
    d = q.shape[-1]
    scale = _f32(scale if scale is not None else 1.0 / (d**0.5))
    work = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, of, dof = (x.to(work) for x in (q, k, v, o, do))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        delta = (dof * of).sum(-1, keepdim=True)
        s = (qf * scale) @ kf.transpose(-1, -2)
        if causal:
            t_q, t_kv = s.shape[-2], s.shape[-1]
            q_pos = torch.arange(t_q, device=s.device)[:, None]
            k_pos = torch.arange(t_kv, device=s.device)[None, :]
            s = s.masked_fill(q_pos < k_pos, NEG_INF)
        p = torch.exp(s - lse.to(work)[..., None])
        dp = dof @ vf.transpose(-1, -2)
        ds = p * (dp - delta)
        dq = (ds @ kf) * scale
        dk = (ds.transpose(-1, -2) @ qf) * scale
        dv = p.transpose(-1, -2) @ dof
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_libs: dict = {}
_lib_lock = threading.Lock()


def _library(name: str):
    """The built kernel library ``csrc/<name>.cu``, ``flash_fwd`` or
    ``flash_bwd`` (built on first use, once per process)."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            from predictionio_tpu_torch.ops import _build

            lib = ctypes.CDLL(str(_build.library(name)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            if name == "flash_fwd":
                lib.pio_flash_fwd.argtypes = [p] * 7 + [i] * 5 + [f, i, i, ctypes.c_longlong, p]
                lib.pio_flash_fwd.restype = i
                limits = lib.pio_flash_fwd_limits
            else:
                lib.pio_flash_bwd_dq.argtypes = [p] * 7 + [i] * 5 + [f, i, ctypes.c_longlong, p]
                lib.pio_flash_bwd_dq.restype = i
                lib.pio_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + [f, p]
                lib.pio_flash_bwd_dkv.restype = i
                limits = lib.pio_flash_bwd_limits
            limits.argtypes = [p, p]
            limits.restype = i
            lib.pio_flash_error_string.argtypes = [i]
            lib.pio_flash_error_string.restype = ctypes.c_char_p
            tile, max_head = ctypes.c_int(), ctypes.c_int()
            limits(ctypes.byref(tile), ctypes.byref(max_head))
            if (tile.value, max_head.value) != (TILE, MAX_HEAD):
                raise KernelError(f"{name}.cu TILE/MAX_HEAD disagree with Python")
            _libs[name] = lib
        return lib


def _check_operands(**tensors) -> torch.device:
    """The kernels take float32, contiguous tensors on one device."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise KernelError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise KernelError(f"{name} has dtype {t.dtype}; the flash kernels take float32")
        if not t.is_contiguous():
            raise KernelError(f"{name} must be contiguous")
    return device


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"{what} kernel launch failed: {lib.pio_flash_error_string(rc).decode()} ({rc})")


# One zeroed ticket counter a query tile, per (device, stream): the merging
# block of a split tile sets its counter back to 0, and launches on one
# stream run one after another, so a buffer serves every call on its stream.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    with _lib_lock:
        buf = _tickets.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
            _tickets[key] = buf
        return buf


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, causal: bool, scale: float):
    """One forward launch over the flattened batch·head dimension. The host
    work is kept to what the launch needs: one allocation holds o, lse and
    the split scratch, the plan is cached, and the device is made current
    only when it is not."""
    device = _check_operands(q=q, k=k, v=v)
    t_q, d = q.shape[-2:]
    t_kv = k.shape[-2]
    bh = q.numel() // (t_q * d)
    if bh == 0:
        raise KernelError("empty batch·head dimension")
    lib = _libs.get("flash_fwd") or _library("flash_fwd")
    causal = bool(causal)
    index = device.index
    q_rows, ks, blocks = split_plan(bh, t_q, t_kv, causal, _sm_count(index))
    n_qt = -(-t_q // q_rows)
    n_o, n_lse = bh * t_q * d, bh * t_q
    at = -(-(n_o + n_lse) // 4) * 4  # the scratch starts 16-byte aligned
    n_part = bh * n_qt * -(-t_kv // ks) * q_rows * (d + 2) if blocks > bh * n_qt else 0
    buf = torch.empty(at + n_part, dtype=torch.float32, device=device)
    o = buf.as_strided(q.shape, q.stride())  # q is contiguous: so are o and lse
    lse = buf.as_strided(q.shape[:-1], tuple(st // d for st in q.stride()[:-1]), n_o)
    stream = torch._C._cuda_getCurrentRawStream(index)
    base = buf.data_ptr()
    part = tickets = None
    if n_part:  # some query tile has more than one split
        part = base + 4 * at
        tickets = _ticket_buffer(device, stream, bh * n_qt).data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), base, base + 4 * n_o, part, tickets,
            bh, t_q, t_kv, d, int(causal), scale, q_rows, ks, blocks, stream)
    if index == torch.cuda.current_device():
        rc = lib.pio_flash_fwd(*args)
    else:
        with torch.cuda.device(index):
            rc = lib.pio_flash_fwd(*args)
    _raise_on(lib, rc, "flash_fwd")
    launches.bump()
    return o, lse


def flash_block_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block-pair forward: ``(o (..., T_q, D), lse (..., T_q))``.

    ``o`` is the softmax-normalized attention of q over THIS k/v block and
    ``lse`` its log-sum-exp, the pair ring attention merges across blocks
    with ``logaddexp``. Leading dimensions flatten into one batch·head
    dimension.
    """
    _check_lengths(q, k, v)
    scale = _f32(scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5))
    device = q.device
    if device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if device.type != "cuda":
        raise KernelError(f"no flash kernel for device {device}")
    return _launch(q, k, v, causal, scale)


def _bwd_geometry(q, k, v, do, lse, delta):
    device = _check_operands(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    t_q, d = q.shape[-2:]
    bh = q.numel() // (t_q * d)
    if bh == 0:
        raise KernelError("empty batch·head dimension")
    return device, bh, t_q, k.shape[-2], d


def _launch_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    """Kernel 5: dq, one launch over the flattened batch·head dimension,
    on the grid of :func:`dq_plan`."""
    device, bh, t_q, t_kv, d = _bwd_geometry(q, k, v, do, lse, delta)
    lib = _library("flash_bwd")
    dq = torch.empty_like(q)
    q_rows, blocks = dq_plan(bh, t_q, d, _sm_count(device.index))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), bh, t_q, t_kv, d, int(bool(causal)), scale,
            q_rows, blocks, stream,
        )
    _raise_on(lib, rc, "flash_bwd_dq")
    bwd_dq_launches.bump()
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Kernel 6: dk and dv, one launch over the flattened batch·head
    dimension."""
    device, bh, t_q, t_kv, d = _bwd_geometry(q, k, v, do, lse, delta)
    lib = _library("flash_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t_q, t_kv, d,
            int(bool(causal)), scale, stream,
        )
    _raise_on(lib, rc, "flash_bwd_dkv")
    bwd_dkv_launches.bump()
    return dk, dv


def flash_block_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block-pair backward: ``(dq, dk, dv)``, this block's shares.

    ``o`` and ``lse`` (..., T_q) are the GLOBAL (all-blocks) forward
    results for these queries: with a global ``lse``, ``exp(s - lse)`` is
    the globally normalized probability of this block, so the pieces of all
    blocks sum to the full gradients (the ring backward). ``do`` is made
    contiguous here. Leading dimensions flatten into one batch·head
    dimension.
    """
    _check_lengths(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:-1]:
        raise KernelError(
            f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse {tuple(lse.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    scale = _f32(scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5))
    do = do.contiguous()
    device = q.device
    if device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal, scale)
    if device.type != "cuda":
        raise KernelError(f"no flash kernel for device {device}")
    _check_operands(o=o)
    # Σ_d do·o, the softmax-Jacobian row term: a torch op, as the JAX
    # package computes it in plain XLA outside its kernels
    delta = (do * o).sum(-1)
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *_launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale))


class _FlashAttention(torch.autograd.Function):
    """Exact attention with the recomputation backward, the port of the JAX
    ``custom_vjp`` (``_flash_2d``): the forward saves ``q, k, v, o, lse``,
    the backward recomputes each score tile from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        o, lse = flash_block_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_block_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention, q/k/v (..., T, D) → o (..., T_q, D), differentiable.

    Lengths must divide the JAX package's default blocks
    (``min(128, T)``); others raise ``ValueError`` on every device.
    """
    return _FlashAttention.apply(q, k, v, causal, scale)
