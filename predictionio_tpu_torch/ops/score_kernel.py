"""Gather → score → top-k for the serving fast path: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``predictionio_tpu/ops/score_kernel.py``
``_score_topk_kernel`` (with its merge ``_merge_block``), reached through
``fused_gather_score_topk``. The kernel is ``csrc/score_topk.cu``, built
with ``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``) and called
through ``ctypes``; its source note says what bounds it and how it is laid
out. In short, one launch: each block scores one slice of the catalog
(:func:`slice_plan`) for up to eight rows, keeping only the items above each
row's running k-th best, and the last block of a row group to finish merges
the group's slice lists into its top ``k``.

:func:`fused_gather_score_topk` routes by device and nothing else:

* tensors on the CPU take :func:`gather_score_topk_reference`, the plain
  version the CPU tests run;
* tensors on a CUDA device launch the kernel, or raise on a device, dtype,
  shape or contiguity the kernel does not take, or on a CUDA error.

There is no ``try`` that falls back and no environment variable that picks
the plain version on the card. :data:`launches` counts the kernel's
launches (one per call) so a run can show that its main path went through
the kernel.

IVF retrieval runs the same kernel in its probe-table mode, over the
clusters' item blocks that a batch probes (the JAX package's
``serving/fastpath.py:721-819`` ``_compile_ivf`` step, a ``lax.scan`` of
one Pallas call a probe): :func:`select_probes` picks the blocks on the
card (torch ops, as the JAX package computes them outside Pallas), and
:func:`fused_probed_score_topk` scans all of them in ONE launch, answering
in global ids. :func:`ivf_score_topk` is the two together, one dispatch;
:func:`probed_score_topk_reference` and :func:`ivf_score_topk_reference`
are the plain versions, the JAX step written out (a loop over probes of
:func:`gather_score_topk_reference`, then ``merge_topk``). A probe-mode
launch counts in :data:`launches` and in :data:`ivf_launches`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.ops.topk import merge_topk, sort_two_key, top_k_with_mask

# Catalogs pad to a multiple of the JAX package's BLOCK_I, so one layout
# serves both packages.
BLOCK_I = 512
# Largest k (a block's buffer of 2·next_pow2(k) 8-byte keys inside the 227 KB
# a block may use), the largest k a warp selects for alone (eight rows a
# block), and the largest rank (the C source's MAX_K, WARP_MAX_K, MAX_RANK,
# MAX_SLICES).
MAX_K = 8192
WARP_MAX_K = 512
MAX_RANK = 256
# Most slices a call cuts the catalog into (a lane's lists are one 32-bit mask)
MAX_SLICES = 1024
# Rows a block takes when each row has a warp, the blocks per SM a call aims
# for, and the granularity of a slice of the catalog, in items.
ROWS_PER_BLOCK = 8
BLOCKS_PER_SM = 2
SLICE_ALIGN = 32

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class LaunchCounter:
    """Plain integer count of kernel launches, safe across server threads."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


launches = LaunchCounter()
# the probe-table mode's launches (IVF retrieval), also counted in launches
ivf_launches = LaunchCounter()


def pad_block_items(n_items: int) -> int:
    """Item-dimension padding of the score path: a multiple of 8 when the
    catalog fits one chunk, else a ``BLOCK_I`` multiple (the JAX package's
    ``pad_block_items``)."""
    base = -(-n_items // 8) * 8
    if base <= BLOCK_I:
        return base
    return -(-n_items // BLOCK_I) * BLOCK_I


def slice_plan(batch: int, n_items: int, k: int, n_sm: int) -> tuple[int, int, int]:
    """``(rows, slices, slice_items)``: the kernel's grid for one call.

    A block takes ``rows`` batch rows (up to :data:`ROWS_PER_BLOCK`, a warp
    each, while ``k`` ≤ :data:`WARP_MAX_K`; else one row and the whole
    block) and one slice of ``slice_items`` consecutive items (the last may
    be shorter). The catalog is cut into as many slices as give the card's
    ``n_sm`` SMs :data:`BLOCKS_PER_SM` blocks each (or more: a slice is a
    multiple of :data:`SLICE_ALIGN` items, rounded down); past ``WARP_MAX_K`` a slice holds at least
    ``k`` items, so its list of ``k`` is not mostly empty.
    """
    rows = min(ROWS_PER_BLOCK, batch) if k <= WARP_MAX_K else 1
    groups = -(-batch // rows)
    want = max(1, -(-BLOCKS_PER_SM * n_sm // groups))
    per = max(SLICE_ALIGN, n_items // want // SLICE_ALIGN * SLICE_ALIGN)
    if k > WARP_MAX_K:
        per = max(per, -(-k // SLICE_ALIGN) * SLICE_ALIGN)
    per = max(per, -(-(-(-n_items // MAX_SLICES)) // SLICE_ALIGN) * SLICE_ALIGN)
    return rows, -(-n_items // per), per


def buffer_cap(k: int) -> int:
    """Keys of one selection's buffer (the C source's ``buffer_cap``). Up to
    :data:`WARP_MAX_K` a warp keeps its best ``max(64, next_pow2(k))`` keys in
    registers and appends as many to its buffer before it merges the two;
    past it a block's buffer holds ``2·next_pow2(k)`` keys and is cut back to
    its best ``k`` when a round could overflow it."""
    q = 1 << max(0, k - 1).bit_length()
    return max(64, q) if k <= WARP_MAX_K else 2 * q


def _dequantize(F: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    F = F.to(torch.float32)
    if scale is not None:
        F = F * scale
    return F


def gather_score_topk_reference(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: gather → dequantize → f32
    matmul → item scale → mask → two-key top-k.

    On the card the matmul runs in full float32: TF32 is switched off
    (``torch.backends.cuda.matmul.allow_tf32 = False``) for the call.
    """
    n_items = V.shape[0]
    if not 0 < k <= n_items:
        raise KernelError(f"k={k} out of range for {n_items} items")
    Uf = _dequantize(U, u_scale)
    Vf = _dequantize(V, None)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scores = Uf[u_idx.long()] @ Vf.T  # (B, rank) @ (rank, n_items)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if v_scale is not None:
        scores = scores * v_scale.reshape(1, -1)
    mask = item_mask.reshape(1, -1) if item_mask is not None else None
    return top_k_with_mask(scores, k, mask=mask)


_lib = None
_lib_lock = threading.Lock()


def _library():
    """The built kernel library (built on first use, once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from predictionio_tpu_torch.ops import _build

            # built at warm-up: the fast path launches every rung from
            # BucketedScorer.__init__ before the first request, so a request
            # finds the library loaded
            # pio: ignore[hotpath-jit-in-request]
            lib = ctypes.CDLL(str(_build.library("score_topk")))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_score_topk.argtypes = [p] * 10 + [i] * 8 + [p]
            lib.pio_score_topk.restype = i
            lib.pio_score_topk_probed.argtypes = [p] * 12 + [i] * 10 + [p]
            lib.pio_score_topk_probed.restype = i
            lib.pio_score_topk_limits.argtypes = [p] * 4
            lib.pio_score_topk_limits.restype = i
            lib.pio_error_string.argtypes = [i]
            lib.pio_error_string.restype = ctypes.c_char_p
            limits = [ctypes.c_int() for _ in range(4)]
            lib.pio_score_topk_limits(*(ctypes.byref(x) for x in limits))
            if tuple(x.value for x in limits) != (MAX_K, WARP_MAX_K, MAX_RANK, MAX_SLICES):
                raise KernelError("score_topk.cu limits disagree with Python's")
            _lib = lib
        return _lib


# One zeroed ticket counter a row group, per (device, stream): the kernel's
# merging blocks set their counters back to 0, and launches on one stream run
# one after another, so a buffer serves every call on its stream.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    with _lib_lock:
        buf = _tickets.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
            _tickets[key] = buf
        return buf


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


def fused_gather_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    timing: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k scores: ``(values (B, k) f32, indices (B, k) int32)``.

    ``U`` (n_users, rank) and ``V`` (n_items, rank) are f32, bf16 or int8
    of one dtype; int8 needs ``u_scale`` (n_users, 1) and ``v_scale``
    (n_items, 1) f32. ``u_idx`` is (B,) int32, ``item_mask`` (n_items,)
    bool with True for excluded items. Values sort descending, ties go to
    the smaller index. A user index outside ``[0, n_users)`` is clamped,
    as XLA's gather clamps it. ``timing``, a pair of CUDA events made with
    ``enable_timing=True``, is recorded on the launch's stream just before
    and just after the kernel (the plain version on the CPU ignores it).
    """
    if V.device.type == "cpu":
        return gather_score_topk_reference(
            U, V, u_idx, k, item_mask, u_scale=u_scale, v_scale=v_scale
        )
    return _launch(U, V, u_idx, k, item_mask, u_scale, v_scale, timing)


def _launch(U, V, u_idx, k, item_mask, u_scale, v_scale, timing, probed=None):
    """Check the operands and launch the kernel once: the exact mode, or
    with ``probed = (probes, gid, block_items)`` the probe-table mode."""
    device = V.device
    if device.type != "cuda":
        raise KernelError(f"no score kernel for device {device}")
    n_users, rank = U.shape
    n_items = V.shape[0]
    batch = u_idx.shape[0]
    if U.dtype not in _DTYPE_CODE or V.dtype != U.dtype:
        raise KernelError(f"U/V dtypes {U.dtype}/{V.dtype} not supported")
    if U.dtype == torch.int8 and (u_scale is None or v_scale is None):
        raise KernelError("int8 factors need u_scale and v_scale")
    scanned = n_items
    if probed is not None:
        probes, gid, block_items = probed
        if block_items < 1 or n_items % block_items:
            raise KernelError(f"{n_items} slots are not blocks of {block_items}")
        check_probe_plan(n_items // block_items, block_items, probes.shape[0], k, rank)
        _check(probes, "probes", device, (torch.int32,), (probes.shape[0],))
        _check(gid, "gid", device, (torch.int32,), (n_items,))
        scanned = probes.shape[0] * block_items
    elif not 0 < k <= n_items or k > MAX_K:
        raise KernelError(f"k={k} out of range for {n_items} items (max {MAX_K})")
    if batch == 0:
        raise KernelError("empty u_idx")
    _check(U, "U", device, (U.dtype,), (n_users, rank))
    _check(V, "V", device, (U.dtype,), (n_items, rank))
    _check(u_idx, "u_idx", device, (torch.int32,), (batch,))
    _check(item_mask, "item_mask", device, (torch.bool,), (n_items,))
    _check(u_scale, "u_scale", device, (torch.float32,), (n_users, 1))
    _check(v_scale, "v_scale", device, (torch.float32,), (n_items, 1))
    if rank > MAX_RANK:
        raise KernelError(f"rank {rank} is above the score kernel's {MAX_RANK}")
    lib = _library()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rows, slices, per = slice_plan(batch, scanned, k, n_sm)
    cand = torch.empty((batch, slices, k), dtype=torch.int64, device=device)
    vals = torch.empty((batch, k), dtype=torch.float32, device=device)
    idx = torch.empty((batch, k), dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets = _ticket_buffer(device, stream, -(-batch // rows))
        if timing is not None:
            timing[0].record()
        head = (ptr(U), ptr(u_scale), ptr(V), ptr(v_scale), ptr(u_idx), ptr(item_mask))
        tail = (ptr(cand), ptr(tickets), ptr(vals), ptr(idx))
        if probed is None:
            rc = lib.pio_score_topk(
                *head, *tail, n_users, rank, n_items, batch, k, slices, per,
                _DTYPE_CODE[U.dtype], stream,
            )
        else:
            rc = lib.pio_score_topk_probed(
                *head, ptr(gid), ptr(probes), *tail, n_users, rank, n_items // block_items,
                block_items, probes.shape[0], batch, k, slices, per, _DTYPE_CODE[U.dtype], stream,
            )
        if timing is not None:
            timing[1].record()
    if rc != 0:
        msg = lib.pio_error_string(rc).decode()
        mode = "" if probed is None else " probe-mode"
        raise KernelError(f"score_topk{mode} kernel launch failed: {msg} ({rc})")
    launches.bump()
    if probed is not None:
        ivf_launches.bump()
    return vals, idx


# ---- probe-table mode (IVF retrieval) ------------------------------------------

# Largest slot count of a probed layout (the kernel's rows are int32)
MAX_PROBED_SLOTS = 2**31 - 1


def check_probe_plan(n_blocks: int, block_items: int, n_probes: int, k: int, rank: int) -> None:
    """Raise :class:`KernelError` unless the probe-table mode takes a layout
    of ``n_blocks`` blocks of ``block_items`` slots scanned ``n_probes`` at a
    time for top-``k`` at ``rank``; the scorer calls this for every rung
    when it is built, so no query meets the refusal."""
    if n_blocks < 1 or block_items < 1 or not 1 <= n_probes <= n_blocks:
        raise KernelError(
            f"probe plan of {n_probes} probes over {n_blocks} blocks of {block_items}"
        )
    if n_blocks * block_items > MAX_PROBED_SLOTS:
        raise KernelError(
            f"{n_blocks} blocks of {block_items} slots exceed the probe mode's "
            f"{MAX_PROBED_SLOTS} rows"
        )
    if not 0 < k <= min(MAX_K, n_probes * block_items):
        raise KernelError(
            f"k={k} out of range for {n_probes} probes of {block_items} slots (max {MAX_K})"
        )
    if rank > MAX_RANK:
        raise KernelError(f"rank {rank} is above the score kernel's {MAX_RANK}")


def select_probes(
    U: torch.Tensor,
    u_idx: torch.Tensor,
    C: torch.Tensor,
    n_probes: int,
    u_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The batch's ``n_probes`` clusters, ``(n_probes,)`` int32 on the
    factors' device: the dequantized query rows score against the centroids
    ``C`` (nlist, rank) f32, each cluster takes its best score over the
    batch, and the best ``n_probes`` clusters win in ``lax.top_k`` order
    (value descending, then the smaller id). The scores are float64 products
    rounded to float32, so no TF32 and no process-global flag is involved:
    serving threads call this on every dispatch."""
    rows = u_idx.long()
    q = U[rows].to(torch.float32)
    if u_scale is not None:
        q = q * u_scale[rows]
    agg = (q.double() @ C.double().T).to(torch.float32).amax(dim=0)  # (nlist,)
    _, order = sort_two_key(agg.reshape(1, -1))
    return order[0, :n_probes].contiguous()


def probed_score_topk_reference(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    probes: torch.Tensor,
    gid: torch.Tensor,
    block_items: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe-table mode's plain version, the JAX step written out: for
    each probe, :func:`gather_score_topk_reference` over its block for the
    best ``min(k, block_items)``, slots mapped through ``gid``; then
    ``merge_topk`` of the candidates in (value desc, global id asc) order."""
    cap = int(block_items)
    lk = min(k, cap)
    pv, pg = [], []
    for p in probes.tolist():
        s = int(p) * cap
        mb = None if item_mask is None else item_mask[s : s + cap]
        vsb = None if v_scale is None else v_scale[s : s + cap]
        vals, idx = gather_score_topk_reference(
            U, V[s : s + cap], u_idx, lk, mb, u_scale=u_scale, v_scale=vsb
        )
        pv.append(vals)
        pg.append(gid[s : s + cap][idx.long()])
    batch = u_idx.shape[0]
    cand_v = torch.stack(pv, dim=1).reshape(batch, -1)
    cand_g = torch.stack(pg, dim=1).reshape(batch, -1)
    return merge_topk(cand_v, cand_g, k)


def fused_probed_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    probes: torch.Tensor,
    gid: torch.Tensor,
    block_items: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the probed blocks: ``(values (B, k) f32, global ids (B, k)
    int32)``, in one launch of the kernel's probe-table mode.

    ``V`` (n_blocks·block_items, rank) lies in blocks of ``block_items``
    slots, ``gid`` (same length, int32) gives each slot's global id, and
    ``item_mask`` (bool) is True on padded or excluded slots; ``probes``
    ``(P,)`` int32 on the card names the blocks to scan. Otherwise as
    :func:`fused_gather_score_topk`. On the CPU the plain version runs.
    """
    if V.device.type == "cpu":
        return probed_score_topk_reference(
            U, V, u_idx, k, probes, gid, block_items, item_mask,
            u_scale=u_scale, v_scale=v_scale,
        )
    return _launch(U, V, u_idx, k, item_mask, u_scale, v_scale, None,
                   probed=(probes, gid, block_items))


def ivf_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    C: torch.Tensor,
    gid: torch.Tensor,
    item_mask: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    n_probes: int,
    block_items: int,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    timing: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One IVF dispatch: :func:`select_probes` on the device, then
    :func:`fused_probed_score_topk` over those blocks (one kernel launch;
    the probe ids never leave the device). ``timing``, a pair of CUDA
    events, brackets both. Returns ``(values, global ids)``, each (B, k)."""
    if timing is not None:
        timing[0].record()
    probes = select_probes(U, u_idx, C, n_probes, u_scale)
    out = fused_probed_score_topk(
        U, V, u_idx, k, probes, gid, block_items, item_mask, u_scale=u_scale, v_scale=v_scale
    )
    if timing is not None:
        timing[1].record()
    return out


def ivf_score_topk_reference(
    U: torch.Tensor,
    V: torch.Tensor,
    C: torch.Tensor,
    gid: torch.Tensor,
    item_mask: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    n_probes: int,
    block_items: int,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`ivf_score_topk`, on any device."""
    probes = select_probes(U, u_idx, C, n_probes, u_scale)
    return probed_score_topk_reference(
        U, V, u_idx, k, probes, gid, block_items, item_mask, u_scale=u_scale, v_scale=v_scale
    )
