"""Gather → score → top-k for the serving fast path: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``predictionio_tpu/ops/score_kernel.py``
``_score_topk_kernel`` (with its merge ``_merge_block``), reached through
``fused_gather_score_topk``. The kernel is ``csrc/score_topk.cu``, built
with ``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``) and called
through ``ctypes``; its source note says what bounds it and how it is laid
out. In short: pass 1 scores one ``BLOCK_I``-item chunk per thread block
for eight rows and keeps each (row, chunk)'s top ``min(k, BLOCK_I)``; pass 2
merges a row's chunk lists into its top ``k`` — two launches per call.

:func:`fused_gather_score_topk` routes by device and nothing else:

* tensors on the CPU take :func:`gather_score_topk_reference`, the plain
  version the CPU tests run;
* tensors on a CUDA device launch the kernel, or raise on a device, dtype,
  shape or contiguity the kernel does not take, or on a CUDA error.

There is no ``try`` that falls back and no environment variable that picks
the plain version on the card. :data:`launches` counts the kernel's
launches (one per call, two CUDA grids) so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from predictionio_tpu_torch.ops.topk import top_k_with_mask

# Items per pass-1 chunk (the C source's CHUNK). Catalogs pad to a multiple
# of it, as the JAX package pads to its BLOCK_I, so one layout serves both.
BLOCK_I = 512
# Largest k pass 2 holds in shared memory (a 2·next_pow2(k)-entry buffer
# of 8-byte pairs inside the 227 KB a block may use).
MAX_K = 8192

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


def pad_block_items(n_items: int) -> int:
    """Item-dimension padding of the score path: a multiple of 8 when the
    catalog fits one chunk, else a ``BLOCK_I`` multiple (the JAX package's
    ``pad_block_items``)."""
    base = -(-n_items // 8) * 8
    if base <= BLOCK_I:
        return base
    return -(-n_items // BLOCK_I) * BLOCK_I


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
        raise ValueError(f"k={k} out of range for {n_items} items")
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

            lib = ctypes.CDLL(str(_build.library("score_topk")))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_score_topk.argtypes = [p] * 10 + [i] * 6 + [p]
            lib.pio_score_topk.restype = i
            lib.pio_score_topk_chunk.argtypes = []
            lib.pio_score_topk_chunk.restype = i
            lib.pio_error_string.argtypes = [i]
            lib.pio_error_string.restype = ctypes.c_char_p
            if lib.pio_score_topk_chunk() != BLOCK_I:
                raise RuntimeError("score_topk.cu CHUNK disagrees with BLOCK_I")
            _lib = lib
        return _lib


def _check(t: Optional[torch.Tensor], name: str, device, dtypes, shape) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_gather_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k scores: ``(values (B, k) f32, indices (B, k) int32)``.

    ``U`` (n_users, rank) and ``V`` (n_items, rank) are f32, bf16 or int8
    of one dtype; int8 needs ``u_scale`` (n_users, 1) and ``v_scale``
    (n_items, 1) f32. ``u_idx`` is (B,) int32, ``item_mask`` (n_items,)
    bool with True for excluded items. Values sort descending, ties go to
    the smaller index. A user index outside ``[0, n_users)`` is clamped,
    as XLA's gather clamps it.
    """
    device = V.device
    if device.type == "cpu":
        return gather_score_topk_reference(
            U, V, u_idx, k, item_mask, u_scale=u_scale, v_scale=v_scale
        )
    if device.type != "cuda":
        raise ValueError(f"no score kernel for device {device}")
    n_users, rank = U.shape
    n_items = V.shape[0]
    batch = u_idx.shape[0]
    if U.dtype not in _DTYPE_CODE or V.dtype != U.dtype:
        raise ValueError(f"U/V dtypes {U.dtype}/{V.dtype} not supported")
    if U.dtype == torch.int8 and (u_scale is None or v_scale is None):
        raise ValueError("int8 factors need u_scale and v_scale")
    if not 0 < k <= n_items or k > MAX_K:
        raise ValueError(f"k={k} out of range for {n_items} items (max {MAX_K})")
    if batch == 0:
        raise ValueError("empty u_idx")
    _check(U, "U", device, (U.dtype,), (n_users, rank))
    _check(V, "V", device, (U.dtype,), (n_items, rank))
    _check(u_idx, "u_idx", device, (torch.int32,), (batch,))
    _check(item_mask, "item_mask", device, (torch.bool,), (n_items,))
    _check(u_scale, "u_scale", device, (torch.float32,), (n_users, 1))
    _check(v_scale, "v_scale", device, (torch.float32,), (n_items, 1))
    lib = _library()
    n_chunks = -(-n_items // BLOCK_I)
    kc = min(k, BLOCK_I)
    cand_v = torch.empty((batch, n_chunks, kc), dtype=torch.float32, device=device)
    cand_i = torch.empty((batch, n_chunks, kc), dtype=torch.int32, device=device)
    vals = torch.empty((batch, k), dtype=torch.float32, device=device)
    idx = torch.empty((batch, k), dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pio_score_topk(
            ptr(U), ptr(u_scale), ptr(V), ptr(v_scale), ptr(u_idx),
            ptr(item_mask), ptr(cand_v), ptr(cand_i), ptr(vals), ptr(idx),
            n_users, rank, n_items, batch, k, _DTYPE_CODE[U.dtype], stream,
        )
    if rc != 0:
        msg = lib.pio_error_string(rc).decode()
        raise RuntimeError(f"score_topk kernel launch failed: {msg} ({rc})")
    launches.bump()
    return vals, idx
