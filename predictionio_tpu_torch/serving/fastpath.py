"""Bucketed serving fast path: device-resident factors, one kernel launch
per batch.

Counterpart of ``predictionio_tpu/serving/fastpath.py`` ``BucketedScorer``
with its replicated exact placement (``:320-359``). The factor matrices are
placed on the card ONCE at construction; per call the traffic is the (B,)
user-index upload and the (B, k) readback, and the device work is one call
of :func:`~predictionio_tpu_torch.ops.topk.gather_score_topk` (the
hand-written kernel).

* **Bucket ladder** — batches pad up to a rung of :data:`BUCKETS`; the
  padded tail rows are scored and dropped on the host, the padded ITEM
  tail is masked inside the kernel.
* **Warm-up** — PyTorch runs eagerly, so there is nothing to trace or
  compile per rung. Warm-up builds the kernel (``nvcc``, once per process)
  and launches every rung once at construction (deploy/reload time), so
  no request pays the build or a first launch.
* **Hot set** (``PIO_HOTSET_SIZE``, off by default) — ALS scores are
  static between reloads; the scorer keeps decayed per-user request counts
  and every ``PIO_HOTSET_REFRESH_QUERIES`` scored rows materializes the
  top ``PIO_HOTSET_SIZE`` users' top-k through the top rung, answering
  those users from host memory with no device work.

* **Trace stages and device accounting** — each dispatch charges ``h2d``
  (the index upload), ``device_compute`` and ``d2h`` to every active obs
  trace, and records its device time on a :class:`~predictionio_tpu_torch.
  obs.devprof.DeviceUtilization` annotated per rung with the analytic cost
  of the kernel (``fused_score_cost``; ``score_cost`` for the plain version
  on the CPU). On the card the device time is a pair of CUDA events that
  the kernel's wrapper records on its stream just before and just after
  the launch, read after the readback, which waits for the kernel anyway:
  the path gains no synchronization. As in the JAX package,
  ``device_compute`` is the launch's host time and then the kernel (the
  event time), ``d2h`` the copies after it; each trace also carries the
  event time as ``device_us``. On the CPU the plain version runs inside
  the launch call, whose wall is the device time.

* **Delta rows** — :meth:`BucketedScorer.apply_delta_rows` patches a
  streaming micro-generation's user (and item) rows into the resident
  factors: int8 rows re-quantized row-wise with their scales, bf16 rows
  rounded to nearest even, as the JAX package's ``astype(bfloat16)``. It
  clones the tensors it patches, copies the rows in, waits for the copies
  and then swaps all four factor tensors in one rebind. A launch reads
  that tuple once, so it sees the rows before or after a patch, never half
  of them, and no tensor a launch may still read is written. No scorer is
  built, no rung warmed and no kernel built again.

The sharded placement and IVF retrieval come with later slices.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.obs import devprof as _devprof
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import score_kernel as _score_kernel
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops.quantize import factors_to_tensor
from predictionio_tpu_torch.ops.topk import gather_score_topk

logger = logging.getLogger(__name__)

# The batch-size ladder. 1 serves the trickle case with zero padding, 64
# matches MicroBatcher's default max_batch. Tails between rungs pad to the
# next rung (worst waste: 7 rows at rung 8).
BUCKETS = (1, 8, 16, 32, 64)


def bucket_for(n: int, buckets=BUCKETS) -> Optional[int]:
    """Smallest ladder rung ≥ n, or None when n overflows the ladder."""
    for b in buckets:
        if n <= b:
            return b
    return None


class BucketedScorer:
    """Per-bucket score+top-k over device-resident factors."""

    def __init__(
        self,
        ctx: DeviceContext,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        max_k: int = 100,
        hot_size: Optional[int] = None,
        hot_refresh_queries: Optional[int] = None,
        factor_dtype: str = "f32",
        user_scale: Optional[np.ndarray] = None,
        item_scale: Optional[np.ndarray] = None,
        warm_buckets: Optional[tuple] = None,
    ):
        self.ctx = ctx
        self.n_users = user_factors.shape[0]
        self.n_items = item_factors.shape[0]
        self.factor_dtype = factor_dtype
        if factor_dtype == "int8" and (user_scale is None or item_scale is None):
            raise ValueError("int8 factors require user_scale and item_scale")
        self.k = min(max_k, self.n_items)
        self.buckets = BUCKETS
        if factor_dtype == "f32":
            user_factors = np.asarray(user_factors, np.float32)
            item_factors = np.asarray(item_factors, np.float32)
        self._init_replicated_placement(
            user_factors, item_factors, user_scale, item_scale
        )
        self.resident_factor_bytes = sum(
            t.numel() * t.element_size()
            for t in (self._U, self._V, self._Uscale, self._Vscale)
            if t is not None
        )
        self._lock = threading.Lock()
        # serializes delta applies: each clones the factors the last one swapped in
        self._patch_lock = threading.Lock()
        self.delta_applies = 0
        self.delta_rows = 0
        self.hits: dict[int, int] = {b: 0 for b in self.buckets}
        self.queries = 0
        self.padded_rows = 0
        # hot-set working set (off unless PIO_HOTSET_SIZE > 0)
        if hot_size is None:
            hot_size = int(os.environ.get("PIO_HOTSET_SIZE", "0") or 0)
        if hot_refresh_queries is None:
            hot_refresh_queries = int(
                os.environ.get("PIO_HOTSET_REFRESH_QUERIES", "2048") or 2048
            )
        self.hot_size = max(0, min(int(hot_size), self.n_users))
        self.hot_refresh_queries = max(1, int(hot_refresh_queries))
        self._hot_counts = (
            np.zeros(self.n_users, np.float32) if self.hot_size else None
        )
        self._hot_since_refresh = 0
        # user_idx → row in the materialized (hot_size, k) answer table
        self._hot_rows: dict[int, int] = {}
        self._hot_table_idx: Optional[np.ndarray] = None
        self._hot_table_val: Optional[np.ndarray] = None
        self.hot_hits = 0
        self.hot_misses = 0
        self.hot_refreshes = 0
        # the hand-written kernel on the card, its plain version on the CPU
        self.backend = "fused" if self.ctx.device.type == "cuda" else "reference"
        # device-utilization accountant: each rung is cost-annotated here,
        # each dispatch records its device time, and the query server's
        # bridge exports the windowed pio_device_* gauges. One scorer is one
        # model generation, so the window never mixes generations.
        self.devprof = _devprof.DeviceUtilization(
            platform=_devprof.platform_for(self.ctx.device)
        )
        rank = self._U.shape[1]
        for b in self.buckets:
            if self.backend == "fused":
                flops, nbytes = _devprof.fused_score_cost(
                    b, self._n_items_pad, rank, self.k, self.factor_dtype
                )
                self.devprof.set_cost(b, flops, nbytes, source="analytic-fused")
            else:
                flops, nbytes = _devprof.score_cost(
                    b, self._n_items_pad, rank, dtype=self.factor_dtype
                )
                self.devprof.set_cost(b, flops, nbytes, source="analytic")
        # warm-up: build the kernel and launch every rung once (or only the
        # rungs ``warm_buckets`` names), before the first request; a failure
        # here raises to the deploy
        self.warmup_executions = 0
        for b in self.buckets if warm_buckets is None else warm_buckets:
            self._launch(np.zeros(b, np.int32))
            self.warmup_executions += 1
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _init_replicated_placement(
        self, user_factors, item_factors, user_scale, item_scale
    ) -> None:
        """Full factor copies on the card, item dimension padded to the
        kernel's chunk layout (zero rows, masked; unit scales)."""
        dev = self.ctx.device
        self._n_items_pad = _score_kernel.pad_block_items(self.n_items)
        pad_i = self._n_items_pad - self.n_items
        U = factors_to_tensor(np.asarray(user_factors), dev)
        V = factors_to_tensor(np.pad(np.asarray(item_factors), ((0, pad_i), (0, 0))), dev)
        Us = Vs = None
        if self.factor_dtype == "int8":
            Us = self.ctx.replicate(np.asarray(user_scale, np.float32))
            Vs = self.ctx.replicate(
                np.pad(
                    np.asarray(item_scale, np.float32),
                    ((0, pad_i), (0, 0)),
                    constant_values=1.0,
                )
            )
        # (U, V, U scales, V scales): rebound whole by apply_delta_rows and
        # read once a launch, so a launch never mixes two generations' rows
        self._factors = (U, V, Us, Vs)
        self._item_pad_mask = self.ctx.replicate(
            np.arange(self._n_items_pad) >= self.n_items
        )

    @property
    def _U(self) -> torch.Tensor:
        return self._factors[0]

    @property
    def _V(self) -> torch.Tensor:
        return self._factors[1]

    @property
    def _Uscale(self) -> Optional[torch.Tensor]:
        return self._factors[2]

    @property
    def _Vscale(self) -> Optional[torch.Tensor]:
        return self._factors[3]

    def _launch(
        self, padded: np.ndarray, item_mask: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        u_dev = torch.from_numpy(padded).to(self.ctx.device)
        if item_mask is None:
            item_mask = self._item_pad_mask
        U, V, Us, Vs = self._factors
        return gather_score_topk(U, V, u_dev, self.k, item_mask=item_mask, u_scale=Us, v_scale=Vs)

    def score_topk(
        self, user_indices: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` (indices, values) for every user in ``user_indices``.

        Batches larger than the top rung are served in top-rung chunks.
        ``k`` beyond the built width raises ValueError — callers route that
        to their exact path instead of silently truncating. With the hot
        set enabled, users in the materialized table are answered from host
        memory; only the cold remainder pays a device pass. Output order is
        preserved.
        """
        if k > self.k:
            raise ValueError(f"k={k} exceeds compiled top-k width {self.k}")
        users = np.asarray(user_indices, np.int32)
        if self._hot_counts is None:
            return self._device_topk(users, k)
        self._note_traffic(users)
        with self._lock:
            rows = self._hot_rows
            table_idx = self._hot_table_idx
            table_val = self._hot_table_val
        if table_idx is None:
            return self._device_topk(users, k)
        hot_rows = np.fromiter(
            (rows.get(int(u), -1) for u in users), np.int64, count=len(users)
        )
        hot_mask = hot_rows >= 0
        n_hot = int(hot_mask.sum())
        with self._lock:
            self.hot_hits += n_hot
            self.hot_misses += len(users) - n_hot
        if n_hot == 0:
            return self._device_topk(users, k)
        idx_out = np.empty((len(users), k), table_idx.dtype)
        val_out = np.empty((len(users), k), table_val.dtype)
        idx_out[hot_mask] = table_idx[hot_rows[hot_mask], :k]
        val_out[hot_mask] = table_val[hot_rows[hot_mask], :k]
        cold = users[~hot_mask]
        if len(cold):
            c_idx, c_val = self._device_topk(cold, k)
            idx_out[~hot_mask] = c_idx
            val_out[~hot_mask] = c_val
        return idx_out, val_out

    def _device_topk(
        self, users: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """The bucketed device path: one kernel launch per top-rung chunk."""
        top = self.buckets[-1]
        idx_parts, val_parts = [], []
        for s in range(0, len(users), top):
            chunk = users[s : s + top]
            b = bucket_for(len(chunk), self.buckets)
            padded = np.zeros(b, np.int32)
            padded[: len(chunk)] = chunk
            idx_h, val_h = self._dispatch(b, padded)
            with self._lock:
                self.hits[b] += 1
                self.queries += len(chunk)
                self.padded_rows += b - len(chunk)
            # padded tail rows are real top-k rows for user 0 — dropped here
            idx_parts.append(idx_h[: len(chunk), :k])
            val_parts.append(val_h[: len(chunk), :k])
        return np.concatenate(idx_parts), np.concatenate(val_parts)

    def _dispatch(self, b: int, padded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One traced, accounted launch at rung ``b``; host (idx, vals)."""
        for t in _tracing.active_traces():
            t.annotate(bucket=b)
        dev = self.ctx.device
        on_card = dev.type == "cuda"
        try:
            with _tracing.stage("h2d"):
                u_dev = torch.from_numpy(padded).to(dev)
            timing = (
                (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                if on_card else None
            )
            U, V, Us, Vs = self._factors
            t0 = time.perf_counter()
            vals, idx = gather_score_topk(
                U, V, u_dev, self.k, item_mask=self._item_pad_mask,
                u_scale=Us, v_scale=Vs, timing=timing,
            )
            t1 = time.perf_counter()
            # the readback waits for the kernel
            idx_h = idx.cpu().numpy()
            val_h = vals.cpu().numpy()
            t2 = time.perf_counter()
            device_s = timing[0].elapsed_time(timing[1]) / 1e3 if on_card else t1 - t0
        except Exception as e:
            err = _build.as_kernel_error(e, "score kernel dispatch")
            if err is e:
                raise
            raise err from e
        # device_compute: the launch's host time, then the kernel; d2h: the
        # copies after it (on the CPU the plain version ran inside the call)
        compute_s = min(t2 - t0, (t1 - t0) + device_s) if on_card else t1 - t0
        for t in _tracing.active_traces():
            t.add_stage("device_compute", compute_s)
            t.add_stage("d2h", (t2 - t0) - compute_s)
            t.annotate(device_us=round(device_s * 1e6, 2))
        self.devprof.record(b, device_s)
        return idx_h, val_h

    def score_topk_filtered(
        self,
        user_idx: int,
        k: int,
        exclude_items: Optional[np.ndarray] = None,
        candidate_items: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` (indices, values) for ONE user under per-query filters.

        One launch at rung 1 whose exclusion mask is pad | excluded |
        not-in-``candidate_items`` (``None`` means every item is a
        candidate). Bypasses the hot set: the filters make the answer the
        query's own.
        """
        if k > self.k:
            raise ValueError(f"k={k} exceeds compiled top-k width {self.k}")
        dev = self.ctx.device
        mask = self._item_pad_mask.clone()
        if exclude_items is not None and len(exclude_items):
            mask[torch.as_tensor(np.asarray(exclude_items, np.int64), device=dev)] = True
        if candidate_items is not None:
            keep = torch.zeros_like(mask)
            if len(candidate_items):
                keep[torch.as_tensor(np.asarray(candidate_items, np.int64), device=dev)] = True
            mask |= ~keep
        vals, idx = self._launch(np.array([user_idx], np.int32), mask)
        idx_h = idx.cpu().numpy()
        val_h = vals.cpu().numpy()
        with self._lock:
            self.hits[1] += 1
            self.queries += 1
        return idx_h[0, :k], val_h[0, :k]

    # -- hot set -------------------------------------------------------------
    def _note_traffic(self, users: np.ndarray) -> None:
        refresh = False
        with self._lock:
            np.add.at(self._hot_counts, users, 1.0)
            self._hot_since_refresh += len(users)
            if self._hot_since_refresh >= self.hot_refresh_queries:
                self._hot_since_refresh = 0
                refresh = True
        if refresh:
            self._refresh_hot_set()

    def _refresh_hot_set(self) -> None:
        """Re-rank the working set and materialize its top-k table through
        the top rung; the decay halves every count afterward so the ranking
        follows traffic drift rather than all-time popularity."""
        with self._lock:
            counts = self._hot_counts.copy()
            applies = self.delta_applies
        n = self.hot_size
        if n < len(counts):
            cand = np.argpartition(-counts, n - 1)[:n]
        else:
            cand = np.arange(len(counts))
        cand = cand[counts[cand] > 0]
        if len(cand) == 0:
            return
        cand = np.sort(cand).astype(np.int32)
        idx, vals = self._device_topk(cand, self.k)
        with self._lock:
            if self.delta_applies != applies:
                return  # a delta landed meanwhile: the next refresh ranks its rows
            self._hot_rows = {int(u): i for i, u in enumerate(cand)}
            self._hot_table_idx = idx
            self._hot_table_val = vals
            self.hot_refreshes += 1
            self._hot_counts *= 0.5

    # -- streaming micro-generations (core/delta.py) -------------------------
    def apply_delta_rows(self, user_idx, user_rows, item_idx=None, item_rows=None) -> dict:
        """Patch a delta's factor rows into the resident factors.

        Counterpart of ``predictionio_tpu/serving/fastpath.py:553-605`` for
        the replicated placement (the port's only one, so an item's slot is
        its index). Rows past the factor matrices are dropped; the item
        tail's pad rows and mask are never touched. Quantized factors are
        re-quantized row-wise as at publish. The patched users fall out of
        the hot-set table. Returns ``{"users", "items"}`` with the scorer's
        ``warmup_executions`` and the kernels built in this process, both
        unchanged by any delta, and ``device_ms``, the patch's time on the
        device (CUDA events on the card, the host's clock on the CPU).
        """
        users = np.asarray(user_idx, np.int64).reshape(-1)
        u_rows = np.asarray(user_rows, np.float32).reshape(len(users), -1)
        keep = users < self.n_users
        users, u_rows = users[keep], u_rows[keep]
        items = np.asarray(() if item_idx is None else item_idx, np.int64).reshape(-1)
        i_rows = None
        if len(items):
            i_rows = np.asarray(item_rows, np.float32).reshape(len(items), -1)
            keep = items < self.n_items
            items, i_rows = items[keep], i_rows[keep]
        dev = self.ctx.device
        # quantize and upload first: the timed span holds the card's copies
        patches = []
        for which, idx, rows in ((0, users, u_rows), (1, items, i_rows)):
            if len(idx):
                q, scale = _quantize.quantize_factors(rows, self.factor_dtype)
                patches.append((which, torch.from_numpy(idx).to(dev), factors_to_tensor(q, dev),
                                None if scale is None else torch.from_numpy(scale).to(dev)))
        on_card = dev.type == "cuda"
        with self._patch_lock:
            t0 = time.perf_counter()
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            factors = list(self._factors)
            for which, at, q, scale in patches:
                factors[which] = factors[which].clone().index_copy_(0, at, q)
                if scale is not None:
                    factors[which + 2] = factors[which + 2].clone().index_copy_(0, at, scale)
            if on_card:
                end.record()
                try:
                    # the new rows are in memory before any launch can read
                    # them, whatever stream it runs on
                    end.synchronize()
                except Exception as e:
                    err = _build.as_kernel_error(e, "delta row patch")
                    if err is e:
                        raise
                    raise err from e
                device_ms = start.elapsed_time(end)
            else:
                device_ms = (time.perf_counter() - t0) * 1e3
            self._factors = tuple(factors)
        with self._lock:
            for u in users:
                self._hot_rows.pop(int(u), None)
            self.delta_applies += 1
            self.delta_rows += len(users) + len(items)
        return {
            "users": int(len(users)), "items": int(len(items)),
            "warmup_executions": self.warmup_executions,
            "kernel_builds": len(_build.build_log), "device_ms": device_ms,
        }

    def stats(self) -> dict:
        """Counters for ``GET /`` stats."""
        with self._lock:
            hits = dict(self.hits)
            hot_lookups = self.hot_hits + self.hot_misses
            hotset = {
                "size": self.hot_size,
                "resident": len(self._hot_rows),
                "refresh_queries": self.hot_refresh_queries,
                "hits": self.hot_hits,
                "misses": self.hot_misses,
                "refreshes": self.hot_refreshes,
                "hit_rate": round(self.hot_hits / hot_lookups, 4)
                if hot_lookups
                else None,
            }
            top_cost = self.devprof.costs().get(self.buckets[-1]) or {}
            flops, nbytes = top_cost.get("flops"), top_cost.get("bytes")
            return {
                "buckets": list(self.buckets),
                "top_k": self.k,
                "kernel": {
                    "backend": self.backend,
                    "device": str(self.ctx.device),
                    "factor_dtype": self.factor_dtype,
                    "resident_factor_bytes": self.resident_factor_bytes,
                    "block_items": min(_score_kernel.BLOCK_I, self._n_items_pad),
                    "warmup_executions": self.warmup_executions,
                    # top-rung arithmetic intensity: the roofline position
                    "intensity_flops_per_byte": (
                        round(flops / nbytes, 3) if flops and nbytes else None
                    ),
                },
                # eager PyTorch compiles nothing per rung (the kernel is
                # built once a process); the series stays for parity
                "compile_count": 0,
                "bucket_hits": {str(b): h for b, h in hits.items()},
                "calls": sum(hits.values()),
                "queries": self.queries,
                "padded_rows": self.padded_rows,
                "row_occupancy": round(
                    self.queries / (self.queries + self.padded_rows), 4
                )
                if self.queries
                else None,
                "hotset": hotset if self.hot_size else None,
                "deltas": {"applied": self.delta_applies, "rows": self.delta_rows},
                "devprof": self.devprof.snapshot(),
            }
