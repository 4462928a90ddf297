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
  and then swaps the factor tuple in one rebind. A launch reads that tuple
  once, so it sees the rows before or after a patch, never half of them,
  and no tensor a launch may still read is written. No scorer is built, no
  rung warmed and no kernel built again.

* **IVF retrieval** (``PIO_RETRIEVAL``, ``ops/ivf.py``; the JAX package's
  ``:197-232, 361-445, 721-819``) — with a published
  :class:`~predictionio_tpu_torch.ops.ivf.IVFIndex` the item factors (and
  int8 scales) lie in the index's cluster blocks of ``cap_pad`` slots
  (``serving/sharding.build_layout``), with the centroids, each slot's
  global id and the pad mask beside them on the card. A dispatch at rung
  b probes ``P_b = min(nlist, max(min_probes, nprobe·b))`` clusters, picked
  on the card by the batch's best centroid scores, and scans them in ONE
  launch of the score kernel's probe-table mode
  (``ops/score_kernel.ivf_score_topk``), which answers in global ids.
  ``min_probes`` (the fewest clusters sure to hold k real items) keeps
  padding out of every answer; ``PIO_IVF_NPROBE`` overrides the published
  probe count, clamped to ``[1, nlist]``. Per-query filtered calls probe
  every cluster, so they stay exact. Delta item rows land in their
  cluster slots.

* **Sharded placement** (``plan=``, ``PIO_SERVING_SHARDING``; the JAX
  package's ``:113-155, 447-520, 822-926``) — with a publish-time
  :class:`~predictionio_tpu_torch.serving.sharding.ShardingPlan` of S > 1
  shards and a mesh of at least S placements, the item factors (and int8
  scales, unit on pads) lie in the plan's blocks of ``cap_pad`` slots, block
  s on placement s with its global ids and pad mask; the user factors are on
  every placement. A dispatch launches the score kernel once a shard over
  that shard's block for its best ``local_k = min(k, cap_pad)``, maps the
  winners to global ids, gathers the S leaderboards onto the first
  placement and merges them in the two-key order (``merge_topk``), so the
  answer equals the replicated placement's bit for bit. A plan with host
  groups merges in two tiers (``two_tier_merge_topk``) over the ``(host,
  data)`` submesh. ``auto`` (the default) serves sharded only when the
  mesh has the plan's placements: on a one-card default mesh it is the
  replicated path, and an explicit ``sharded`` warns and serves
  replicated. An IVF index under a sharded plan serves exact sharded. On a
  mesh that spans the processes of a launch each process holds its own
  placements' blocks, launches the kernel once a local shard and merges
  with the others in lockstep (:meth:`BucketedScorer.
  _merge_across_processes`); deltas are skipped there.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import nullcontext as _nullcontext
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.parallel import distributed as _distributed
from predictionio_tpu_torch.parallel import mesh as _mesh
from predictionio_tpu_torch.obs import devprof as _devprof
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import ivf as _ivf
from predictionio_tpu_torch.ops import score_kernel as _score_kernel
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops.quantize import factors_to_tensor
from predictionio_tpu_torch.ops.topk import (
    gather_merge_topk,
    gather_score_topk,
    two_tier_merge_topk,
)
from predictionio_tpu_torch.serving import sharding as _sharding

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


SERVING_BACKENDS = ("replicated", "sharded", "auto")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resolve_serving_backend(
    requested: Optional[str] = None,
    *,
    plan=None,
    ctx: Optional[DeviceContext] = None,
) -> str:
    """The factor placement: ``"replicated"`` or ``"sharded"``.

    ``requested`` overrides ``PIO_SERVING_SHARDING`` (default ``auto``).
    ``auto`` serves sharded only when a plan of more than one shard is
    declared and the mesh has at least that many placements; an explicit
    ``sharded`` without a plan raises, and a plan wider than the mesh warns
    and serves replicated (the plan is an optimization, never a point of
    failure).
    """
    req = (requested or os.environ.get("PIO_SERVING_SHARDING") or "auto").strip().lower()
    if req not in SERVING_BACKENDS:
        raise ValueError(f"PIO_SERVING_SHARDING must be one of {SERVING_BACKENDS}, got {req!r}")
    if req == "replicated":
        return "replicated"
    n_dev = ctx.n_devices if ctx is not None else 1
    if req == "sharded":
        if plan is None:
            raise ValueError(
                "PIO_SERVING_SHARDING=sharded requires a ShardingPlan declared at "
                "publish (PIO_SHARD_COUNT/PIO_SHARD_HBM_BUDGET)"
            )
        if plan.n_shards > n_dev:
            logger.warning(
                "sharding plan wants %d shards but the mesh has %d devices; serving "
                "replicated", plan.n_shards, n_dev,
            )
            return "replicated"
        return "sharded"
    if plan is not None and 1 < plan.n_shards <= n_dev:
        return "sharded"
    return "replicated"


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
        plan=None,
        ivf_index=None,
        retrieval: Optional[str] = None,
        sharding: Optional[str] = None,
    ):
        self.ctx = ctx
        self.n_users = user_factors.shape[0]
        self.n_items = item_factors.shape[0]
        self.factor_dtype = factor_dtype
        if factor_dtype == "int8" and (user_scale is None or item_scale is None):
            raise ValueError("int8 factors require user_scale and item_scale")
        self.k = min(max_k, self.n_items)
        self.buckets = BUCKETS
        # factor placement (PIO_SERVING_SHARDING): replicated copies, or the
        # item blocks of the publish-time plan on the mesh's placements
        self.plan = plan
        self.sharding = resolve_serving_backend(sharding, plan=plan, ctx=ctx)
        self._shard_acct: Optional[_sharding.ShardAccounting] = None
        # retrieval path (PIO_RETRIEVAL): IVF prunes the scan to the probed
        # cluster blocks when the model carries an index; a sharded plan
        # already partitions the scan, and takes precedence
        self.ivf_index = ivf_index
        retr = _ivf.resolve_retrieval(retrieval, index=ivf_index)
        if retr == "ivf" and self.sharding == "sharded":
            logger.warning(
                "IVF retrieval composes with replicated placement only; the sharding "
                "plan takes precedence — serving exact sharded"
            )
            retr = "exact"
        self.retrieval = retr
        # a plan with host groups merges in two tiers over (host, data)
        self._pod = self.sharding == "sharded" and getattr(plan, "host_groups", 1) > 1
        if factor_dtype == "f32":
            user_factors = np.asarray(user_factors, np.float32)
            item_factors = np.asarray(item_factors, np.float32)
        self._ivf_extra_bytes = 0
        if self.sharding == "sharded":
            self._init_sharded_placement(user_factors, item_factors, user_scale, item_scale)
            # the flat merge has no second tier to account
            self._shard_acct = _sharding.ShardAccounting(
                self.plan, self._local_k, merged_k=self.k if self._pod else None
            )
            # the user factors (and scales) once, every shard's block
            self.resident_factor_bytes = sum(
                _nbytes(f[0]) for f in (self._factors[0], self._factors[2]) if f is not None
            ) + sum(self.resident_shard_bytes)
        else:
            if self.retrieval == "ivf":
                self._init_ivf_placement(user_factors, item_factors, user_scale, item_scale)
            else:
                self._init_replicated_placement(
                    user_factors, item_factors, user_scale, item_scale
                )
            self.resident_factor_bytes = sum(
                _nbytes(t) for t in (self._U, self._V, self._Uscale, self._Vscale)
                if t is not None
            ) + self._ivf_extra_bytes
        # IVF scan accounting: probed blocks and scanned padded rows per
        # dispatch, against the rows the exact path would have scanned
        self._ivf_dispatches = 0
        self._ivf_probed_blocks = 0
        self._ivf_scanned_rows = 0
        self._ivf_dispatch_rows = 0
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
        rank = np.asarray(user_factors).shape[1]
        # per-rung annotated bytes, read by the shard accounting's merge share
        self._cost_bytes: dict[int, float] = {}
        for b in self.buckets:
            # IVF: a dispatch scans its rung's P_b·cap_pad probed rows for
            # per-probe lists of min(k, cap_pad), as the JAX package annotates;
            # sharded: the S blocks of cap_pad slots every dispatch scans
            scanned, width = self._n_items_pad, self.k
            if self.retrieval == "ivf":
                scanned, width = self._probes[b] * self._ivf_layout.cap_pad, self._local_k
            elif self.sharding == "sharded":
                scanned = self.plan.n_shards * self._n_items_pad
            if self.backend == "fused":
                flops, nbytes = _devprof.fused_score_cost(
                    b, scanned, rank, width, self.factor_dtype
                )
                self.devprof.set_cost(b, flops, nbytes, source="analytic-fused")
            else:
                flops, nbytes = _devprof.score_cost(b, scanned, rank, dtype=self.factor_dtype)
                self.devprof.set_cost(b, flops, nbytes, source="analytic")
            self._cost_bytes[b] = float(nbytes)
        # warm-up: build the kernel and launch every rung once (or only the
        # rungs ``warm_buckets`` names), before the first request; a failure
        # here raises to the deploy
        self.warmup_executions = 0
        for b in self.buckets if warm_buckets is None else warm_buckets:
            self._score(torch.zeros(b, dtype=torch.int32, device=self.ctx.device), b)
            self.warmup_executions += 1
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _init_replicated_placement(
        self, user_factors, item_factors, user_scale, item_scale
    ) -> None:
        """Full factor copies on the card, item dimension padded to the
        kernel's chunk layout (zero rows, masked; unit scales)."""
        dev = self.ctx.device
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
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
        # pio: ignore[race-unguarded-rebind]
        self._factors = (U, V, Us, Vs)
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
        self._item_pad_mask = self.ctx.replicate(
            np.arange(self._n_items_pad) >= self.n_items
        )

    def _init_ivf_placement(self, user_factors, item_factors, user_scale, item_scale) -> None:
        """The item factors in the IVF index's cluster blocks, with the
        centroids, slot→global id and pad mask on the card.

        ``build_layout`` gives every cluster a block of ``cap_pad`` slots
        (the kernel's item padding of the largest cluster), real slots
        ascending by global id. ``_n_items_pad`` becomes the per-probe block
        size; ``_exact_items_pad`` is what the exact path would scan, the
        scanned fraction's denominator. Raises ``KernelError`` if the probe
        mode cannot take some rung's plan.
        """
        dev = self.ctx.device
        index = self.ivf_index
        index.validate(self.n_items)
        layout = _sharding.build_layout(index.plan, _score_kernel.pad_block_items)
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
        self._ivf_layout = layout
        self._n_items_pad = layout.cap_pad
        self._exact_items_pad = _score_kernel.pad_block_items(self.n_items)
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
        self._local_k = min(self.k, layout.cap_pad)
        # deploy-time probe budget: PIO_IVF_NPROBE overrides the published
        # default, clamped to [1, nlist]
        env_nprobe = os.environ.get("PIO_IVF_NPROBE", "")
        nprobe = int(env_nprobe) if env_nprobe.strip() else int(index.nprobe)
        self._nprobe = max(1, min(nprobe, index.nlist))
        # fewest probes whose clusters are sure to hold >= k real items (the
        # P smallest clusters' sizes sum to >= k), so padding never wins
        sizes = np.sort(index.plan.shard_sizes())
        self._min_probes = int(np.searchsorted(np.cumsum(sizes), self.k) + 1)
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
        self._probes = {
            b: min(index.nlist, max(self._min_probes, self._nprobe * b)) for b in self.buckets
        }
        rank = np.asarray(user_factors).shape[1]
        for p in self._probes.values():
            _score_kernel.check_probe_plan(index.nlist, layout.cap_pad, p, self.k, rank)
        gid = layout.gid
        pad_mask = layout.pad_mask
        # global item id -> its slot, for delta rows and per-query filters
        self._slot_of = np.empty(self.n_items, np.int64)
        real = np.flatnonzero(~pad_mask)
        # built once during construction, read-only under traffic
        # pio: ignore[race-unguarded-rmw]
        self._slot_of[gid[real]] = real
        U = factors_to_tensor(np.asarray(user_factors), dev)
        V = factors_to_tensor(layout.take_rows(np.asarray(item_factors)), dev)
        Us = Vs = None
        if self.factor_dtype == "int8":
            Us = self.ctx.replicate(np.asarray(user_scale, np.float32))
            Vs = self.ctx.replicate(layout.take_rows(np.asarray(item_scale, np.float32), fill=1.0))
        C = np.ascontiguousarray(index.centroids, np.float32)
        self._item_pad_mask = self.ctx.replicate(pad_mask)
        # (U, V, U scales, V scales, centroids, gid, pad mask): the last
        # three never change, and a patch swaps the whole tuple
        self._factors = (U, V, Us, Vs, self.ctx.replicate(C), self.ctx.replicate(gid),
                         self._item_pad_mask)
        self._ivf_extra_bytes = int(C.nbytes) + int(gid.nbytes) + int(pad_mask.nbytes)

    def _init_sharded_placement(self, user_factors, item_factors, user_scale, item_scale) -> None:
        """The item factors in the plan's blocks on the shard placements.

        ``build_layout`` gives every shard a block of ``cap_pad`` slots (the
        kernel's item padding of the largest shard), real slots ascending by
        global id, so a shard's local top-k order composes with the merge's.
        Block s goes to placement s of the shard submesh (the ``(host,
        data)`` pod submesh for a plan with host groups), with its global
        ids and pad mask; the user factors go to every placement, one tensor
        a device. ``_n_items_pad`` is the block size, ``_local_k`` a shard's
        leaderboard width: a shard with fewer than k real items gives its
        whole block, and S·cap_pad ≥ n_items ≥ k.
        """
        plan = self.plan
        plan.validate(self.n_items)
        layout = _sharding.build_layout(plan, _score_kernel.pad_block_items)
        self._shard_layout = layout
        self._n_items_pad = layout.cap_pad
        self._local_k = min(self.k, layout.cap_pad)
        shard_axes = _mesh.DATA_AXIS
        if self._pod:
            try:
                sc = self.ctx.pod_submesh(plan.n_shards, plan.host_groups)
                shard_axes = (_mesh.HOST_AXIS, _mesh.DATA_AXIS)
            except ValueError as e:
                logger.warning("pod layout rejected (%s); serving the flat merge instead", e)
                # construction-time: before the scorer is shared
                # pio: ignore[race-unguarded-rebind]
                self._pod = False
        if not self._pod:
            sc = self.ctx.submesh(plan.n_shards)
        # construction-time: before the scorer is shared
        # pio: ignore[race-unguarded-rebind]
        self._shard_ctx = sc
        gid, pad_mask = layout.gid, layout.pad_mask
        # global item id -> its slot, for delta rows and per-query filters
        self._slot_of = np.empty(self.n_items, np.int64)
        real = np.flatnonzero(~pad_mask)
        self._slot_of[gid[real]] = real

        # host tensors first (a uint16 array is a bf16 bit pattern), then
        # the placements' blocks
        def blocks(x):
            return tuple(sc.place(factors_to_tensor(x, "cpu"), shard_axes))

        def everywhere(x):
            return tuple(sc.place(factors_to_tensor(x, "cpu")))

        U = everywhere(np.asarray(user_factors))
        V = blocks(layout.take_rows(np.asarray(item_factors)))
        Us = Vs = None
        if self.factor_dtype == "int8":
            Us = everywhere(np.asarray(user_scale, np.float32))
            Vs = blocks(layout.take_rows(np.asarray(item_scale, np.float32), fill=1.0))
        # (U, V, U scales, V scales, gid, pad mask), each a tuple of the S
        # placements' tensors; a patch swaps the whole tuple
        self._factors = (U, V, Us, Vs, blocks(gid), blocks(pad_mask))
        # this process's blocks (every block in one process)
        self.resident_shard_bytes = [
            _nbytes(V[s]) + (_nbytes(Vs[s]) if Vs is not None else 0) for s in range(len(V))
        ]

    def _layout_slots(self) -> Optional[np.ndarray]:
        """Global item id → laid-out slot under IVF retrieval or a sharded
        plan, else None (the exact placement's slot is the item's index)."""
        return self._slot_of if self.retrieval == "ivf" or self.sharding == "sharded" else None

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

    def _score(
        self, u_dev: torch.Tensor, b: int, timing: Optional[tuple] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One dispatch at rung ``b``: the exact scan, the IVF probe scan
        (answering in global ids), or one launch a shard and the merge
        (global ids). Reads the factor tuple once."""
        f = self._factors
        if self.sharding == "sharded":
            return self._score_sharded(f, u_dev, f[5], timing)
        U, V, Us, Vs = f[:4]
        if self.retrieval == "ivf":
            C, gid, mask = f[4:]
            return _score_kernel.ivf_score_topk(
                U, V, C, gid, mask, u_dev, self.k, self._probes[b], self._ivf_layout.cap_pad,
                u_scale=Us, v_scale=Vs, timing=timing,
            )
        return gather_score_topk(
            U, V, u_dev, self.k, item_mask=self._item_pad_mask,
            u_scale=Us, v_scale=Vs, timing=timing,
        )

    def _score_sharded(self, f, u_dev, masks, timing=None):
        """The kernel once a shard over its block at ``local_k``, winners
        mapped to global ids, the S leaderboards gathered onto the first
        placement and merged (two tiers for a pod plan). ``masks`` are the
        shards' exclusion masks; ``timing`` brackets the launches and the
        merge on the first placement's stream."""
        U, V, Us, Vs, gid = f[:5]
        merge_dev = V[0].device
        on_card = merge_dev.type == "cuda"
        with torch.cuda.device(merge_dev) if on_card else _nullcontext():
            if timing is not None:
                timing[0].record()
            lv, lg, u_on = [], [], {}
            for s in range(len(V)):
                dev = V[s].device
                if dev not in u_on:
                    u_on[dev] = u_dev.to(dev)
                vals, idx = gather_score_topk(
                    U[s], V[s], u_on[dev], self._local_k, item_mask=masks[s],
                    u_scale=None if Us is None else Us[s], v_scale=None if Vs is None else Vs[s],
                )
                lv.append(vals)
                lg.append(gid[s][idx.long()])
            if self._shard_ctx.spans_processes:
                out = self._merge_across_processes(lv, lg, merge_dev)
            elif self._pod:
                out = two_tier_merge_topk(lv, lg, self.k, host_groups=self.plan.host_groups,
                                          device=merge_dev)
            else:
                out = gather_merge_topk(lv, lg, self.k, merge_dev)
            if timing is not None:
                timing[1].record()
        return out

    def _merge_across_processes(self, lv, lg, dev):
        """The merge on a shard mesh that spans processes (``fastpath.py:
        851-890`` in the JAX package), every process in lockstep: under a
        pod plan tier 1 merges each of this process's host rows here and
        tier 2 gathers the H per-host leaderboards from every process
        (``distributed.gather_blocks``, host-staged); the flat merge gathers
        every shard's leaderboard. The lists and the merges are the
        one-process ones, so the answer is the one-process pod serve's."""
        from predictionio_tpu_torch.parallel import distributed

        if self._pod:
            g = self.plan.n_shards // self.plan.host_groups
            host_v, host_g = [], []
            for r in range(0, len(lv), g):  # this process holds whole host rows
                v, i = gather_merge_topk(lv[r:r + g], lg[r:r + g], self.k, lv[r].device)
                host_v.append(v)
                host_g.append(i)
            every_v, every_g = distributed.gather_blocks(host_v), distributed.gather_blocks(host_g)
            return gather_merge_topk(every_v, every_g, self.k, dev)
        sc = self._shard_ctx
        gv, gg = _mesh.all_gather(lv, dev, ctx=sc), _mesh.all_gather(lg, dev, ctx=sc)
        return gather_merge_topk(list(gv), list(gg), self.k, dev)

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
            idx_h, val_h, device_s = self._dispatch(b, padded)
            with self._lock:
                self.hits[b] += 1
                self.queries += len(chunk)
                self.padded_rows += b - len(chunk)
                if self._shard_acct is not None:
                    self._shard_acct.note(idx_h[: len(chunk), :k], b, device_s, self._cost_bytes[b])
                if self.retrieval == "ivf":
                    self._ivf_dispatches += 1
                    self._ivf_probed_blocks += self._probes[b]
                    self._ivf_scanned_rows += self._probes[b] * self._ivf_layout.cap_pad
                    self._ivf_dispatch_rows += b
            # padded tail rows are real top-k rows for user 0 — dropped here
            idx_parts.append(idx_h[: len(chunk), :k])
            val_parts.append(val_h[: len(chunk), :k])
        return np.concatenate(idx_parts), np.concatenate(val_parts)

    def _dispatch(self, b: int, padded: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
        """One traced, accounted dispatch at rung ``b``; host (idx, vals)
        and the device seconds."""
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
            t0 = time.perf_counter()
            vals, idx = self._score(u_dev, b, timing)
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
        return idx_h, val_h, device_s

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
        query's own. Under IVF retrieval the launch probes every cluster,
        so the answer is the exact one, as the JAX package's per-query path
        (which never prunes) gives it.
        """
        if k > self.k:
            raise ValueError(f"k={k} exceeds compiled top-k width {self.k}")
        dev = self.ctx.device
        slots = self._layout_slots()

        def at(items):
            items = np.asarray(items, np.int64)
            return torch.as_tensor(items if slots is None else slots[items], device=dev)

        f = self._factors
        sharded = self.sharding == "sharded"
        if sharded:  # the layout's whole mask, split back into blocks below
            dev = torch.device("cpu")
            mask = torch.from_numpy(self._shard_layout.pad_mask.copy())
        else:
            mask = self._item_pad_mask.clone()
        if exclude_items is not None and len(exclude_items):
            mask[at(exclude_items)] = True
        if candidate_items is not None:
            keep = torch.zeros_like(mask)
            if len(candidate_items):
                keep[at(candidate_items)] = True
            mask |= ~keep
        u_dev = torch.tensor([user_idx], dtype=torch.int32, device=dev)
        if sharded:
            cap = self._n_items_pad
            masks = [mask[s * cap:(s + 1) * cap].to(f[1][s].device) for s in range(len(f[1]))]
            vals, idx = self._score_sharded(f, u_dev, masks)
        elif self.retrieval == "ivf":
            every = torch.arange(self.ivf_index.nlist, dtype=torch.int32, device=dev)
            vals, idx = _score_kernel.fused_probed_score_topk(
                f[0], f[1], u_dev, self.k, every, f[5], self._ivf_layout.cap_pad, mask,
                u_scale=f[2], v_scale=f[3],
            )
        else:
            vals, idx = gather_score_topk(
                f[0], f[1], u_dev, self.k, item_mask=mask, u_scale=f[2], v_scale=f[3]
            )
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

        Counterpart of ``predictionio_tpu/serving/fastpath.py:553-646``: an
        item row lands in its slot, the item's index under the exact
        placement, its cluster slot under IVF and its slot in its shard's
        block under a sharded plan (``_layout_slots``). Rows
        past the factor matrices are dropped; pad rows, the mask, the
        centroids and the global ids are never touched. Quantized factors are
        re-quantized row-wise as at publish. The patched users fall out of
        the hot-set table. Returns ``{"users", "items"}`` with the scorer's
        ``warmup_executions`` and the kernels built in this process, both
        unchanged by any delta, and ``device_ms``, the patch's time on the
        device (CUDA events on the card, the host's clock on the CPU).
        """
        if self.sharding == "sharded" and self._shard_ctx.spans_processes:
            # another process holds the other shards' blocks: deltas do not
            # compose with serving across processes, the next full reload
            # picks them up (the JAX package's documented degrade)
            logger.warning(
                "apply_delta_rows skipped: factors span processes on a pod mesh; "
                "deltas apply at the next full publish/reload"
            )
            return {"users": 0, "items": 0, "warmup_executions": self.warmup_executions,
                    "kernel_builds": len(_build.build_log), "device_ms": 0.0, "skipped": "pod"}
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
        slots = self._layout_slots()
        item_at = items if slots is None else slots[items]
        if self.sharding == "sharded":
            patch = self._sharded_patch(users, u_rows, item_at, i_rows)
        else:
            # quantize and upload first: the timed span holds the card's copies
            patches = []
            for which, idx, rows in ((0, users, u_rows), (1, item_at, i_rows)):
                if len(idx):
                    q, scale = _quantize.quantize_factors(rows, self.factor_dtype)
                    patches.append((which, torch.from_numpy(idx).to(dev), factors_to_tensor(q, dev),
                                    None if scale is None else torch.from_numpy(scale).to(dev)))

            def patch(factors):
                factors = list(factors)
                for which, at, q, scale in patches:
                    factors[which] = factors[which].clone().index_copy_(0, at, q)
                    if scale is not None:
                        factors[which + 2] = factors[which + 2].clone().index_copy_(0, at, scale)
                return tuple(factors)

        on_card = dev.type == "cuda"
        with self._patch_lock:
            t0 = time.perf_counter()
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            factors = patch(self._factors)
            if on_card:
                end.record()
                try:
                    # the new rows are in memory before any launch can read
                    # them, whatever stream it runs on
                    # pio: ignore[hotpath-block-sync]
                    end.synchronize()
                except Exception as e:
                    err = _build.as_kernel_error(e, "delta row patch")
                    if err is e:
                        raise
                    raise err from e
                device_ms = start.elapsed_time(end)
            else:
                device_ms = (time.perf_counter() - t0) * 1e3
            self._factors = factors
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

    def _sharded_patch(self, users, u_rows, item_slots, i_rows):
        """The patch of :meth:`apply_delta_rows` under a sharded plan, a
        function of the factor tuple: user rows go into the user factors of
        every placement's device (one clone a device, the scales with them),
        item rows into the block of the shard that owns their slot. The
        placements share the card the patch is timed on."""
        cap = self._n_items_pad
        uq = us = iq = i_scale = None
        if len(users):
            uq, us = _quantize.quantize_factors(u_rows, self.factor_dtype)
        if len(item_slots):
            iq, i_scale = _quantize.quantize_factors(i_rows, self.factor_dtype)

        def patch(factors):
            U, V, Us, Vs, gid, mask = (None if x is None else list(x) for x in factors)
            done: dict = {}
            for s, t in enumerate(U if len(users) else ()):
                if id(t) not in done:
                    at = torch.from_numpy(users).to(t.device)
                    done[id(t)] = (
                        t.clone().index_copy_(0, at, factors_to_tensor(uq, t.device)),
                        None if Us is None
                        else Us[s].clone().index_copy_(0, at, torch.from_numpy(us).to(t.device)),
                    )
                U[s] = done[id(t)][0]
                if Us is not None:
                    Us[s] = done[id(t)][1]
            owner = item_slots // cap
            for s in np.unique(owner).tolist():
                pick = owner == s
                d = V[s].device
                at = torch.from_numpy(item_slots[pick] - s * cap).to(d)
                V[s] = V[s].clone().index_copy_(0, at, factors_to_tensor(iq[pick], d))
                if Vs is not None:
                    Vs[s] = Vs[s].clone().index_copy_(0, at, torch.from_numpy(i_scale[pick]).to(d))
            return tuple(None if x is None else tuple(x) for x in (U, V, Us, Vs, gid, mask))

        return patch

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
            retrieval = None
            if self.retrieval == "ivf":
                index = self.ivf_index
                # scanned fraction: rows the probe scans streamed over the rows
                # the exact path would have streamed for the same dispatches
                denom = self._ivf_dispatches * self._exact_items_pad
                retrieval = {
                    "backend": "ivf",
                    "nlist": index.nlist,
                    "nprobe": self._nprobe,
                    "min_probes": self._min_probes,
                    "cap_pad": self._ivf_layout.cap_pad,
                    "probes_per_rung": {str(b): p for b, p in self._probes.items()},
                    "dispatches": self._ivf_dispatches,
                    "dispatch_rows": self._ivf_dispatch_rows,
                    "probed_blocks": self._ivf_probed_blocks,
                    "scanned_rows": self._ivf_scanned_rows,
                    "scanned_fraction": round(self._ivf_scanned_rows / denom, 6)
                    if denom else None,
                    "resident_extra_bytes": self._ivf_extra_bytes,
                    "recall_at_publish": index.recall_at_publish,
                    "fingerprint": index.fingerprint,
                }
            sharding = pod = None
            if self._shard_acct is not None:
                sharding = self._shard_acct.snapshot(
                    (self.devprof.snapshot() or {}).get("busy_fraction"),
                    list(self.resident_shard_bytes),
                )
                if self._pod:
                    pod = {
                        "host_groups": self.plan.host_groups,
                        "shards_per_group": self.plan.shards_per_group,
                        "process_index": self._shard_ctx.process_index,
                        "process_count": _distributed.num_processes(),
                        "spans_processes": self._shard_ctx.spans_processes,
                        "fingerprint": self.plan.fingerprint,
                        "cross_host_merge_bytes": sharding["pod_merge_bytes"],
                        "cross_host_merge_seconds": sharding["pod_merge_seconds"],
                        "dispatches": sharding["pod_dispatches"],
                    }
            return {
                "buckets": list(self.buckets),
                "top_k": self.k,
                "serving_backend": self.sharding,
                "sharding": sharding,
                "pod": pod,
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
                "retrieval_backend": self.retrieval,
                "retrieval": retrieval,
                "devprof": self.devprof.snapshot(),
            }
