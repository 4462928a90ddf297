"""Alternating Least Squares: training with the dense or the segment
solver, the model and its serving-side scorer.

Counterpart of ``predictionio_tpu/models/als.py`` on one card:

* training (``:170-1069``): :class:`ALSConfig` with its training fields and
  :func:`train_als`, with two solvers. The dense solver (the default):
  host-side degree bucketing (``_degree_sort_permutation``,
  ``_bucket_boundaries``, ``_make_dense_blocks``, ``_dense_blocks_for``),
  then per half-step one call of the hand-written CUDA kernel
  ``ops/train_kernel.fused_train_normal_eq`` per degree bucket and one
  batched Cholesky solve. The segment solver (``solver="segment"``): the
  rating stream in its own order (``_make_blocks``), sorted by entity once
  per side (``_segment_layout``), then per half-step one call of the CUDA
  kernel ``ops/train_kernel.fused_segment_normal_eq``, which sums the
  normal equations in the JAX package's chunk order, and the same solve.
  On a mesh of S placements the ids are cut into S shards (the LPT
  rebalance, ``_balance_permutation``; ``_make_dense_shards`` /
  ``_make_shard_blocks``): every half-step runs the kernel on each of this
  process's shards and all-gathers the new factors (``_run_shards``), across
  processes when the mesh spans a launch. Under ``pio launch`` the trainer
  also takes the 1/N read (``ShardedInteractions``,
  :func:`_train_als_sharded`: ``_sharded_balance_permutation``,
  ``_sharded_blocks_for_host``; dense only). With ``checkpoint_dir`` set,
  the factors are saved every ``checkpoint_interval`` iterations (by the
  coordinator) and a rerun resumes from the last matching step
  (``core/checkpoint.py``; ``:954-1030``);
* :class:`ALSModel` (``:132``) and :func:`als_model_from_arrays`, which
  carries factors and id lists across from anywhere else;
* :class:`CheckpointedALSModel` (``:1379-1748``): checkpoint-mode
  persistence, the factors in a sealed numpy store, the quantized serving
  variant behind its publish gate (``PIO_QUANT_DTYPE``), the sharding plan
  (``plan.blob``, fingerprint-checked at load) and the IVF index behind its
  recall gate (``PIO_IVF_NLIST``, ``PIO_IVF_MIN_RECALL``);
* the sharding declaration (``:1321-1347``): :func:`train_als` attaches a
  :class:`~predictionio_tpu_torch.serving.sharding.ShardingPlan` when
  ``PIO_SHARD_COUNT`` or ``PIO_SHARD_HBM_BUDGET`` is set, which the fast
  path serves sharded on a mesh with the plan's placements;
* the IVF declaration (``:1351-1377``): :func:`train_als` attaches a
  k-means coarse partition (``ops/ivf.py``) when ``PIO_IVF_NLIST`` is set,
  which an auto-mode model pickles with it and ``pio deploy --batching``
  serves through the score kernel's probe-table mode;
* serving (``:1757-2000``): :class:`ALSScorer`.

:class:`ALSConfig` resolves a ``compute_dtype`` or ``solver`` left at None
from ``PIO_ALS_COMPUTE_DTYPE`` and ``PIO_ALS_SOLVER`` when it is built, as
the JAX package does (``models/als.py:105-117``). The port reads no
``PIO_TRAIN_KERNEL`` or ``PIO_NATIVE``: they choose a kernel, and a CUDA
tensor always takes the kernel.

Every device scoring call goes through the scorer's
:class:`~predictionio_tpu_torch.serving.fastpath.BucketedScorer`, the one
holder of the factors on the card, and so through the score kernel: the
batched path and the per-query path (whose blacklist and whitelist become
the kernel's exclusion mask at B = 1). Unlike the JAX package, which keeps a
second float32 copy for per-query calls, a published quantized variant
therefore serves per-query calls from the same narrow factors as batches.
The host numpy branches stay where the JAX package sends queries to the
host: ``num`` beyond the built top-k width, filter sets larger than the
top filter bucket, and catalogs below :attr:`ALSScorer.HOST_THRESHOLD`
for per-query calls.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import os
import threading
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.core import persistence as _persistence
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops import score_kernel as _score_kernel
from predictionio_tpu_torch.ops import train_kernel as _train_kernel
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.parallel import mesh as _mesh
from predictionio_tpu_torch.ops.topk import NEG_INF
from predictionio_tpu_torch.serving import sharding as _sharding

logger = logging.getLogger(__name__)

COMPUTE_DTYPES = ("f32", "bf16", "int8")


@dataclasses.dataclass
class ALSConfig:
    rank: int = 10
    iterations: int = 10
    reg: float = 0.01  # lambda (per-rating, ALS-WR scaled)
    implicit: bool = False
    alpha: float = 1.0  # implicit confidence scale
    seed: int = 3
    # mid-training checkpoint/resume: factors + step saved every
    # checkpoint_interval iterations under checkpoint_dir; training resumes
    # from the latest matching step found there
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 5
    # dtype of the GATHERED opposite factors ("f32" | "bf16" | "int8"): bf16
    # gathers the opposite matrix in bfloat16, int8 quantizes it per
    # half-step with per-row scales; every contraction accumulates f32.
    # None → PIO_ALS_COMPUTE_DTYPE (default "f32"), read when the config is
    # built, not when the module is imported
    compute_dtype: Optional[str] = None
    # the LPT rebalance across mesh shards (models/als.py:180); one shard
    # rebalances nothing: the dense solver degree-sorts and the segment
    # solver keeps the original order
    rebalance: bool = True
    # "dense" — degree-bucketed normal equations through the training
    # kernel (ranks 1..64); "segment" — the rating stream sorted by entity,
    # summed in chunk order by the segment kernel (ranks 1..1024).
    # None → PIO_ALS_SOLVER (default "dense"), read when the config is built
    solver: Optional[str] = None

    def __post_init__(self):
        if self.solver is None:
            self.solver = os.environ.get("PIO_ALS_SOLVER", "dense")
        if self.compute_dtype is None:
            self.compute_dtype = os.environ.get("PIO_ALS_COMPUTE_DTYPE", "f32")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}, got {self.compute_dtype!r}"
            )
        if self.solver not in ("dense", "segment"):
            raise ValueError(f"solver must be 'dense' or 'segment', got {self.solver!r}")

    def __setstate__(self, state):
        # a JAX-package config also holds train_kernel, which chooses a
        # kernel the port always launches on the card
        _persistence.reconcile_state(self, state, drop=("train_kernel",))
        self.__post_init__()


@dataclasses.dataclass
class ALSModel:
    """Trained factors + id tables (host form; placed on the card to serve)."""

    user_factors: np.ndarray  # (n_users, rank) float32
    item_factors: np.ndarray  # (n_items, rank) float32
    user_map: BiMap
    item_map: BiMap
    config: ALSConfig = None
    # quantized serving variant (ops/quantize.py); "f32" means absent and
    # serving uses the float32 factors above, which are ALWAYS kept. bf16
    # arrays hold their uint16 bit pattern.
    factor_dtype: str = "f32"
    user_factors_q: Optional[np.ndarray] = None
    user_scale: Optional[np.ndarray] = None
    item_factors_q: Optional[np.ndarray] = None
    item_scale: Optional[np.ndarray] = None
    # publish-time ShardingPlan (serving/sharding.py), declared when the
    # PIO_SHARD_* knobs ask for item-factor partitioning; None serves
    # replicated. Travels inside the sealed MODELDATA pickle (auto mode) or
    # as its own sealed plan.blob (checkpoint mode).
    sharding_plan: Optional[object] = None
    # publish-time IVF coarse-retrieval index (ops/ivf.py), declared when
    # PIO_IVF_NLIST asks for an approximate scan; None serves exact.
    # Recall-gated at publish and sealed as ivf.blob (checkpoint mode).
    ivf_index: Optional[object] = None

    def __setstate__(self, state):
        _persistence.reconcile_state(self, state)

    def predict_rating(self, user_idx: int, item_idx: int) -> float:
        return float(self.user_factors[user_idx] @ self.item_factors[item_idx])


def als_model_from_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_ids,
    item_ids,
    config: Optional[ALSConfig] = None,
    factor_dtype: str = "f32",
) -> ALSModel:
    """Build the port's :class:`ALSModel` from plain arrays.

    ``user_ids``/``item_ids`` list the external ids in factor-row order
    (the JAX model's ``user_map.inverse[i]`` for ``i`` in row order).
    ``factor_dtype`` other than ``"f32"`` also fills the quantized serving
    variant with :func:`~predictionio_tpu_torch.ops.quantize.quantize_factors`.
    """
    U = np.ascontiguousarray(user_factors, np.float32)
    V = np.ascontiguousarray(item_factors, np.float32)
    user_ids, item_ids = list(user_ids), list(item_ids)
    if len(user_ids) != U.shape[0] or len(item_ids) != V.shape[0]:
        raise ValueError("id lists must match the factor rows")
    model = ALSModel(
        user_factors=U,
        item_factors=V,
        user_map=BiMap({u: i for i, u in enumerate(user_ids)}),
        item_map=BiMap({it: i for i, it in enumerate(item_ids)}),
        config=config or ALSConfig(rank=U.shape[1]),
        factor_dtype=factor_dtype,
    )
    if factor_dtype != "f32":
        model.user_factors_q, model.user_scale = _quantize.quantize_factors(
            U, factor_dtype
        )
        model.item_factors_q, model.item_scale = _quantize.quantize_factors(
            V, factor_dtype
        )
    return model


# ---------------------------------------------------------------------------
# Host-side degree bucketing (models/als.py:262-442, one shard)
# ---------------------------------------------------------------------------


# Upper bound on elements per bucket (n_b·D_b); bounds the (n_b, D_b, k)
# gathered tensor of the plain version to ~chunk·k·4 bytes.
_DENSE_CHUNK = 4_194_304


@dataclasses.dataclass
class _DenseBlocks:
    """Per-bucket dense rating matrices of one side.

    Bucket b holds the next n_b entities of the degree-sorted order, one row
    each, with row width widths[b] ≥ every member entity's rating count.
    ``idx``/``rat``/``msk`` are (n_b, width_b); padding slots carry idx 0
    and msk 0 and contribute exactly zero.
    """

    idx: list  # of (n_b, D_b) int32 — opposite-entity ids (blocked order)
    rat: list  # of (n_b, D_b) float32
    msk: list  # of (n_b, D_b) float32
    widths: list  # of int
    padded_ratings: int  # Σ n_b·D_b — the device workload size


def _degree_sort_permutation(entity: np.ndarray, n_entity: int, n_shards: int = 1) -> np.ndarray:
    """Old id → new id relabeling by descending rating count (stable)
    within each shard's id range, so contiguous id ranges form degree
    buckets (shard membership unchanged; the JAX package's companion of the
    LPT rebalance)."""
    counts = np.bincount(entity, minlength=n_entity)
    per_shard = n_entity // n_shards
    perm = np.empty(n_entity, np.int64)
    for p in range(n_shards):
        lo = p * per_shard
        order = np.argsort(-counts[lo:lo + per_shard], kind="stable")
        perm[lo + order] = lo + np.arange(per_shard)
    return perm


def _balance_permutation(entity: np.ndarray, n_entity_pad: int, n_shards: int) -> np.ndarray:
    """Old id → new id relabeling that balances the shards' rating counts
    (``models/als.py:180``): LPT with capacity, the hottest entity to the
    lightest shard with a free slot, ties by shard index. Each shard then
    holds an equal slice of the popularity curve, degree-sorted."""
    counts = np.bincount(entity, minlength=n_entity_pad)
    order = np.argsort(-counts, kind="stable")  # hottest first
    per_shard = n_entity_pad // n_shards
    perm = np.empty(n_entity_pad, np.int64)
    heap = [(0, p) for p in range(n_shards)]
    used = np.zeros(n_shards, np.int64)
    for o in order:
        load, p = heapq.heappop(heap)
        perm[o] = p * per_shard + used[p]
        used[p] += 1
        if used[p] < per_shard:  # full shards leave the heap
            heapq.heappush(heap, (load + int(counts[o]), p))
    return perm


def _sharded_balance_permutation(
    counts: np.ndarray, owner: np.ndarray, n_hosts: int, d_local: int, per_shard: int,
) -> np.ndarray:
    """Global old id → blocked id under sharded ingest
    (``models/als.py:306``). Entity e's rows live only on process
    ``owner[e]`` (the DAO shard hash), so its row lands in one of that
    process's ``d_local`` shards: LPT within each process over the global
    counts; padding ids fill the free slots in order. Every process
    computes the same permutation from the exchanged counts."""
    n_entities = len(counts)
    n_pad = per_shard * n_hosts * d_local
    perm = np.empty(n_pad, np.int64)
    free_slots: list[int] = []
    for q in range(n_hosts):
        ids = np.flatnonzero(owner == q)
        order = ids[np.argsort(-counts[ids], kind="stable")]
        if len(order) > d_local * per_shard:
            raise ValueError(
                f"host {q} owns {len(order)} entities > capacity {d_local * per_shard}")
        heap = [(0, d) for d in range(d_local)]
        used = np.zeros(d_local, np.int64)
        for o in order:
            load, d = heapq.heappop(heap)
            perm[o] = (q * d_local + d) * per_shard + used[d]
            used[d] += 1
            if used[d] < per_shard:
                heapq.heappush(heap, (load + int(counts[o]), d))
        for d in range(d_local):
            base_slot = (q * d_local + d) * per_shard
            free_slots.extend(range(base_slot + used[d], base_slot + per_shard))
    perm[n_entities:] = np.sort(np.array(free_slots, np.int64))
    return perm


def _bucket_boundaries(dmax: np.ndarray, chunk_budget: int) -> list:
    """Split a non-increasing per-id degree curve into (start, end, width)
    buckets: width = next multiple of 8 ≥ the bucket's top degree, members
    keep degree ≥ width/2 (≤2× padding waste), and n·width ≤ chunk_budget."""
    n = len(dmax)
    out = []
    j = 0
    while j < n:
        width = max(8, int(-8 * (-int(dmax[j]) // 8)))  # pad8, floor 8
        cap = max(1, chunk_budget // width)
        j1 = j + 1
        while j1 < n and (j1 - j) < cap and (width == 8 or int(dmax[j1]) >= width // 2):
            j1 += 1
        out.append((j, j1, width))
        j = j1
    return out


@dataclasses.dataclass
class _ShardDenseBlocks:
    """Per-bucket dense rating matrices of shards [s0, s1) of one side
    (the JAX package's ``_DenseBlocks``): ``idx``/``rat``/``msk`` are
    (s1 - s0, n_b, width_b), bucket b covers local ids [starts, ends)
    identically in every shard."""

    idx: list
    rat: list
    msk: list
    widths: list
    per_shard: int
    padded_ratings: int

    def shard(self, j: int) -> list:
        """Shard j's buckets, [(idx, rat, msk)], each (n_b, width_b)."""
        return [(i[j], r[j], m[j]) for i, r, m in zip(self.idx, self.rat, self.msk)]


def _make_dense_shards(
    entity: np.ndarray,
    other: np.ndarray,
    rating: np.ndarray,
    n_entity_pad: int,
    n_shards: int,
    chunk_budget: Optional[int] = None,
    shard_range: Optional[tuple] = None,
    deg_global: Optional[np.ndarray] = None,
) -> _ShardDenseBlocks:
    """Degree-bucketed dense rating matrices over ``n_shards`` shards of
    ``n_entity_pad // n_shards`` ids (``models/als.py:377``). Degrees must
    be monotone within each shard (the LPT or degree-sort permutation).

    ``shard_range=(s0, s1)`` fills shards [s0, s1) only, from this
    process's rows (sharded ingest), with bucket boundaries cut from
    ``deg_global``, the (n_shards, per_shard) degree matrix every process
    derives from the exchanged counts, so every process gets the same
    buckets over different data."""
    chunk_budget = chunk_budget or _DENSE_CHUNK
    per_shard = n_entity_pad // n_shards
    local_deg = np.bincount(entity, minlength=n_entity_pad)
    deg = deg_global if deg_global is not None else local_deg.reshape(n_shards, per_shard)
    bounds = _bucket_boundaries(deg.max(axis=0), chunk_budget)
    s0, s1 = shard_range if shard_range is not None else (0, n_shards)
    # sort triples by (shard, local id): each (shard, bucket) is then one
    # contiguous slice, and the column is the rank within the entity
    order = np.argsort(entity, kind="stable")
    entity_s, other_s, rating_s = entity[order], other[order], rating[order]
    offsets = np.concatenate([[0], np.cumsum(local_deg)])
    pos = np.arange(len(entity_s)) - offsets[entity_s]
    idx_l, rat_l, msk_l, widths = [], [], [], []
    padded = 0
    for j0, j1, width in bounds:
        n_b = j1 - j0
        idx_b = np.zeros((s1 - s0, n_b, width), np.int32)
        rat_b = np.zeros((s1 - s0, n_b, width), np.float32)
        msk_b = np.zeros((s1 - s0, n_b, width), np.float32)
        for p in range(s0, s1):
            s = offsets[p * per_shard + j0]
            e = offsets[p * per_shard + j1]
            rows = entity_s[s:e] - (p * per_shard + j0)
            cols = pos[s:e]
            idx_b[p - s0, rows, cols] = other_s[s:e]
            rat_b[p - s0, rows, cols] = rating_s[s:e]
            msk_b[p - s0, rows, cols] = 1.0
        idx_l.append(idx_b)
        rat_l.append(rat_b)
        msk_l.append(msk_b)
        widths.append(width)
        padded += (s1 - s0) * n_b * width
    return _ShardDenseBlocks(idx=idx_l, rat=rat_l, msk=msk_l, widths=widths,
                             per_shard=per_shard, padded_ratings=padded)


def _make_dense_blocks(
    entity: np.ndarray,
    other: np.ndarray,
    rating: np.ndarray,
    n_entity: int,
    chunk_budget: Optional[int] = None,
) -> _DenseBlocks:
    """One shard's degree-bucketed dense rating matrices. ``entity`` must
    already be degree-sorted (:func:`_degree_sort_permutation`): all
    ratings of one entity land in one row of one bucket, so the half-step
    needs no scatter."""
    b = _make_dense_shards(entity, other, rating, n_entity, 1, chunk_budget)
    return _DenseBlocks(idx=[a[0] for a in b.idx], rat=[a[0] for a in b.rat],
                        msk=[a[0] for a in b.msk], widths=b.widths,
                        padded_ratings=b.padded_ratings)


def _dense_blocks_for(interactions, cfg: ALSConfig):
    """Both sides' blocks and the permutations: ``(ub, ib, u_perm, i_perm)``
    with ``perm[original id] = blocked id`` (the JAX package's one-shard
    path: degree sort, whatever ``cfg.rebalance`` says)."""
    n_users, n_items = interactions.n_users, interactions.n_items
    user = interactions.user.astype(np.int64)
    item = interactions.item.astype(np.int64)
    rating = interactions.rating.astype(np.float32)
    u_perm = _degree_sort_permutation(user, n_users)
    i_perm = _degree_sort_permutation(item, n_items)
    ub = _make_dense_blocks(u_perm[user], i_perm[item], rating, n_users)
    ib = _make_dense_blocks(i_perm[item], u_perm[user], rating, n_items)
    return ub, ib, u_perm, i_perm


def _dense_shards_for(interactions, cfg: ALSConfig, n_shards: int):
    """The mesh's dense prep (``models/als.py:1043``): ``(ub, ib, u_perm,
    i_perm)`` over ``n_shards`` shards of the padded id ranges, LPT under
    ``cfg.rebalance`` and the per-shard degree sort otherwise."""
    n_users_pad = _pad_to_multiple(interactions.n_users, n_shards)
    n_items_pad = _pad_to_multiple(interactions.n_items, n_shards)
    user = interactions.user.astype(np.int64)
    item = interactions.item.astype(np.int64)
    rating = interactions.rating.astype(np.float32)
    if cfg.rebalance and n_shards > 1:
        u_perm = _balance_permutation(user, n_users_pad, n_shards)
        i_perm = _balance_permutation(item, n_items_pad, n_shards)
    else:
        u_perm = _degree_sort_permutation(user, n_users_pad, n_shards)
        i_perm = _degree_sort_permutation(item, n_items_pad, n_shards)
    ub = _make_dense_shards(u_perm[user], i_perm[item], rating, n_users_pad, n_shards)
    ib = _make_dense_shards(i_perm[item], u_perm[user], rating, n_items_pad, n_shards)
    return ub, ib, u_perm, i_perm


def _sharded_blocks_for_host(sh, n_shards: int, pid: int, n_hosts: int):
    """One process's dense blocks and layout under sharded ingest
    (``models/als.py:1120-1181``): a pure function of the exchanged global
    tables, so every process computes the same permutations, pads and
    bucket widths, and only the local block contents differ.

    Returns ``(ub, ib, u_geom, i_geom, shard_range)``, each geom
    ``(per_shard, n_pad, perm, deg_blocked)``; ``shard_range`` is the
    interval of shards this process's blocks cover."""
    from predictionio_tpu_torch.data.storage.base import PEvents

    d_local = n_shards // n_hosts

    def side(id_map, counts):
        inv = id_map.inverse
        n = len(id_map)
        owner = np.fromiter(
            (PEvents.shard_hash(inv[i]) % n_hosts for i in range(n)), np.int64, count=n)
        # capacity: the fullest process's entities fit its d_local shards
        host_max = int(np.bincount(owner, minlength=n_hosts).max()) if n else 1
        per_shard = max(1, -(-host_max // d_local))
        n_pad = per_shard * n_shards
        perm = _sharded_balance_permutation(counts, owner, n_hosts, d_local, per_shard)
        deg = np.zeros(n_pad, np.int64)
        deg[perm[:n]] = counts
        return per_shard, n_pad, perm, deg.reshape(n_shards, per_shard)

    u_geom = side(sh.user_map, sh.user_counts)
    i_geom = side(sh.item_map, sh.item_counts)
    _, n_users_pad, u_perm, deg_u = u_geom
    _, n_items_pad, i_perm, deg_i = i_geom
    my = (pid * d_local, (pid + 1) * d_local)
    ub = _make_dense_shards(
        u_perm[sh.user_rows.user.astype(np.int64)],
        i_perm[sh.user_rows.item.astype(np.int64)],
        sh.user_rows.rating.astype(np.float32),
        n_users_pad, n_shards, shard_range=my, deg_global=deg_u,
    )
    ib = _make_dense_shards(
        i_perm[sh.item_rows.item.astype(np.int64)],
        u_perm[sh.item_rows.user.astype(np.int64)],
        sh.item_rows.rating.astype(np.float32),
        n_items_pad, n_shards, shard_range=my, deg_global=deg_i,
    )
    return ub, ib, u_geom, i_geom, my


# ---------------------------------------------------------------------------
# Segment solver: the rating stream in chunks (models/als.py:170-258, one shard)
# ---------------------------------------------------------------------------


# Ratings per chunk of the segment half-step: bounds the (chunk, k, k)
# outer products. Chunk boundaries set the summation order, so this is the
# JAX package's knob and default (``models/als.py:453``).
_CHUNK = int(os.environ.get("PIO_ALS_CHUNK", 65536))


@dataclasses.dataclass
class _Blocks:
    """One side's rating stream, padded: slot s rates ``local[s]`` (this
    side's entity) against ``other[s]``. Padding slots carry other 0,
    rating 0 and mask 0 and contribute exactly zero."""

    local: np.ndarray  # (length,) int32 — this side's entity
    other: np.ndarray  # (length,) int32 — the opposite entity
    rating: np.ndarray  # (length,) float32
    mask: np.ndarray  # (length,) float32, 1 = real, 0 = padding
    n_entity: int  # entities of this side (the JAX package's per_shard)
    length: int  # slots: a multiple of 8, and of _CHUNK beyond one chunk


def _pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= max(n, 1) (``parallel/mesh.py:96``)."""
    return max(1, -(-max(n, 1) // m)) * m


def _make_blocks(
    entity: np.ndarray, other: np.ndarray, rating: np.ndarray, n_entity: int
) -> _Blocks:
    """The stream in its given order, padded to a multiple of 8 and, when it
    is longer than one chunk, to a multiple of :data:`_CHUNK` (the JAX
    package's ``_make_blocks`` at ``n_shards = 1``)."""
    n = len(entity)
    length = _pad_to_multiple(n, 8)
    if length > _CHUNK:
        length = _pad_to_multiple(length, _CHUNK)
    local_b = np.zeros(length, np.int32)
    other_b = np.zeros(length, np.int32)
    rating_b = np.zeros(length, np.float32)
    mask_b = np.zeros(length, np.float32)
    local_b[:n] = entity
    other_b[:n] = other
    rating_b[:n] = rating
    mask_b[:n] = 1.0
    return _Blocks(local=local_b, other=other_b, rating=rating_b, mask=mask_b,
                   n_entity=n_entity, length=length)


def _segment_layout(blk: _Blocks, device) -> _train_kernel.SegmentLayout:
    """One side's stream sorted by entity on ``device``, for the segment
    kernel: built once per side before the iterations. The runs follow the
    half-step's chunk, ``min(length, _CHUNK)``; on the CPU the layout also
    keeps the stream, which the plain version sums."""
    stream = [torch.from_numpy(a).to(device) for a in (blk.local, blk.other, blk.rating, blk.mask)]
    return _train_kernel.segment_layout(
        *stream, blk.n_entity, chunk=min(blk.length, _CHUNK))


def _segment_blocks_for(interactions) -> tuple[_Blocks, _Blocks]:
    """Both sides' streams, users' then items', in original id order."""
    user = interactions.user.astype(np.int64)
    item = interactions.item.astype(np.int64)
    rating = interactions.rating.astype(np.float32)
    return (
        _make_blocks(user, item, rating, interactions.n_users),
        _make_blocks(item, user, rating, interactions.n_items),
    )


def _make_shard_blocks(
    entity: np.ndarray, other: np.ndarray, rating: np.ndarray, n_entity_pad: int, n_shards: int,
) -> list[_Blocks]:
    """The stream cut into ``n_shards`` shards by entity range
    (``models/als.py:218``): shard p holds the ratings of entities
    [p·per_shard, (p+1)·per_shard) with shard-local ids, every shard padded
    to the longest one's length (a multiple of 8, and of :data:`_CHUNK`
    beyond one chunk)."""
    per_shard = n_entity_pad // n_shards
    shard = entity // per_shard
    order = np.argsort(shard, kind="stable")
    entity, other, rating, shard = entity[order], other[order], rating[order], shard[order]
    counts = np.bincount(shard, minlength=n_shards)
    length = _pad_to_multiple(int(counts.max()) if len(counts) else 1, 8)
    if length > _CHUNK:
        length = _pad_to_multiple(length, _CHUNK)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    out = []
    for p in range(n_shards):
        s, e = offsets[p], offsets[p + 1]
        n = e - s
        blk = _Blocks(local=np.zeros(length, np.int32), other=np.zeros(length, np.int32),
                      rating=np.zeros(length, np.float32), mask=np.zeros(length, np.float32),
                      n_entity=per_shard, length=length)
        blk.local[:n] = entity[s:e] - p * per_shard
        blk.other[:n] = other[s:e]
        blk.rating[:n] = rating[s:e]
        blk.mask[:n] = 1.0
        out.append(blk)
    return out


# ---------------------------------------------------------------------------
# Device half-step: solve one side's factors from the other's
# ---------------------------------------------------------------------------


def _solve_normal_equations(A, b, cnt, gram, rank, reg, implicit):
    """Ridge + batched k×k Cholesky (``models/als.py:530``): explicit
    λ·n_u + 1e-6 (ALS-WR, as MLlib; the ε keeps empty rows solvable),
    implicit VᵀV + λI."""
    eye = torch.eye(rank, dtype=torch.float32, device=A.device)
    lam = _train_kernel._f32(reg)
    if implicit:
        A = A + gram[None, :, :] + lam * eye[None, :, :]
    else:
        A = A + (lam * cnt + 1e-6)[:, None, None] * eye[None, :, :]
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


def _dense_half_step(blocks, opp, gram, cfg: ALSConfig):
    """One side's new factors (blocked order) from the opposite side's:
    quantize the opposite factors to the compute dtype, one kernel call per
    degree bucket, concatenate (bucket rows ARE the blocked entity order),
    solve. ``blocks`` holds each bucket's (idx, rat, msk) on the device."""
    opp_q, opp_scale = _quantize.quantize_factors_torch(opp, cfg.compute_dtype)
    As, bs, cnts = [], [], []
    for idx, rat, msk in blocks:
        A, b, cnt = _train_kernel.fused_train_normal_eq(
            idx, rat, msk, opp_q, opp_scale, implicit=cfg.implicit, alpha=cfg.alpha
        )
        As.append(A)
        bs.append(b)
        cnts.append(cnt)
    return _solve_normal_equations(
        torch.cat(As), torch.cat(bs), torch.cat(cnts), gram,
        cfg.rank, cfg.reg, cfg.implicit,
    )


def _half_step(layout, opp, gram, cfg: ALSConfig):
    """The segment solver's half-step (``models/als.py:456-527``): one
    side's new factors from the opposite side's. ``layout`` is the side's
    :class:`~predictionio_tpu_torch.ops.train_kernel.SegmentLayout`.

    Quantize the opposite factors once, sum A, b and cnt in one call of the
    segment kernel (on the CPU its plain version: JAX's chunk loop), solve.
    """
    opp_q, opp_scale = _quantize.quantize_factors_torch(opp, cfg.compute_dtype)
    A, b, cnt = _train_kernel.fused_segment_normal_eq(
        layout, opp_q, opp_scale, implicit=cfg.implicit, alpha=cfg.alpha)
    return _solve_normal_equations(A, b, cnt, gram, cfg.rank, cfg.reg, cfg.implicit)


def _gram(F: torch.Tensor) -> torch.Tensor:
    """FᵀF (k, k) in full float32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return F.T @ F
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _initial_factors(cfg: ALSConfig, n: int, gen: torch.Generator) -> np.ndarray:
    """(n, rank) float32 standard normal draws scaled by 1/sqrt(rank), in
    original entity order."""
    scale = _train_kernel._f32(1.0 / np.sqrt(cfg.rank))
    return (torch.randn((n, cfg.rank), generator=gen, dtype=torch.float32) * scale).numpy()


def _checkpoint_fingerprint(interactions, cfg: ALSConfig, n_shards: int = 1) -> np.ndarray:
    """What ties a checkpoint to this config and dataset: the JAX package's
    fields (``models/als.py:954-975``). A foreign or permuted dataset
    (another digest) starts fresh; rebalance, solver and shard count set
    the saved row order."""
    from predictionio_tpu_torch.core.checkpoint import dataset_digest

    rating = interactions.rating.astype(np.float32)
    return np.array(
        [
            _pad_to_multiple(interactions.n_users, n_shards),
            _pad_to_multiple(interactions.n_items, n_shards),
            len(rating),
            cfg.rank,
            int(cfg.implicit),
            cfg.seed,
            dataset_digest(
                interactions.user.astype(np.int64),
                interactions.item.astype(np.int64),
                rating,
            ),
            float(cfg.reg),
            float(cfg.alpha),
            int(cfg.rebalance),
            int(cfg.solver == "dense"),
            n_shards,
        ],
        dtype=np.float64,
    )


def _initial_rows(cfg: ALSConfig, given, n: int, n_pad: int, gen) -> np.ndarray:
    """(n_pad, rank) initial factors in original (global) id order: the
    given rows (n of them, zero padded, or all n_pad), else a draw of
    n_pad rows from ``gen`` (the JAX package draws the padded count)."""
    if given is None:
        return _initial_factors(cfg, n_pad, gen)
    f = np.array(given, np.float32)
    if f.ndim != 2 or f.shape[1] != cfg.rank or f.shape[0] not in (n, n_pad):
        raise ValueError(
            f"init_factors rows of shape {f.shape}, expected ({n} or {n_pad}, {cfg.rank})")
    if f.shape[0] == n_pad:
        return f
    out = np.zeros((n_pad, cfg.rank), np.float32)
    out[:n] = f
    return out


def _shard_inputs(blocks, shards, devices, dense: bool) -> list:
    """The half-step inputs of the given shards, each on its placement:
    dense, a list of (idx, rat, msk) tensors per bucket; segment, a
    :class:`~predictionio_tpu_torch.ops.train_kernel.SegmentLayout`."""
    if dense:
        return [[tuple(torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in t)
                 for t in blocks.shard(j)] for j, d in zip(shards, devices)]
    return [_segment_layout(blocks[j], d) for j, d in zip(shards, devices)]


def _run_shards(ctx, u_shards, i_shards, U0, V0, cfg: ALSConfig, fingerprint=None):
    """The iterations over this process's shards (``models/als.py:712-758``
    for the dense solver): each half-step runs the kernel once a bucket (or
    the segment kernel once) on every local shard, solves, and all-gathers
    the shards' new factors across the mesh's placements (across processes
    when ``ctx`` spans them), so every process holds both sides whole.
    ``U0``/``V0`` are (n_pad, rank) in blocked order; returns the final
    host factors in blocked order. Checkpoints are written by the
    coordinator."""
    half_step = _dense_half_step if cfg.solver == "dense" else _half_step
    start_iter, manager = 0, None
    if cfg.checkpoint_dir:
        from predictionio_tpu_torch.core import checkpoint as _checkpoint

        _checkpoint.validate_interval(cfg.checkpoint_interval)
        manager = _checkpoint.CheckpointManager(cfg.checkpoint_dir)
        start_iter, state = _checkpoint.resume_from(manager, fingerprint, cfg.iterations)
        if state is not None:
            # the saved factors are in this layout's row order (the
            # fingerprint names the solver and the shards)
            U0, V0 = state["U"], state["V"]
    dev, devs = ctx.device, ctx.local_devices
    U = torch.from_numpy(np.ascontiguousarray(U0, np.float32)).to(dev)
    V = torch.from_numpy(np.ascontiguousarray(V0, np.float32)).to(dev)

    def side(shards, opp):
        gram = _gram(opp) if cfg.implicit else None
        outs = [half_step(blk, opp.to(d), None if gram is None else gram.to(d), cfg)
                for blk, d in zip(shards, devs)]
        full = _mesh.all_gather(outs, dev, ctx=ctx)
        return full.reshape(-1, cfg.rank)

    for it in range(start_iter, cfg.iterations):
        # u-solve gathers ITEM factors, v-solve gathers USER factors
        U = side(u_shards, V)
        V = side(i_shards, U)
        if manager is not None and _checkpoint.save_due(
            it + 1, cfg.checkpoint_interval, cfg.iterations
        ):
            manager.save(it + 1, {"U": U, "V": V, "fingerprint": fingerprint})
    return U.cpu().numpy(), V.cpu().numpy()


def train_als(
    ctx: DeviceContext,
    interactions,
    config: Optional[ALSConfig] = None,
    *,
    init_factors: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> ALSModel:
    """Train factors over the mesh's ``data`` axis with ``config.solver``;
    returns a host-form :class:`ALSModel` with factors in original id order.

    ``interactions`` is an :class:`Interactions` (every process holds all
    rows) or a :class:`~predictionio_tpu_torch.parallel.ingest.
    ShardedInteractions` (each process of a launch read 1/N:
    :func:`_train_als_sharded`). On S placements the ids are padded to a
    multiple of S and cut into S shards (LPT-balanced under
    ``config.rebalance``; degree-sorted otherwise); each shard runs on its
    placement and the half-steps all-gather the factors.

    The initial factors are standard normal draws from a CPU
    ``torch.Generator`` seeded by ``config.seed``, scaled by 1/sqrt(rank),
    over the padded id count, unless ``init_factors=(U0, V0)`` gives them
    in ORIGINAL id order (n or n_pad rows a side; n rows are zero padded).
    Entity e starts from row e of the draw whatever the layout. The JAX
    package draws them with jax's threefry generator, which torch cannot
    reproduce, so the parity tests pass the JAX draw here. On a CUDA device
    every bucket of every dense half-step launches the training kernel on
    every shard, and every segment half-step the segment kernel once a
    shard; on the CPU they run the kernels' plain versions.

    With ``config.checkpoint_dir`` the factors are saved (as host arrays,
    in the layout's row order) after every ``checkpoint_interval``
    iterations and the last; a run that finds a step whose fingerprint
    matches resumes there and launches the kernels only for the
    iterations left.
    """
    from predictionio_tpu_torch.parallel.ingest import ShardedInteractions

    cfg = config or ALSConfig()
    if isinstance(interactions, ShardedInteractions):
        return _train_als_sharded(ctx, interactions, cfg, init_factors)
    n_shards = ctx.axis_size(_mesh.DATA_AXIS)
    n_users, n_items = interactions.n_users, interactions.n_items
    n_users_pad = _pad_to_multiple(n_users, n_shards)
    n_items_pad = _pad_to_multiple(n_items, n_shards)
    gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))
    given = init_factors if init_factors is not None else (None, None)
    U0 = _initial_rows(cfg, given[0], n_users, n_users_pad, gen)
    V0 = _initial_rows(cfg, given[1], n_items, n_items_pad, gen)
    dense = cfg.solver == "dense"
    if dense:
        ub, ib, u_perm, i_perm = _dense_shards_for(interactions, cfg, n_shards)
    else:
        user = interactions.user.astype(np.int64)
        item = interactions.item.astype(np.int64)
        rating = interactions.rating.astype(np.float32)
        u_perm = i_perm = None
        if cfg.rebalance and n_shards > 1:
            u_perm = _balance_permutation(user, n_users_pad, n_shards)
            i_perm = _balance_permutation(item, n_items_pad, n_shards)
        user_blk = u_perm[user] if u_perm is not None else user
        item_blk = i_perm[item] if i_perm is not None else item
        ub = _make_shard_blocks(user_blk, item_blk, rating, n_users_pad, n_shards)
        ib = _make_shard_blocks(item_blk, user_blk, rating, n_items_pad, n_shards)
    if u_perm is not None:
        # blocked row perm[e] holds original entity e
        U0, V0 = U0[np.argsort(u_perm)], V0[np.argsort(i_perm)]
    shards = range(*ctx.local_range)
    U_all, V_all = _run_shards(
        ctx,
        _shard_inputs(ub, shards, ctx.local_devices, dense),
        _shard_inputs(ib, shards, ctx.local_devices, dense),
        U0, V0, cfg,
        _checkpoint_fingerprint(interactions, cfg, n_shards) if cfg.checkpoint_dir else None,
    )
    U_host = U_all[u_perm[:n_users]] if u_perm is not None else U_all[:n_users]
    V_host = V_all[i_perm[:n_items]] if i_perm is not None else V_all[:n_items]
    return _declare_ivf_partition(_declare_sharding_plan(ALSModel(
        user_factors=U_host,
        item_factors=V_host,
        user_map=interactions.user_map,
        item_map=interactions.item_map,
        config=cfg,
    )))


def _sharded_fingerprint(sh, cfg: ALSConfig, n_users_pad, n_items_pad, n_shards) -> np.ndarray:
    """The sharded layout's checkpoint fingerprint (``models/als.py:
    1246-1279``), the same on every process: the exchanged row digest and
    the global degree vectors stand in for the rows."""
    from predictionio_tpu_torch.core.checkpoint import dataset_digest

    return np.array(
        [
            n_users_pad, n_items_pad, int(sh.user_counts.sum()),
            cfg.rank, int(cfg.implicit), cfg.seed,
            float(sh.dataset_digest),
            dataset_digest(sh.user_counts, sh.item_counts),
            float(cfg.reg), float(cfg.alpha),
            2.0,  # layout tag: sharded-ingest dense blocking
            n_shards, sh.num_processes,
        ],
        dtype=np.float64,
    )


def _train_als_sharded(ctx, sh, cfg: ALSConfig, init_factors=None) -> ALSModel:
    """Training from a launch's 1/N read (``models/als.py:1184-1316``).

    Each process arrives with its users' and its items' rows in global ids
    and the global degree vectors; every relabeling and bucket geometry is
    derived from the exchanged counts, so the processes run the same
    buckets over different data (:func:`_sharded_blocks_for_host`). Dense
    only, as in the JAX package. The coordinator removes the rendezvous
    blobs after the last collective."""
    if cfg.solver != "dense":
        raise ValueError("sharded multi-host training requires solver='dense'")
    n_shards = ctx.axis_size(_mesh.DATA_AXIS)
    n_hosts = sh.num_processes
    if n_shards % n_hosts:
        raise ValueError(f"{n_shards} device shards not divisible by {n_hosts} hosts")
    ub, ib, u_geom, i_geom, my = _sharded_blocks_for_host(
        sh, n_shards, sh.process_index, n_hosts)
    if tuple(ctx.local_range) != tuple(my):
        raise ValueError(
            f"process {sh.process_index}'s placements {ctx.local_range} are not its "
            f"shards {my}")
    _, n_users_pad, u_perm, _ = u_geom
    _, n_items_pad, i_perm, _ = i_geom
    U0, V0 = sharded_initial_factors(sh, cfg, u_perm, i_perm, init_factors)
    local = range(n_shards // n_hosts)
    U_all, V_all = _run_shards(
        ctx,
        _shard_inputs(ub, local, ctx.local_devices, True),
        _shard_inputs(ib, local, ctx.local_devices, True),
        U0, V0, cfg,
        _sharded_fingerprint(sh, cfg, n_users_pad, n_items_pad, n_shards)
        if cfg.checkpoint_dir else None,
    )
    from predictionio_tpu_torch.parallel import distributed

    if sh.cleanup is not None and distributed.should_write_storage():
        # the final all-gather was a collective: every process finished
        # its exchange long ago
        sh.cleanup()
    return _declare_ivf_partition(_declare_sharding_plan(ALSModel(
        user_factors=U_all[u_perm[:sh.n_users]],
        item_factors=V_all[i_perm[:sh.n_items]],
        user_map=sh.user_map,
        item_map=sh.item_map,
        config=cfg,
    )))


def sharded_initial_factors(sh, cfg: ALSConfig, u_perm, i_perm, init_factors=None):
    """The sharded layout's initial (U0, V0) in blocked order: a draw over
    the entities only (``init_factors`` in global-id order, or the seeded
    torch draw), zero padded, so the start is the same for any process
    count or capacity (padding rows have no ratings)."""
    gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))
    given = init_factors if init_factors is not None else (
        _initial_factors(cfg, sh.n_users, gen), _initial_factors(cfg, sh.n_items, gen))
    U0 = _initial_rows(cfg, given[0], sh.n_users, len(u_perm), None)
    V0 = _initial_rows(cfg, given[1], sh.n_items, len(i_perm), None)
    return U0[np.argsort(u_perm)], V0[np.argsort(i_perm)]


def _declare_sharding_plan(model: ALSModel) -> ALSModel:
    """Publish-time sharding declaration (``PIO_SHARD_*``; no-op unset).

    The popularity strategy's weights are the item-factor L2 norms, the
    train-time proxy for expected traffic; ``pio shards rebuild`` can
    rebalance later. A failed declaration publishes unsharded with a
    warning.
    """
    try:
        plan = _sharding.plan_from_env(
            model.item_factors.shape[0],
            weights=np.linalg.norm(model.item_factors, axis=1),
            bytes_per_item=float(model.item_factors.shape[1]) * 4.0,
        )
    except ValueError as e:
        logger.warning("sharding plan declaration failed (%s); publishing unsharded", e)
        return model
    if plan is not None:
        model.sharding_plan = plan
        logger.info(
            "declared sharding plan %s: %d shards (%s)",
            plan.fingerprint, plan.n_shards, plan.strategy,
        )
    return model


def _declare_ivf_partition(model: ALSModel) -> ALSModel:
    """Publish-time IVF declaration (``PIO_IVF_NLIST``; no-op unset).

    Trains the k-means coarse partition over the item factors
    (``ops/ivf.py``, host numpy) and attaches it to the model; the recall
    gate runs at publish (``CheckpointedALSModel._publish_ivf``), not here.
    A failed declaration publishes exact-only with a warning.
    """
    from predictionio_tpu_torch.ops import ivf as _ivf

    try:
        index = _ivf.index_from_env(model.item_factors)
    except ValueError as e:
        logger.warning("IVF index declaration failed (%s); publishing exact-only", e)
        return model
    if index is not None:
        model.ivf_index = index
        logger.info(
            "declared IVF index %s: nlist=%d nprobe=%d",
            index.fingerprint, index.nlist, index.nprobe,
        )
    return model


def _fold_in_gather(rows: np.ndarray, compute_dtype: str, acc_dt) -> np.ndarray:
    """Gathered item rows in the fold-in's ``compute_dtype``, widened to
    ``acc_dt``: bf16 rounds each value to nearest even, as ``ml_dtypes``'
    ``astype(bfloat16)`` does in the JAX package (``_fold_in_dtype``);
    every other dtype gathers float32 (int8 included, as there)."""
    if compute_dtype == "bf16":
        rows = _quantize.bf16_bits_to_f32(_quantize.f32_to_bf16_bits(rows))
    return rows.astype(acc_dt)


def fold_in_users(item_factors, interactions, *, rank, reg,
                  implicit=False, alpha=1.0, compute_dtype="f32"):
    """Streaming user-side fold-in: re-solve user rows against FIXED items.

    Counterpart of ``predictionio_tpu/models/als.py:555-597``, in numpy on
    the host as there: the micro-generation delta pipeline
    (``core/delta.py``) calls it with each user's ``[(item_idx, rating),
    ...]`` history and gets replacement user rows without touching the item
    side, the normal equations of one ALS half-step restricted to those
    users (batches are small; a device round trip would cost more than the
    solve).

    ``compute_dtype`` degrades the gathered item rows as the training
    knob does ("f32" | "bf16"; "f64" is the full-fidelity reference the
    publish gate compares against); accumulation and solve run in at least
    float32.

    Returns an (n_users, rank) float32 array ordered by sorted user index.
    """
    V = np.asarray(item_factors, dtype=np.float32)
    acc_dt = np.float64 if compute_dtype == "f64" else np.float32
    eye = np.eye(rank, dtype=acc_dt)
    gram = None
    if implicit:
        Vg = _fold_in_gather(V, compute_dtype, acc_dt)
        gram = Vg.T @ Vg
    rows = np.zeros((len(interactions), rank), dtype=np.float32)
    for j, uidx in enumerate(sorted(interactions)):
        pairs = interactions[uidx]
        idx = np.array([i for i, _ in pairs], dtype=np.int64)
        r = np.array([x for _, x in pairs], dtype=acc_dt)
        Vu = _fold_in_gather(V[idx], compute_dtype, acc_dt)
        if implicit:
            # confidence c = 1 + alpha*r: A = VᵀV + Vuᵀ diag(alpha·r) Vu
            # + reg·I, b = Vuᵀ c  (Hu-Koren-Volinsky fold-in)
            A = gram + (Vu * (alpha * r)[:, None]).T @ Vu + reg * eye
            b = Vu.T @ (1.0 + alpha * r)
        else:
            # λ·n_u ridge, matching _solve_normal_equations' explicit path
            A = Vu.T @ Vu + (reg * len(pairs) + 1e-6) * eye
            b = Vu.T @ r
        rows[j] = np.linalg.solve(A, b).astype(np.float32)
    return rows


class CheckpointedALSModel(ALSModel, _persistence.PersistentModel):
    """ALSModel persisted through the PersistentModel protocol (checkpoint
    mode, ``persistMode: "checkpoint"``).

    Counterpart of ``predictionio_tpu/models/als.py:1379-1748`` (parity: the
    reference's mode-2 persistence, ``PersistentModel.save`` + manifest):
    only a manifest naming this class goes into MODELDATA. The factors live
    under ``$PIO_FS_BASEDIR/persistent_models/<instance>/`` in a sealed
    numpy store (``factors.blob``; the JAX package writes an orbax
    checkpoint there, which the port cannot read, nor the JAX package this
    store), the id maps and publish records in ``maps.pkl``, the quantized
    variant, when its gate passed, in ``quant.blob``, and the IVF index,
    when its recall gate passed, in ``ivf.blob``. Deploy calls :meth:`load`.
    """

    FACTORS = "factors.blob"
    MAPS = "maps.pkl"
    QUANT = "quant.blob"
    PLAN = "plan.blob"
    IVF = "ivf.blob"

    @staticmethod
    def _dir(instance_id: str) -> str:
        from predictionio_tpu_torch.utils.fs import pio_base_dir

        return os.path.join(pio_base_dir(), "persistent_models", instance_id)

    def save(self, instance_id: str, params) -> bool:
        import pickle

        from predictionio_tpu_torch.core.checkpoint import save_state

        d = self._dir(instance_id)
        os.makedirs(d, exist_ok=True)
        save_state(
            os.path.join(d, self.FACTORS),
            {"user_factors": self.user_factors, "item_factors": self.item_factors},
        )
        quant_meta = self._publish_quantized(d)
        shard_meta = self._publish_plan(d)
        ivf_meta = self._publish_ivf(d)
        with open(os.path.join(d, self.MAPS), "wb") as f:
            pickle.dump(
                {"user_map": self.user_map, "item_map": self.item_map,
                 "config": self.config, "quant": quant_meta,
                 "sharding": shard_meta, "ivf": ivf_meta},
                f,
            )
        return True  # manifest mode: MODELDATA stores only the class path

    def _publish_plan(self, d: str) -> dict:
        """Seal the declared ShardingPlan beside the factors (``plan.blob``).

        The manifest record carries the plan's fingerprint, so a deploy can
        check that the blob it opens is the partition this generation was
        published with; ``pio shards rebuild`` reseals both. No plan records
        ``n_shards: 0`` and serving stays replicated.
        """
        plan = getattr(self, "sharding_plan", None)
        if plan is None:
            return {"n_shards": 0}
        _sharding.save_plan(os.path.join(d, self.PLAN), plan)
        logger.info(
            "sharding plan sealed: %d shards / %d host groups (%s), fingerprint %s",
            plan.n_shards, plan.host_groups, plan.strategy, plan.fingerprint,
        )
        return {
            "n_shards": plan.n_shards,
            "strategy": plan.strategy,
            "fingerprint": plan.fingerprint,
            "host_groups": plan.host_groups,
        }

    def _publish_ivf(self, d: str) -> dict:
        """Recall-gate and seal the IVF index at publish (``ivf.blob``).

        Measures recall@10 of the IVF-pruned ranking against the exact one
        (:func:`ops.ivf.measure_recall`, f32 factors, b = 1 probing) and
        only if it clears ``PIO_IVF_MIN_RECALL`` (0.95) seals the index: the
        ``PIO_QUANT_MIN_OVERLAP`` contract. A refused index leaves no blob
        and serving stays exact; the manifest record is always written. A
        model built without :func:`train_als` can still declare one through
        ``PIO_IVF_NLIST`` here.
        """
        from predictionio_tpu_torch.ops import ivf as _ivf

        index = getattr(self, "ivf_index", None)
        if index is None:
            try:
                index = _ivf.index_from_env(self.item_factors)
            except ValueError as e:
                logger.warning("IVF index declaration failed (%s); publishing exact-only", e)
                return {"nlist": 0}
        if index is None:
            return {"nlist": 0}
        threshold = float(os.environ.get("PIO_IVF_MIN_RECALL", "0.95"))
        sample = int(os.environ.get("PIO_IVF_EVAL_USERS", "256") or 256)
        sealed, record = _ivf.gate_index(
            self.user_factors, self.item_factors, index, threshold, sample=sample
        )
        self.ivf_index = sealed
        if sealed is None:
            logger.warning(
                "IVF publish REFUSED: recall@%d %.4f < %.4f (PIO_IVF_MIN_RECALL); "
                "serving stays exact",
                record["k"], record["recall"], threshold,
            )
            return record
        _ivf.save_index(os.path.join(d, self.IVF), sealed)
        logger.info(
            "IVF index sealed: nlist=%d nprobe=%d recall@%d %.4f >= %.4f, fingerprint %s",
            sealed.nlist, sealed.nprobe, record["k"], record["recall"], threshold,
            sealed.fingerprint,
        )
        return record

    def _publish_quantized(self, d: str) -> dict:
        """Offline quantize step at model publish (``PIO_QUANT_DTYPE``).

        Produces the bf16/int8 factor variant, measures its top-k overlap
        against fp32 (:func:`core.evaluation.quantized_topk_overlap`), and
        only if the overlap clears ``PIO_QUANT_MIN_OVERLAP`` (0.98) seals
        the variant as ``quant.blob``. A refused variant leaves no blob and
        serving keeps fp32. Returns the manifest record (always written, so
        a refusal and its measured overlap stay auditable).
        """
        import pickle

        from predictionio_tpu_torch.core import evaluation as _evaluation

        dtype = (os.environ.get("PIO_QUANT_DTYPE") or "auto").strip().lower()
        if dtype in ("auto", "f32", ""):
            return {"dtype": "f32"}
        user_q, user_scale = _quantize.quantize_factors(self.user_factors, dtype)
        item_q, item_scale = _quantize.quantize_factors(self.item_factors, dtype)
        k = min(100, self.item_factors.shape[0])
        threshold = float(os.environ.get("PIO_QUANT_MIN_OVERLAP", "0.98"))
        sample = int(os.environ.get("PIO_QUANT_EVAL_USERS", "256") or 256)
        overlap = _evaluation.quantized_topk_overlap(
            self.user_factors, self.item_factors,
            user_q, user_scale, item_q, item_scale, k=k, sample=sample,
        )
        if overlap < threshold:
            logger.warning(
                "quantized publish REFUSED: %s top-%d overlap %.4f < %.4f "
                "(PIO_QUANT_MIN_OVERLAP); serving keeps fp32",
                dtype, k, overlap, threshold,
            )
            return {"dtype": "f32", "refused": dtype, "topk_overlap": overlap,
                    "threshold": threshold, "k": k}
        payload = pickle.dumps(
            {"dtype": dtype, "user_factors_q": user_q, "user_scale": user_scale,
             "item_factors_q": item_q, "item_scale": item_scale},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        _persistence.seal_blob_file(os.path.join(d, self.QUANT), payload)
        logger.info(
            "quantized publish: %s factors sealed (top-%d overlap %.4f >= %.4f)",
            dtype, k, overlap, threshold,
        )
        return {"dtype": dtype, "topk_overlap": overlap, "threshold": threshold, "k": k}

    @classmethod
    def load(cls, instance_id: str, params, ctx) -> "CheckpointedALSModel":
        from predictionio_tpu_torch.core.checkpoint import restore_state

        d = cls._dir(instance_id)
        arrays = restore_state(os.path.join(d, cls.FACTORS))
        with open(os.path.join(d, cls.MAPS), "rb") as f:
            meta = _persistence.load_models_blob(f.read())
        model = cls(
            user_factors=np.asarray(arrays["user_factors"], np.float32),
            item_factors=np.asarray(arrays["item_factors"], np.float32),
            user_map=meta["user_map"],
            item_map=meta["item_map"],
            config=meta["config"],
        )
        cls._load_quantized(model, d, meta.get("quant") or {})
        cls._load_plan(model, d, meta.get("sharding") or {})
        cls._load_ivf(model, d, meta.get("ivf") or {})
        return model

    @classmethod
    def _load_plan(cls, model: "CheckpointedALSModel", d: str, rec: dict) -> None:
        """Attach the published ShardingPlan, degrading on any damage.

        A torn or missing ``plan.blob``, a checksum mismatch or a
        fingerprint that disagrees with the manifest logs a warning and
        leaves ``sharding_plan`` unset: the server cold-starts replicated,
        and the deploy never fails on the plan.
        """
        import pickle

        if not rec or not rec.get("n_shards"):
            return
        try:
            plan = _sharding.load_plan(os.path.join(d, cls.PLAN))
            want = rec.get("fingerprint")
            if want and plan.fingerprint != want:
                raise _persistence.ModelIntegrityError(
                    f"plan fingerprint {plan.fingerprint} != manifest {want}"
                )
            model.sharding_plan = plan
            logger.info(
                "loaded sharding plan %s: %d shards (%s)",
                plan.fingerprint, plan.n_shards, plan.strategy,
            )
        except (
            _persistence.ModelIntegrityError, OSError, KeyError,
            pickle.UnpicklingError, EOFError, ValueError,
        ) as e:
            logger.warning("sharding plan unavailable (%s); serving replicated", e)

    @classmethod
    def _load_ivf(cls, model: "CheckpointedALSModel", d: str, rec: dict) -> None:
        """Attach the published IVF index, degrading on any damage.

        A torn or missing ``ivf.blob``, a checksum mismatch or a
        fingerprint that disagrees with the manifest logs a warning and
        leaves ``ivf_index`` unset: the server serves the exact scan and the
        deploy never fails. ``PIO_RETRIEVAL=exact`` is the rollback: the
        sealed index is ignored even when present and valid.
        """
        import pickle

        from predictionio_tpu_torch.ops import ivf as _ivf

        if not rec or not rec.get("nlist"):
            return
        want = (os.environ.get("PIO_RETRIEVAL") or "auto").strip().lower()
        if want == "exact":
            logger.info("PIO_RETRIEVAL=exact: ignoring sealed IVF index; serving exact")
            return
        try:
            index = _ivf.load_index(os.path.join(d, cls.IVF))
            want_fp = rec.get("fingerprint")
            if want_fp and index.fingerprint != want_fp:
                raise _persistence.ModelIntegrityError(
                    f"IVF fingerprint {index.fingerprint} != manifest {want_fp}"
                )
            model.ivf_index = index
            logger.info(
                "loaded IVF index %s: nlist=%d nprobe=%d (recall@%s %.4f at publish)",
                index.fingerprint, index.nlist, index.nprobe,
                rec.get("k"), rec.get("recall", -1.0),
            )
        except (
            _persistence.ModelIntegrityError, OSError, KeyError,
            pickle.UnpicklingError, EOFError, ValueError,
        ) as e:
            logger.warning("IVF index unavailable (%s); serving exact", e)

    @classmethod
    def _load_quantized(cls, model: "CheckpointedALSModel", d: str, quant: dict) -> None:
        """Attach the published quantized variant, if any and wanted.

        ``PIO_QUANT_DTYPE`` at deploy: ``auto`` (default) serves whatever
        dtype the manifest recorded; ``f32`` is the rollback switch; an
        explicit ``bf16``/``int8`` must match the artifact or fp32 is served
        with a warning. A missing or corrupt ``quant.blob`` degrades to
        fp32 with a warning (the score kernel serves either on the card).
        """
        import pickle

        recorded = quant.get("dtype", "f32")
        want = (os.environ.get("PIO_QUANT_DTYPE") or "auto").strip().lower()
        effective = recorded if want in ("auto", "") else want
        if effective == "f32" or recorded == "f32":
            if want in ("bf16", "int8") and recorded != want:
                logger.warning(
                    "PIO_QUANT_DTYPE=%s but artifact records %s; serving fp32",
                    want, recorded,
                )
            return
        if effective != recorded:
            logger.warning(
                "PIO_QUANT_DTYPE=%s but artifact records %s; serving fp32", want, recorded,
            )
            return
        try:
            payload = _persistence.load_models_blob(
                _persistence.open_blob_file(os.path.join(d, cls.QUANT))
            )
            model.factor_dtype = payload["dtype"]
            model.user_factors_q = payload["user_factors_q"]
            model.user_scale = payload["user_scale"]
            model.item_factors_q = payload["item_factors_q"]
            model.item_scale = payload["item_scale"]
            logger.info(
                "loaded %s quantized factors (top-k overlap %.4f at publish)",
                payload["dtype"], quant.get("topk_overlap", -1.0),
            )
        except (
            _persistence.ModelIntegrityError, OSError, KeyError,
            pickle.UnpicklingError, EOFError,
        ) as e:
            logger.warning("quantized factors unavailable (%s); serving fp32", e)


class ALSScorer:
    """Serving-side top-N ranking with factors resident on the card.

    Parity role: ``ALSModel.recommendProductsWithFilter`` of the reference's
    blacklist-items template; score, filter and top-k run as one kernel
    launch while the factors stay on the card between queries.
    """

    # Below this factor-matrix size, per-query calls score on the host: a
    # few-µs numpy matvec beats a device round trip for single queries.
    HOST_THRESHOLD = 2_000_000  # item_factors elements

    # Filter sets larger than this go to the host path (the JAX package's
    # top FILTER_BUCKETS width).
    MAX_FILTER = 32768

    _batch_init_lock = threading.Lock()

    def __init__(
        self,
        ctx: DeviceContext,
        model: ALSModel,
        max_k: int = 100,
        on_device: Optional[bool] = None,
    ):
        self.ctx = ctx
        self.model = model
        self.n_items = model.item_factors.shape[0]
        self.max_k = max_k
        if on_device is None:
            on_device = model.item_factors.size >= self.HOST_THRESHOLD
        self.on_device = on_device
        if on_device:
            # per-query calls score through the fast path's factors
            self.enable_fastpath()

    def enable_fastpath(
        self, max_k: Optional[int] = None, warm_buckets: Optional[tuple] = None
    ):
        """Build the bucketed serving fast path (deploy/reload time).

        Places the factors on the card and warms every rung (or only
        ``warm_buckets``); idempotent and thread-safe. Built even when
        ``on_device`` is False: the batched serve path amortizes the round
        trip that makes single queries prefer the host.
        """
        fp = getattr(self, "_fastpath", None)
        if fp is None:
            with self._batch_init_lock:
                fp = getattr(self, "_fastpath", None)
                if fp is None:
                    fp = self._new_scorer(max_k or self.max_k, warm_buckets)
                    self._fastpath = fp
        return fp

    def _new_scorer(self, max_k: int, warm_buckets: Optional[tuple]):
        from predictionio_tpu_torch.serving.fastpath import BucketedScorer

        m = self.model
        # a publish-time ShardingPlan selects the sharded placement per
        # PIO_SERVING_SHARDING, a published IVF index the pruned retrieval
        # path per PIO_RETRIEVAL
        plan = getattr(m, "sharding_plan", None)
        ivf_index = getattr(m, "ivf_index", None)
        if m.factor_dtype != "f32" and m.user_factors_q is not None:
            # published quantized variant: narrow factors on the card,
            # upcast inside the kernel
            return BucketedScorer(
                self.ctx, m.user_factors_q, m.item_factors_q, max_k=max_k,
                factor_dtype=m.factor_dtype,
                user_scale=m.user_scale, item_scale=m.item_scale,
                warm_buckets=warm_buckets, plan=plan, ivf_index=ivf_index,
            )
        return BucketedScorer(
            self.ctx, m.user_factors, m.item_factors, max_k=max_k,
            warm_buckets=warm_buckets, plan=plan, ivf_index=ivf_index,
        )

    def _batch_fastpath(self, k: int):
        """The card's scorer for a batch at top-``k``: the serving fast path
        when it is (or would be) wide enough, else one of its own at width
        ``k``. Either is warmed at the top rung only, the one batches use."""
        from predictionio_tpu_torch.serving.fastpath import BUCKETS

        if k > _score_kernel.MAX_K:
            raise KernelError(
                f"num={k} is above the score kernel's top-k limit {_score_kernel.MAX_K}"
            )
        top = BUCKETS[-1:]
        fp = getattr(self, "_fastpath", None)
        if fp is None and k <= self.max_k:
            return self.enable_fastpath(warm_buckets=top)
        if fp is not None and k <= fp.k:
            return fp
        with self._batch_init_lock:
            wide = getattr(self, "_wide_fastpath", None)
            if wide is None or wide.k < k:
                wide = self._wide_fastpath = self._new_scorer(k, top)
        return wide

    def fastpath_stats(self) -> Optional[dict]:
        fp = getattr(self, "_fastpath", None)
        return fp.stats() if fp is not None else None

    def apply_delta_rows(self, user_idx, user_rows, item_idx=None, item_rows=None):
        """Patch a streaming delta's rows into every scorer built on the
        card (the serving fast path and a wide batch scorer); the caller
        patches the host model, which scorers built later read. Returns the
        fast path's receipt, or None when it is not built."""
        out = None
        for name in ("_wide_fastpath", "_fastpath"):
            fp = getattr(self, name, None)
            if fp is not None:
                out = fp.apply_delta_rows(user_idx, user_rows, item_idx, item_rows)
        return out

    def recommend_batch(
        self, user_indices: np.ndarray, num: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Unfiltered top-num for MANY users in one pass.

        On the card the batch goes through the fast path, built on first
        use whatever :attr:`HOST_THRESHOLD` says (it decides single queries
        only), so the score kernel runs in top-rung chunks: the JAX
        package's on-device batch program (``models/als.py:1904-1925``). A
        ``num`` past the fast path's width gets a scorer of its own at that
        width; one past the kernel's limit raises. On the CPU the host
        product serves unless the fast path was built.
        Returns (idx (B, k), scores (B, k)).
        """
        users = np.asarray(user_indices, np.int64)
        k = min(max(num, 1), self.n_items)
        if self.ctx.device.type == "cuda":
            return self._batch_fastpath(k).score_topk(users, k)
        fp = getattr(self, "_fastpath", None)
        if fp is not None and k <= fp.k:
            return fp.score_topk(users, k)
        m = self.model
        scores = m.user_factors[users] @ m.item_factors.T  # (B, n_items)
        idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        row_scores = np.take_along_axis(scores, idx, axis=1)
        order = np.argsort(-row_scores, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        return idx, np.take_along_axis(row_scores, order, axis=1)

    def recommend(
        self,
        user_idx: int,
        num: int,
        exclude_items: Optional[np.ndarray] = None,
        candidate_items: Optional[np.ndarray] = None,
        prefer_card: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(item_indices, scores) of the top ``num`` items for one user.

        ``prefer_card`` ranks on the fast path whenever one is built on the
        card, below :attr:`HOST_THRESHOLD` too (the pipeline's ranking
        stage: one kernel launch under the candidate mask)."""
        k = min(max(num, 1), self.n_items)
        n_excl = 0 if exclude_items is None else len(exclude_items)
        n_cand = 0 if candidate_items is None else len(candidate_items)
        fp = getattr(self, "_fastpath", None)
        on_card = self.on_device or (
            prefer_card and fp is not None and fp.ctx.device.type == "cuda"
        )
        # num beyond the built top-k width serves exactly from the host
        # rather than silently truncating; oversized filter sets also drop
        # to the host
        if (
            on_card and k <= fp.k
            and n_excl <= self.MAX_FILTER and n_cand <= self.MAX_FILTER
        ):
            idx, vals = fp.score_topk_filtered(
                user_idx, k, exclude_items, candidate_items
            )
        elif candidate_items is not None:
            # candidate path on the host: gather only the candidate rows
            cand = np.asarray(candidate_items, np.int64)
            if exclude_items is not None and len(exclude_items):
                cand = cand[~np.isin(cand, np.asarray(exclude_items, np.int64))]
            m = self.model
            if len(cand) == 0:
                return np.zeros(0, np.int64), np.zeros(0, np.float32)
            sub = m.item_factors[cand] @ m.user_factors[user_idx]
            kk = min(k, len(cand))
            pick = np.argpartition(-sub, kk - 1)[:kk]
            order = np.argsort(-sub[pick])
            pick = pick[order]
            idx = cand[pick]
            vals = sub[pick]
        else:
            mask = np.zeros(self.n_items, bool)
            if exclude_items is not None and len(exclude_items):
                mask[np.asarray(exclude_items, np.int64)] = True
            m = self.model
            scores = m.user_factors[user_idx] @ m.item_factors.T
            scores = np.where(mask, NEG_INF, scores)
            idx = np.argpartition(-scores, k - 1)[:k]
            order = np.argsort(-scores[idx])
            idx = idx[order]
            vals = scores[idx]
        real = vals > -1e29
        return idx[real][:num], vals[real][:num]
