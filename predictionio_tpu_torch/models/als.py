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
  There is no mesh: one card holds
  every entity, so the blocks have no shard dimension (the JAX package's
  ``n_shards = 1`` layout). Mid-training checkpoints come with a later
  slice (ROADMAP §1 item 7) and raise until then;
* :class:`ALSModel` (``:132``) and :func:`als_model_from_arrays`, which
  carries factors and id lists across from anywhere else;
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
import logging
import os
import threading
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops import train_kernel as _train_kernel
from predictionio_tpu_torch.ops.topk import NEG_INF

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
    # mid-training checkpoint/resume: not ported yet (ROADMAP §1 item 7)
    checkpoint_dir: Optional[str] = None
    # dtype of the GATHERED opposite factors ("f32" | "bf16" | "int8"): bf16
    # gathers the opposite matrix in bfloat16, int8 quantizes it per
    # half-step with per-row scales; every contraction accumulates f32.
    # None → PIO_ALS_COMPUTE_DTYPE (default "f32"), read when the config is
    # built, not when the module is imported
    compute_dtype: Optional[str] = None
    # The JAX package's LPT rebalance across mesh shards. One card has one
    # shard, where the JAX package rebalances nothing: the dense solver
    # degree-sorts and the segment solver keeps the original order either
    # way (kept so configs and pickled models read the same).
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
        if self.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_dir (mid-training checkpoints) is not ported yet "
                "(ROADMAP §1 item 7)"
            )


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


def _degree_sort_permutation(entity: np.ndarray, n_entity: int) -> np.ndarray:
    """Old id → new id relabeling by descending rating count (stable), so
    contiguous id ranges form degree buckets."""
    counts = np.bincount(entity, minlength=n_entity)
    order = np.argsort(-counts, kind="stable")
    perm = np.empty(n_entity, np.int64)
    perm[order] = np.arange(n_entity)
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


def _make_dense_blocks(
    entity: np.ndarray,
    other: np.ndarray,
    rating: np.ndarray,
    n_entity: int,
    chunk_budget: Optional[int] = None,
) -> _DenseBlocks:
    """Degree-bucketed dense rating matrices. ``entity`` must already be
    degree-sorted (:func:`_degree_sort_permutation`): all ratings of one
    entity land in one row of one bucket, so the half-step needs no
    scatter."""
    chunk_budget = chunk_budget or _DENSE_CHUNK
    deg = np.bincount(entity, minlength=n_entity)
    bounds = _bucket_boundaries(deg, chunk_budget)
    # sort triples by entity: each bucket is one contiguous slice, and the
    # column is the rank within the entity
    order = np.argsort(entity, kind="stable")
    entity_s, other_s, rating_s = entity[order], other[order], rating[order]
    offsets = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(len(entity_s)) - offsets[entity_s]
    idx_l, rat_l, msk_l, widths = [], [], [], []
    padded = 0
    for j0, j1, width in bounds:
        n_b = j1 - j0
        idx_b = np.zeros((n_b, width), np.int32)
        rat_b = np.zeros((n_b, width), np.float32)
        msk_b = np.zeros((n_b, width), np.float32)
        s, e = offsets[j0], offsets[j1]
        rows = entity_s[s:e] - j0
        cols = pos[s:e]
        idx_b[rows, cols] = other_s[s:e]
        rat_b[rows, cols] = rating_s[s:e]
        msk_b[rows, cols] = 1.0
        idx_l.append(idx_b)
        rat_l.append(rat_b)
        msk_l.append(msk_b)
        widths.append(width)
        padded += n_b * width
    return _DenseBlocks(
        idx=idx_l, rat=rat_l, msk=msk_l, widths=widths, padded_ratings=padded,
    )


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


def train_als(
    ctx: DeviceContext,
    interactions,
    config: Optional[ALSConfig] = None,
    *,
    init_factors: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> ALSModel:
    """Train factors on ``ctx.device`` with ``config.solver``; returns a
    host-form :class:`ALSModel` with factors in original id order.

    The initial factors are standard normal draws from a CPU
    ``torch.Generator`` seeded by ``config.seed``, scaled by 1/sqrt(rank),
    unless ``init_factors=(U0, V0)`` gives them, in ORIGINAL entity order
    ((n_users, rank) and (n_items, rank)). Both solvers start entity e from
    row e of the draw, so one seed starts them from the same factors. The
    JAX package draws them with jax's threefry generator, which torch
    cannot reproduce, so the parity tests pass the JAX draw here. On a CUDA
    device every bucket of every dense half-step launches the training
    kernel, and every segment half-step the segment kernel once; on the CPU
    they run the kernels' plain versions.
    """
    cfg = config or ALSConfig()
    device = ctx.device
    n_users, n_items = interactions.n_users, interactions.n_items

    if init_factors is None:
        gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))
        U0 = _initial_factors(cfg, n_users, gen)
        V0 = _initial_factors(cfg, n_items, gen)
    else:
        U0, V0 = (np.array(f, np.float32) for f in init_factors)
        if U0.shape != (n_users, cfg.rank) or V0.shape != (n_items, cfg.rank):
            raise ValueError(
                f"init_factors shapes {U0.shape}/{V0.shape}, expected "
                f"{(n_users, cfg.rank)}/{(n_items, cfg.rank)}"
            )
    if cfg.solver == "segment":
        # no relabeling: the JAX package's one-shard segment path
        u_perm = i_perm = None
        u_blocks, i_blocks = (
            _segment_layout(blk, device) for blk in _segment_blocks_for(interactions))
        half_step = _half_step
    else:
        ub, ib, u_perm, i_perm = _dense_blocks_for(interactions, cfg)
        # blocked row perm[e] holds original entity e
        U0 = U0[np.argsort(u_perm)]
        V0 = V0[np.argsort(i_perm)]
        u_blocks, i_blocks = (
            [tuple(torch.from_numpy(a).to(device) for a in t)
             for t in zip(blk.idx, blk.rat, blk.msk)]
            for blk in (ub, ib)
        )
        half_step = _dense_half_step
    U = torch.from_numpy(np.ascontiguousarray(U0)).to(device)
    V = torch.from_numpy(np.ascontiguousarray(V0)).to(device)
    for _ in range(cfg.iterations):
        # u-solve gathers ITEM factors, v-solve gathers USER factors
        U = half_step(u_blocks, V, _gram(V) if cfg.implicit else None, cfg)
        V = half_step(i_blocks, U, _gram(U) if cfg.implicit else None, cfg)
    U_host, V_host = U.cpu().numpy(), V.cpu().numpy()
    if u_perm is not None:
        U_host, V_host = U_host[u_perm], V_host[i_perm]
    return ALSModel(
        user_factors=U_host,
        item_factors=V_host,
        user_map=interactions.user_map,
        item_map=interactions.item_map,
        config=cfg,
    )


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

    def enable_fastpath(self, max_k: Optional[int] = None):
        """Build the bucketed serving fast path (deploy/reload time).

        Places the factors on the card and warms every rung; idempotent and
        thread-safe. Built even when ``on_device`` is False: the batched
        serve path amortizes the round trip that makes single queries
        prefer the host.
        """
        fp = getattr(self, "_fastpath", None)
        if fp is None:
            with self._batch_init_lock:
                fp = getattr(self, "_fastpath", None)
                if fp is None:
                    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

                    m = self.model
                    if m.factor_dtype != "f32" and m.user_factors_q is not None:
                        # published quantized variant: narrow factors on the
                        # card, upcast inside the kernel
                        fp = BucketedScorer(
                            self.ctx, m.user_factors_q, m.item_factors_q,
                            max_k=max_k or self.max_k,
                            factor_dtype=m.factor_dtype,
                            user_scale=m.user_scale, item_scale=m.item_scale,
                        )
                    else:
                        fp = BucketedScorer(
                            self.ctx, m.user_factors, m.item_factors,
                            max_k=max_k or self.max_k,
                        )
                    self._fastpath = fp
        return fp

    def fastpath_stats(self) -> Optional[dict]:
        fp = getattr(self, "_fastpath", None)
        return fp.stats() if fp is not None else None

    def recommend_batch(
        self, user_indices: np.ndarray, num: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Unfiltered top-num for MANY users in one pass.

        Returns (idx (B, k), scores (B, k)).
        """
        users = np.asarray(user_indices, np.int64)
        k = min(max(num, 1), self.n_items)
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
    ) -> tuple[np.ndarray, np.ndarray]:
        """(item_indices, scores) of the top ``num`` items for one user."""
        k = min(max(num, 1), self.n_items)
        n_excl = 0 if exclude_items is None else len(exclude_items)
        n_cand = 0 if candidate_items is None else len(candidate_items)
        fp = getattr(self, "_fastpath", None)
        # num beyond the built top-k width serves exactly from the host
        # rather than silently truncating; oversized filter sets also drop
        # to the host
        if (
            self.on_device and k <= fp.k
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
