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
  ``n_shards = 1`` layout). With ``checkpoint_dir`` set, the factors are
  saved every ``checkpoint_interval`` iterations and a rerun resumes from
  the last matching step (``core/checkpoint.py``; ``:954-1030``);
* :class:`ALSModel` (``:132``) and :func:`als_model_from_arrays`, which
  carries factors and id lists across from anywhere else;
* :class:`CheckpointedALSModel` (``:1379-1748``): checkpoint-mode
  persistence, the factors in a sealed numpy store and the quantized
  serving variant behind its publish gate (``PIO_QUANT_DTYPE``);
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

from predictionio_tpu_torch.core import persistence as _persistence
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops import score_kernel as _score_kernel
from predictionio_tpu_torch.ops import train_kernel as _train_kernel
from predictionio_tpu_torch.ops._build import KernelError
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

    def __setstate__(self, state):
        # a JAX-package model also holds sharding_plan and ivf_index, None
        # unless sharded serving or IVF (not ported) declared them
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


def _checkpoint_fingerprint(interactions, cfg: ALSConfig) -> np.ndarray:
    """What ties a checkpoint to this config and dataset: the JAX package's
    fields (``models/als.py:954-975``) at one shard, so no padding. A
    foreign or permuted dataset (another digest) starts fresh."""
    from predictionio_tpu_torch.core.checkpoint import dataset_digest

    rating = interactions.rating.astype(np.float32)
    return np.array(
        [
            interactions.n_users,
            interactions.n_items,
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
            # rebalance, solver and shard count set the saved row order
            int(cfg.rebalance),
            int(cfg.solver == "dense"),
            1,
        ],
        dtype=np.float64,
    )


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

    With ``config.checkpoint_dir`` the factors are saved (as host arrays,
    in the solver's row order) after every ``checkpoint_interval``
    iterations and the last; a run that finds a step whose fingerprint
    matches resumes there and launches the kernels only for the
    iterations left.
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
    start_iter, manager, fingerprint = 0, None, None
    if cfg.checkpoint_dir:
        from predictionio_tpu_torch.core import checkpoint as _checkpoint

        _checkpoint.validate_interval(cfg.checkpoint_interval)
        manager = _checkpoint.CheckpointManager(cfg.checkpoint_dir)
        fingerprint = _checkpoint_fingerprint(interactions, cfg)
        start_iter, state = _checkpoint.resume_from(manager, fingerprint, cfg.iterations)
        if state is not None:
            # the saved factors are in this solver's row order (the
            # fingerprint names the solver)
            U0, V0 = state["U"], state["V"]
    U = torch.from_numpy(np.ascontiguousarray(U0, np.float32)).to(device)
    V = torch.from_numpy(np.ascontiguousarray(V0, np.float32)).to(device)
    for it in range(start_iter, cfg.iterations):
        # u-solve gathers ITEM factors, v-solve gathers USER factors
        U = half_step(u_blocks, V, _gram(V) if cfg.implicit else None, cfg)
        V = half_step(i_blocks, U, _gram(U) if cfg.implicit else None, cfg)
        if manager is not None and _checkpoint.save_due(
            it + 1, cfg.checkpoint_interval, cfg.iterations
        ):
            manager.save(it + 1, {"U": U, "V": V, "fingerprint": fingerprint})
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
    store), the id maps and publish records in ``maps.pkl``, and the
    quantized variant, when its gate passed, in ``quant.blob``. Deploy calls
    :meth:`load`.
    """

    FACTORS = "factors.blob"
    MAPS = "maps.pkl"
    QUANT = "quant.blob"

    @staticmethod
    def _dir(instance_id: str) -> str:
        from predictionio_tpu_torch.utils.fs import pio_base_dir

        return os.path.join(pio_base_dir(), "persistent_models", instance_id)

    def save(self, instance_id: str, params) -> bool:
        import pickle

        from predictionio_tpu_torch.core.checkpoint import save_state

        _refuse_unported_publish_knobs()
        d = self._dir(instance_id)
        os.makedirs(d, exist_ok=True)
        save_state(
            os.path.join(d, self.FACTORS),
            {"user_factors": self.user_factors, "item_factors": self.item_factors},
        )
        quant_meta = self._publish_quantized(d)
        with open(os.path.join(d, self.MAPS), "wb") as f:
            # the plan and IVF records as the JAX package writes them with
            # their knobs unset: replicated, exact
            pickle.dump(
                {"user_map": self.user_map, "item_map": self.item_map,
                 "config": self.config, "quant": quant_meta,
                 "sharding": {"n_shards": 0}, "ivf": {"nlist": 0}},
                f,
            )
        return True  # manifest mode: MODELDATA stores only the class path

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
        return model

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


def _refuse_unported_publish_knobs() -> None:
    """A publish that asks for sharded serving or IVF retrieval raises: the
    plan and IVF gates come with those slices."""
    for knobs, what, item in (
        (("PIO_SHARD_COUNT", "PIO_SHARD_HBM_BUDGET"), "a sharding plan", 10),
        (("PIO_IVF_NLIST",), "an IVF index", 9),
    ):
        set_ = [k for k in knobs if os.environ.get(k, "").strip()]
        if set_:
            raise NotImplementedError(
                f"{', '.join(set_)} asks the publish for {what}, which is not "
                f"ported to predictionio_tpu_torch yet (ROADMAP §1 item {item})"
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
        if m.factor_dtype != "f32" and m.user_factors_q is not None:
            # published quantized variant: narrow factors on the card,
            # upcast inside the kernel
            return BucketedScorer(
                self.ctx, m.user_factors_q, m.item_factors_q, max_k=max_k,
                factor_dtype=m.factor_dtype,
                user_scale=m.user_scale, item_scale=m.item_scale,
                warm_buckets=warm_buckets,
            )
        return BucketedScorer(
            self.ctx, m.user_factors, m.item_factors, max_k=max_k,
            warm_buckets=warm_buckets,
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
