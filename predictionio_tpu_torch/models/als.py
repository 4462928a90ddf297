"""ALS model and its serving-side scorer.

Counterpart of the serving half of ``predictionio_tpu/models/als.py``:
:class:`ALSConfig` (``:59``, the model's own fields with the same
defaults), :class:`ALSModel` (``:132``) and :class:`ALSScorer`
(``:1757-2000``). Training (the dense solver and its kernel, block
building, checkpoints) comes with the training slice; until then a model
reaches the port through :func:`als_model_from_arrays`, which carries
factors and id lists across — from the JAX package's trained ``ALSModel``
in the tests, from a seeded draw in ``chip_smoke.py``.

Every device scoring call goes through the scorer's
:class:`~predictionio_tpu_torch.serving.fastpath.BucketedScorer`, the one
holder of the factors on the card, and so through the kernel: the batched
path and the per-query path (whose blacklist and whitelist become the
kernel's exclusion mask at B = 1). Unlike the JAX package, which keeps a
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
import threading
from typing import Optional

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.ops.topk import NEG_INF

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ALSConfig:
    rank: int = 10
    iterations: int = 10
    reg: float = 0.01  # lambda (per-rating, ALS-WR scaled)
    implicit: bool = False
    alpha: float = 1.0  # implicit confidence scale
    seed: int = 3


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
