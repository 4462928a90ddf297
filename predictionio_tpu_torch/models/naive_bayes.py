"""Naive Bayes classifiers: multinomial (numeric vectors) + categorical.

Counterpart of ``predictionio_tpu/models/naive_bayes.py`` (parity: MLlib
``NaiveBayes.train``, the classification template's algorithm, and
``e2/.../engine/CategoricalNaiveBayes.scala:23-172``). Class-conditional
statistics are segment sums keyed by label (``ops/segment.py``, ``index_add_``
on the context's device); scoring is one matmul (multinomial) or table
lookups (categorical) on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops.segment import segment_count, segment_sum


def _device(ctx: Optional[DeviceContext]) -> torch.device:
    # no context means the card, as everywhere in the port
    return (ctx or DeviceContext.create()).device


# -- multinomial NB (MLlib NaiveBayes parity) --------------------------------


@dataclasses.dataclass
class MultinomialNBModel:
    log_prior: np.ndarray  # (C,)
    log_theta: np.ndarray  # (C, F)
    label_map: BiMap  # label string ↔ class index

    def predict_scores(self, x: np.ndarray) -> np.ndarray:
        """(..., F) → (..., C) joint log-likelihoods."""
        return x @ self.log_theta.T + self.log_prior

    def predict(self, x: np.ndarray) -> str:
        idx = int(np.argmax(self.predict_scores(np.asarray(x, np.float32))))
        return self.label_map.inverse[idx]


def train_multinomial_nb(
    ctx,
    features: np.ndarray,  # (N, F) non-negative
    labels: Sequence,  # N label values (any hashable)
    smoothing: float = 1.0,
) -> MultinomialNBModel:
    label_map = BiMap.string_int([str(l) for l in labels])
    y = label_map.to_index_array([str(l) for l in labels])
    n_classes = len(label_map)
    dev = _device(ctx)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    yt = torch.from_numpy(y.astype(np.int64)).to(dev)
    class_counts = segment_count(yt, n_classes)
    feat_sums = segment_sum(x, yt, n_classes)  # (C, F)
    log_prior = torch.log(class_counts / class_counts.sum())
    num = feat_sums + smoothing
    log_theta = torch.log(num / num.sum(dim=1, keepdim=True))
    return MultinomialNBModel(
        log_prior=log_prior.cpu().numpy(),
        log_theta=log_theta.cpu().numpy(),
        label_map=label_map,
    )


# -- categorical NB (e2 CategoricalNaiveBayes parity) ------------------------


@dataclasses.dataclass
class CategoricalNBModel:
    """Per-feature value tables of log P(value | class) + log priors; unseen
    values score a configurable default (``log_score``'s
    ``default_likelihood``, CategoricalNaiveBayes.scala:~120)."""

    log_prior: np.ndarray  # (C,)
    log_likelihood: list  # per feature f: (C, V_f)
    label_map: BiMap
    value_maps: list

    def log_score(
        self, features: Sequence[str], default_likelihood: float = float("-inf")
    ) -> Optional[np.ndarray]:
        """(C,) joint log scores, or None if a value is unseen and default=-inf."""
        scores = self.log_prior.copy()
        for f, value in enumerate(features):
            vi = self.value_maps[f].get(value)
            if vi is None:
                if default_likelihood == float("-inf"):
                    return None
                scores = scores + default_likelihood
            else:
                scores = scores + self.log_likelihood[f][:, vi]
        return scores

    def predict(self, features: Sequence[str]) -> str:
        scores = self.log_score(features, default_likelihood=-20.0)
        return self.label_map.inverse[int(np.argmax(scores))]


def train_categorical_nb(
    ctx, points: Sequence[tuple[str, Sequence[str]]]
) -> CategoricalNBModel:
    """points: (label, [feature values]) — all rows same feature count."""
    labels = [l for l, _ in points]
    label_map = BiMap.string_int(labels)
    y = label_map.to_index_array(labels).astype(np.int64)
    n_classes = len(label_map)
    n_features = len(points[0][1]) if points else 0
    dev = _device(ctx)
    class_counts = segment_count(torch.from_numpy(y).to(dev), n_classes).cpu().numpy()
    value_maps: list = []
    tables: list = []
    for f in range(n_features):
        col = [p[1][f] for p in points]
        vmap = BiMap.string_int(col)
        vi = vmap.to_index_array(col).astype(np.int64)
        # joint index (class, value) → one flat count per feature
        flat = torch.from_numpy(y * len(vmap) + vi).to(dev)
        counts = (
            segment_count(flat, n_classes * len(vmap))
            .cpu().numpy().reshape(n_classes, len(vmap))
        )
        smoothed = counts + 1.0  # add-one smoothing (reference default)
        tables.append(np.log(smoothed / smoothed.sum(axis=1, keepdims=True)))
        value_maps.append(vmap)
    log_prior = np.log(class_counts / class_counts.sum())
    return CategoricalNBModel(
        log_prior=log_prior,
        log_likelihood=tables,
        label_map=label_map,
        value_maps=value_maps,
    )
