"""Random forest classifier: histogram-based split search on the card.

Counterpart of ``predictionio_tpu/models/random_forest.py`` (parity: MLlib
``RandomForest.trainClassifier``, the classification template's
add-algorithm variant):

* features are quantized once on the host to ``n_bins`` quantile bins, so
  split search is a dense histogram problem;
* trees grow level-wise on the context's device (:func:`_grow_tree`): per
  level one flat ``index_add_`` builds the (node, feature, bin, class)
  histogram (integer counts, exact in float32 in any order), a ``cumsum``
  gives each candidate split's left and right counts, Gini impurity scores
  them and ``argmin`` picks the first best (feature, threshold) per node;
* the bootstrap and feature draws are ``np.random.default_rng(seed)``, as
  in the JAX package, so one seed draws the same trees in both packages.

Candidates that tie in exact arithmetic can round apart between torch and
XLA in the Gini sums over classes; ROADMAP §3 logs what the parity test
found.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext


@dataclasses.dataclass
class RFConfig:
    n_trees: int = 10
    max_depth: int = 5
    n_bins: int = 32
    feature_fraction: float = 1.0  # fraction of features per tree
    seed: int = 0


@dataclasses.dataclass
class RandomForestModel:
    # per tree, per internal node (2^depth - 1): split feature + bin threshold
    split_feature: np.ndarray  # (T, nodes) int32, -1 = leaf/dead
    split_bin: np.ndarray  # (T, nodes) int32
    leaf_class: np.ndarray  # (T, leaves=2^depth) int32
    bin_edges: np.ndarray  # (F, n_bins-1) quantile thresholds
    max_depth: int
    label_map: BiMap

    def _binize(self, x: np.ndarray) -> np.ndarray:
        cols = [
            np.searchsorted(self.bin_edges[f], x[..., f], side="right")
            for f in range(x.shape[-1])
        ]
        return np.stack(cols, axis=-1).astype(np.int32)

    def predict_class_index(self, x: np.ndarray) -> int:
        xb = self._binize(np.asarray(x, np.float32)[None, :])[0]
        votes = np.zeros(len(self.label_map), np.int64)
        n_trees = self.split_feature.shape[0]
        for t in range(n_trees):
            node = 0
            for _ in range(self.max_depth):
                f = self.split_feature[t, node]
                # unsplit nodes route left, mirroring training's sample routing
                go_right = f >= 0 and xb[f] > self.split_bin[t, node]
                node = 2 * node + 1 + int(go_right)
            leaf = node - (2**self.max_depth - 1)
            votes[self.leaf_class[t, leaf]] += 1
        return int(np.argmax(votes))

    def predict(self, x: np.ndarray) -> str:
        return self.label_map.inverse[self.predict_class_index(x)]


def _quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.stack(
        [np.quantile(x[:, f], qs) for f in range(x.shape[1])]
    ).astype(np.float32)


def _gini(counts: torch.Tensor) -> torch.Tensor:
    """(..., C) class counts → impurity × weight."""
    s = counts.sum(-1)
    p = counts / torch.clamp(s[..., None], min=1.0)
    return s * (1.0 - (p**2).sum(-1))


def _grow_tree(xb, y, feat_mask, n_nodes_total, n_classes, n_bins, max_depth):
    """Level-wise growth of ONE tree on ``xb``'s device. xb: (N, F) int32
    bins; y: (N,) int32; feat_mask: (F,) bool. Returns the tree's
    (split_feature, split_bin, leaf_class) tensors."""
    dev = xb.device
    n, n_features = xb.shape
    xb, y = xb.long(), y.long()
    split_feature = torch.full((n_nodes_total,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(n_nodes_total, dtype=torch.int32, device=dev)
    node_of = torch.zeros(n, dtype=torch.int64, device=dev)  # node id per sample
    feats = torch.arange(n_features, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for depth in range(max_depth):
        n_level = 2**depth
        level_base = n_level - 1
        local = node_of - level_base  # 0..n_level-1 for live samples
        # histogram: (node, feature, bin, class) via one flat index_add_
        flat = ((local[:, None] * n_features + feats[None, :]) * n_bins + xb) * n_classes + y[:, None]
        hist = torch.zeros(n_level * n_features * n_bins * n_classes, device=dev)
        hist.index_add_(0, flat.reshape(-1), torch.ones(flat.numel(), device=dev))
        hist = hist.view(n_level, n_features, n_bins, n_classes)
        # cumulative over bins → left/right class counts per candidate split
        left = torch.cumsum(hist, dim=2)
        total = left[:, :, -1:, :]
        right = total - left
        score = _gini(left) + _gini(right)  # lower is better; (node, F, bin)
        score = torch.where(feat_mask[None, :, None], score, inf)
        score[:, :, -1] = inf  # last bin = no split
        flat_score = score.reshape(n_level, -1)
        best = torch.argmin(flat_score, dim=1)
        best_f = (best // n_bins).to(torch.int32)
        best_b = (best % n_bins).to(torch.int32)
        # only split nodes that actually reduce impurity and have samples
        parent = _gini(total[:, 0, 0, :])
        improve = parent - flat_score.gather(1, best[:, None]).squeeze(1)
        do_split = improve > 1e-6
        best_f = torch.where(do_split, best_f, torch.full_like(best_f, -1))
        split_feature[level_base:level_base + n_level] = best_f
        split_bin[level_base:level_base + n_level] = best_b
        # route samples
        f_of_sample = best_f[local].long()
        b_of_sample = best_b[local].long()
        sample_bin = xb.gather(1, torch.clamp(f_of_sample, min=0)[:, None]).squeeze(1)
        go_right = (sample_bin > b_of_sample) & (f_of_sample >= 0)
        node_of = 2 * node_of + 1 + go_right.long()
    # leaves: majority class per leaf
    leaf_of = node_of - (2**max_depth - 1)
    leaf_hist = torch.zeros((2**max_depth) * n_classes, device=dev)
    leaf_hist.index_add_(0, leaf_of * n_classes + y, torch.ones(n, device=dev))
    leaf_class = torch.argmax(leaf_hist.view(2**max_depth, n_classes), dim=1).to(torch.int32)
    return split_feature, split_bin, leaf_class


def train_random_forest(
    ctx,
    features: np.ndarray,  # (N, F) float
    labels: Sequence,  # N label values
    config: Optional[RFConfig] = None,
) -> RandomForestModel:
    cfg = config or RFConfig()
    dev = (ctx or DeviceContext.create()).device
    x = np.asarray(features, np.float32)
    label_map = BiMap.string_int([str(l) for l in labels])
    y = label_map.to_index_array([str(l) for l in labels]).astype(np.int32)
    n, n_features = x.shape
    n_classes = len(label_map)
    bin_edges = _quantile_bins(x, cfg.n_bins)
    xb = np.stack(
        [
            np.searchsorted(bin_edges[f], x[:, f], side="right")
            for f in range(n_features)
        ],
        axis=1,
    ).astype(np.int32)

    rng = np.random.default_rng(cfg.seed)
    n_nodes = 2**cfg.max_depth - 1
    sf = np.zeros((cfg.n_trees, n_nodes), np.int32)
    sb = np.zeros((cfg.n_trees, n_nodes), np.int32)
    lc = np.zeros((cfg.n_trees, 2**cfg.max_depth), np.int32)
    n_feat_used = max(1, int(round(cfg.feature_fraction * n_features)))
    xb_dev = torch.from_numpy(xb).to(dev)
    y_dev = torch.from_numpy(y).to(dev)
    for t in range(cfg.n_trees):
        boot = rng.integers(0, n, n)  # bootstrap sample
        feats = rng.choice(n_features, size=n_feat_used, replace=False)
        feat_mask = np.zeros(n_features, bool)
        feat_mask[feats] = True
        boot_dev = torch.from_numpy(boot).to(dev)
        tsf, tsb, tlc = _grow_tree(
            xb_dev[boot_dev],
            y_dev[boot_dev],
            torch.from_numpy(feat_mask).to(dev),
            n_nodes,
            n_classes,
            cfg.n_bins,
            cfg.max_depth,
        )
        sf[t], sb[t], lc[t] = tsf.cpu().numpy(), tsb.cpu().numpy(), tlc.cpu().numpy()
    return RandomForestModel(
        split_feature=sf,
        split_bin=sb,
        leaf_class=lc,
        bin_edges=bin_edges,
        max_depth=cfg.max_depth,
        label_map=label_map,
    )
