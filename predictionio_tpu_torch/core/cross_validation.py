"""k-fold cross-validation splitting helper.

Copy of ``predictionio_tpu/core/cross_validation.py``. Parity: ``e2/.../evaluation/CrossValidation.scala:24-67`` — deterministic
k-fold assignment by row index (the reference uses ``zipWithUniqueId`` % k);
here indices are explicit so any array-like dataset splits the same way.
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def k_fold_indices(n: int, k: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(train_idx, test_idx)] per fold; row i belongs to fold i % k."""
    if k < 2:
        raise ValueError("k must be >= 2")
    fold_of = np.arange(n) % k
    out = []
    for f in range(k):
        test = np.nonzero(fold_of == f)[0]
        train = np.nonzero(fold_of != f)[0]
        out.append((train, test))
    return out


def k_fold(
    data: Sequence[T], k: int
) -> list[tuple[list[T], list[T]]]:
    """Materialized (train, test) row lists per fold."""
    splits = k_fold_indices(len(data), k)
    return [
        ([data[i] for i in tr], [data[i] for i in te]) for tr, te in splits
    ]


def k_fold_eval(
    data: Sequence[T],
    k: int,
    to_training: Callable[[list[T]], object],
    to_query_actual: Callable[[T], tuple],
):
    """Build DataSource.read_eval-shaped folds from a row dataset."""
    return [
        (to_training(train), [to_query_actual(row) for row in test])
        for train, test in k_fold(data, k)
    ]
