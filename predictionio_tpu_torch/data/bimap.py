"""BiMap: immutable bidirectional map, the id-indexing workhorse.

Copy of ``predictionio_tpu/data/bimap.py`` (parity: ``BiMap.scala``
``stringInt`` / ``stringLong``). The bulk paths factorize with numpy
instead of pandas, which the port does not depend on; the results are the
same (first-seen order for :meth:`string_int`, ``missing`` for unknown keys
in :meth:`to_index_array`).
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, Sequence, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


def _factorize(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, uniques) with uniques in first-seen order."""
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], uniq[order]


class BiMap(Generic[K, V]):
    __slots__ = ("_fwd", "_rev", "_inverse")

    def __init__(self, fwd: Mapping[K, V], _rev: Mapping[V, K] | None = None):
        self._fwd: dict[K, V] = dict(fwd)
        if _rev is None:
            _rev = {v: k for k, v in self._fwd.items()}
            if len(_rev) != len(self._fwd):
                raise ValueError("BiMap values must be unique")
        self._rev: dict[V, K] = dict(_rev)
        self._inverse: "BiMap[V, K] | None" = None

    # Builders (parity: BiMap.stringInt / stringLong / stringDouble) -------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Index distinct keys 0..n-1 in first-seen order."""
        if isinstance(keys, np.ndarray):
            uniques = _factorize(keys)[1]
            return BiMap(dict(zip(uniques.tolist(), range(len(uniques)))))
        fwd: dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    string_long = string_int  # Python ints are unbounded

    # Map API --------------------------------------------------------------
    def __getitem__(self, k: K) -> V:
        return self._fwd[k]

    def get(self, k: K, default=None):
        return self._fwd.get(k, default)

    def __contains__(self, k: K) -> bool:
        return k in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    def items(self):
        return self._fwd.items()

    @property
    def inverse(self) -> "BiMap[V, K]":
        if self._inverse is None:
            self._inverse = BiMap(self._rev, self._fwd)
            self._inverse._inverse = self
        return self._inverse

    def to_dict(self) -> dict[K, V]:
        return dict(self._fwd)

    def take(self, keys: Iterable[K]) -> "BiMap[K, V]":
        return BiMap({k: self._fwd[k] for k in keys if k in self._fwd})

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self) -> str:
        return f"BiMap({len(self._fwd)} entries)"

    # Vectorized forward mapping -------------------------------------------
    def to_index_array(
        self, keys: Sequence[K], missing: int = -1
    ) -> np.ndarray:
        """Map a sequence of keys to an int64 numpy array (missing → -1).

        Bulk lookups (>10k keys) factorize first and map only the distinct
        keys through the dict.
        """
        if len(keys) > 10_000:
            codes, uniques = _factorize(np.asarray(keys, dtype=object))
            unique_vals = np.fromiter(
                (self._fwd.get(u, missing) for u in uniques.tolist()),
                dtype=np.int64,
                count=len(uniques),
            )
            return unique_vals[codes]
        return np.fromiter(
            (self._fwd.get(k, missing) for k in keys), dtype=np.int64, count=len(keys)
        )
