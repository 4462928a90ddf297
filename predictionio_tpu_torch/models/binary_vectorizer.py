"""(property, value) → one-hot vector encoding.

Counterpart of ``predictionio_tpu/models/binary_vectorizer.py`` (parity:
``e2/.../engine/BinaryVectorizer.scala:26-63``): the (property, value) →
column map is built from the training rows, and rows vectorize to dense
float32 arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap


@dataclasses.dataclass
class BinaryVectorizer:
    index: BiMap  # "prop=value" → column

    @staticmethod
    def fit(
        rows: Iterable[Mapping[str, str]], properties: Sequence[str]
    ) -> "BinaryVectorizer":
        keys = []
        for row in rows:
            for p in properties:
                if p in row:
                    keys.append(f"{p}={row[p]}")
        return BinaryVectorizer(index=BiMap.string_int(keys))

    @property
    def width(self) -> int:
        return len(self.index)

    def transform(self, row: Mapping[str, str]) -> np.ndarray:
        x = np.zeros(self.width, np.float32)
        for key, value in row.items():
            j = self.index.get(f"{key}={value}")
            if j is not None:
                x[j] = 1.0
        return x

    def transform_many(self, rows: Sequence[Mapping[str, str]]) -> np.ndarray:
        return np.stack([self.transform(r) for r in rows]) if rows else np.zeros(
            (0, self.width), np.float32
        )
