"""BinaryVectorizer — (property, value) one-hot encoding.

Counterpart of ``pio_tpu.e2.vectorizer``, verbatim. Reference
e2/.../engine/BinaryVectorizer.scala:10-46: builds an index map
from distinct (field, value) pairs and emits MLlib SparseVectors; here the
map is host-side and `transform` emits dense numpy one-hot rows (XLA wants
dense static shapes; at typical categorical widths a dense row is the right
layout for the MXU anyway).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

from pio_tpu_torch.data.bimap import BiMap


@dataclass
class BinaryVectorizer:
    index: BiMap  # (field, value) -> dim

    @property
    def n_features(self) -> int:
        return len(self.index)

    @staticmethod
    def fit(
        maps: Iterable[Mapping[str, str]], fields: Sequence[str]
    ) -> "BinaryVectorizer":
        """Reference BinaryVectorizer.apply(rdd, properties)."""
        pairs: dict[tuple[str, str], int] = {}
        for m in maps:
            for f in fields:
                if f in m:
                    key = (f, str(m[f]))
                    if key not in pairs:
                        pairs[key] = len(pairs)
        return BinaryVectorizer(BiMap(pairs))

    def transform(self, m: Mapping[str, str]) -> np.ndarray:
        """One map -> dense one-hot row (reference toBinaryVector)."""
        v = np.zeros(self.n_features, np.float32)
        for f, val in m.items():
            j = self.index.get((f, str(val)), -1)
            if j >= 0:
                v[j] = 1.0
        return v

    def transform_batch(self, maps: Sequence[Mapping[str, str]]) -> np.ndarray:
        out = np.zeros((len(maps), self.n_features), np.float32)
        for i, m in enumerate(maps):
            out[i] = self.transform(m)
        return out
