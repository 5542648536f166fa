"""Markov chain transition model.

Replaces reference e2/.../engine/MarkovChain.scala:8-53: from a sparse count
matrix of state transitions, keep the top-N outgoing probabilities per state
(row-normalized). The reference builds a Spark CoordinateMatrix and maps
rows; here the counts accumulate into a dense (S, S) numpy matrix (states
are item/page vocabularies — fits host memory) and the top-N trim runs as
one top-k on the host, ``ops.topk.topk_lowest_index``, which orders equal
probabilities by the lower state as the reference's ``lax.top_k`` does.
Counterpart of ``pio_tpu.ops.markov``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.ops.topk import topk_lowest_index


@dataclass
class MarkovChainModel:
    """Top-N transitions per state (reference MarkovChainModel)."""

    indices: np.ndarray        # (S, N) target state per slot (-1 = empty)
    probs: np.ndarray          # (S, N) row-normalized transition prob
    n_states: int

    def transition_probs(self, state: int) -> dict[int, float]:
        out = {}
        for j, p in zip(self.indices[state], self.probs[state]):
            if j >= 0 and p > 0:
                out[int(j)] = float(p)
        return out

    def predict(self, state: int) -> int | None:
        """Most likely next state, None if the state was never seen."""
        if self.probs[state].sum() <= 0:
            return None
        return int(self.indices[state][np.argmax(self.probs[state])])


def markov_chain_train(
    transitions: Sequence[tuple[int, int]] | np.ndarray,
    n_states: int,
    top_n: int = 10,
) -> MarkovChainModel:
    """transitions: [(from_state, to_state)] counts-of-one (duplicates
    accumulate). Reference MarkovChain.train(matrix, topN)."""
    counts = np.zeros((n_states, n_states), np.float32)
    t = np.asarray(transitions, dtype=np.int64)
    if t.size:
        np.add.at(counts, (t[:, 0], t[:, 1]), 1.0)
    row_sums = counts.sum(axis=1, keepdims=True)
    probs = np.divide(
        counts, row_sums, out=np.zeros_like(counts), where=row_sums > 0
    )
    top_n = min(top_n, n_states)
    top_p, top_i = topk_lowest_index(torch.from_numpy(probs), top_n)
    top_p = top_p.numpy()
    top_i = np.where(top_p > 0, top_i.numpy().astype(np.int32), -1)
    return MarkovChainModel(indices=top_i, probs=top_p, n_states=n_states)
