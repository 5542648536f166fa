"""Ranking metrics for the recommendation templates.

The reference's similarproduct/ecommerce evaluation examples define
Precision@K-style metrics over PredictedResult.itemScores vs. actual item
sets; these are the shared vectorized implementations.
"""

from __future__ import annotations

from pio_tpu_torch.controller.evaluation import (  # noqa: F401 (re-export)
    MeanSquareError,
    OptionAverageMetric,
)


def _predicted_items(prediction) -> list[str]:
    if isinstance(prediction, dict):
        return [s["item"] for s in prediction.get("itemScores", [])]
    return list(prediction or [])


class PrecisionAtK(OptionAverageMetric):
    """tp / min(k, |actual|) over the top-k predictions — the reference
    recommendation-template metric shape. Queries with no *actuals* score
    None (excluded); an engine returning few/no predictions is penalized,
    not excluded, so tuning cannot be gamed by under-predicting."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_one(self, query, prediction, actual):
        actual_set = set(actual or [])
        if not actual_set:
            return None
        pred = _predicted_items(prediction)[: self.k]
        tp = sum(1 for p in pred if p in actual_set)
        return tp / min(self.k, len(actual_set))


class RecallAtK(OptionAverageMetric):
    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"Recall@{self.k}"

    def calculate_one(self, query, prediction, actual):
        actual_set = set(actual or [])
        if not actual_set:
            return None
        pred = _predicted_items(prediction)[: self.k]
        return sum(1 for p in pred if p in actual_set) / len(actual_set)
