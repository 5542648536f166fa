"""User-code engine: two algorithms combined by a score-merging Serving.

The reference's multi-algorithm demo, examples/scala-parallel-similarproduct/
multi: alongside the standard implicit-ALS similarity algorithm it adds
LikeAlgorithm (LikeAlgorithm.scala:21-86 — like/dislike events become +1/-1
ratings for an EXPLICIT ALS train), and Serving.scala merges both result
lists by summing per-item scores.

User code below: LikeAlgorithm subclasses the built-in similarity algorithm
but swaps the data read/weighting; CombineServing implements the merge.
engine.json's `algorithms` list instantiates BOTH; the workflow fans the
query out to each and hands Serving the list of predictions.

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``, run through ``python -m pio_tpu_torch`` with
``--engine-dir`` this directory. The port's ``als_train`` takes the
device explicitly: LikeAlgorithm trains on ``ctx.device``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    IdentityPreparator,
    Serving,
)
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.models.similarproduct import (
    ALSAlgorithmParams,
    ALSSimilarityAlgorithm,
    DataSourceParams,
    SimilarProductData,
    SimilarProductDataSource,
)
from pio_tpu_torch.ops import als


class MultiDataSource(SimilarProductDataSource):
    """Reads view AND like/dislike streams in one pass; each algorithm
    selects its slice (reference multi/DataSource.scala adds likeEvents)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> SimilarProductData:
        # base read keeps view/like interactions for the implicit algorithm;
        # the signed like/dislike stream rides along for LikeAlgorithm.
        # User code maps raw events to signed ratings itself — the same shape
        # as the reference's likeEvents.map { Rating(+1/-1) }.
        from pio_tpu_torch.data.eventstore import to_interactions

        data = super().read_training(ctx)
        events = ctx.event_store.find(
            app_name=self.params.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=["like", "dislike"],
        )
        data.like_interactions = to_interactions(
            events,
            value_fn=lambda e: 1.0 if e.event == "like" else -1.0,
            dedup="last",   # latest like/dislike wins (reference semantics)
        )
        return data


class LikeAlgorithm(ALSSimilarityAlgorithm):
    """Explicit ALS over signed like/dislike ratings (reference
    LikeAlgorithm.scala: ALS.train on Rating(+1/-1), cosine over product
    features)."""

    params_class = ALSAlgorithmParams

    def train(self, ctx, data: SimilarProductData):
        inter: Interactions = getattr(data, "like_interactions", None)
        if inter is None or len(inter) == 0:
            raise ValueError(
                "MultiDataSource.like_interactions is empty — the app has "
                "no like/dislike events"
            )
        p = self.params
        ap = als.ALSParams(
            rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
            implicit=False,  # explicit: signed ratings, no confidence alpha
            seed=p.seed if p.seed is not None else 3, chunk=p.chunk,
        )
        factors = als.als_train(
            inter.user_idx, inter.item_idx, inter.values,
            inter.n_users, inter.n_items, ap, device=ctx.device,
        )
        from pio_tpu_torch.models.similarproduct import SimilarProductModel

        return SimilarProductModel(
            factors.item_factors, inter.items, data.item_categories
        )


class CombineServing(Serving):
    """Sum per-item scores across algorithm outputs, re-rank, truncate
    (reference multi/Serving.scala standardize+combine)."""

    def serve(self, query, predictions):
        num = int(query.get("num", 10))
        combined: dict[str, float] = defaultdict(float)
        for pred in predictions:
            scores = pred["itemScores"]
            if not scores:
                continue
            # standardize each list so one algorithm's scale can't drown
            # the other (reference Serving.scala z-score standardization)
            vals = np.array([s["score"] for s in scores], np.float64)
            mu, sd = vals.mean(), vals.std() or 1.0
            for s, v in zip(scores, vals):
                combined[s["item"]] += (v - mu) / sd
        ranked = sorted(combined.items(), key=lambda kv: -kv[1])[:num]
        return {"itemScores": [
            {"item": item, "score": float(sc)} for item, sc in ranked
        ]}


class MultiAlgoEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            MultiDataSource,
            IdentityPreparator,
            {"als": ALSSimilarityAlgorithm, "likealgo": LikeAlgorithm},
            CombineServing,
        )
