"""Evaluation + params-generator pair for the quickstart dataset (the
`pio eval` entry shape, reference Evaluation.scala / quickstart docs).

Precision@10 over k-fold splits (DataSourceParams.eval_k -> read_eval),
grid over rank x lambda. The PyTorch port's counterpart of
``../eval_def.py``, run from the repository's root:

    python -m pio_tpu_torch eval \
        examples.quickstart.port.eval_def.QuickstartEval \
        examples.quickstart.port.eval_def.QuickstartParams --output best.json
"""

from __future__ import annotations

from pio_tpu_torch.controller import EngineParams, EngineParamsGenerator, Evaluation
from pio_tpu_torch.e2.metrics import PrecisionAtK, RecallAtK
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithmParams,
    DataSourceParams,
    RecommendationEngine,
)

APP_NAME = "quickstart"
FOLDS = 3
# (rank, lambda, alpha, binarize) — implicit ALS: the metric scores
# heldout INTERACTIONS (which items a user touches), which is the
# implicit-MF task; explicit rating-prediction ALS ranks by predicted
# star rating and loses to raw popularity on it by construction.
# `binarize` is a DATASOURCE variant (rating_event=""): every event maps
# to confidence 1 instead of its star rating — the grid tunes data
# preparation and algorithm together, the DASE way.
GRID = [(16, 0.05, 10.0, False), (32, 0.1, 10.0, False),
        (32, 0.05, 8.0, True), (48, 0.05, 8.0, True)]


class QuickstartEval(Evaluation):
    @classmethod
    def engine_metric(cls):
        return RecommendationEngine.apply(), PrecisionAtK(10)

    @classmethod
    def other_metrics(cls):
        return [RecallAtK(10)]


class QuickstartParams(EngineParamsGenerator):
    @classmethod
    def params_list(cls):
        return [
            EngineParams(
                datasource=("", DataSourceParams(
                    app_name=APP_NAME, eval_k=FOLDS,
                    # binarized: no event carries a rating -> every
                    # interaction becomes implicit_value 1.0
                    rating_event="" if binarize else "rate",
                    implicit_value=1.0 if binarize else 4.0)),
                algorithms=[("als", ALSAlgorithmParams(
                    rank=rank, num_iterations=12, lambda_=lam,
                    alpha=alpha, implicit_prefs=True, chunk=8192))],
            )
            for rank, lam, alpha, binarize in GRID
        ]
