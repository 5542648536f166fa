"""User-code evaluation: hyperparameter tuning for the recommendation
engine with MetricEvaluator.

The tuning demo the reference ships as
examples/experimental/scala-local-movielens-evaluation (Evaluation
subclasses binding an engine to metrics, an EngineParamsGenerator spanning
the search grid, MetricEvaluator picking the best params and writing
best.json — reference controller/Evaluation.scala:10-64,
MetricEvaluator.scala:76-260).

The PyTorch port's counterpart of ``../engine.py``. Run from this
directory:

    python -m pio_tpu_torch eval engine.RecEvaluation \
        engine.RecParamsGenerator --engine-dir . --workers 2

or run the SAME grid batched — every shape-compatible candidate trains
as one stacked device program (docs/evaluation.md):

    python -m pio_tpu_torch eval --sweep --engine-dir . \
        --grid '{"rank": [4, 8, 16], "lambda_": [0.01, 0.1]}' \
        --metric precision@5 --other-metrics recall@5

The engine's DataSource splits the app's rating events into eval_k
index-mod-k folds; every params candidate trains on each fold's training
split and is scored on the held-out queries; the best candidate's params
land in best.json, ready to paste into engine.json for
`python -m pio_tpu_torch train`.
"""

from __future__ import annotations

from pio_tpu_torch.controller import EngineParams, EngineParamsGenerator, Evaluation
from pio_tpu_torch.e2.metrics import PrecisionAtK, RecallAtK
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithmParams,
    DataSourceParams,
    RecommendationEngine,
)

APP_NAME = "EvalApp"


class RecEvaluation(Evaluation):
    """Binds the engine to the primary tuning metric + extra columns
    (reference Evaluation DSL: `engineMetric = (engine, metric)`)."""

    engine = RecommendationEngine.apply()
    metric = PrecisionAtK(k=5)
    metrics = [RecallAtK(k=5)]


class RecParamsGenerator(EngineParamsGenerator):
    """The search grid (reference EngineParamsGenerator.scala): rank x
    regularization, shared datasource with 3-fold splits."""

    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(app_name=APP_NAME, eval_k=3)),
            algorithms=[("als", ALSAlgorithmParams(
                rank=rank, num_iterations=6, lambda_=reg))],
        )
        for rank in (4, 8, 16)
        for reg in (0.01, 0.1)
    ]
