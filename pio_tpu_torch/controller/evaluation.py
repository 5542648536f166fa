"""Evaluation + metrics + tuning.

Mirrors the reference's metric workflow:
 * `Metric[EI,Q,P,A,R].calculate` over Seq[(EI, RDD[(Q,P,A)])]
   (core/.../controller/Metric.scala:13-134) — the RDD union+stats Spark
   reductions become numpy reductions over the flattened (q,p,a) triples;
 * helper shapes AverageMetric / OptionAverageMetric / StdevMetric /
   SumMetric / ZeroMetric;
 * `Evaluation` binding an engine to its metric(s)
   (controller/Evaluation.scala:10-64);
 * `EngineParamsGenerator` (controller/EngineParamsGenerator.scala);
 * `MetricEvaluator` scoring every EngineParams and picking the best
   (controller/MetricEvaluator.scala:76-260), incl. the best.json output.
"""

from __future__ import annotations

import abc
import html
import json
import math
from dataclasses import dataclass, field
from typing import Any, Generic, Sequence, TypeVar

import numpy as np

from pio_tpu_torch.controller.engine import Engine, EngineParams

R = TypeVar("R")

# eval data set shape: [(eval_info, [(query, prediction, actual)])]
EvalDataSet = Sequence[tuple[Any, Sequence[tuple[dict, Any, Any]]]]


class Metric(abc.ABC, Generic[R]):
    """Reference Metric.scala: calculate + comparison semantics."""

    #: larger is better by default (reference Metric's Ordering)
    higher_is_better: bool = True

    @abc.abstractmethod
    def calculate(self, ctx, eval_data_set: EvalDataSet) -> R: ...

    @property
    def header(self) -> str:
        return type(self).__name__


class QPAMetric(Metric[float]):
    """Base for metrics defined per (q, p, a) triple.

    Non-Option metrics treat a None from calculate_one as a bug and raise
    (the reference's AverageMetric takes a plain Double); Option* variants
    set allow_none and exclude Nones."""

    allow_none = False

    @abc.abstractmethod
    def calculate_one(self, query: dict, prediction: Any, actual: Any) -> Any:
        ...

    def _scores(self, eval_data_set: EvalDataSet) -> np.ndarray:
        out = []
        for _, qpa in eval_data_set:
            for q, p, a in qpa:
                s = self.calculate_one(q, p, a)
                if s is None:
                    if not self.allow_none:
                        raise ValueError(
                            f"{type(self).__name__}.calculate_one returned "
                            "None; use an Option* metric to skip triples"
                        )
                    continue
                out.append(s)
        return np.array(out, dtype=np.float64)


class AverageMetric(QPAMetric):
    """Reference Metric.scala AverageMetric: mean over all triples."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        scores = self._scores(eval_data_set)
        return float(np.mean(scores)) if scores.size else float("nan")


class OptionAverageMetric(AverageMetric):
    """calculate_one may return None; Nones are excluded from the mean
    (reference OptionAverageMetric)."""

    allow_none = True


class StdevMetric(QPAMetric):
    """Reference StdevMetric: population stdev of scores."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        scores = self._scores(eval_data_set)
        return float(np.std(scores)) if scores.size else float("nan")


class OptionStdevMetric(StdevMetric):
    """Reference OptionStdevMetric."""

    allow_none = True


class SumMetric(QPAMetric):
    """Reference SumMetric."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        scores = self._scores(eval_data_set)
        return float(np.sum(scores))


class MeanSquareError(AverageMetric):
    """Regression MSE over served numeric predictions — the metric the
    reference regression examples evaluate with
    (examples/experimental/scala-parallel-regression/Run.scala imports
    controller.MeanSquareError). Lower is better."""

    higher_is_better = False

    @property
    def header(self) -> str:
        return "MSE"

    def calculate_one(self, query, prediction, actual):
        return (float(prediction) - float(actual)) ** 2


class ZeroMetric(Metric[float]):
    """Reference ZeroMetric: always 0 (placeholder)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return 0.0


class EngineParamsGenerator:
    """Tuning search space (reference EngineParamsGenerator.scala).
    Subclass and set engine_params_list (None default avoids a shared
    mutable class-level list across subclasses)."""

    engine_params_list: list[EngineParams] | None = None

    @classmethod
    def params_list(cls) -> list[EngineParams]:
        if not cls.engine_params_list:
            raise ValueError(
                f"{cls.__name__} must define engine_params_list"
            )
        return list(cls.engine_params_list)


class Evaluation:
    """Binds an engine with its metric(s) (reference Evaluation.scala).

    Subclass and set engine + metric (and optionally metrics for
    supplementary columns)."""

    engine: Engine = None
    metric: Metric = None
    metrics: list[Metric] | None = None

    @classmethod
    def other_metrics(cls) -> list[Metric]:
        return list(cls.metrics or [])

    @classmethod
    def engine_metric(cls) -> tuple[Engine, Metric]:
        if cls.engine is None or cls.metric is None:
            raise ValueError(
                f"{cls.__name__} must define both engine and metric"
            )
        return cls.engine, cls.metric


@dataclass
class MetricScores:
    score: Any
    other_scores: list[Any] = field(default_factory=list)


@dataclass
class MetricEvaluatorResult:
    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: list[str]
    engine_params_scores: list[tuple[EngineParams, MetricScores]]

    def one_liner(self) -> str:
        return (
            f"[{self.best_score.score}] {self.best_engine_params.to_json()}"
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestScore": _jsonable(self.best_score.score),
                "bestIndex": self.best_idx,
                "bestEngineParams": json.loads(self.best_engine_params.to_json()),
                "allScores": [
                    {
                        "engineParams": json.loads(ep.to_json()),
                        "score": _jsonable(ms.score),
                        "otherScores": [_jsonable(s) for s in ms.other_scores],
                    }
                    for ep, ms in self.engine_params_scores
                ],
            },
            indent=2,
        )

    def to_html(self) -> str:
        esc = html.escape
        rows = "".join(
            f"<tr><td>{i}</td><td>{esc(str(_jsonable(ms.score)))}</td>"
            f"<td><pre>{esc(ep.to_json())}</pre></td></tr>"
            for i, (ep, ms) in enumerate(self.engine_params_scores)
        )
        return (
            f"<h2>{esc(self.metric_header)}</h2>"
            f"<p>Best score: {esc(str(_jsonable(self.best_score.score)))} "
            f"(params #{self.best_idx})</p>"
            f"<table><tr><th>#</th><th>score</th><th>params</th></tr>"
            f"{rows}</table>"
        )


def _jsonable(x):
    if isinstance(x, float) and (math.isnan(x) or math.isinf(x)):
        return str(x)
    return x


def pick_best_index(scores: Sequence[tuple], metric: Metric) -> int:
    """Best-candidate index over [(engine_params, MetricScores)] with
    the evaluator's NaN rule: NaN is never best, for either comparison
    direction. The ONE selection policy — the classic evaluator and the
    tuning sweep both call it, so their winners cannot drift."""
    def sort_key(i: int):
        s = scores[i][1].score
        if isinstance(s, float) and math.isnan(s):
            return -math.inf  # NaN is never best, for either direction
        return s if metric.higher_is_better else -s

    return max(range(len(scores)), key=sort_key)


class MetricEvaluator:
    """Scores every EngineParams with the metric, picks the best
    (reference MetricEvaluator.scala evaluateBase:163, best selection +
    best.json at :138-161)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: str | None = None,
        workers: int = 1,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path
        # workers > 1 runs the params grid on a thread pool — the reference
        # runs it `.par` (MetricEvaluator.scala:169-178). Default sequential:
        # deterministic FastEval cache behavior, and single-device training
        # rarely overlaps anyway; tuning sweeps over many params opt in.
        self.workers = workers

    def _score_one(self, ctx, engine: Engine, ep: EngineParams) -> MetricScores:
        eval_data_set = engine.eval(ctx, ep)
        return MetricScores(
            score=self.metric.calculate(ctx, eval_data_set),
            other_scores=[
                m.calculate(ctx, eval_data_set) for m in self.other_metrics
            ],
        )

    def evaluate_base(
        self,
        ctx,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        if self.workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                all_ms = list(pool.map(
                    lambda ep: self._score_one(ctx, engine, ep),
                    engine_params_list,
                ))
            scores = list(zip(engine_params_list, all_ms))
        else:
            scores = [
                (ep, self._score_one(ctx, engine, ep))
                for ep in engine_params_list
            ]

        best_idx = pick_best_index(scores, self.metric)
        result = MetricEvaluatorResult(
            best_score=scores[best_idx][1],
            best_engine_params=scores[best_idx][0],
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            with open(self.output_path, "w") as f:
                f.write(result.best_engine_params.to_json())
        return result
