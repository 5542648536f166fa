"""Fake workflow — run an arbitrary function through the full evaluation
plumbing (test infrastructure).

Parity with reference core/.../workflow/FakeWorkflow.scala:14-71 (`FakeRun`
wraps a `SparkContext => Unit` in a fake engine/evaluator so tests exercise
the real EvaluationInstance lifecycle). Here the function receives the
WorkflowContext; everything else — instance INIT -> EVALCOMPLETED, result
persistence — is the production path in workflow/evaluate.py.
"""

from __future__ import annotations

from typing import Callable

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
)
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.evaluation import Metric
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.workflow.context import WorkflowContext


class FakeEvalResult:
    """Marker eval-info (reference FakeEvalResult)."""

    def __repr__(self):
        return "FakeEvalResult()"


class _FakeDataSource(DataSource):
    def __init__(self, params=None):
        pass

    def read_training(self, ctx):
        return ()

    def read_eval(self, ctx):
        return [((), FakeEvalResult(), [])]


class _FakeAlgorithm(LAlgorithm):
    def __init__(self, params=None):
        pass

    def train(self, ctx, data):
        return ()

    def predict(self, model, query):
        return None


class _FakeEngine(Engine):
    """Engine whose eval() runs the wrapped function (reference FakeRunner)."""

    def __init__(self, fn: Callable[[WorkflowContext], None]):
        super().__init__(
            _FakeDataSource, IdentityPreparator,
            {"fake": _FakeAlgorithm}, FirstServing,
        )
        self.fn = fn

    def eval(self, ctx, engine_params):
        self.fn(ctx)
        return [(FakeEvalResult(), [])]


class _FakeMetric(Metric):
    def calculate(self, ctx, eval_data_set) -> float:
        return 0.0


def fake_run(
    fn: Callable[[WorkflowContext], None],
    storage: Storage,
    ctx: WorkflowContext | None = None,
) -> str:
    """Run `fn(ctx)` through the real evaluation workflow; returns the
    EvaluationInstance id (status EVALCOMPLETED on success)."""
    from pio_tpu_torch.workflow.evaluate import run_evaluation

    instance_id, _ = run_evaluation(
        engine=_FakeEngine(fn),
        metric=_FakeMetric(),
        engine_params_list=[EngineParams(algorithms=[("fake", None)])],
        storage=storage,
        evaluation_class="FakeRun",
        ctx=ctx,
    )
    return instance_id
