"""Evaluation workflow — EvaluationInstance lifecycle around MetricEvaluator.

Mirrors reference CoreWorkflow.runEvaluation (core/.../CoreWorkflow.scala:100-157)
+ EvaluationWorkflow.scala:17-27: insert EvaluationInstance, run
engine.eval x params via the evaluator, persist one-liner/JSON/HTML results,
mark EVALCOMPLETED.
"""

from __future__ import annotations

import logging
import traceback
from dataclasses import replace
from typing import Sequence

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.evaluation import (
    Evaluation,
    Metric,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from pio_tpu_torch.data.dao import EvaluationInstance
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.utils.time import utcnow
from pio_tpu_torch.workflow.context import WorkflowContext, create_workflow_context

log = logging.getLogger("pio_tpu_torch.workflow")


def run_evaluation(
    engine: Engine,
    metric: Metric,
    engine_params_list: Sequence[EngineParams],
    storage: Storage,
    other_metrics: Sequence[Metric] = (),
    evaluation_class: str = "",
    params_generator_class: str = "",
    batch: str = "",
    output_path: str | None = None,
    ctx: WorkflowContext | None = None,
    workers: int = 1,
) -> tuple[str, MetricEvaluatorResult]:
    """Returns (evaluation instance id, result)."""
    ctx = ctx or create_workflow_context(storage)
    instances = storage.get_metadata_evaluation_instances()
    now = utcnow()
    instance_id = instances.insert(
        EvaluationInstance(
            id="",
            status="INIT",
            start_time=now,
            end_time=now,
            evaluation_class=evaluation_class,
            engine_params_generator_class=params_generator_class,
            batch=batch,
        )
    )
    instance = instances.get(instance_id)
    try:
        evaluator = MetricEvaluator(
            metric, other_metrics=other_metrics, output_path=output_path,
            workers=workers,
        )
        result = evaluator.evaluate_base(ctx, engine, engine_params_list)
        instances.update(
            replace(
                instance,
                status="EVALCOMPLETED",
                end_time=utcnow(),
                evaluator_results=result.one_liner(),
                evaluator_results_html=result.to_html(),
                evaluator_results_json=result.to_json(),
            )
        )
        log.info("evaluation %s EVALCOMPLETED best=%s",
                 instance_id, result.best_score.score)
        return instance_id, result
    except Exception:
        log.error("evaluation %s FAILED:\n%s", instance_id, traceback.format_exc())
        instances.update(
            replace(instance, status="EVALFAILED", end_time=utcnow())
        )
        raise


def run_evaluation_class(
    evaluation_class: type[Evaluation],
    generator_class,
    storage: Storage,
    **kwargs,
) -> tuple[str, MetricEvaluatorResult]:
    """Run an Evaluation subclass with an EngineParamsGenerator (the
    `pio eval Evaluation ParamsGenerator` entry shape)."""
    engine, metric = evaluation_class.engine_metric()
    return run_evaluation(
        engine=engine,
        metric=metric,
        engine_params_list=generator_class.params_list(),
        storage=storage,
        other_metrics=evaluation_class.other_metrics(),
        evaluation_class=evaluation_class.__name__,
        params_generator_class=generator_class.__name__,
        **kwargs,
    )


def run_sweep_evaluation(
    engine: Engine,
    candidates,
    storage: Storage,
    sweep_config,
    engine_id: str = "",
    engine_version: str = "",
    engine_variant: str = "",
    batch: str = "",
    output_path: str | None = None,
    resume_eval_id: str | None = None,
    ctx: WorkflowContext | None = None,
    tracer=None,
    status=None,
) -> tuple[str, MetricEvaluatorResult]:
    """The batched-sweep twin of run_evaluation (pio eval --sweep):
    same EvaluationInstance lifecycle and result rendering, but the
    grid runs through tuning.sweep.SweepRunner — candidates sharing
    array shapes train as ONE stacked device program, per-unit results
    checkpoint into the durable ``<eval-iid>:sweep`` record (a killed
    sweep resumes via ``resume_eval_id`` and completes the remaining
    units with an identical final result), and the winner lands in
    ``<eval-iid>:best_params`` for ``pio train/deploy --from-eval``.

    Returns (evaluation instance id, result)."""
    from pio_tpu_torch.tuning.records import save_best_params
    from pio_tpu_torch.tuning.sweep import SweepRunner

    ctx = ctx or create_workflow_context(storage)
    instances = storage.get_metadata_evaluation_instances()
    now = utcnow()
    if resume_eval_id:
        instance = instances.get(resume_eval_id)
        if instance is None:
            raise ValueError(
                f"cannot resume: evaluation instance {resume_eval_id} "
                "not found")
        if instance.status == "EVALCOMPLETED":
            raise ValueError(
                f"evaluation {resume_eval_id} already completed; "
                "start a fresh sweep")
        instance_id = instance.id
    else:
        instance_id = instances.insert(
            EvaluationInstance(
                id="",
                status="INIT",
                start_time=now,
                end_time=now,
                evaluation_class="sweep",
                engine_params_generator_class="grid",
                batch=batch,
            )
        )
        instance = instances.get(instance_id)
    runner = SweepRunner(
        engine, candidates, storage, sweep_config,
        eval_id=instance_id, tracer=tracer,
    )
    if status is not None:
        status.update(phase="running", evalId=instance_id,
                      mode=runner.mode,
                      metric=sweep_config.metric.header)
        runner.on_unit = lambda done, total: status.update(
            unitsDone=done, unitsTotal=total)
    try:
        result = runner.run(ctx)
        if status is not None:
            status.update(
                phase="completed",
                bestScore=_finite_or_none(result.best_score.score))
            if runner.last_sweep_seconds is not None:
                status.observe_sweep_seconds(runner.last_sweep_seconds)
        save_best_params(
            storage, instance_id, result.best_engine_params,
            score=(result.best_score.score
                   if isinstance(result.best_score.score, float)
                   else float(result.best_score.score)),
            metric=result.metric_header,
            engine_id=engine_id, engine_version=engine_version,
            engine_variant=engine_variant,
            all_scores=[
                {"score": _finite_or_none(ms.score),
                 "otherScores": [_finite_or_none(s)
                                 for s in ms.other_scores]}
                for _, ms in result.engine_params_scores
            ],
        )
        instances.update(
            replace(
                instance,
                status="EVALCOMPLETED",
                end_time=utcnow(),
                evaluator_results=result.one_liner(),
                evaluator_results_html=result.to_html(),
                evaluator_results_json=result.to_json(),
            )
        )
        if output_path:
            # plain text like MetricEvaluator's best.json: this file is
            # the USER artifact (paste into engine.json); the durable
            # copy lives in the :best_params record
            with open(output_path, "w") as f:
                f.write(result.best_engine_params.to_json())
        log.info("sweep evaluation %s EVALCOMPLETED best=%s mode=%s "
                 "(%.2fs)", instance_id, result.best_score.score,
                 runner.mode, runner.last_sweep_seconds or 0.0)
        return instance_id, result
    except Exception:
        if status is not None:
            status.update(phase="failed")
        # advertise --resume-eval only when a sweep state record exists:
        # a usage/plan error raised before any unit ran would fail the
        # resume identically — the hint would just accrete junk rows
        from pio_tpu_torch.tuning.records import load_sweep_state

        try:
            resumable = load_sweep_state(storage, instance_id) is not None
        except Exception:  # noqa: BLE001 - the hint is advisory
            resumable = False
        log.error("sweep evaluation %s FAILED%s:\n%s",
                  instance_id,
                  (f" (resumable with --resume-eval {instance_id})"
                   if resumable else ""),
                  traceback.format_exc())
        instances.update(
            replace(instance, status="EVALFAILED", end_time=utcnow())
        )
        raise


def _finite_or_none(x):
    try:
        x = float(x)
    except (TypeError, ValueError):
        return None
    return None if x != x else x
