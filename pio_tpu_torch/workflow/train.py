"""Train workflow: supervised training runs, persisting models, restoring
them.

Counterpart of ``pio_tpu.workflow.train``. ``run_train`` takes an engine
instance INIT -> TRAINING -> COMPLETED, or FAILED (re-raising the error)
or INTERRUPTED (preempted, resumable): it reads and trains through
``Engine.train``, frames the models and writes them to MODELDATA before
the COMPLETED transition, so deploy's latest-completed lookup never finds
an instance without models. The run is supervised
(workflow/lifecycle.py), as the reference's is:

 * every run gets a per-instance step-checkpoint directory (keyed by
   EngineInstance.id) that the iterative trainer saves into, so a killed
   run loses at most ``checkpoint_every`` steps;
 * SIGTERM/SIGINT request a final checkpoint at the next step boundary —
   the instance lands INTERRUPTED (resumable), not half-dead INIT. Only
   the sequence template checks for it at its steps; the recommendation
   (ALS) template never does, so there the first signal is held and the
   run goes on to COMPLETED, and a second SIGINT aborts it;
 * heartbeats keep the instance's ``progress`` field fresh; stale
   INIT/TRAINING zombies from kill -9'd runs are swept to FAILED at the
   next train startup;
 * ``resume_instance_id`` / ``auto_resume`` re-enter a resumable
   instance: the (seed, step)-keyed batch stream makes the resumed run
   reproduce the uninterrupted one exactly;
 * the ``train.persist`` chaos point stands before the model write;
 * several processes (``parallel/distributed.py``, one a rank): only
   process 0 sweeps zombies and writes metadata and the model blob; the
   others take the instance id from ``PIO_TPU_RUN_ID``, set alike on
   every process, and every process reaches the ``train-persist``
   barrier before process 0 records COMPLETED, whether its persist
   failed or not.

``persist_models`` stores models made elsewhere (seeded factors, or a
model carried across by ``convert.py``) as a COMPLETED instance the same
way. ``load_models`` is the deploy-side restore.

Not ported: the reference's persistent compile cache (eager torch has no
XLA cache), and step checkpoints saved from several processes (the
sequence template saves from one; ROADMAP A5).
"""

from __future__ import annotations

import logging
import os
import traceback
from dataclasses import replace
from typing import Any

from pio_tpu_torch.controller.base import TrainingInterruption
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.dao import EngineInstance, Model
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.parallel.distributed import barrier, is_primary
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.utils.time import format_time, utcnow
from pio_tpu_torch.workflow.checkpoint import models_from_bytes, models_to_bytes
from pio_tpu_torch.workflow.context import WorkflowContext, create_workflow_context
from pio_tpu_torch.workflow.lifecycle import (
    RESUMABLE_STATUSES,
    PreemptionHandler,
    TrainingPreempted,
    TrainLifecycle,
    checkpoint_dir_for,
    find_resumable,
    sweep_zombies,
)

log = logging.getLogger("pio_tpu_torch.workflow")

# steps between heartbeat writes to the instance row
HEARTBEAT_EVERY_STEPS = 10


def _fresh_instance(engine_params: EngineParams, engine_id: str,
                    engine_version: str, engine_variant: str,
                    engine_factory: str, batch: str,
                    instance_id: str = "") -> EngineInstance:
    """A new INIT engine instance (not stored); an empty id is assigned
    at insert."""
    now = utcnow()
    return EngineInstance(
        id=instance_id,
        status="INIT",
        start_time=now,
        end_time=now,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=batch,
        datasource_params=f"{engine_params.datasource}",
        preparator_params=f"{engine_params.preparator}",
        algorithms_params=f"{engine_params.algorithms}",
        serving_params=f"{engine_params.serving}",
    )


def _insert_instance(storage: Storage, engine_params: EngineParams,
                     engine_id: str, engine_version: str,
                     engine_variant: str, engine_factory: str,
                     batch: str) -> EngineInstance:
    """A new INIT engine instance, as stored."""
    instances = storage.get_metadata_engine_instances()
    instance_id = instances.insert(_fresh_instance(
        engine_params, engine_id, engine_version, engine_variant,
        engine_factory, batch))
    return instances.get(instance_id)


def _set_status(storage: Storage, instance: EngineInstance,
                status: str) -> EngineInstance:
    instance = replace(instance, status=status, end_time=utcnow())
    storage.get_metadata_engine_instances().update(instance)
    return instance


def persist_models(
    models: list[Any],
    engine_params: EngineParams,
    storage: Storage,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    engine_factory: str = "",
    batch: str = "",
) -> str:
    """Store trained models as a COMPLETED engine instance; returns its
    id. The instance goes INIT -> COMPLETED only after the blob is
    written, so deploy never sees a COMPLETED instance without models."""
    instance = _insert_instance(storage, engine_params, engine_id,
                                engine_version, engine_variant,
                                engine_factory, batch)
    blob = models_to_bytes(models)
    storage.get_model_data_models().insert(Model(instance.id, blob))
    _set_status(storage, instance, "COMPLETED")
    log.info("engine instance %s COMPLETED (%d bytes of models)",
             instance.id, len(blob))
    return instance.id


def _resolve_instance(
    storage: Storage,
    primary: bool,
    resume_instance_id: str | None,
    auto_resume: bool,
    engine_id: str,
    engine_version: str,
    engine_variant: str,
    engine_factory: str,
    batch: str,
    engine_params: EngineParams,
    checkpoint_root: str | None,
) -> EngineInstance:
    """Resume an existing resumable instance, or insert a fresh one."""
    instances = storage.get_metadata_engine_instances()
    if resume_instance_id:
        instance = instances.get(resume_instance_id)
        if instance is None:
            raise ValueError(
                f"cannot resume: engine instance {resume_instance_id} "
                "not found"
            )
        if instance.status not in RESUMABLE_STATUSES:
            raise ValueError(
                f"cannot resume instance {resume_instance_id}: status is "
                f"{instance.status} (resumable: "
                f"{', '.join(RESUMABLE_STATUSES)})"
            )
        got = (instance.engine_id, instance.engine_version,
               instance.engine_variant)
        want = (engine_id, engine_version, engine_variant)
        if got != want:
            # resuming under the wrong engine would persist engine B's
            # model blob against engine A's instance — and deploy's
            # get_latest_completed would then serve it
            raise ValueError(
                f"cannot resume instance {resume_instance_id}: it belongs "
                f"to engine {got}, not {want} (wrong --engine-dir?)"
            )
        return instance
    if auto_resume:
        instance = find_resumable(
            instances, engine_id, engine_version, engine_variant,
            checkpoint_root,
        )
        if instance is not None:
            log.info("auto-resume: picking up instance %s (%s, last step "
                     "%s)", instance.id, instance.status,
                     instance.progress.get("step"))
            return instance
        log.info("auto-resume: no resumable instance with checkpoints "
                 "found; starting fresh")
    # several processes: every process must agree on the instance id, and
    # only process 0 may insert — an explicit PIO_TPU_RUN_ID provides both
    run_id = os.environ.get("PIO_TPU_RUN_ID", "")
    fresh = _fresh_instance(engine_params, engine_id, engine_version,
                            engine_variant, engine_factory, batch, run_id)
    if not primary:
        if not run_id:
            raise ValueError(
                "multi-host training needs PIO_TPU_RUN_ID set (identically "
                "on every host) so non-primary processes know the "
                "engine-instance id without writing metadata"
            )
        return fresh
    return instances.get(instances.insert(fresh))


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    storage: Storage,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    engine_factory: str = "",
    batch: str = "",
    ctx: WorkflowContext | None = None,
    stop_after_read: bool = False,
    stop_after_prepare: bool = False,
    resume_instance_id: str | None = None,
    auto_resume: bool = False,
    checkpoint_root: str | None = None,
) -> str:
    """Returns the EngineInstance id (status COMPLETED on success).

    Every run gets the full lifecycle: a startup zombie sweep, a
    per-instance checkpoint dir, SIGTERM/SIGINT preemption handling
    (raises TrainingPreempted at the next step the template checks;
    instance INTERRUPTED) and heartbeats every ``HEARTBEAT_EVERY_STEPS``
    steps. ``resume_instance_id`` re-enters a resumable
    (INTERRUPTED/FAILED) instance; ``auto_resume`` picks the most recent
    one with checkpoints on disk. On any other error the instance is
    marked FAILED and the error re-raised; if that status write fails
    too, the training error is raised, chained to it."""
    ctx = ctx or create_workflow_context(storage)
    instances = storage.get_metadata_engine_instances()
    primary = is_primary()
    if primary:
        try:
            swept = sweep_zombies(storage)
            if swept:
                log.warning("startup sweep transitioned %d zombie "
                            "instance(s) to FAILED: %s",
                            len(swept), [i.id for i in swept])
        except Exception:  # noqa: BLE001 - the sweep is advisory
            log.warning("startup zombie sweep failed", exc_info=True)

    instance = _resolve_instance(
        storage, primary, resume_instance_id, auto_resume, engine_id,
        engine_version, engine_variant, engine_factory, batch,
        engine_params, checkpoint_root,
    )
    resumed = instance.status in RESUMABLE_STATUSES
    instance_id = instance.id

    # a resumed run MUST read the directory the original run recorded —
    # recomputing from the current --checkpoint-root/env could point at
    # an empty dir and silently restart from step 0 (and --auto-resume's
    # has_checkpoint validation reads the recorded dir)
    ckpt_dir = (
        (instance.progress or {}).get("checkpoint_dir") if resumed else None
    ) or checkpoint_dir_for(instance_id, checkpoint_root)
    handler = PreemptionHandler()
    lifecycle = TrainLifecycle(
        instances,
        instance,
        checkpoint_dir=ckpt_dir,
        heartbeat_every_steps=HEARTBEAT_EVERY_STEPS,
        preemption=handler,
        readonly=not primary,
    )

    def record(status: str, **progress_extra) -> None:
        """Terminal status transition, keeping accumulated progress."""
        lifecycle.stop()  # the liveness beat must not race terminal writes
        if not primary:
            return
        progress = dict(lifecycle.instance.progress)
        progress.update(progress_extra)
        lifecycle.instance = replace(
            lifecycle.instance, status=status, end_time=utcnow(),
            progress=progress,
        )
        instances.update(lifecycle.instance)

    # mark the run live before training: TRAINING + an initial heartbeat
    # so a kill -9 from now on is detectable as a stale zombie
    progress = dict(instance.progress)
    if resumed:
        progress["resumed_at"] = format_time(utcnow())
    lifecycle.instance = replace(
        instance, status="TRAINING", progress=progress
    )
    if primary:
        instances.update(lifecycle.instance)
    lifecycle.heartbeat(progress.get("step", 0), force=True)
    lifecycle.start()  # wall-clock liveness beat (see TrainLifecycle)

    ctx.lifecycle = lifecycle
    try:
        with handler:
            models = engine.train(
                ctx,
                engine_params,
                stop_after_read=stop_after_read,
                stop_after_prepare=stop_after_prepare,
            )
            # chaos point: a `train.persist` spec simulates a storage
            # fault during the final model write — the run must land
            # FAILED (resumable from its last checkpoint), never
            # COMPLETED-without-a-blob. The barrier is reached on BOTH
            # outcomes: a process whose persist failed must not leave its
            # peers blocked in it forever.
            persist_error: Exception | None = None
            try:
                chaos.maybe_inject("train.persist")
                blob = models_to_bytes(models)
                if primary:
                    storage.get_model_data_models().insert(
                        Model(instance_id, blob))
            except Exception as e:  # noqa: BLE001 - re-raised after barrier
                persist_error = e
            # the COMPLETED transition must not outrun any process's part
            # of the persist
            barrier("train-persist")
            if persist_error is not None:
                raise persist_error
            record("COMPLETED")
            log.info("training %s COMPLETED (%d bytes of models)",
                     instance_id, len(blob))
            return instance_id
    except TrainingPreempted as preempted:
        try:
            record(
                "INTERRUPTED",
                preempted_at_step=preempted.step,
                resumable=True,
            )
        except Exception:  # noqa: BLE001 - preserve the preemption signal
            log.error("could not mark %s INTERRUPTED (status store down)",
                      instance_id, exc_info=True)
        log.warning(
            "training %s INTERRUPTED by preemption at step %s; resume "
            "with: python -m pio_tpu_torch train --resume %s",
            instance_id, preempted.step, instance_id,
        )
        raise
    except TrainingInterruption:
        record("INTERRUPTED")
        raise
    except Exception as train_error:
        log.error("training %s FAILED:\n%s",
                  instance_id, traceback.format_exc())
        try:
            record("FAILED")
        except Exception as update_error:
            # the status write failing (store down) must not MASK why
            # training died: surface the training error, chained to the
            # bookkeeping failure
            raise train_error from update_error
        raise
    finally:
        lifecycle.stop()
        ctx.lifecycle = None


def load_models(
    storage: Storage,
    engine: Engine,
    engine_params: EngineParams,
    instance_id: str,
    ctx: WorkflowContext | None = None,
    algorithms: list[Any] | None = None,
) -> list[Any]:
    """Restore an instance's models and run per-algorithm deploy prep on
    ``algorithms`` (the instances that will serve them; new ones from the
    engine params when None). Deploy prep may bind serve-time state to
    its algorithm (the sequence template's live event store), so the
    server passes its own.

    Raises ModelIntegrityError (utils/durable.py) when the stored blob
    fails its CRC32C frame — a truncated or bit-rotted artifact never
    reaches the unpickler; serve falls back to the previous COMPLETED
    instance on that error."""
    ctx = ctx or create_workflow_context(storage)
    record = storage.get_model_data_models().get(instance_id)
    if record is None:
        raise ValueError(f"no models stored for engine instance {instance_id}")
    models = models_from_bytes(record.models)
    algos = algorithms
    if algos is None:
        _, _, algos, _ = engine._doers(engine_params)
    if len(models) != len(algos):
        raise ValueError(
            f"instance {instance_id} has {len(models)} models but engine "
            f"params define {len(algos)} algorithms"
        )
    return [
        algo.prepare_model_for_deploy(ctx, m)
        for algo, m in zip(algos, models)
    ]
