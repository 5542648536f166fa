"""Train workflow: training runs, persisting models, restoring them.

Counterpart of ``pio_tpu.workflow.train``. ``run_train`` takes an engine
instance INIT -> TRAINING -> COMPLETED (or FAILED, re-raising the error):
it reads and trains through ``Engine.train``, frames the models and writes
them to MODELDATA before the COMPLETED transition, so deploy's
latest-completed lookup never finds an instance without models.
``persist_models`` stores models made elsewhere (seeded factors, or a
model carried across by ``convert.py``) as a COMPLETED instance the same
way. ``load_models`` is the deploy-side restore.

Not ported yet: the supervised lifecycle (``lifecycle.py`` heartbeats,
preemption, the zombie sweep, resume), the ``train.persist`` chaos point,
the persistent compile cache and the multi-host barrier.
"""

from __future__ import annotations

import logging
import traceback
from dataclasses import replace
from typing import Any

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.dao import EngineInstance, Model
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.utils.time import utcnow
from pio_tpu_torch.workflow.checkpoint import models_from_bytes, models_to_bytes
from pio_tpu_torch.workflow.context import WorkflowContext, create_workflow_context

log = logging.getLogger("pio_tpu_torch.workflow")


def _insert_instance(storage: Storage, engine_params: EngineParams,
                     engine_id: str, engine_version: str,
                     engine_variant: str, engine_factory: str,
                     batch: str) -> EngineInstance:
    """A new INIT engine instance, as stored."""
    instances = storage.get_metadata_engine_instances()
    now = utcnow()
    instance_id = instances.insert(EngineInstance(
        id="",
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
    ))
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
) -> str:
    """Read, train and persist; returns the EngineInstance id (status
    COMPLETED). On any error the instance is marked FAILED and the error
    re-raised; if that status write fails too, the training error is
    raised, chained to it."""
    ctx = ctx or create_workflow_context(storage)
    instance = _insert_instance(storage, engine_params, engine_id,
                                engine_version, engine_variant,
                                engine_factory, batch)
    instance = _set_status(storage, instance, "TRAINING")
    try:
        models = engine.train(ctx, engine_params)
        blob = models_to_bytes(models)
        storage.get_model_data_models().insert(Model(instance.id, blob))
    except Exception as train_error:
        log.error("training %s FAILED:\n%s", instance.id,
                  traceback.format_exc())
        try:
            _set_status(storage, instance, "FAILED")
        except Exception as update_error:
            raise train_error from update_error
        raise
    _set_status(storage, instance, "COMPLETED")
    log.info("training %s COMPLETED (%d bytes of models)", instance.id,
             len(blob))
    return instance.id


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
