"""Train workflow: persisting models and restoring them for deploy.

Counterpart of ``pio_tpu.workflow.train``. ``persist_models`` is the
persist-and-record tail of the reference's ``run_train``: it inserts the
EngineInstance, writes the framed model blob into MODELDATA, and marks
the instance COMPLETED, so deploy's latest-completed lookup finds the
models exactly as after a finished training run. ``load_models`` is the
deploy-side restore. Reading events and training (the head of
``run_train``, with its supervised lifecycle) come with the training
slice.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Any

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.dao import EngineInstance, Model
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.utils.time import utcnow
from pio_tpu_torch.workflow.checkpoint import models_from_bytes, models_to_bytes
from pio_tpu_torch.workflow.context import WorkflowContext, create_workflow_context

log = logging.getLogger("pio_tpu_torch.workflow")


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
    blob = models_to_bytes(models)
    storage.get_model_data_models().insert(Model(instance_id, blob))
    instance = instances.get(instance_id)
    instances.update(replace(instance, status="COMPLETED", end_time=utcnow()))
    log.info("engine instance %s COMPLETED (%d bytes of models)",
             instance_id, len(blob))
    return instance_id


def load_models(
    storage: Storage,
    engine: Engine,
    engine_params: EngineParams,
    instance_id: str,
    ctx: WorkflowContext | None = None,
) -> list[Any]:
    """Restore an instance's models and run per-algorithm deploy prep.

    Raises ModelIntegrityError (utils/durable.py) when the stored blob
    fails its CRC32C frame — a truncated or bit-rotted artifact never
    reaches the unpickler; serve falls back to the previous COMPLETED
    instance on that error."""
    ctx = ctx or create_workflow_context(storage)
    record = storage.get_model_data_models().get(instance_id)
    if record is None:
        raise ValueError(f"no models stored for engine instance {instance_id}")
    models = models_from_bytes(record.models)
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
