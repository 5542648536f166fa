"""Resolve the persisted factor model of an engine instance.

Counterpart of ``resolve_fleet_model`` in ``pio_tpu.serving_fleet.fleet``,
copied on its own: the reference module imports the fleet router and the
shard servers at module level, and the port has neither yet.
"""

from __future__ import annotations

import dataclasses

import torch

from pio_tpu_torch.workflow.checkpoint import models_from_bytes


def resolve_fleet_model(storage, engine_id: str, engine_version: str = "1",
                        engine_variant: str = "default",
                        instance_id: str | None = None, device=None):
    """-> (EngineInstance, factor model) from the persisted blob — the
    RAW persisted model (host numpy), with no algorithm deploy-prep. With
    ``device``, the model's factor tables come back as f32 tensors on
    that device (the blob's leaves may be numpy or tensors of any
    device)."""
    from pio_tpu_torch.rollout.state import latest_eligible_completed

    instances = storage.get_metadata_engine_instances()
    if instance_id:
        instance = instances.get(instance_id)
        if instance is None:
            raise ValueError(f"Engine instance {instance_id} not found")
    else:
        # rollout-eligibility gates auto-resolution (rolled-back /
        # in-flight canaries are skipped); explicit pins don't fall
        # under it — the operator asked for THAT instance
        instance = latest_eligible_completed(
            storage, engine_id, engine_version, engine_variant)
        if instance is None:
            raise ValueError(
                f"No COMPLETED engine instance found for engine "
                f"{engine_id} {engine_version} {engine_variant}. "
                "Run train first."
            )
    record = storage.get_model_data_models().get(instance.id)
    if record is None:
        raise ValueError(f"no models stored for engine instance "
                         f"{instance.id}")
    models = models_from_bytes(record.models)
    if len(models) != 1:
        raise ValueError(
            f"fleet serving supports single-algorithm factor engines; "
            f"instance {instance.id} has {len(models)} models"
        )
    model = models[0]
    if device is not None:
        factors = model.factors
        model = dataclasses.replace(model, factors=dataclasses.replace(
            factors,
            user_factors=_on(factors.user_factors, device),
            item_factors=_on(factors.item_factors, device)))
    return instance, model


def _on(table, device) -> torch.Tensor:
    return torch.as_tensor(table).to(device, torch.float32)
