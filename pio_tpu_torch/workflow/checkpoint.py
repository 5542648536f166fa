"""Model persistence.

Counterpart of ``pio_tpu.workflow.checkpoint``: tensors inside a model are
pulled to host numpy and the model list is pickled inside the same CRC32C
``durable.frame`` envelope, so a blob written by either package carries
the same integrity check. Restore hands back numpy leaves; each
algorithm's ``prepare_model_for_deploy`` moves them onto the device.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any

import torch

from pio_tpu_torch.utils.durable import ModelIntegrityError, frame, unframe

__all__ = [
    "ModelIntegrityError", "host_copy", "models_from_bytes",
    "models_to_bytes",
]


def host_copy(model: Any) -> Any:
    """Map tensor leaves to numpy through dataclasses, lists, tuples and
    dicts (the containers a port model is built from); other objects are
    returned untouched. Dataclasses are rebuilt from their init fields, so
    attributes set outside them (caches) are dropped."""
    if isinstance(model, torch.Tensor):
        return model.detach().cpu().numpy()
    if dataclasses.is_dataclass(model) and not isinstance(model, type):
        return type(model)(**{
            f.name: host_copy(getattr(model, f.name))
            for f in dataclasses.fields(model) if f.init
        })
    if isinstance(model, (list, tuple)):
        return type(model)(host_copy(x) for x in model)
    if isinstance(model, dict):
        return {k: host_copy(v) for k, v in model.items()}
    return model


def models_to_bytes(models: list[Any]) -> bytes:
    """Pickle + CRC32C-frame (utils/durable.py)."""
    buf = io.BytesIO()
    pickle.dump([host_copy(m) for m in models], buf, protocol=5)
    return frame(buf.getvalue())


def models_from_bytes(data: bytes) -> list[Any]:
    """Verify + unpickle. Raises ModelIntegrityError when a framed blob
    fails its checksum."""
    return pickle.loads(unframe(data, source="model blob"))
