"""WorkflowContext — what every DASE stage receives.

Counterpart of ``pio_tpu.workflow.context``: where the JAX package holds a
device ``Mesh`` and a PRNG key, the port holds this process's
``torch.device``, the ``parallel.mesh.Mesh`` of the group's ranks, and
hands out seeded ``torch.Generator``s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from pio_tpu_torch.data.eventstore import EventStore
from pio_tpu_torch.data.storage import Storage, get_storage
from pio_tpu_torch.parallel.mesh import MeshConfig, create_mesh


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


@dataclass
class WorkflowContext:
    storage: Storage
    device: torch.device
    # parallel.mesh.Mesh | None (None = one device); the templates train
    # sharded when it holds more than one rank
    mesh: Any = None
    seed: int = 0
    batch: str = ""
    params: dict = field(default_factory=dict)  # runtime conf (sparkConf slot)
    # training supervision handle (workflow/lifecycle.TrainLifecycle),
    # set by run_train for the extent of a supervised run
    lifecycle: Any = None

    @property
    def event_store(self) -> EventStore:
        return EventStore(self.storage)

    def rng(self) -> torch.Generator:
        """A fresh generator seeded with ``seed`` (the reference's
        ``PRNGKey(seed)``), on the context's device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g


def create_workflow_context(
    storage: Storage | None = None,
    device: "str | torch.device | None" = None,
    seed: int = 0,
    batch: str = "",
    params: dict | None = None,
    mesh_config: MeshConfig | None = None,
    use_mesh: bool = True,
) -> WorkflowContext:
    """A context on ``device`` (CUDA unless the caller asks for the CPU).
    When PIO_TPU_COORDINATOR is set, the process group is joined first
    (``parallel/distributed.py``), and the context's device is then this
    rank's; with ``use_mesh`` the mesh spans every rank of the group."""
    from pio_tpu_torch.parallel.distributed import initialize_distributed

    dev = resolve_device(device)
    initialize_distributed(device=dev)  # no-op unless configured
    mesh = create_mesh(mesh_config, device=dev) if use_mesh else None
    if mesh is not None and mesh.size > 1:
        dev = mesh.device
    return WorkflowContext(
        storage=storage or get_storage(), device=dev, mesh=mesh,
        seed=seed, batch=batch, params=dict(params or {}),
    )
