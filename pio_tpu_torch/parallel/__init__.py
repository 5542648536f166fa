"""Several ranks: the process group (``distributed``) and the mesh of its
ranks (``mesh``). Counterpart of ``pio_tpu.parallel``, exporting the
reference's names that have a counterpart (``shard_batch`` and
``replicate`` are JAX placements; see ``mesh``)."""

from pio_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    create_mesh,
)

__all__ = [
    "MeshConfig",
    "Mesh",
    "create_mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
]
