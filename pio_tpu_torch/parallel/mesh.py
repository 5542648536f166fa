"""The mesh of ranks a sharded trainer runs over.

Counterpart of ``pio_tpu.parallel.mesh``. The JAX package lays a
``jax.sharding.Mesh`` over devices, with the axes "data" (batch and
entity sharding), "seq" (sequence parallelism) and "model" (factor and
feature sharding), and XLA compiles the collectives. The port's devices
are the ranks of the ``torch.distributed`` group, one device each
(``parallel/distributed.py``), and its ``Mesh`` is a small record of
them: the shape by axis, this rank and its device, with the two
collectives the sharded trainer calls (``psum`` and a tiled
``all_gather``), the counterparts of ``jax.lax.psum`` and
``jax.lax.all_gather(..., tiled=True)`` over the data axis.

Only the data axis is ported: a seq or model axis above 1 raises (ROADMAP
A5). ``data_sharding``, ``replicated``, ``shard_batch`` and ``replicate``
are JAX placements (``NamedSharding``, ``device_put``) with no
counterpart here: a rank holds its own block as a plain tensor.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pio_tpu_torch.parallel.distributed import rank_device

log = logging.getLogger("pio_tpu_torch.parallel")

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshConfig:
    """Mesh shape: data-parallel x sequence-parallel x model-parallel.
    -1 = use all remaining. The seq axis carries ring/all-to-all sequence
    parallelism (ops/attention.py); it is 1 for the non-sequence templates."""

    data: int = -1
    seq: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        model = self.model if self.model > 0 else 1
        seq = self.seq if self.seq > 0 else 1
        data = self.data if self.data > 0 else n_devices // (model * seq)
        if data * seq * model > n_devices:
            raise ValueError(
                f"mesh {data}x{seq}x{model} needs {data * seq * model} "
                f"devices, have {n_devices}"
            )
        return data, seq, model


@dataclass(frozen=True, eq=False)
class Mesh:
    """Every rank of the process group on the data axis. ``shape`` maps
    each axis to its size, as the reference's ``Mesh.shape`` does;
    ``rank`` is this process's index on the data axis and ``device`` its
    device."""

    shape: dict         # {DATA_AXIS: n, SEQ_AXIS: 1, MODEL_AXIS: 1}
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``x`` over every rank (a new tensor; at
        one rank ``x`` itself)."""
        if self.size == 1:
            return x
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in rank order (at one
        rank ``x`` itself). Every rank must pass the same shape."""
        if self.size == 1:
            return x
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather(list(out.chunk(self.size)), x.contiguous())
        return out


def create_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """The mesh over every rank of the group (one rank when no group was
    joined). ``device`` is what the caller asked for ("cpu", "cuda" or
    None): the mesh's device is this rank's, ``distributed.rank_device``.
    A single process that sees several cards trains on one and logs how
    many it leaves idle."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, seq, model = (config or MeshConfig()).resolve(world)
    if seq > 1 or model > 1:
        raise NotImplementedError(
            f"a mesh with seq={seq}, model={model} is not ported; the port "
            "shards the data axis only (ROADMAP A5)")
    if data != world:
        raise ValueError(
            f"a mesh of {data} of the group's {world} ranks needs a "
            "subgroup, which is not ported (ROADMAP A5); the data axis "
            "spans every rank")
    if not dist.is_initialized():
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and torch.cuda.device_count() > 1:
            log.warning(
                "one process without a coordinator runs on %s and "
                "leaves %d other card(s) idle; launch one process a card "
                "with PIO_TPU_COORDINATOR, PIO_TPU_NUM_PROCESSES and "
                "PIO_TPU_PROCESS_ID to use them", dev,
                torch.cuda.device_count() - 1)
    else:
        dev = rank_device(rank, device)
    return Mesh({DATA_AXIS: data, SEQ_AXIS: seq, MODEL_AXIS: model}, rank,
                dev)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` of x up to a multiple (XLA wants static, divisible shapes)."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple if n else multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width, constant_values=fill), n
