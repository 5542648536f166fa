"""The mesh of ranks a sharded trainer runs over.

Counterpart of ``pio_tpu.parallel.mesh``. The JAX package lays a
``jax.sharding.Mesh`` over devices, with the axes "data" (batch and
entity sharding), "seq" (sequence parallelism) and "model" (factor and
feature sharding), and XLA compiles the collectives. The port's devices
are the ranks of the ``torch.distributed`` group, one device each
(``parallel/distributed.py``), laid out as the reference lays out its
devices, ``reshape(data, seq, model)``: rank r sits at
``(r // (seq * model), (r // model) % seq, r % model)``.

``Mesh`` is a small record of that layout: the shape by axis, this rank,
its device and its coordinates, with a process group for every line of
the mesh along every set of axes (``create_mesh`` makes them all, on
every rank in the same order, as ``dist.new_group`` wants). Its ``psum``
and tiled ``all_gather`` are the counterparts of ``jax.lax.psum`` and
``jax.lax.all_gather(..., tiled=True)`` over a named axis or a tuple of
axes (every axis when none is named); the differentiable collectives a
trainer calls inside its loss are in ``parallel/collectives.py``.

``data_sharding``, ``replicated``, ``shard_batch`` and ``replicate`` are
JAX placements (``NamedSharding``, ``device_put``) with no counterpart
here: a rank holds its own block as a plain tensor.
"""

from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from pio_tpu_torch.parallel.distributed import rank_device

log = logging.getLogger("pio_tpu_torch.parallel")

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


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


def rank_coords(rank: int, shape: dict) -> tuple[int, int, int]:
    """Rank ``rank``'s (data, seq, model) index: the reference's
    ``reshape(data, seq, model)`` of the device list."""
    seq, model = shape[SEQ_AXIS], shape[MODEL_AXIS]
    return rank // (seq * model), (rank // model) % seq, rank % model


def _line(coords: tuple, shape: dict, axes: tuple) -> list[int]:
    """The global ranks that share ``coords`` off ``axes``, in the order
    of their index along ``axes`` (row-major over the named axes)."""
    sizes = [shape[a] for a in AXES]
    ranges = [range(sizes[i]) if a in axes else (coords[i],)
              for i, a in enumerate(AXES)]
    return [(d * sizes[1] + s) * sizes[2] + m
            for d, s, m in itertools.product(*ranges)]


@dataclass(frozen=True, eq=False)
class Mesh:
    """Every rank of the process group, laid out over the three axes.
    ``shape`` maps each axis to its size, as the reference's
    ``Mesh.shape`` does; ``rank`` is this process's rank in the group,
    ``device`` its device, ``coords`` its (data, seq, model) index.
    ``lines`` holds, for each set of axes (in AXES order) whose line has
    more than one rank, the global ranks of this rank's line and its
    process group (None when the line is the whole group)."""

    shape: dict         # {DATA_AXIS: n, SEQ_AXIS: s, MODEL_AXIS: m}
    rank: int
    device: torch.device
    lines: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> tuple[int, int, int]:
        return rank_coords(self.rank, self.shape)

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[AXES.index(axis)]

    def axis_size(self, axis) -> int:
        """The number of ranks along ``axis`` or a tuple of axes."""
        return math.prod(self.shape[a] for a in self._axes(axis))

    @staticmethod
    def _axes(axis) -> tuple:
        if axis is None:
            return AXES
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(names) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"expected some of {AXES}")
        return tuple(a for a in AXES if a in names)

    def line(self, axis) -> tuple[list[int], object]:
        """(the global ranks of this rank's line along ``axis``, in axis
        order, and its process group); ([rank], None) for a line of one
        rank."""
        axes = self._axes(axis)
        if self.axis_size(axes) == 1:
            return [self.rank], None
        return self.lines[axes]

    def psum(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """The elementwise sum of ``x`` over the ranks of this rank's line
        along ``axis`` (every axis by default): a new tensor, or ``x``
        itself on a line of one rank."""
        if self.axis_size(axis) == 1:
            return x
        _, group = self.line(axis)
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    def all_gather(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """Every ``x`` of this rank's line along ``axis`` (every axis by
        default) stacked along dim 0 in axis order (``x`` itself on a
        line of one rank). Every rank must pass the same shape."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        _, group = self.line(axis)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather(list(out.chunk(n)), x.contiguous(), group=group)
        return out


def _make_lines(rank: int, shape: dict, world: int) -> dict:
    """A process group for every line of the mesh along every set of axes
    with more than one rank, created on every rank in one order (each
    rank joins ``dist.new_group`` for every group, its own or not); ->
    this rank's {axes: (ranks, group)}."""
    groups = {}    # one group for each set of ranks, whatever its axes
    mine = {}
    for k in range(1, len(AXES) + 1):
        for axes in itertools.combinations(AXES, k):
            if math.prod(shape[a] for a in axes) == 1:
                continue
            for r in range(world):
                ranks = tuple(_line(rank_coords(r, shape), shape, axes))
                if ranks not in groups:
                    groups[ranks] = (None if len(ranks) == world
                                     else dist.new_group(list(ranks)))
                if r == rank:
                    mine[axes] = (list(ranks), groups[ranks])
    return mine


def create_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """The mesh over every rank of the group (one rank when no group was
    joined). ``device`` is what the caller asked for ("cpu", "cuda" or
    None): the mesh's device is this rank's, ``distributed.rank_device``.
    A single process that sees several cards trains on one and logs how
    many it leaves idle."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, seq, model = (config or MeshConfig()).resolve(world)
    if data * seq * model != world:
        raise ValueError(
            f"a mesh {data}x{seq}x{model} of {data * seq * model} of the "
            f"group's {world} ranks needs a subgroup, which is not ported "
            "(ROADMAP A5); the mesh spans every rank")
    shape = {DATA_AXIS: data, SEQ_AXIS: seq, MODEL_AXIS: model}
    if not dist.is_initialized():
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and torch.cuda.device_count() > 1:
            log.warning(
                "one process without a coordinator runs on %s and "
                "leaves %d other card(s) idle; launch one process a card "
                "with PIO_TPU_COORDINATOR, PIO_TPU_NUM_PROCESSES and "
                "PIO_TPU_PROCESS_ID to use them", dev,
                torch.cuda.device_count() - 1)
        return Mesh(shape, rank, dev)
    return Mesh(shape, rank, rank_device(rank, device),
                _make_lines(rank, shape, world))


def local_mesh(device) -> Mesh:
    """The mesh of this process alone, every axis 1: a trainer's
    one-device run, whose collectives are identities."""
    return Mesh({a: 1 for a in AXES}, 0, torch.device(device))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` of x up to a multiple (XLA wants static, divisible shapes)."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple if n else multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width, constant_values=fill), n
