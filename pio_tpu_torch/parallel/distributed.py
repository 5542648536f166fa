"""Multi-process runtime initialization: the distributed communication
backend's control plane.

Counterpart of ``pio_tpu.parallel.distributed``. The JAX package joins
JAX's multi-controller runtime, after which one process drives every
device of its host. The port follows PyTorch's idiom instead: one
process per rank, each with one device, joined into a
``torch.distributed`` process group. Rank r takes ``cuda:(r %
torch.cuda.device_count())``, or the CPU when the caller asks for it.

Configuration is the reference's, in the storage locator's env-var style:

    PIO_TPU_COORDINATOR   host:port of process 0 (present => multi-process)
    PIO_TPU_NUM_PROCESSES total process count
    PIO_TPU_PROCESS_ID    this process's index

and, the port's own, ``PIO_TPU_COORDINATOR_TIMEOUT_S`` (default 600): a
rank that cannot reach the coordinator within it fails, and so does a
collective that waits longer than that for its peers.

Process 0 holds the coordinator's TCP store (what ``init_method=
"tcp://host:port"`` would create) on that address. Through it every rank
says where it runs before the group is formed: the group uses NCCL when
every rank has a card of its own, and gloo on the CPU or when ranks share
a card (NCCL puts no two ranks on one device; gloo stages CUDA tensors
through the host). A process without a coordinator skips all of this;
every code path works unchanged either way, since a mesh of one rank
needs no collective.
"""

from __future__ import annotations

import atexit
import logging
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

log = logging.getLogger("pio_tpu_torch.parallel")

#: seconds a rank waits for the coordinator, and a collective for its peers
DEFAULT_TIMEOUT_S = 600.0

_initialized = False
_backend = ""


def distributed_env() -> dict | None:
    """Read PIO_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}; None when the
    process is not part of a multi-process job."""
    addr = os.environ.get("PIO_TPU_COORDINATOR")
    if not addr:
        return None
    nproc = os.environ.get("PIO_TPU_NUM_PROCESSES")
    pid = os.environ.get("PIO_TPU_PROCESS_ID")
    env = {"coordinator_address": addr}
    # Completeness is validated on the MERGED args+env config inside
    # initialize_distributed — a launcher may legitimately pass
    # num_processes/process_id as arguments with only the coordinator in env.
    if nproc is not None:
        env["num_processes"] = int(nproc)
    if pid is not None:
        env["process_id"] = int(pid)
    return env


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` runs on: the CPU when ``device`` asks for
    it, else ``cuda:(rank % torch.cuda.device_count())``; raises without
    CUDA, as every entry point of the port does."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _choose_backend(store, rank: int, world: int,
                    dev: torch.device) -> str:
    """NCCL when every rank has a card of its own, else gloo: each rank
    writes its host and device to the store and reads every other's."""
    if dev.type != "cuda":
        return "gloo"
    store.set(f"pio/place/{rank}", f"{socket.gethostname()}/{dev}")
    keys = [f"pio/place/{r}" for r in range(world)]
    store.wait(keys)
    places = {store.get(k) for k in keys}
    return "nccl" if len(places) == world else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join the multi-process group; returns True if initialization ran.

    Arguments fall back to the PIO_TPU_* env vars. Safe to call more than
    once and in a single-process job (both are no-ops). ``device`` is the
    device the caller asked for ("cpu", "cuda" or None, which is CUDA):
    the rank's own device is ``rank_device(process_id, device)``, and on
    CUDA it becomes the process's current device."""
    global _initialized, _backend
    if _initialized:
        return False
    if None not in (coordinator_address, num_processes, process_id):
        env = {}  # fully specified explicitly; env vars are irrelevant
    else:
        env = distributed_env() or {}
    kwargs = {
        "coordinator_address": coordinator_address
        or env.get("coordinator_address"),
        "num_processes": num_processes or env.get("num_processes"),
        "process_id": process_id if process_id is not None
        else env.get("process_id"),
    }
    if kwargs["coordinator_address"] is None:
        return False  # not configured: a single process
    if kwargs["num_processes"] is None or kwargs["process_id"] is None:
        # A coordinator with no process count/index means every host would
        # form its own 1-process "cluster" — fail fast on the merged config.
        raise ValueError(
            "a coordinator address is configured but num_processes/"
            "process_id are not (set PIO_TPU_NUM_PROCESSES/"
            "PIO_TPU_PROCESS_ID or pass them as arguments); all three are "
            "required for a multi-host job"
        )
    world, rank = int(kwargs["num_processes"]), int(kwargs["process_id"])
    host, _, port = kwargs["coordinator_address"].rpartition(":")
    timeout = timedelta(seconds=float(os.environ.get(
        "PIO_TPU_COORDINATOR_TIMEOUT_S", DEFAULT_TIMEOUT_S)))
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timeout, wait_for_workers=True)
        backend = _choose_backend(store, rank, world, dev)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    except RuntimeError as e:  # torch's DistError and its kin
        raise RuntimeError(
            f"process {rank}/{world} could not join the group at "
            f"{kwargs['coordinator_address']} within "
            f"{timeout.total_seconds():g} s: {e}") from e
    _initialized, _backend = True, backend
    atexit.register(_shutdown)
    log.info("joined distributed runtime: process %s/%s via %s on %s "
             "(backend %s)", rank, world, kwargs["coordinator_address"],
             dev, backend)
    return True


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    """The group's backend ("nccl" or "gloo"); "" for a single process."""
    return _backend


def _flag_device() -> torch.device:
    """Where a small collective's tensor lives: NCCL moves CUDA tensors
    only, gloo takes host tensors."""
    if _backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_primary() -> bool:
    """True on process 0 — the process that writes checkpoints/metadata
    (single-controller duties in the multi-controller model)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def any_process(flag: bool) -> bool:
    """OR-reduce a per-process boolean across all processes (identity in a
    single process). Used for the preemption flag: the scheduler may
    SIGTERM only one host's VM, and a host that force-saved while its
    peers kept training would deadlock the save barrier — every process
    must agree to stop before any of them does. Collective: all
    processes must call it at the same point (the trainers do, at span
    boundaries)."""
    if _world() <= 1:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op in a single
    process). ``name`` is logged.

    Used at the final persist: process 0 must not record the run
    COMPLETED until every process has finished its part, and a process
    whose persist failed still reaches it, so no peer waits forever."""
    if _world() <= 1:
        return
    log.debug("barrier %s", name)
    if _backend == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def runtime_info() -> dict:
    """Topology snapshot for `pio status` / logs: the reference's keys.
    Each process drives one device, so the job's devices are its
    processes; ``local_devices`` is what this process can see."""
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": _world(),
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": _world(),
        "platform": "gpu" if cuda else "cpu",
        "distributed": _initialized,
    }
