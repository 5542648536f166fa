"""Mid-train step checkpoints with resume.

Counterpart of ``pio_tpu.workflow.orbax_ckpt`` (the port has no orbax).
A checkpoint holds {model state dict, optimizer state dict, step}, moved
to the CPU and serialized with ``torch.save``; it is written with
``utils/durable.durable_write`` (CRC32C frame, tmp file + fsync +
rename), so a file named by a step number is always a whole step and a
torn write is only ever a tmp file. Training saves every ``save_every``
steps and, on restart, resumes from the latest step with an identical
batch stream (batches are keyed by (seed, step), so a resumed run
reproduces the uninterrupted one).

Restore reads with ``torch.load(..., weights_only=True)`` and loads the
state into the caller's model and optimizer, which puts it back on their
device. Saves are synchronous: ``close`` has nothing to drain.

Several processes (``parallel/distributed.py``) save as the reference's
orbax manager does there: every process calls ``save`` at the same
step, the primary alone writes the whole state, and every process then
passes a barrier, which it reaches also when its save raised, so a
failing writer does not leave its peers waiting. A model whose params
are sharded over the ranks (a tensor-parallel one) gives the whole state
through ``gathered_state(optimizer)`` (a collective every rank calls)
and takes its own shard back from the whole state through
``load_gathered_state(model_state, optimizer_state, optimizer)``; every
process restores from the same file (a directory all of them see).
"""

from __future__ import annotations

import io
import logging
import os
import time
from dataclasses import dataclass

import torch

from pio_tpu_torch.parallel.distributed import barrier, is_primary
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.utils.durable import durable_read, durable_write

log = logging.getLogger("pio_tpu_torch.workflow")


@dataclass(frozen=True)
class StepCheckpointConfig:
    directory: str
    save_every: int = 100       # save cadence in steps
    max_to_keep: int = 3


def _to_cpu(obj):
    """Tensors of a (nested) state dict, on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class StepCheckpointer:
    """Step checkpoints of a ``torch.nn.Module`` and its optimizer in one
    directory: one file per saved step, named by the step number, the
    newest ``max_to_keep`` kept."""

    def __init__(self, config: StepCheckpointConfig):
        self.config = config
        self.directory = os.path.abspath(config.directory)
        # the newest step saved, kept in memory: every process decides
        # the cadence alike, without listing a directory the primary may
        # be writing
        self._latest = self.latest_step()

    def _steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def maybe_save(self, step: int, model, optimizer) -> bool:
        """Save if the cadence says so: ``step`` a multiple of
        ``save_every`` and newer than the latest saved step."""
        if step % max(1, self.config.save_every) or (
                self._latest is not None and step <= self._latest):
            return False
        return self.save(step, model, optimizer)

    def save(self, step: int, model, optimizer) -> bool:
        """Save unconditionally — the preemption path's final checkpoint
        at the interrupted step, regardless of cadence. With several
        processes every one calls it; the primary writes, and all pass
        the barrier after."""
        t0 = time.perf_counter()
        if hasattr(model, "gathered_state"):
            model_state, opt_state = model.gathered_state(optimizer)
        else:
            model_state, opt_state = model.state_dict(), optimizer.state_dict()
        save_error = None
        try:
            # chaos point: a `train.checkpoint` spec simulates a
            # checkpoint-write fault (full disk, flaky blobstore) —
            # training must surface it, and a later resume must restore
            # the PREVIOUS step
            chaos.maybe_inject("train.checkpoint")
            if is_primary():
                self._write(step, model_state, opt_state, t0)
        except Exception as e:  # noqa: BLE001 - re-raised after the barrier
            save_error = e
        # reached on success AND failure: a process whose save raised must
        # not strand its peers (a no-op in a single process)
        barrier(f"ckpt-save-{step}")
        if save_error is not None:
            raise save_error
        self._latest = step
        return True

    def _write(self, step: int, model_state, opt_state, t0: float) -> None:
        state = {"model": _to_cpu(model_state),
                 "optimizer": _to_cpu(opt_state), "step": int(step)}
        buf = io.BytesIO()
        torch.save(state, buf)
        os.makedirs(self.directory, exist_ok=True)
        durable_write(os.path.join(self.directory, str(step)),
                      buf.getvalue())
        for old in self._steps()[:-max(1, self.config.max_to_keep)]:
            try:
                os.unlink(os.path.join(self.directory, str(old)))
            except FileNotFoundError:
                pass
        log.info("step checkpoint %d saved in %.3f ms (%d bytes)", step,
                 1e3 * (time.perf_counter() - t0), buf.tell())

    def restore(self, model, optimizer, step: int | None = None) -> int:
        """Load a saved step (the latest by default) into ``model`` and
        ``optimizer``, on their device; returns the step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise ValueError(f"no checkpoint in {self.config.directory}")
        raw = durable_read(os.path.join(self.directory, str(step)))
        state = torch.load(io.BytesIO(raw), map_location="cpu",
                           weights_only=True)
        if hasattr(model, "load_gathered_state"):
            model.load_gathered_state(state["model"], state["optimizer"],
                                      optimizer)
        else:
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])

    def close(self) -> None:
        """Nothing to drain: every save is durable when it returns."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def resume_or_init(ckpt: StepCheckpointer | None, model, optimizer) -> int:
    """Restore the latest step into ``model`` and ``optimizer`` when a
    checkpointer with history is given; returns the first step to run
    (0 for a fresh start)."""
    if ckpt is not None and ckpt.latest_step() is not None:
        return ckpt.restore(model, optimizer) + 1  # saved AFTER it ran
    return 0
