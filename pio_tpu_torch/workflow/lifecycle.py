"""Training lifecycle supervision: preemption, heartbeats, zombie sweep.

Counterpart of ``pio_tpu.workflow.lifecycle``, copied with its imports
rewritten. The reference's CoreWorkflow has exactly two terminal
transitions — COMPLETED or FAILED — and a killed trainer restarts from
scratch (CoreWorkflow.scala:42-98; SURVEY §5 "No mid-train resume
exists"). Preemption of a training job is routine on shared accelerators,
so the training path gets the same lifecycle rigor as serving:

  * ``PreemptionHandler`` — SIGTERM/SIGINT become a *checkpoint request*
    observed at the next step boundary instead of an immediate death.
    The trainer force-saves, ``run_train`` marks the instance
    INTERRUPTED, and the CLI exits with ``EXIT_PREEMPTED`` (75,
    EX_TEMPFAIL) so supervisors can distinguish "resume me" from a real
    failure.
  * ``TrainLifecycle`` — the per-run supervision handle threaded through
    ``WorkflowContext.lifecycle`` into the iterative trainers: a
    throttled *heartbeat* (the instance's ``progress`` field gains
    {step, total_steps, heartbeat, pid, host}) plus the per-instance
    checkpoint directory the trainers hand to ``StepCheckpointer``.
    Heartbeats are best-effort: a down metadata store must never kill a
    healthy training run.
  * ``sweep_zombies`` — a kill -9'd run leaves an INIT/TRAINING instance
    forever; since deploy's ``get_latest_completed`` contract ignores
    them they are invisible until someone wonders why no model ever
    lands. The sweep transitions instances whose heartbeat went stale to
    FAILED (resumable — their checkpoints survive) and is run by
    ``run_train`` at startup.
  * ``find_resumable`` — resolves ``train --auto-resume``: the most
    recent INTERRUPTED/FAILED instance of the engine triple that still
    has a checkpoint on disk.

Resume correctness rests on the (seed, step)-keyed batch stream of the
sequence trainer (models/sequence.py): a resumed run replays the exact
step sequence, so its final params are bit-identical to an uninterrupted
run on the same device (tests/test_torch_lifecycle.py).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import threading
import time
from dataclasses import replace
from typing import Any

from pio_tpu_torch.controller.base import TrainingInterruption
from pio_tpu_torch.data.dao import EngineInstance, EngineInstancesDAO
from pio_tpu_torch.utils.time import format_time, parse_time, utcnow

log = logging.getLogger("pio_tpu_torch.workflow")

#: sysexits EX_TEMPFAIL — the run was preempted with a checkpoint on
#: disk; `pio train --resume <id>` (or --auto-resume) continues it.
EXIT_PREEMPTED = 75

#: heartbeats older than this mark an INIT/TRAINING instance as a zombie
DEFAULT_STALE_S = 600.0

#: statuses a crashed/preempted run can be resumed from
RESUMABLE_STATUSES = ("INTERRUPTED", "FAILED")


class TrainingPreempted(TrainingInterruption):
    """A preemption signal was honored at a step boundary; the final
    checkpoint (if a checkpointer was active) is on disk."""

    def __init__(self, step: int | None = None):
        at = f"preemption at step {step}" if step is not None else "preemption"
        super().__init__(at)
        self.step = step


class PreemptionHandler:
    """Context manager turning SIGTERM/SIGINT into a cooperative stop
    request (``requested`` Event) for the dynamic extent of a training
    run. A second SIGINT restores Python's default KeyboardInterrupt so
    an operator can still insist. Signal handlers only install from the
    main thread; elsewhere (e.g. a test harness thread) the handler
    degrades to a manually settable Event."""

    def __init__(self) -> None:
        self.requested = threading.Event()
        self.signum: int | None = None
        self._previous: dict[int, Any] = {}

    def _handle(self, signum, frame) -> None:
        if signum == signal.SIGINT and self.requested.is_set():
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        self.signum = signum
        self.requested.set()
        log.warning(
            "received %s: requesting checkpoint + stop at the next step "
            "boundary (send SIGINT again to abort immediately)",
            signal.Signals(signum).name,
        )

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for signum in (signal.SIGTERM, signal.SIGINT):
                self._previous[signum] = signal.signal(signum, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):
                pass
        # pio: lint-ok[attr-no-lock] enter/exit run on the one thread
        # that owns the training run; signal delivery only SETS an Event
        self._previous.clear()


class TrainLifecycle:
    """Per-run supervision handle (``WorkflowContext.lifecycle``).

    Trainers call ``heartbeat(step, total)`` and ``check_preemption(step)``
    at step/span boundaries; ``checkpoint_dir`` is the per-instance
    directory algorithms hand to ``StepCheckpointer`` when their params
    do not pin one explicitly.
    """

    def __init__(
        self,
        instances: EngineInstancesDAO,
        instance: EngineInstance,
        checkpoint_dir: str = "",
        heartbeat_every_steps: int = 10,
        heartbeat_min_interval_s: float = 2.0,
        preemption: PreemptionHandler | None = None,
        readonly: bool = False,
        liveness_interval_s: float = 60.0,
    ):
        self.instances = instances
        self.instance = instance
        self.checkpoint_dir = checkpoint_dir
        self.heartbeat_every_steps = max(1, heartbeat_every_steps)
        self.heartbeat_min_interval_s = heartbeat_min_interval_s
        self.preemption = preemption
        # a readonly lifecycle tracks progress and observes preemption
        # requests but writes no metadata (the reference's non-primary
        # hosts; the port runs one process)
        self.readonly = readonly
        # wall-clock liveness floor: step heartbeats only fire at span
        # boundaries, which on big models can be further apart than the
        # zombie-stale threshold — a background thread re-stamps the
        # heartbeat so a healthy mid-span run is never swept. 0 = off.
        self.liveness_interval_s = liveness_interval_s
        self.last_step: int | None = None
        self._last_beat = 0.0
        self._last_written_step: int | None = None
        self._lock = threading.Lock()   # training thread vs beat thread
        self._stop_beat = threading.Event()
        self._beat_thread: threading.Thread | None = None

    # -- heartbeat -----------------------------------------------------------
    def heartbeat(self, step: int, total_steps: int | None = None,
                  force: bool = False) -> bool:
        """Record training progress on the instance. The local snapshot
        updates on every call (so the terminal COMPLETED/FAILED record
        carries the true last step); the STORE write is throttled by
        step cadence AND wall time, and is best-effort — losing a
        heartbeat must not lose the run."""
        with self._lock:
            self.last_step = step
            progress = dict(self.instance.progress)
            progress.update(
                step=step,
                heartbeat=format_time(utcnow()),
                pid=os.getpid(),
                host=socket.gethostname(),
            )
            if total_steps is not None:
                progress["total_steps"] = total_steps
            if self.checkpoint_dir:
                progress["checkpoint_dir"] = self.checkpoint_dir
            self.instance = replace(self.instance, progress=progress)
            now = time.monotonic()
            # throttle by steps SINCE THE LAST WRITTEN beat, not by step
            # modulo: trainers only call at span boundaries (checkpoint-
            # aligned), and a cadence that never lands on a modulo-of-N
            # step would starve the store of beats — a healthy run would
            # read as a zombie and get swept mid-flight
            if not force and (
                (self._last_written_step is not None
                 and step - self._last_written_step
                 < self.heartbeat_every_steps)
                or now - self._last_beat < self.heartbeat_min_interval_s
            ):
                return False
            if self.readonly:
                return False
            self._last_beat = now
            self._last_written_step = step
            snapshot = self.instance
        try:
            # pio: lint-ok[attr-no-lock] DAO call, not local mutation:
            # the store write runs outside _lock on purpose (no I/O
            # under the lock); DAOs are thread-safe, and last-writer-
            # wins between beats is harmless
            self.instances.update(snapshot)
        except Exception:  # noqa: BLE001 - heartbeat is best-effort
            log.warning("heartbeat for instance %s failed (store down?)",
                        snapshot.id, exc_info=True)
            return False
        return True

    # -- wall-clock liveness beat --------------------------------------------
    def start(self) -> None:
        """Start the background liveness thread (no-op when readonly or
        disabled): re-stamps the heartbeat timestamp every
        ``liveness_interval_s`` so the zombie sweep never mistakes a
        healthy run mid-long-span for a crash."""
        if self.readonly or self.liveness_interval_s <= 0:
            return
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="train-liveness", daemon=True
        )
        self._beat_thread.start()

    def stop(self) -> None:
        self._stop_beat.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=5.0)
            self._beat_thread = None

    def _beat_loop(self) -> None:
        while not self._stop_beat.wait(self.liveness_interval_s):
            with self._lock:
                progress = dict(self.instance.progress)
                progress["heartbeat"] = format_time(utcnow())
                self.instance = replace(self.instance, progress=progress)
                snapshot = self.instance
            try:
                # pio: lint-ok[attr-no-lock] DAO call outside _lock by
                # design (no I/O under the lock); see heartbeat()
                self.instances.update(snapshot)
            except Exception:  # noqa: BLE001 - liveness is best-effort
                log.warning("liveness beat for instance %s failed",
                            snapshot.id, exc_info=True)

    # -- preemption ----------------------------------------------------------
    def preempted(self) -> bool:
        return self.preemption is not None and self.preemption.requested.is_set()

    def check_preemption(self, step: int, force: bool = False) -> None:
        """Raise TrainingPreempted when a stop was requested. Trainers
        call this AFTER force-saving their checkpoint at the boundary.
        ``force`` stops without consulting the handler (spans.after_span
        passes it once it has seen the request)."""
        if force or self.preempted():
            self.heartbeat(step, force=True)
            raise TrainingPreempted(step)


def checkpoint_dir_for(instance_id: str, root: str | None = None) -> str:
    """Per-instance step-checkpoint directory: keyed by EngineInstance.id
    so `--resume <id>` finds exactly its own run's steps. Root resolves
    `root` arg -> $PIO_TPU_CKPT_ROOT -> $PIO_TPU_HOME/checkpoints."""
    root = root or os.environ.get("PIO_TPU_CKPT_ROOT") or os.path.join(
        os.environ.get(
            "PIO_TPU_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu")
        ),
        "checkpoints",
    )
    return os.path.join(root, instance_id.replace("/", "_"))


def has_checkpoint(directory: str) -> bool:
    """True when `directory` holds at least one saved step (cheap listing
    check: a step file is named by its number, and a torn write's tmp
    file never is — workflow/step_checkpoint.py)."""
    try:
        return any(name.isdigit() for name in os.listdir(directory))
    except OSError:
        return False


def _heartbeat_age_s(instance: EngineInstance, now) -> float:
    """Seconds since the instance last proved liveness: its heartbeat
    stamp, else its start_time (pre-heartbeat instances and runs that
    died before the first beat)."""
    stamp = instance.progress.get("heartbeat") if instance.progress else None
    ts = None
    if stamp:
        try:
            ts = parse_time(stamp)
        except (ValueError, TypeError):
            ts = None
    if ts is None:
        ts = instance.start_time
    if ts is None:
        return float("inf")
    return (now - ts).total_seconds()


def sweep_zombies(
    storage,
    stale_after_s: float = DEFAULT_STALE_S,
    now=None,
) -> list[EngineInstance]:
    """Transition stale INIT/TRAINING instances to FAILED (resumable).

    A kill -9'd trainer leaves its instance in-flight forever; deploy's
    get_latest_completed ignores it, so nothing ever surfaces the loss.
    The sweep makes the crash explicit and the run resumable. Returns
    the instances it transitioned.
    """
    instances = storage.get_metadata_engine_instances()
    now = now or utcnow()
    swept: list[EngineInstance] = []
    for inst in instances.get_all():
        if inst.status not in ("INIT", "TRAINING"):
            continue
        age = _heartbeat_age_s(inst, now)
        if age < stale_after_s:
            continue
        progress = dict(inst.progress)
        progress.update(
            zombie=True,
            swept_at=format_time(now),
            stale_for_s=round(age, 1),
        )
        updated = replace(
            inst, status="FAILED", end_time=now, progress=progress
        )
        try:
            instances.update(updated)
        except Exception:  # noqa: BLE001 - sweep is advisory
            log.warning("zombie sweep could not update instance %s",
                        inst.id, exc_info=True)
            continue
        log.warning(
            "zombie sweep: instance %s (%s) heartbeat stale for %.0fs -> "
            "FAILED (resumable)", inst.id, inst.status, age,
        )
        swept.append(updated)
    return swept


def find_resumable(
    instances: EngineInstancesDAO,
    engine_id: str,
    engine_version: str,
    engine_variant: str,
    checkpoint_root: str | None = None,
) -> EngineInstance | None:
    """The most recent INTERRUPTED/FAILED instance of the engine triple
    whose checkpoint directory still holds steps (for --auto-resume)."""
    candidates = [
        i for i in instances.get_all()
        if i.status in RESUMABLE_STATUSES
        and (i.engine_id, i.engine_version, i.engine_variant)
        == (engine_id, engine_version, engine_variant)
    ]
    candidates.sort(key=lambda i: i.start_time, reverse=True)
    for inst in candidates:
        ckpt_dir = (inst.progress or {}).get("checkpoint_dir") or \
            checkpoint_dir_for(inst.id, checkpoint_root)
        if has_checkpoint(ckpt_dir):
            return inst
    return None
