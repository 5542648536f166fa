"""Step-boundary bookkeeping for the iterative trainers.

Counterpart of ``pio_tpu.workflow.spans``. The reference's trainers scan
spans of steps on the device, and ``span_bounds`` cuts those spans so
that each ends right after a save-eligible step. The port's trainer
(models/sequence.py) updates one step at a time, so every step ends a
span: it calls ``after_span(step + 1, ...)`` after each update, and
``span_bounds`` has no counterpart here.
"""

from __future__ import annotations

from pio_tpu_torch.parallel.distributed import any_process
from pio_tpu_torch.resilience import chaos


def step_chaos_active() -> bool:
    """True when a `train.step` chaos spec is live. The reference's
    trainers then degrade their spans to single steps so that a
    `train.step.<n>` fault fires at exactly step n; the port's steps
    are single already, and the trainer asks only so that the chaos
    point costs nothing when chaos is off."""
    return chaos.watches("train.step")


def after_span(
    hi: int,
    total_steps: int,
    params,
    opt_state,
    *,
    checkpoint,
    lifecycle,
    save_after: bool,
    step_chaos: bool,
) -> None:
    """Bookkeeping after step ``hi - 1``, in the reference's order:

      1. the `train.step.<hi-1>` chaos point (the kill-at-step hook);
      2. the cadence save (only save-eligible steps reach maybe_save);
      3. preemption: force-save the current step when it is off-cadence,
         then raise TrainingPreempted (via lifecycle.check_preemption).
         With several processes the flag is OR-reduced across them
         first (``any_process``): a SIGTERM often lands on one process
         only, and every process must agree to stop before any does;
      4. the heartbeat.

    ``params`` and ``opt_state`` are whatever the checkpointer saves (the
    port passes the encoder and its optimizer)."""
    if step_chaos:
        chaos.maybe_inject(f"train.step.{hi - 1}")
    if save_after:
        checkpoint.maybe_save(hi - 1, params, opt_state)
    if lifecycle is not None:
        if any_process(lifecycle.preempted()):
            if checkpoint is not None and not save_after:
                checkpoint.save(hi - 1, params, opt_state)
            lifecycle.check_preemption(hi - 1, force=True)  # raises
        lifecycle.heartbeat(hi - 1, total_steps)
