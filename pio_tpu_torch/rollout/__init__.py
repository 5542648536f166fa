"""Guarded model rollout: canary traffic splitting, live divergence
guards, and one-command instant rollback — the port's copy of the
reference package (``split.py``, ``guards.py``, ``controller.py`` and
``state.py`` verbatim but for their imports).

A candidate EngineInstance is loaded ALONGSIDE the active one on the
deploy server (``workflow/serve.py QueryServer``), traffic splits
deterministically (``crc32c(user) % 100``, sticky per user), ramp
stages advance only while live guards stay green, and any breach — or
``python -m pio_tpu_torch rollback`` — reverts 100% of traffic
atomically and records a durable ROLLED_BACK verdict that the deploy's
reloads and the fold-in worker respect forever after.
"""

from pio_tpu_torch.rollout.controller import (
    ARM_ACTIVE,
    ARM_CANDIDATE,
    DEFAULT_STAGES,
    CandidateLoadError,
    RolloutConfig,
    RolloutController,
    RolloutGuardBreach,
    install_rollout_routes,
)
from pio_tpu_torch.rollout.guards import (
    ArmStats,
    GuardConfig,
    ShadowStats,
    evaluate_guards,
    is_empty_response,
    prediction_divergence,
)
from pio_tpu_torch.rollout.split import canary_bucket, in_canary
from pio_tpu_torch.rollout.state import (
    VERDICT_IN_FLIGHT,
    VERDICT_PROMOTED,
    VERDICT_ROLLED_BACK,
    RolloutRecord,
    eligible_completed,
    is_auto_advance_eligible,
    latest_eligible_completed,
    load_record,
    rollout_model_id,
    save_record,
)

__all__ = [
    "ARM_ACTIVE", "ARM_CANDIDATE", "DEFAULT_STAGES", "ArmStats",
    "CandidateLoadError", "GuardConfig", "RolloutConfig",
    "RolloutController", "RolloutGuardBreach", "RolloutRecord",
    "ShadowStats", "VERDICT_IN_FLIGHT", "VERDICT_PROMOTED",
    "VERDICT_ROLLED_BACK", "canary_bucket", "eligible_completed",
    "evaluate_guards", "in_canary", "install_rollout_routes",
    "is_auto_advance_eligible", "is_empty_response",
    "latest_eligible_completed", "load_record", "prediction_divergence",
    "rollout_model_id", "save_record",
]
