"""Rollout records: the durable verdict on every canaried instance.

A rollout's lifecycle state is recorded in the MODELDATA repository
alongside the candidate EngineInstance's own blob (the same pattern the
fleet uses for shard plans, serving_fleet/plan.py):

  ``<instance>:rollout`` — JSON (CRC32C-framed via utils/durable) with
  the stage ladder, the current stage, the verdict
  (in-flight | PROMOTED | ROLLED_BACK), the reason, and the guard
  evidence that justified the last transition.

The record is what makes rollback STICK: ``serve``'s instance
resolution, the fleet's ``partitioned_instances``, and the fold-in
worker's model refresh all consult ``is_auto_advance_eligible`` before
auto-advancing onto a newer COMPLETED instance — a ROLLED_BACK
instance (or one whose canary is still in flight in another process)
is skipped, so no reload/restart can quietly re-serve a model the
guards already rejected. Operators can still pin a rolled-back
instance explicitly (``--engine-instance-id``); the record blocks only
AUTOMATIC advancement.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field

from pio_tpu_torch.utils.durable import ModelIntegrityError, frame, unframe
from pio_tpu_torch.utils.time import format_time, utcnow

log = logging.getLogger("pio_tpu_torch.rollout")

VERDICT_IN_FLIGHT = "IN_FLIGHT"
VERDICT_PROMOTED = "PROMOTED"
VERDICT_ROLLED_BACK = "ROLLED_BACK"


def rollout_model_id(instance_id: str) -> str:
    return f"{instance_id}:rollout"


@dataclass
class RolloutRecord:
    """One canaried instance's durable rollout state (see module doc)."""

    instance_id: str                 # the candidate being rolled out
    baseline_instance_id: str        # last-good active at begin time
    stages: tuple[int, ...]          # the pct ladder, e.g. (1, 5, 25, 100)
    stage_pct: int                   # current/final canary percentage
    verdict: str                     # IN_FLIGHT | PROMOTED | ROLLED_BACK
    reason: str = ""                 # operator/guard justification
    evidence: dict = field(default_factory=dict)  # guard snapshot
    updated: str = ""                # ISO time of the last transition

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "RolloutRecord":
        d = json.loads(text)
        return RolloutRecord(
            instance_id=d["instance_id"],
            baseline_instance_id=d["baseline_instance_id"],
            stages=tuple(int(s) for s in d["stages"]),
            stage_pct=int(d["stage_pct"]),
            verdict=d["verdict"],
            reason=d.get("reason", ""),
            evidence=d.get("evidence", {}),
            updated=d.get("updated", ""),
        )


def save_transition(storage, model_id: str, record):
    """The shared transition writer: stamp ``updated``, frame, upsert —
    the one durability discipline every controller-style state machine
    (rollout records here, the fleet's reshard records in
    serving_fleet/reshard.py) persists its transitions through. The
    record needs only a mutable ``updated`` attribute and ``to_json``."""
    from pio_tpu_torch.data.dao import Model

    record.updated = format_time(utcnow())
    storage.get_model_data_models().insert(Model(
        model_id, frame(record.to_json().encode("utf-8"))))
    return record


def save_record(storage, record: RolloutRecord) -> RolloutRecord:
    """Persist (upsert) the record, CRC32C-framed; stamps `updated`.
    This is the ONLY writer of rollout state — controller transitions
    call it, nothing else does (the `rollout-state` lint rule keeps it
    that way)."""
    return save_transition(storage, rollout_model_id(record.instance_id),
                           record)


def load_record(storage, instance_id: str) -> RolloutRecord | None:
    """The instance's rollout record, or None when it was never
    canaried. Raises ModelIntegrityError on a corrupt record blob."""
    rec = storage.get_model_data_models().get(rollout_model_id(instance_id))
    if rec is None:
        return None
    return RolloutRecord.from_json(
        unframe(rec.models, source=rollout_model_id(instance_id))
        .decode("utf-8"))


def is_auto_advance_eligible(storage, instance_id: str) -> bool:
    """May serve/fleet/fold-in AUTO-advance onto this instance?

    Eligible: never canaried (no record) or PROMOTED. Not eligible:
    ROLLED_BACK (the guards rejected it — permanently), IN_FLIGHT (its
    canary is still being judged; a restart mid-canary must stay on the
    baseline, not jump to 100% of the thing under test), or a corrupt
    record (fail safe: if we cannot read the verdict, assume the worst).
    """
    try:
        record = load_record(storage, instance_id)
    except ModelIntegrityError as e:
        log.error("rollout record for instance %s is corrupt (%s); "
                  "treating it as NOT eligible", instance_id, e)
        return False
    return record is None or record.verdict == VERDICT_PROMOTED


def rollback_abandoned(storage, engine_id: str, engine_version: str,
                       engine_variant: str,
                       reason: str) -> RolloutRecord | None:
    """Conclude an ORPHANED canary: the newest IN_FLIGHT record among
    the engine's COMPLETED instances is flipped to ROLLED_BACK (and
    returned), or None when nothing is in flight. A serving process
    that crashes mid-canary leaves an IN_FLIGHT record no controller
    owns anymore — it correctly blocks auto-advance (a restart must not
    jump to 100% of the thing under test), but without this the
    operator could never conclude it: ``pio rollback`` against a fresh
    process answered "no rollout in flight" forever."""
    import dataclasses

    instances = storage.get_metadata_engine_instances()
    for inst in instances.get_completed(engine_id, engine_version,
                                        engine_variant):
        try:
            record = load_record(storage, inst.id)
        except ModelIntegrityError:
            continue        # corrupt record: already not eligible
        if record is not None and record.verdict == VERDICT_IN_FLIGHT:
            return save_record(storage, dataclasses.replace(
                record, verdict=VERDICT_ROLLED_BACK, reason=reason))
    return None


def eligible_completed(storage, engine_id: str, engine_version: str,
                       engine_variant: str) -> list:
    """COMPLETED instances auto-advance may consider, newest first —
    ``get_completed`` minus rolled-back / in-flight canaries."""
    instances = storage.get_metadata_engine_instances()
    return [
        i for i in instances.get_completed(engine_id, engine_version,
                                           engine_variant)
        if is_auto_advance_eligible(storage, i.id)
    ]


def latest_eligible_completed(storage, engine_id: str, engine_version: str,
                              engine_variant: str):
    out = eligible_completed(storage, engine_id, engine_version,
                             engine_variant)
    return out[0] if out else None
