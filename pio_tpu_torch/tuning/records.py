"""Durable sweep records — fold checkpoints and the best-params verdict.

Two CRC32C-framed JSON records ride the MODELDATA repository keyed by
the EvaluationInstance id, the same pattern the fleet uses for shard
plans and the rollout controller for verdicts:

  ``<eval-iid>:sweep``        — per-unit (fold / candidate) results,
      written after every completed unit. A killed sweep resumes from
      this record: completed units are never recomputed, which is what
      makes resume's result identical to the uninterrupted run.
  ``<eval-iid>:best_params``  — the winning EngineParams (variant-shaped
      JSON ready for ``engine_params_from_variant``), the score, and
      the metric. ``train --from-eval`` / ``deploy --from-eval``
      consume it (the reference's ``pio doctor`` also compares it against
      what production serves; the port has no doctor verb yet).

All writes go through utils/durable's framing: no raw file writes in
this package. Copy of ``pio_tpu.tuning.records``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from pio_tpu_torch.controller.base import params_to_dict
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.dao import Model
from pio_tpu_torch.utils.durable import ModelIntegrityError, frame, unframe


def sweep_model_id(eval_id: str) -> str:
    return f"{eval_id}:sweep"


def best_params_model_id(eval_id: str) -> str:
    return f"{eval_id}:best_params"


def engine_params_to_variant(ep: EngineParams) -> dict:
    """EngineParams -> the engine.json variant stage shape, so the
    record round-trips through ``Engine.engine_params_from_variant`` and
    comes back TYPED (params_class dataclasses, not raw dicts)."""
    return {
        "datasource": {"name": ep.datasource[0],
                       "params": params_to_dict(ep.datasource[1]) or {}},
        "preparator": {"name": ep.preparator[0],
                       "params": params_to_dict(ep.preparator[1]) or {}},
        "algorithms": [
            {"name": n, "params": params_to_dict(p) or {}}
            for n, p in (ep.algorithms or [])
        ],
        "serving": {"name": ep.serving[0],
                    "params": params_to_dict(ep.serving[1]) or {}},
    }


@dataclass
class SweepState:
    """The sweep's durable progress: ordered unit keys + per-unit result
    payloads. A unit is one crash-safe slice of work — a fold on the
    batched ALS path, a candidate on the sequential fallback."""

    eval_id: str
    spec: dict = field(default_factory=dict)
    units: list[str] = field(default_factory=list)
    completed: dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "eval_id": self.eval_id,
            "spec": self.spec,
            "units": self.units,
            "completed": self.completed,
        }, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "SweepState":
        d = json.loads(text)
        return SweepState(
            eval_id=d["eval_id"], spec=d.get("spec", {}),
            units=list(d.get("units", [])),
            completed=dict(d.get("completed", {})),
        )


def save_sweep_state(storage, state: SweepState) -> None:
    storage.get_model_data_models().insert(Model(
        sweep_model_id(state.eval_id),
        frame(state.to_json().encode("utf-8")),
    ))


def load_sweep_state(storage, eval_id: str) -> SweepState | None:
    rec = storage.get_model_data_models().get(sweep_model_id(eval_id))
    if rec is None:
        return None
    return SweepState.from_json(
        unframe(rec.models, source=sweep_model_id(eval_id))
        .decode("utf-8"))


def save_best_params(storage, eval_id: str, best_ep: EngineParams,
                     score: float, metric: str,
                     engine_id: str = "", engine_version: str = "",
                     engine_variant: str = "",
                     all_scores: list | None = None) -> dict:
    """Persist the sweep's verdict; returns the payload written."""
    payload = {
        "evaluationInstanceId": eval_id,
        "metric": metric,
        "score": None if score != score else score,   # NaN -> null
        "engineId": engine_id,
        "engineVersion": engine_version,
        "engineVariant": engine_variant,
        "variant": engine_params_to_variant(best_ep),
        "allScores": all_scores or [],
    }
    storage.get_model_data_models().insert(Model(
        best_params_model_id(eval_id),
        frame(json.dumps(payload, sort_keys=True).encode("utf-8")),
    ))
    return payload


def load_best_params(storage, eval_id: str) -> dict | None:
    """The ``:best_params`` payload, or None when the eval never
    finished a sweep. Raises ModelIntegrityError on a corrupt frame —
    --from-eval must fail loudly, never train on garbage params."""
    rec = storage.get_model_data_models().get(best_params_model_id(eval_id))
    if rec is None:
        return None
    return json.loads(
        unframe(rec.models, source=best_params_model_id(eval_id))
        .decode("utf-8"))


def latest_best_params(storage):
    """-> (EvaluationInstance, payload) for the newest EVALCOMPLETED
    instance carrying a readable best-params record, or None. Corrupt
    records are SKIPPED, newest-first — the ONE scan the doctor's
    eval row and --from-eval latest both ride."""
    dao = storage.get_metadata_evaluation_instances()
    for inst in dao.get_completed():
        try:
            payload = load_best_params(storage, inst.id)
        except ModelIntegrityError:
            continue   # corrupt record: keep looking, newest-first
        if payload is not None:
            return inst, payload
    return None


def resolve_from_eval(storage, eval_id: str) -> tuple[str, dict]:
    """-> (eval instance id, best-params payload) for --from-eval.
    ``eval_id`` may be a concrete EvaluationInstance id or "latest"
    (the most recent EVALCOMPLETED instance carrying a record)."""
    if eval_id != "latest":
        payload = load_best_params(storage, eval_id)
        if payload is None:
            inst = storage.get_metadata_evaluation_instances().get(eval_id)
            detail = ("no such evaluation instance" if inst is None
                      else f"instance status is {inst.status} and no "
                           "best-params record was persisted")
            raise ValueError(
                f"--from-eval {eval_id}: no best-params record "
                f"({detail}; run `pio eval --sweep` first)")
        return eval_id, payload
    found = latest_best_params(storage)
    if found is None:
        raise ValueError(
            "--from-eval latest: no completed evaluation carries a "
            "best-params record (run `pio eval --sweep` first)")
    return found[0].id, found[1]
