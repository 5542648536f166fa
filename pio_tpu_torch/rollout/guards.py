"""Live rollout guards: the evidence a canary stage must keep green.

Four guards, all computed from traffic the canary actually served (no
offline eval pass — the point of staged exposure is that production
traffic IS the eval set):

  * ``error_rate``  — candidate-arm exceptions per request;
  * ``latency``     — candidate mean latency as a multiple of the
                      active arm's (both arms measured on the same
                      process over the same window, so host noise
                      cancels);
  * ``empty_rate``  — empty or flagged-degraded responses on the
                      candidate arm (a model that converged badly often
                      fails soft: 200s full of nothing);
  * ``divergence``  — score-distribution drift vs the active arm,
                      measured by shadow-scoring a sample of
                      candidate-arm queries on BOTH models and
                      comparing the top-k item sets (1 - Jaccard). A
                      retrain is EXPECTED to move rankings somewhat;
                      the guard catches wholesale disagreement (skewed
                      fold, bad hyperparams, silent data regression).

Every guard stays ``pending`` (green) until its minimum sample count is
reached — a 1% stage on low traffic must not be judged on three
requests. Evaluation is pure (stats in, verdict out) so the controller
can persist the exact evidence that justified a transition.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GuardConfig:
    """Breach thresholds. Defaults are deliberately loose — a canary
    should die for being WRONG, not for p50 jitter on a busy host."""

    max_error_rate: float = 0.05      # candidate errors / requests
    max_latency_ratio: float = 3.0    # candidate mean / active mean
    max_empty_rate: float = 0.25      # empty or degraded / requests
    max_divergence: float = 0.5       # mean (1 - topk Jaccard) vs active
    min_samples: int = 20             # per-arm requests before judging
    min_shadow_samples: int = 10      # shadow pairs before judging

    def to_dict(self) -> dict:
        return {
            "maxErrorRate": self.max_error_rate,
            "maxLatencyRatio": self.max_latency_ratio,
            "maxEmptyRate": self.max_empty_rate,
            "maxDivergence": self.max_divergence,
            "minSamples": self.min_samples,
            "minShadowSamples": self.min_shadow_samples,
        }


class ArmStats:
    """Per-arm request counters for one rollout stage. NOT internally
    locked: the owning RolloutController mutates and reads it under its
    own lock (one lock for the whole decision state, so a guard
    evaluation always sees a consistent snapshot)."""

    def __init__(self) -> None:
        self.requests = 0
        self.errors = 0
        self.empty = 0
        self.latency_total_s = 0.0

    def record(self, latency_s: float, error: bool, empty: bool) -> None:
        self.requests += 1
        if error:
            self.errors += 1
        if empty:
            self.empty += 1
        self.latency_total_s += max(0.0, latency_s)

    @property
    def mean_latency_s(self) -> float:
        return self.latency_total_s / self.requests if self.requests else 0.0

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "errors": self.errors,
            "empty": self.empty,
            "meanLatencySeconds": round(self.mean_latency_s, 6),
        }


class ShadowStats:
    """Divergence accumulator (same locking contract as ArmStats)."""

    def __init__(self) -> None:
        self.samples = 0
        self.divergence_total = 0.0

    def record(self, divergence: float) -> None:
        self.samples += 1
        self.divergence_total += min(1.0, max(0.0, divergence))

    @property
    def mean(self) -> float:
        return self.divergence_total / self.samples if self.samples else 0.0

    def snapshot(self) -> dict:
        return {"samples": self.samples,
                "meanDivergence": round(self.mean, 4)}


def prediction_divergence(a, b) -> float:
    """1 - Jaccard similarity of the two predictions' recommended item
    sets (1.0 = total disagreement). Non-dict / score-less predictions
    compare by equality — engines outside the itemScores shape still
    get a coarse agreement signal."""
    a_items = _item_set(a)
    b_items = _item_set(b)
    if a_items is None or b_items is None:
        return 0.0 if a == b else 1.0
    if not a_items and not b_items:
        return 0.0
    union = a_items | b_items
    return 1.0 - len(a_items & b_items) / len(union)


def _item_set(p) -> set | None:
    if not isinstance(p, dict):
        return None
    scores = p.get("itemScores")
    if not isinstance(scores, list):
        return None
    out = set()
    for s in scores:
        if isinstance(s, dict) and "item" in s:
            out.add(s["item"])
    return out


def is_empty_response(prediction) -> bool:
    """Empty/degraded-response classifier for the ``empty_rate`` guard:
    a dict prediction with no itemScores, or one flagged degraded by
    the fleet router's fallback path."""
    if not isinstance(prediction, dict):
        return False
    if prediction.get("degraded"):
        return True
    if "itemScores" in prediction:
        return not prediction["itemScores"]
    return False


def evaluate_guards(active: ArmStats, candidate: ArmStats,
                    shadow: ShadowStats,
                    config: GuardConfig) -> tuple[bool, dict]:
    """-> (all green, per-guard evidence). Pure: the caller holds its
    lock and passes consistent stats. Each guard's evidence carries
    ok/value/threshold (+ pending while under-sampled) so a breach
    verdict persisted to the rollout record is self-explanatory."""
    evidence: dict = {}

    judged = candidate.requests >= config.min_samples
    err = (candidate.errors / candidate.requests
           if candidate.requests else 0.0)
    evidence["error_rate"] = {
        "ok": (not judged) or err <= config.max_error_rate,
        "value": round(err, 4), "threshold": config.max_error_rate,
        "pending": not judged,
    }

    lat_judged = (judged and active.requests >= config.min_samples
                  and active.mean_latency_s > 0)
    ratio = (candidate.mean_latency_s / active.mean_latency_s
             if lat_judged else 0.0)
    evidence["latency"] = {
        "ok": (not lat_judged) or ratio <= config.max_latency_ratio,
        "value": round(ratio, 3), "threshold": config.max_latency_ratio,
        "pending": not lat_judged,
    }

    empty = (candidate.empty / candidate.requests
             if candidate.requests else 0.0)
    evidence["empty_rate"] = {
        "ok": (not judged) or empty <= config.max_empty_rate,
        "value": round(empty, 4), "threshold": config.max_empty_rate,
        "pending": not judged,
    }

    div_judged = shadow.samples >= config.min_shadow_samples
    evidence["divergence"] = {
        "ok": (not div_judged) or shadow.mean <= config.max_divergence,
        "value": round(shadow.mean, 4),
        "threshold": config.max_divergence,
        "pending": not div_judged,
    }

    return all(g["ok"] for g in evidence.values()), evidence
