"""RolloutController: guarded promotion of a candidate EngineInstance.

The controller owns ONE canary at a time on a serving host (the
single-host ``QueryServer`` or the fleet ``FleetRouter`` — anything
implementing the small host protocol below). It

  1. loads the candidate ALONGSIDE the active model (second model slot
     behind the host's existing swap lock — never a wholesale swap),
  2. splits traffic deterministically (``split.in_canary``: sticky
     ``crc32c(user) % 100``), ramping through configured stages only
     while the live guards (guards.py) stay green,
  3. shadow-scores a sample of candidate-arm queries on the ACTIVE
     model to measure score divergence between the arms,
  4. on ANY guard breach — or an operator ``pio rollback`` — atomically
     reverts 100% of traffic to the active (last-good) instance, and
  5. records every transition durably (state.py: the
     ``<iid>:rollout`` record in MODELDATA), so PROMOTED survives a
     restart and a ROLLED_BACK instance is never auto-advanced onto
     again.

Host protocol (duck-typed; implemented by QueryServer and FleetRouter):

  ``rollout_active_instance_id() -> str``
  ``load_candidate(instance_id)``   — load the second arm; raise on any
                                      failure (nothing swapped)
  ``promote_candidate()``           — candidate becomes the active arm
  ``drop_candidate()``              — discard the candidate arm
  ``shadow_predict(q, arm) -> prediction`` — score `q` on one arm
                                      without recording stats
  attribute ``rollout``             — the attached controller (or None)

Chaos points: ``rollout.guard`` fires inside every guard evaluation (an
injected ConnectionError IS a breach — the drill's lever) and
``rollout.promote`` inside the promote transition.

Concurrency: every stage/verdict write goes through ``_transition``
under ``self._lock`` and persists via ``state.save_record`` (the
``rollout-state`` lint rule enforces both); host mutations
(drop/promote) run OUTSIDE the lock so the controller can never hold
its lock across the host's.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.rollout import state as rstate
from pio_tpu_torch.rollout.guards import (
    ArmStats, GuardConfig, ShadowStats, evaluate_guards, is_empty_response,
    prediction_divergence,
)
from pio_tpu_torch.rollout.split import in_canary

log = logging.getLogger("pio_tpu_torch.rollout")

ARM_ACTIVE = "active"
ARM_CANDIDATE = "candidate"

DEFAULT_STAGES = (1, 5, 25, 100)


class CandidateLoadError(RuntimeError):
    """The candidate could not be loaded on (part of) the serving
    layer; the rollout was auto-rolled-back before ANY traffic hit it."""


class RolloutGuardBreach(RuntimeError):
    """Promote refused: at least one guard is red."""

    def __init__(self, evidence: dict):
        super().__init__(f"guards not green: "
                         f"{[g for g, e in evidence.items() if not e.get('ok')]}")
        self.evidence = evidence


@dataclass
class RolloutConfig:
    """Canary shape. ``stages`` is the ramp ladder; a fixed-pct deploy
    is a one-stage ladder. ``auto`` advances through the ladder
    unattended while guards stay green (promote itself remains an
    explicit command)."""

    stages: tuple[int, ...] = DEFAULT_STAGES
    auto: bool = False
    min_stage_samples: int = 50     # candidate requests before advancing
    min_stage_seconds: float = 30.0
    shadow_every: int = 10          # shadow-score every Nth candidate query
    check_every: int = 5            # guard evaluation cadence (requests)
    tick_interval_s: float = 1.0    # auto-ramp timer; 0 = traffic-driven only
    guards: GuardConfig = field(default_factory=GuardConfig)


class RolloutController:
    """One guarded rollout (see module docstring)."""

    def __init__(self, storage, host, candidate_instance_id: str,
                 baseline_instance_id: str,
                 config: RolloutConfig | None = None):
        self.storage = storage
        self.host = host
        self.candidate_instance_id = candidate_instance_id
        self.baseline_instance_id = baseline_instance_id
        self.config = config or RolloutConfig()
        if not self.config.stages:
            raise ValueError("rollout needs at least one stage pct")
        self._lock = threading.RLock()
        # serializes the two CONCLUDING paths (promote / rollback) end
        # to end, INCLUDING their host mutations: a guard breach firing
        # mid-promote-fan must wait and then see the PROMOTED verdict
        # (no-op), never interleave its drop fan with the promote fan —
        # on a fleet that interleaving leaves shard groups serving the
        # rolled-back instance as active (skew) or overwrites a
        # persisted ROLLED_BACK with PROMOTED
        self._conclude_lock = threading.Lock()
        self.stage_index = 0
        self.verdict: str | None = None   # None = in flight
        self.reason = ""
        self.stage_started = time.monotonic()
        self.start_time = time.monotonic()
        self.active_stats = ArmStats()
        self.candidate_stats = ArmStats()
        self.shadow_stats = ShadowStats()
        self.last_evidence: dict = {}
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        # shadow scoring runs OFF the serving request thread (a shadow
        # is a full second prediction — inline it would double every
        # shadow_every-th canary request's latency); single slot,
        # skip-if-busy, so the sampler can never queue up behind a slow
        # arm either
        self._shadow_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rollout-shadow")
        self._shadow_inflight = False

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def begin(cls, storage, host, candidate_instance_id: str,
              config: RolloutConfig | None = None) -> "RolloutController":
        """Create, persist the IN_FLIGHT record, and load the candidate
        arm. A load failure anywhere rolls the record to ROLLED_BACK
        (zero traffic ever reached the arm) and raises
        CandidateLoadError."""
        ctl = cls(storage, host, candidate_instance_id,
                  host.rollout_active_instance_id(), config)
        ctl._transition()  # durable IN_FLIGHT at stage 0
        try:
            host.load_candidate(candidate_instance_id)
        except Exception as e:
            ctl.rollback(reason=f"candidate load failed: "
                                f"{type(e).__name__}: {e}")
            raise CandidateLoadError(
                f"candidate {candidate_instance_id} could not be loaded "
                f"({e}); rollout rolled back before serving any traffic"
            ) from e
        host.rollout = ctl
        ctl._start_ticker()
        log.info("rollout begun: candidate %s vs baseline %s, stages %s",
                 candidate_instance_id, ctl.baseline_instance_id,
                 ctl.config.stages)
        return ctl

    def _start_ticker(self) -> None:
        if not (self.config.auto and self.config.tick_interval_s > 0):
            return
        self._ticker = threading.Thread(
            target=self._tick_loop, name="rollout-ticker", daemon=True)
        self._ticker.start()

    def _tick_loop(self) -> None:
        while not self._stop.wait(timeout=self.config.tick_interval_s):
            with self._lock:
                if self.verdict is not None:
                    return
            self._maybe_react()

    def close(self) -> None:
        self._stop.set()
        self._shadow_pool.shutdown(wait=False)

    # -- the single state-writer ---------------------------------------------
    def _transition(self, stage_index: int | None = None,
                    verdict: str | None = None, reason: str = "",
                    evidence: dict | None = None) -> None:
        """THE ONLY writer of stage/verdict state. Callers hold or take
        ``self._lock`` here; the new state is persisted durably (CRC32C-
        framed MODELDATA record) before the method returns, so every
        observable transition is also a recovered-after-restart one."""
        with self._lock:
            if stage_index is not None:
                self.stage_index = stage_index
                self.stage_started = time.monotonic()
            if verdict is not None:
                self.verdict = verdict
            if reason:
                self.reason = reason
            if evidence is not None:
                self.last_evidence = evidence
            record = rstate.RolloutRecord(
                instance_id=self.candidate_instance_id,
                baseline_instance_id=self.baseline_instance_id,
                stages=tuple(self.config.stages),
                stage_pct=self.stage_pct(),
                verdict=self.verdict or rstate.VERDICT_IN_FLIGHT,
                reason=self.reason,
                evidence=self.last_evidence,
            )
        rstate.save_record(self.storage, record)

    # -- traffic split -------------------------------------------------------
    def stage_pct(self) -> int:
        with self._lock:
            if self.verdict == rstate.VERDICT_ROLLED_BACK:
                return 0
            if self.verdict == rstate.VERDICT_PROMOTED:
                return 100
            return int(self.config.stages[self.stage_index])

    def arm_for(self, query) -> str:
        """Which arm serves this query. Sticky and deterministic:
        ``crc32c(user) % 100 < stage_pct``. Queries without a user field
        (and all traffic after a verdict) ride the active arm."""
        with self._lock:
            if self.verdict is not None:
                return ARM_ACTIVE
            pct = int(self.config.stages[self.stage_index])
        user = query.get("user") if isinstance(query, dict) else None
        if user is None:
            return ARM_ACTIVE
        return ARM_CANDIDATE if in_canary(user, pct) else ARM_ACTIVE

    # -- observation ---------------------------------------------------------
    def observe(self, arm: str, query, prediction, latency_s: float,
                error: bool = False) -> None:
        """Record one served request and react: shadow-score a sample
        of candidate traffic, and evaluate guards every
        ``check_every`` candidate requests. Called from the host's
        query path OUTSIDE its locks."""
        shadow_due = False
        with self._lock:
            if self.verdict is not None:
                return
            stats = (self.candidate_stats if arm == ARM_CANDIDATE
                     else self.active_stats)
            stats.record(latency_s, error,
                         (not error) and is_empty_response(prediction))
            if arm == ARM_CANDIDATE:
                # guards evaluate on ERRORED candidate requests too —
                # the error_rate guard exists precisely for a candidate
                # that crashes the predict path, and in fixed-pct mode
                # (no ticker) observe() is the only trigger
                n = self.candidate_stats.requests
                shadow_due = (not error
                              and self.config.shadow_every > 0
                              and n % self.config.shadow_every == 0
                              and not self._shadow_inflight)
                if shadow_due:
                    self._shadow_inflight = True
                check_due = n % max(1, self.config.check_every) == 0
            else:
                check_due = False
        if shadow_due:
            try:
                self._shadow_pool.submit(self._shadow_sample, query,
                                         prediction)
            except RuntimeError:        # pool shut down (close() raced)
                with self._lock:
                    self._shadow_inflight = False
        if check_due:
            self._maybe_react()

    def _shadow_sample(self, query, prediction) -> None:
        """Score one candidate-arm query on the active arm and record
        the divergence — on the shadow thread, never the request's."""
        try:
            other = self.host.shadow_predict(query, ARM_ACTIVE)
            div = prediction_divergence(prediction, other)
            with self._lock:
                self.shadow_stats.record(div)
        except Exception as e:  # noqa: BLE001 - shadow is best-effort
            log.warning("shadow scoring failed: %s", e)
        finally:
            with self._lock:
                self._shadow_inflight = False

    def _maybe_react(self) -> None:
        """Evaluate guards (under the ``rollout.guard`` chaos point):
        a breach rolls back immediately; green guards may auto-advance
        the stage ladder."""
        with self._lock:
            if self.verdict is not None:
                return
            breach_reason = ""
            try:
                chaos.maybe_inject("rollout.guard")
                ok, evidence = evaluate_guards(
                    self.active_stats, self.candidate_stats,
                    self.shadow_stats, self.config.guards)
            except ConnectionError as e:
                # drill lever: injected failure at the guard point IS a
                # breach — the rollback path must behave identically
                ok, evidence = False, {
                    "chaos": {"ok": False, "error": str(e)}}
                breach_reason = f"chaos at rollout.guard: {e}"
            self.last_evidence = evidence
            if ok:
                advance = (self.config.auto
                           and self.stage_index < len(self.config.stages) - 1
                           and self.candidate_stats.requests
                           >= self.config.min_stage_samples
                           and (time.monotonic() - self.stage_started)
                           >= self.config.min_stage_seconds)
            else:
                advance = False
                if not breach_reason:
                    red = [g for g, e in evidence.items()
                           if not e.get("ok")]
                    breach_reason = f"guard breach: {', '.join(red)}"
        if not ok:
            self.rollback(reason=breach_reason, evidence=evidence)
            return
        if advance:
            with self._lock:
                if self.verdict is not None:
                    return
                nxt = self.stage_index + 1
                # fresh evidence per stage: a 1% stage's stats must not
                # pre-judge (or pre-absolve) the 25% stage
                self.active_stats = ArmStats()
                self.candidate_stats = ArmStats()
                self.shadow_stats = ShadowStats()
                self._transition(stage_index=nxt)
            log.info("rollout advanced to stage %d%% (candidate %s)",
                     self.stage_pct(), self.candidate_instance_id)

    # -- verdicts ------------------------------------------------------------
    def rollback(self, reason: str = "operator rollback",
                 evidence: dict | None = None) -> dict:
        """Atomically revert 100% of traffic to the active instance and
        record ROLLED_BACK. Idempotent; the verdict flips under the
        lock FIRST (``arm_for`` answers active from that instant), then
        the candidate arm is dropped outside the lock. Serialized with
        promote() by ``_conclude_lock`` — a breach firing mid-promote
        waits, then no-ops against the PROMOTED verdict instead of
        racing its drop fan against the promote fan."""
        with self._conclude_lock:
            with self._lock:
                if self.verdict is not None:
                    return self.status()
                self._transition(verdict=rstate.VERDICT_ROLLED_BACK,
                                 reason=reason,
                                 evidence=evidence or self.last_evidence)
            self._stop.set()
            self._shadow_pool.shutdown(wait=False)
            try:
                self.host.drop_candidate()
            except Exception as e:  # noqa: BLE001 - traffic already
                log.warning("dropping candidate arm failed (traffic "
                            "already on the active arm): %s", e)
        log.warning("rollout ROLLED_BACK (candidate %s): %s",
                    self.candidate_instance_id, reason)
        return self.status()

    def promote(self) -> dict:
        """Candidate becomes the active instance at 100%. Refused while
        any guard is red (RolloutGuardBreach); wrapped in the
        ``rollout.promote`` chaos point — an injected failure leaves
        the rollout in flight, nothing swapped. Holds ``_conclude_lock``
        across the host swap so a concurrent guard-breach rollback can
        never interleave with (or overwrite the verdict of) the
        promote."""
        with self._conclude_lock:
            with self._lock:
                if self.verdict == rstate.VERDICT_PROMOTED:
                    return self.status()
                if self.verdict is not None:
                    raise ValueError(
                        f"rollout already concluded: {self.verdict}")
                chaos.maybe_inject("rollout.promote")
                ok, evidence = evaluate_guards(
                    self.active_stats, self.candidate_stats,
                    self.shadow_stats, self.config.guards)
                self.last_evidence = evidence
                if not ok:
                    raise RolloutGuardBreach(evidence)
            # swap OUTSIDE the controller lock (host takes its own
            # locks); a failure here leaves the rollout in flight and
            # the record IN_FLIGHT — restart then serves the baseline,
            # never half a promote
            self.host.promote_candidate()
            with self._lock:
                self._transition(stage_index=len(self.config.stages) - 1,
                                 verdict=rstate.VERDICT_PROMOTED,
                                 reason="promoted", evidence=evidence)
            self._stop.set()
            # concluded controllers are replaced, not close()d — free
            # the shadow worker now or each canary leaks a thread
            self._shadow_pool.shutdown(wait=False)
        log.info("rollout PROMOTED: %s now active",
                 self.candidate_instance_id)
        return self.status()

    # -- observability -------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "active": self.verdict is None,
                "candidateInstanceId": self.candidate_instance_id,
                "baselineInstanceId": self.baseline_instance_id,
                "stages": list(self.config.stages),
                "stageIndex": self.stage_index,
                "stagePct": self.stage_pct(),
                "verdict": self.verdict,
                "reason": self.reason,
                "auto": self.config.auto,
                "timeInStageSeconds": round(
                    time.monotonic() - self.stage_started, 3),
                "arms": {
                    ARM_ACTIVE: self.active_stats.snapshot(),
                    ARM_CANDIDATE: self.candidate_stats.snapshot(),
                },
                "shadow": self.shadow_stats.snapshot(),
                "guards": self.last_evidence,
                "guardConfig": self.config.guards.to_dict(),
            }


# -- HTTP surface (shared by the single-host server and the router) ----------

def install_rollout_routes(app, host, storage, check_server_key) -> None:
    """Wire the rollout verbs onto a serving HttpApp:

      POST /rollout/deploy   {"pct": n | "auto": true, "instanceId"?, ...}
      POST /rollout/promote
      POST /rollout/rollback {"reason"?}
      GET  /rollout/status

    Mutating routes are server-key guarded like /reload — they move
    production traffic."""

    def _controller():
        return getattr(host, "rollout", None)

    # serializes the in-flight check against begin(): two concurrent
    # deploys must not BOTH pass the check and create two controllers
    # (last-writer-wins on host.rollout, with the loser's ticker still
    # able to drop the winner's live candidate arm)
    deploy_lock = threading.Lock()

    @app.route("POST", r"/rollout/deploy")
    def rollout_deploy(req):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        if storage is None:
            return 503, {"message": "no storage configured; rollout "
                                    "records cannot be persisted"}
        try:
            body = req.json() or {}
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid body: {e}"}
        if not isinstance(body, dict):
            return 400, {"message": "body must be a JSON object"}
        try:
            config = _config_from_body(body)
        except (TypeError, ValueError) as e:
            return 400, {"message": str(e)}
        with deploy_lock:
            ctl = _controller()
            if ctl is not None and ctl.verdict is None:
                return 409, {"message": "a rollout is already in flight",
                             "rollout": ctl.status()}
            active_id = host.rollout_active_instance_id()
            candidate = body.get("instanceId")
            if candidate is None:
                c = host.config
                latest = rstate.latest_eligible_completed(
                    storage, c.engine_id, c.engine_version,
                    c.engine_variant)
                candidate = latest.id if latest is not None else None
            if candidate is None or candidate == active_id:
                return 409, {"message": "no candidate instance newer than "
                                        f"the active one ({active_id}); "
                                        "train first or pass instanceId"}
            try:
                ctl = RolloutController.begin(storage, host, candidate,
                                              config)
            except CandidateLoadError as e:
                return 503, {"message": str(e),
                             "verdict": rstate.VERDICT_ROLLED_BACK,
                             "candidateInstanceId": candidate}
        return 200, {"message": "canary serving", "rollout": ctl.status()}

    @app.route("POST", r"/rollout/promote")
    def rollout_promote(req):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        ctl = _controller()
        if ctl is None:
            return 409, {"message": "no rollout in flight"}
        try:
            status = ctl.promote()
        except RolloutGuardBreach as e:
            return 409, {"message": f"promote refused: {e}",
                         "guards": e.evidence}
        except ValueError as e:
            return 409, {"message": str(e), "rollout": ctl.status()}
        except ConnectionError as e:
            # rollout.promote chaos / transport failure mid-promote:
            # nothing swapped, rollout still in flight
            return 503, {"message": f"promote failed: {e}",
                         "rollout": ctl.status()}
        return 200, {"message": "Promoted", "rollout": status}

    @app.route("POST", r"/rollout/rollback")
    def rollout_rollback(req):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            body = req.json() or {}
        except Exception:  # noqa: BLE001 - body is optional
            body = {}
        reason = (body.get("reason") if isinstance(body, dict) else None) \
            or "operator rollback"
        ctl = _controller()
        if ctl is None:
            # no live controller, but a crashed canary may have left an
            # orphaned IN_FLIGHT record (blocking that instance's
            # auto-advance forever) — `pio rollback` is the documented
            # one-command way out, so conclude it here
            if storage is not None:
                c = host.config
                orphan = rstate.rollback_abandoned(
                    storage, c.engine_id, c.engine_version,
                    c.engine_variant,
                    reason=f"{reason} (abandoned canary: no rollout in "
                           "flight in this process)")
                if orphan is not None:
                    return 200, {
                        "message": "Rolled back an abandoned canary "
                                   "record (no rollout was in flight in "
                                   "this process)",
                        "instanceId": orphan.instance_id,
                        "verdict": orphan.verdict,
                    }
            return 409, {"message": "no rollout in flight"}
        return 200, {"message": "Rolled back",
                     "rollout": ctl.rollback(reason=reason)}

    # pio: lint-ok[route-unguarded] read-only status surface,
    # deliberately open like / and /metrics — `pio doctor` and the
    # deploy watchdogs poll it without a server key
    @app.route("GET", r"/rollout/status")
    def rollout_status(req):
        ctl = _controller()
        if ctl is None:
            return 200, {"active": False}
        return 200, ctl.status()


def _config_from_body(body: dict) -> RolloutConfig:
    """Parse the /rollout/deploy knobs into a RolloutConfig. ``pct``
    yields a one-stage ladder (operator promotes manually); ``auto``
    rides the default (or given) ladder unattended."""
    auto = bool(body.get("auto", False))
    stages = body.get("stages")
    if stages is not None:
        stages = tuple(int(s) for s in stages)
    elif auto:
        stages = DEFAULT_STAGES
    else:
        pct = body.get("pct")
        if pct is None:
            raise ValueError("body needs \"pct\": n or \"auto\": true")
        pct = int(pct)
        if not 0 < pct <= 100:
            raise ValueError(f"pct must be in (0, 100], got {pct}")
        stages = (pct,)
    if any(not 0 < int(s) <= 100 for s in stages):
        raise ValueError(f"stage pcts must be in (0, 100]: {stages}")
    guards = GuardConfig()
    overrides = body.get("guards") or {}
    if not isinstance(overrides, dict):
        raise ValueError("\"guards\" must be an object")
    mapping = {
        "maxErrorRate": "max_error_rate",
        "maxLatencyRatio": "max_latency_ratio",
        "maxEmptyRate": "max_empty_rate",
        "maxDivergence": "max_divergence",
        "minSamples": "min_samples",
        "minShadowSamples": "min_shadow_samples",
    }
    for key, attr in mapping.items():
        if key in overrides:
            setattr(guards, attr, type(getattr(guards, attr))(
                overrides[key]))
    # only keys PRESENT in the body override; absent ones defer to the
    # dataclass defaults (restating them here would silently fork the
    # HTTP path from a tuned RolloutConfig default)
    kwargs = {}
    for key, attr, cast in (
        ("minStageSamples", "min_stage_samples", int),
        ("minStageSeconds", "min_stage_seconds", float),
        ("shadowEvery", "shadow_every", int),
        ("checkEvery", "check_every", int),
        ("tickIntervalS", "tick_interval_s", float),
    ):
        if key in body:
            kwargs[attr] = cast(body[key])
    return RolloutConfig(stages=stages, auto=auto, guards=guards, **kwargs)
