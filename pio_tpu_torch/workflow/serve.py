"""Deploy server — REST query serving with models resident on the device.

Counterpart of ``pio_tpu.workflow.serve`` (reference CreateServer.scala):

  GET  /                    -> engine status (instance info + latency stats
                               + fold-in accounting)
  GET  /healthz, /readyz    -> liveness; readiness (model loaded, storage
                               breakers closed, warm buckets, async queue
                               under its shed watermark; fold-in and the
                               rollout shown, never gating)
  POST /queries.json        -> supplement -> per-algo predict -> serve
                               (+ the rollout's arm, output plugins, the
                               optional feedback event), through the micro
                               or continuous batcher when one is configured
  POST /batch/queries.json  -> a JSON array of queries, one batch_predict
                               per algorithm (and arm)
  POST /model/upsert_users  -> streaming fold-in apply (server-key guarded)
                               on both rollout arms
  POST /reload              -> hot-swap to the latest eligible COMPLETED
                               instance (GET kept as a deprecated alias); a
                               failed reload keeps serving the last-good
                               model
  POST /rollout/deploy, /rollout/promote, /rollout/rollback
                            -> guarded canary (server-key guarded;
                               ``rollout/``); GET /rollout/status
  POST /stop                -> shut down (server-key guarded)
  POST /profile/start, /profile/stop
                            -> a torch.profiler device trace of the process
                               (server-key guarded)
  GET  /plugins.json        -> plugin listing; /plugins/<name>/* -> plugin
                               REST
  GET  /metrics.json, /metrics -> stage histograms, counters, the batch
                               occupancy histogram (Prometheus text)
  GET  /batcher.json        -> which batcher fronts the device, its counters
  POST /batcher/window      -> live coalesce-window retune (server-key
                               guarded)

with the same body shapes and error codes. Ported: model restore (latest
eligible COMPLETED instance or a pinned id, falling back past a corrupt
blob), the query routes with their stage spans, hedged predict dispatch,
the per-request budget, the admission stage (``QueryBatcher`` and
``serving/batcher.ContinuousBatcher``), the warm sweep, reload and stop,
the guarded rollout's two arms (the candidate restored and served with
one set of algorithm instances, as the active arm is: the reference
restores with one set and serves with another), shadow scoring for its
divergence guard, output plugins and feedback events, the fold-in apply
surface (``foldin_upsert``: user rows replaced or appended, existing
item rows replaced with the clustered-retrieval sidecar re-encoded for
exactly those rows, in one last-good swap, on each arm), TLS, and both
transports (async by default). A candidate arm runs the deploy's warm
query before it takes traffic, as the active arm did at startup, so its
retrieval index is built before the latency guard times it.

A query answers the same bits alone, micro-batched or coalesced: every
library scoring product runs at one dispatch shape (``ops.bucketing.
DISPATCH_ROWS``, ``ServingConfig.batch_max``'s default), so the
batchers take at most that many queries a dispatch, and a batch split
by rollout arm scores each arm's rows at that shape too. With one shape
the warm sweep is one batch of ``batch_max`` queries, and the
reference's bucket registry (which remembers which power-of-two batch
sizes a deployment served, to warm only those) would choose among
identical batches: it is left out, and with it ``utils/compilecache``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    TimeoutError as FuturesTimeoutError,
    wait as futures_wait,
)
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.ops import retrieval as rt
from pio_tpu_torch.ops.bucketing import DISPATCH_ROWS, pow2_bucket
from pio_tpu_torch.resilience import (
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
)
from pio_tpu_torch.resilience.health import (
    breaker_checks,
    install_health_routes,
    shedder_check,
)
from pio_tpu_torch.rollout import (
    ARM_ACTIVE,
    ARM_CANDIDATE,
    install_rollout_routes,
    is_auto_advance_eligible,
)
from pio_tpu_torch.server.http import (
    AsyncHttpServer,
    HttpApp,
    HttpServer,
    Request,
    json_response,
    server_key_ok,
)
from pio_tpu_torch.server.plugins import PluginContext
from pio_tpu_torch.utils.durable import ModelIntegrityError
from pio_tpu_torch.utils.time import format_time, utcnow
from pio_tpu_torch.utils.tracing import Tracer
from pio_tpu_torch.workflow.context import WorkflowContext, create_workflow_context
from pio_tpu_torch.workflow.train import load_models

log = logging.getLogger("pio_tpu_torch.serve")


@dataclass
class ServingConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    engine_id: str = ""
    engine_version: str = "1"
    engine_variant: str = "default"
    feedback: bool = False
    feedback_app_name: str = ""   # app receiving pio_pr predict events
    # guards /stop, /reload, /model/upsert_users, /rollout/*, /profile/*
    server_key: str = ""
    warm_query: dict | None = None  # sample query run at startup
    certfile: str | None = None   # TLS cert (PEM); with keyfile -> HTTPS
    keyfile: str | None = None
    backend: str = "async"        # HTTP transport: "async" | "threaded"
    # dynamic micro-batching: concurrent /queries.json requests arriving
    # within the window are executed as ONE batch_predict per algorithm.
    # batch_window_ms > 0: fixed collection window; < 0: ADAPTIVE
    # (continuous) batching — no artificial wait, each batch is whatever
    # queued while the previous one executed, so batch size self-tunes to
    # arrival-rate x device-roundtrip. 0 = off.
    batch_window_ms: float = 0.0
    # the most queries one batched dispatch takes; at most
    # ops.bucketing.DISPATCH_ROWS, the rows every scoring product runs at
    batch_max: int = 64
    # batches concurrently in flight. 0 = AUTO from the measured dispatch
    # RTT (_auto_pipeline_depth): 2 on a local device (double buffering —
    # the collection window overlaps the in-flight batch), 4 over a
    # high-RTT link where in-flight batches hide the round trip.
    batch_pipeline: int = 0
    # tail hedging for the predict dispatch: if a device dispatch has not
    # returned after hedge_after x the rolling predict-stage MEDIAN, issue
    # a duplicate dispatch and take whichever finishes first. predict is a
    # pure function of (model, queries), so the duplicate is safe; it only
    # costs device time on the rare stall. 0 disables. Hedging arms only
    # after 20 recorded predict spans; warm-up calls record no spans at
    # all (record=False skips the histograms), so warm-ups never skew the
    # median the hedge timeout derives from.
    hedge_after: float = 3.0
    # per-request time budget (seconds) opened around each /queries.json
    # dispatch and propagated (resilience.Deadline contextvar) into the
    # storage DAO calls made on the REQUEST THREAD: retries stop
    # sleeping and I/O stops starting once the budget is spent, and the
    # request answers 503 instead of holding a connection past its
    # usefulness. Work executed on other pools (micro-batched execution,
    # hedged predict dispatch) does not inherit the contextvar — the
    # batcher instead enforces the budget at its result wait, and predict
    # stages are bounded by their own hedging. 0 = off.
    request_budget_s: float = 0.0
    # cross-request continuous batching (serving/batcher.py): > 0 puts a
    # ContinuousBatcher in front of the device program — concurrent
    # /queries.json requests coalesce into ONE batched dispatch whenever
    # a pipeline slot frees OR this window (ms) elapses, whichever comes
    # first (2 ms is the recommended default when enabling). Unlike
    # batch_window_ms it is Deadline-aware: a query whose budget cannot
    # survive the window dispatches solo or sheds 503 instead of
    # parking. Takes precedence over batch_window_ms. 0 = off.
    coalesce_window_ms: float = 0.0


def _no_span(_name: str, **_labels):
    """A span that records nothing (the unrecorded calls' stand-in for
    ``Tracer.span``)."""
    return nullcontext()


@dataclass
class _CandidateArm:
    """The second model slot a guarded rollout serves its canary from
    (``rollout/``): a fully-restored instance living BEHIND the same swap
    lock as the active one, so promote is one pointer move and rollback
    is one pointer drop — never a reload."""

    instance: Any
    models: list
    algorithms: list
    serving: Any


class QueryServer:
    """Serving runtime: engine + params + restored models (reference
    ServerActor state, CreateServer.scala:407-431)."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        storage: Storage,
        config: ServingConfig,
        ctx: WorkflowContext | None = None,
        plugin_context: PluginContext | None = None,
        instance_id: str | None = None,
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.storage = storage
        self.config = config
        self.ctx = ctx or create_workflow_context(storage)
        self.plugins = plugin_context or PluginContext()
        batching = config.coalesce_window_ms > 0 or config.batch_window_ms != 0
        if batching and pow2_bucket(config.batch_max) > DISPATCH_ROWS:
            raise ValueError(
                f"batch_max {config.batch_max} exceeds the {DISPATCH_ROWS} "
                "rows every scoring product runs at; a larger batch would "
                "score its queries at another shape than a solo query")
        self._lock = threading.RLock()
        # per-stage latency histograms + distributed span records (obs/):
        # every span under an active trace context lands in the recorder,
        # and the HTTP edge (dispatch_safe) opens that context per request
        from pio_tpu_torch.obs import make_recorder

        self.recorder = make_recorder("serving")
        self.tracer = Tracer(recorder=self.recorder)
        self.start_time = utcnow()
        self._stop_requested = threading.Event()
        self._predict_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="predict"
        )
        # separate pool for hedged device dispatches: _hedged may be
        # CALLED from a _predict_pool worker (multi-algo path), so its
        # inner submissions must not compete for the same workers or a
        # full pool deadlocks on its own children
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="hedge"
        )
        self.hedged_dispatches = 0
        self.last_reload_error: str | None = None
        # streaming fold-in accounting (foldin_upsert): how many user
        # and item rows were applied, and the newest batch's staleness
        self.foldin_applied_users = 0
        self.foldin_applied_items = 0
        self.foldin_last_time = None
        self.foldin_last_staleness_s: float | None = None
        # guarded rollout (rollout/): the candidate arm and the
        # controller splitting traffic onto it. Both live behind the
        # existing locks — queries snapshot whichever arm serves them
        # exactly like they snapshot the active model.
        self.rollout = None                       # RolloutController
        self.candidate: _CandidateArm | None = None
        # recorded device dispatches of each arm (/metrics.json
        # armDispatches): a solo query is one, a batch one per arm
        self.arm_dispatches = {ARM_ACTIVE: 0, ARM_CANDIDATE: 0}
        # fold-in rows that could not land on the candidate arm yet
        # (arm mid-swap, rank mismatch): queued and retried on the next
        # apply so freshness never silently diverges the experiment
        self._candidate_foldin_pending: dict = {}
        self._candidate_item_pending: dict = {}
        # serializes whole reloads (resolve + restore + swap) end to end
        # WITHOUT blocking queries: queries snapshot state under
        # self._lock, which a reload only takes for the final swap.
        # Without this, two concurrent /reloads could resolve different
        # "latest" instances and swap in restore-completion order,
        # leaving the older one serving.
        self._load_lock = threading.Lock()
        self._load(instance_id)
        # admission stage in front of the device program: the continuous
        # batcher (deadline-aware, slot-OR-window drain) takes precedence
        # over the window-only micro-batcher; both expose the same
        # .query()/.close() so the serving edge and the readiness
        # "buckets" gate treat them interchangeably
        if config.coalesce_window_ms > 0:
            from pio_tpu_torch.serving.batcher import ContinuousBatcher

            self.batcher = ContinuousBatcher(
                self, config.coalesce_window_ms / 1e3, config.batch_max,
                pipeline_depth=config.batch_pipeline
                or _auto_pipeline_depth(self.ctx.device))
        elif config.batch_window_ms != 0:
            self.batcher = QueryBatcher(
                self, config.batch_window_ms / 1e3, config.batch_max,
                pipeline_depth=config.batch_pipeline
                or _auto_pipeline_depth(self.ctx.device))
        else:
            self.batcher = None
        self._buckets_warmed = False
        self._warm_once = threading.Lock()
        # the last completed warm sweep: {"seconds", "buckets"} (/readyz)
        self.warm_sweep: dict | None = None
        # /readyz gate (resilience/health.py "buckets" check): starts
        # NOT-ready only when a warm sweep is owed at startup (batching on
        # + a warm query to run it with); set once the sweep completes.
        # Without a warm query the first real request triggers the
        # background sweep — gating then would deadlock readiness on the
        # traffic it gates, so the server reports ready and the gate only
        # drops while that background warm is in flight.
        self._buckets_ready = threading.Event()
        if self.batcher is None or config.warm_query is None:
            self._buckets_ready.set()
        self._warm()

    # -- model lifecycle ----------------------------------------------------
    def _load(self, instance_id: str | None = None) -> None:
        """Restore an instance's models and swap them in ATOMICALLY: every
        failable step (metadata lookup, model restore, doer construction)
        runs before the swap, so a failed load leaves the previous
        instance/models/algorithms fully intact — the last-good model
        keeps serving through a broken /reload. Whole loads (resolve +
        restore + swap) are serialized by _load_lock so concurrent
        reloads cannot swap in restore-completion order; queries are NOT
        blocked — they contend only on the final swap."""
        with self._load_lock:
            self._load_locked(instance_id)

    def _load_locked(self, instance_id: str | None) -> None:
        c = self.config
        instances = self.storage.get_metadata_engine_instances()
        if instance_id is None:
            candidates = instances.get_completed(
                c.engine_id, c.engine_version, c.engine_variant
            )
            # rollout verdicts gate AUTO-advancement: an instance the
            # guards ROLLED_BACK (or whose canary is still in flight)
            # is skipped, so no reload/restart quietly re-serves a
            # rejected model. Operators can still pin one explicitly.
            candidates = [
                cand for cand in candidates
                if is_auto_advance_eligible(self.storage, cand.id)
            ]
            if not candidates:
                raise ValueError(
                    f"No COMPLETED engine instance eligible for engine "
                    f"{c.engine_id} {c.engine_version} "
                    f"{c.engine_variant} (rolled-back canaries are "
                    "skipped). Run train first."
                )
        else:
            instance = instances.get(instance_id)
            if instance is None:
                raise ValueError(f"Engine instance {instance_id} not found")
            candidates = [instance]
        # the instances that serve are the ones deploy prep runs on (the
        # reference prepares one set and serves with another, which drops
        # what prep binds to an algorithm, e.g. a live event store)
        _, _, algorithms, serving = self.engine._doers(self.engine_params)
        # restore OUTSIDE the lock: queries keep serving the old model
        # while the new one loads. A corrupt blob (CRC32C mismatch) on the
        # latest instance falls back to the previous COMPLETED one:
        # integrity failures are permanent for that blob, and an older
        # good model beats none. An explicit instance id does not fall
        # back.
        models = instance = None
        last_integrity_error: ModelIntegrityError | None = None
        for candidate in candidates:
            try:
                models = load_models(
                    self.storage, self.engine, self.engine_params,
                    candidate.id, ctx=self.ctx, algorithms=algorithms,
                )
                instance = candidate
                break
            except ModelIntegrityError as e:
                log.error(
                    "model blob for instance %s is corrupt (%s); trying "
                    "the previous COMPLETED instance", candidate.id, e,
                )
                last_integrity_error = e
        if models is None:
            raise last_integrity_error
        with self._lock:
            # hot-swap: retire the outgoing doers' resources — on a delay:
            # queries that snapshotted the old algorithms may still be
            # mid-predict
            self._retire_algorithms(getattr(self, "algorithms", []))
            self.instance = instance
            self.models = models
            self.algorithms = algorithms
            self.serving = serving
        log.info("deployed engine instance %s", instance.id)

    def reload(self) -> str:
        """Hot-swap to the latest eligible completed instance (rolled-back
        and in-flight canaries are skipped); returns its id. On
        failure the exception propagates and the last-good model keeps
        serving (the /reload route maps it to 503 + the serving id)."""
        try:
            self._load(None)
        except Exception as e:
            self.last_reload_error = f"{type(e).__name__}: {e}"
            raise
        self.last_reload_error = None
        return self.instance.id

    # -- guarded rollout arms (rollout/) -------------------------------------
    def rollout_active_instance_id(self) -> str:
        with self._lock:
            return self.instance.id

    def load_candidate(self, instance_id: str) -> None:
        """Restore `instance_id` into the CANDIDATE slot alongside the
        active model, with the algorithm instances that will serve it.
        Every failable step runs before the slot is set (same atomicity
        contract as _load); no last-good fallback — a canary candidate
        is THAT instance or nothing. The deploy's warm query runs on the
        arm first, unrecorded, as it ran on the active arm at startup:
        the first query of a clustered model builds its retrieval index,
        which the latency guard must not time."""
        with self._load_lock:
            instance = self.storage.get_metadata_engine_instances().get(
                instance_id)
            if instance is None:
                raise ValueError(f"Engine instance {instance_id} not found")
            if instance.status != "COMPLETED":
                raise ValueError(
                    f"candidate instance {instance_id} is "
                    f"{instance.status}, not COMPLETED")
            _, _, algorithms, serving = self.engine._doers(self.engine_params)
            models = load_models(
                self.storage, self.engine, self.engine_params,
                instance.id, ctx=self.ctx, algorithms=algorithms,
            )
            if self.config.warm_query is not None:
                try:
                    _predict_on(models, algorithms, serving,
                                dict(self.config.warm_query))
                except Exception:  # noqa: BLE001 - warmup is best-effort
                    log.warning("candidate warm query failed",
                                exc_info=True)
            with self._lock:
                self._retire_algorithms(
                    self.candidate.algorithms if self.candidate else [])
                self.candidate = _CandidateArm(
                    instance=instance, models=models,
                    algorithms=algorithms, serving=serving)
                self._candidate_foldin_pending = {}
                self._candidate_item_pending = {}
        log.info("candidate arm loaded: instance %s", instance_id)

    def drop_candidate(self) -> None:
        """Discard the candidate arm (rollback). The active arm is
        untouched — in-flight queries that snapshotted the candidate
        finish on their snapshot; new ones never see it."""
        with self._lock:
            cand, self.candidate = self.candidate, None
            self._candidate_foldin_pending = {}
            self._candidate_item_pending = {}
            if cand is not None:
                self._retire_algorithms(cand.algorithms)

    def promote_candidate(self) -> None:
        """The candidate becomes the active instance (100%): one
        pointer swap under the lock, the exact shape _load uses. The
        outgoing active arm's resources retire on the usual delay.
        Queued candidate fold-ins flush under ``_load_lock`` (an upsert
        landing between an unlocked flush and the swap would be
        silently discarded); anything STILL pending at the swap — rank
        mismatch, or an apply racing the swap itself — is logged, and
        the next fold-in cycle re-solves those users."""
        with self._load_lock:
            self._flush_candidate_foldin()
            with self._lock:
                cand = self.candidate
                if cand is None:
                    raise ValueError("no candidate arm to promote")
                dropped = (len(self._candidate_foldin_pending)
                           + len(self._candidate_item_pending))
                if dropped:
                    log.warning(
                        "%d queued candidate fold-in row(s) could not "
                        "apply at promote and are dropped (next fold-in "
                        "cycle re-solves those users)", dropped)
                self._retire_algorithms(self.algorithms)
                self.instance = cand.instance
                self.models = cand.models
                self.algorithms = cand.algorithms
                self.serving = cand.serving
                self.candidate = None
                self._candidate_foldin_pending = {}
                self._candidate_item_pending = {}
        log.info("candidate promoted: instance %s now active",
                 self.instance.id)

    def _retire_algorithms(self, algorithms) -> None:
        """Close an arm's algorithm resources on a delay (see
        _load_locked: queries that snapshotted them may be mid-predict).
        Callers hold self._lock."""
        retired = [
            close for algo in algorithms
            if callable(close := getattr(algo, "close", None))
        ]
        if retired:
            # pio: lint-ok[context-loss] deliberate detach: the delayed
            # close must outlive the request (and its budget) that
            # triggered the reload
            t = threading.Timer(30.0, lambda: [c() for c in retired])
            t.daemon = True
            t.start()

    def _arm_snapshot(self, arm: str):
        """-> (models, algorithms, serving, instance_id) for the arm a
        query rides. A candidate request that races a just-finished
        rollback falls through to the active arm — a dropped arm is
        never served."""
        with self._lock:
            if arm == ARM_CANDIDATE and self.candidate is not None:
                c = self.candidate
                return c.models, c.algorithms, c.serving, c.instance.id
            return (self.models, self.algorithms, self.serving,
                    self.instance.id)

    def shadow_predict(self, q: dict, arm: str) -> Any:
        """Score `q` on one arm without stats, feedback, or plugins —
        the rollout controller's divergence sampler. Its seconds go to
        the "shadow" span: the shadow thread's busy time."""
        models, algorithms, serving, _ = self._arm_snapshot(arm)
        with self.tracer.span("shadow", arm=arm):
            return _predict_on(models, algorithms, serving, q)

    def close(self) -> None:
        """Release serving resources (predict pools, batcher thread, the
        rollout controller, and both arms' algorithm-held resources).
        The HTTP transport's stop() does not know about them."""
        if self.batcher is not None:
            self.batcher.close()
        self._predict_pool.shutdown(wait=False)
        self._hedge_pool.shutdown(wait=False)
        if self.rollout is not None:
            self.rollout.close()
        arms = list(getattr(self, "algorithms", []))
        if self.candidate is not None:
            arms += self.candidate.algorithms
        for algo in arms:
            close = getattr(algo, "close", None)
            if callable(close):
                close()

    # -- warm-up -------------------------------------------------------------
    def _warm_bucket_set(self) -> list[int]:
        """The batch sizes the warm sweep runs: batch_max's bucket alone.
        Every batch of up to batch_max queries runs its library products
        at the DISPATCH_ROWS shape, so the largest batch warms what every
        smaller one runs, and the scan kernel's widest grid besides (the
        reference runs the whole power-of-two ladder, one shape each)."""
        return [pow2_bucket(self.config.batch_max)]

    def _warm(self) -> None:
        if self.config.warm_query is None:
            return
        try:
            # record=False: warm-up does not count toward stats
            self.query(dict(self.config.warm_query), record=False)
        except Exception:  # noqa: BLE001 - warmup is best-effort
            log.warning("warm query failed", exc_info=True)
        if self.batcher is None:
            return
        try:
            # run the sweep up front so the batchers' first batches find
            # the retrieval index built and the device allocator primed
            self._sweep(self.config.warm_query)
            self._buckets_warmed = True
        except Exception:  # noqa: BLE001 - warmup is best-effort
            log.warning("warm batch failed", exc_info=True)
        finally:
            # ready either way: a failed warm means traffic pays the
            # first-batch cost, which beats a permanently not-ready
            # instance
            self._buckets_ready.set()

    def _sweep(self, sample: dict) -> None:
        """One unrecorded batch of ``sample`` at each warm bucket size."""
        t0 = time.monotonic()
        buckets = self._warm_bucket_set()
        for b in buckets:
            self.query_batch([dict(sample)] * b, record=False)
        self.warm_sweep = {"seconds": time.monotonic() - t0,
                           "buckets": buckets}

    def _auto_warm_buckets(self, sample: dict) -> None:
        """Run the warm sweep in the background using a clone of the
        first real query, so the first batch's costs never land
        mid-traffic. Explicit ServingConfig.warm_query does this up front
        at startup."""
        # atomic test-and-set: concurrent batch executions must not spawn
        # duplicate warm threads
        if self.batcher is None:
            return
        with self._warm_once:
            if self._buckets_warmed:
                return
            self._buckets_warmed = True
        # pio: lint-ok[attr-no-lock] threading.Event is internally locked
        self._buckets_ready.clear()  # /readyz drops while the sweep runs

        def go():
            try:
                self._sweep(sample)
            except Exception:  # noqa: BLE001 - warmup is best-effort
                log.warning("background bucket warm failed", exc_info=True)
            finally:
                self._buckets_ready.set()

        # pio: lint-ok[context-loss] deliberate detach: bucket warm-up
        # is best-effort background priming, not on the triggering
        # request's clock or trace
        threading.Thread(
            target=go, name="bucket-warm", daemon=True
        ).start()

    # -- query path (reference CreateServer.scala:492-615) ------------------
    def query(self, q: dict, record: bool = True) -> Any:
        """``record=False`` keeps the call out of the stage histograms, the
        request count, the rollout's stats, feedback (warm-ups, a batch
        backfill's queries); such calls always ride the active arm."""
        t0 = time.monotonic()
        # guarded rollout: the controller picks the arm (sticky crc32c
        # user split); warm-ups (record=False) always ride active
        rollout = self.rollout if record else None
        arm = rollout.arm_for(q) if rollout is not None else ARM_ACTIVE
        # warm-up calls (record=False) must not enter the stage
        # histograms: their first-call spans would pollute dashboard
        # quantiles AND the hedge-arming median (_hedge_timeout)
        span = self.tracer.span if record else _no_span
        models, algorithms, serving, instance_id = self._arm_snapshot(arm)
        try:
            with span("supplement", arm=arm):
                supplemented = serving.supplement(q)
            with span("predict", arm=arm):
                if record:
                    self._count_dispatch(arm)
                if len(algorithms) > 1:
                    # concurrent per-algo predict; copy_context: predict
                    # runs ON the request path — the Deadline budget and
                    # trace must follow it onto the pool worker
                    futures = [
                        self._predict_pool.submit(
                            contextvars.copy_context().run,
                            a.predict, m, supplemented)
                        for a, m in zip(algorithms, models)
                    ]
                    predictions = [f.result() for f in futures]
                else:
                    predictions = [
                        algorithms[0].predict(models[0], supplemented)]
            with span("serve", arm=arm):
                prediction = serving.serve(q, predictions)
        except Exception:
            if rollout is not None:
                rollout.observe(arm, q, None, time.monotonic() - t0,
                                error=True)
            raise
        if rollout is not None:
            rollout.observe(arm, q, prediction, time.monotonic() - t0)
        if record:
            self._auto_warm_buckets(q)
        return self._postprocess(q, prediction, instance_id, record, t0)

    def _count_dispatch(self, arm: str) -> None:
        with self._lock:
            self.arm_dispatches[arm] += 1

    def _hedge_timeout(self) -> float | None:
        """Seconds after which a predict dispatch gets a duplicate, or
        None when hedging is off / not yet armed (needs 20 recorded spans
        so warm-ups never count as stalls)."""
        if self.config.hedge_after <= 0:
            return None
        h = self.tracer.histogram("predict")
        if h.count < 20:
            return None
        p50 = h.quantiles((0.5,))["p50"]
        if p50 <= 0:
            return None
        return max(0.05, self.config.hedge_after * p50)

    def _hedged(self, fn, *args):
        """Run fn on the hedge pool; if it outlives the hedge timeout,
        race a duplicate and return whichever finishes first. fn must be
        pure (device predict is), so the loser is discarded harmlessly.

        The hedge clock starts when the task actually STARTS on a pool
        worker, not at submit: under >pool-width concurrent dispatches,
        queue wait would otherwise read as a "stall" and fire spurious
        duplicates into the already-saturated pool. If the task hasn't
        even started within the timeout, the pool is saturated — a
        duplicate could only queue behind the original, so hedging is
        skipped entirely."""
        timeout = self._hedge_timeout()
        if timeout is None:
            return fn(*args)
        started = threading.Event()
        t_start: list[float] = []

        def wrapped(*a):
            t_start.append(time.monotonic())
            started.set()
            return fn(*a)

        # copy_context on both attempts: the hedged dispatch is the
        # request's own predict — it must see the Deadline budget and
        # parent its spans into the request trace
        futs = [self._hedge_pool.submit(
            contextvars.copy_context().run, wrapped, *args)]
        if not started.wait(timeout):
            # saturated pool: no worker picked the task up within the
            # hedge window — duplicates add load without cutting latency
            return futs[0].result()
        try:
            remaining = t_start[0] + timeout - time.monotonic()
            return futs[0].result(timeout=max(0.0, remaining))
        except FuturesTimeoutError:
            with self._lock:
                self.hedged_dispatches += 1
            futs.append(self._hedge_pool.submit(
                contextvars.copy_context().run, fn, *args))
        # first SUCCESS wins; an attempt's exception propagates only once
        # every attempt has failed
        pending = set(futs)
        first_exc: BaseException | None = None
        while pending:
            done, pending = futures_wait(
                pending, timeout=60.0, return_when=FIRST_COMPLETED
            )
            for f in done:
                exc = f.exception()
                if exc is None:
                    for loser in pending:
                        loser.cancel()  # free not-yet-started duplicates
                    return f.result()
                first_exc = first_exc or exc
        raise first_exc

    def query_batch(self, queries: list[dict], record: bool = True,
                    observe_batch_errors: bool = True) -> list:
        """Serve several queries as one batch_predict per algorithm (the
        micro-batching execution path; also the bulk path behind
        /batch/queries.json). With a rollout in flight the batch is
        partitioned by arm — each sub-batch executes against its own
        arm's models (its rows padded to the dispatch shape like any
        batch's, so each answer keeps its solo bits), results reassemble
        in request order.

        Nothing of a batch is recorded (rollout stats, feedback events,
        the query histogram) until every arm has answered and every
        answer has passed the output blockers, which may raise to reject
        a request: a sub-batch or a blocker that fails leaves the batch
        unrecorded, so the solo retries of the batchers
        (QueryBatcher/ContinuousBatcher) count each member once. The
        reference observes the first arm's answers before the second arm
        runs, and writes feedback before the blockers, and its retries
        then count them again. observe_batch_errors=False is for those
        callers: the failed arm's members are not counted as errors
        either (their retries record them); with True (the bulk route,
        which does not retry) the failed arm's members count as errors
        and the arms answered before it as served. `query(record=False)`
        takes rollout=None (no stats at all), and `_hedged` duplicates
        run the bare predict fn — neither re-records a request's stats."""
        t0 = time.monotonic()
        rollout = self.rollout if record else None
        arms = ([rollout.arm_for(q) for q in queries] if rollout is not None
                else [ARM_ACTIVE] * len(queries))
        served = []
        for arm in (ARM_ACTIVE, ARM_CANDIDATE):
            idx = [i for i, a in enumerate(arms) if a == arm]
            if not idx:
                continue
            sub = [queries[i] for i in idx]
            try:
                predictions, instance_id, dt = self._query_batch_arm(
                    sub, arm, record, rollout, observe_batch_errors)
            except Exception:
                if rollout is not None and observe_batch_errors:
                    _observe_served(rollout, served)
                raise
            served.append((arm, idx, sub, predictions, instance_id, dt))
        out: list = [None] * len(queries)
        events: list = []
        try:
            for _, idx, sub, predictions, instance_id, _ in served:
                for i, q, p in zip(idx, sub, predictions):
                    out[i] = self._output(q, p, instance_id, record, events)
        except Exception:
            if rollout is not None and observe_batch_errors:
                _observe_served(rollout, served)
            raise
        if rollout is not None:
            _observe_served(rollout, served)
        self._answered(events, len(queries), record, t0)
        return out

    def _query_batch_arm(self, queries: list[dict], arm: str, record: bool,
                         rollout, observe_batch_errors: bool) -> tuple:
        """One arm's sub-batch -> (predictions, instance id, the seconds
        each query is charged). Each query is charged the wall time of the dispatch that
        answered it, the arm's own sub-batch, as a solo query is charged
        its own: the arms execute sequentially, so whole-batch time would
        bill one arm's dispatch to the other; and every sub-batch runs at
        the dispatch rows, so a dispatch's cost barely follows its size,
        and its wall over its size (the reference's) makes the smaller
        arm's queries look slower (ROADMAP C13)."""
        # see query(): warm-up spans stay out of the histograms
        span = self.tracer.span if record else _no_span
        arm_t0 = time.monotonic()
        models, algorithms, serving, instance_id = self._arm_snapshot(arm)
        try:
            with span("supplement", arm=arm):
                supplemented = [serving.supplement(q) for q in queries]
            with span("predict", arm=arm):
                if record:
                    self._count_dispatch(arm)
                if len(algorithms) > 1:
                    futures = [
                        self._predict_pool.submit(
                            contextvars.copy_context().run,
                            self._hedged, a.batch_predict, m, supplemented)
                        for a, m in zip(algorithms, models)
                    ]
                    per_algo = [f.result() for f in futures]
                else:
                    per_algo = [
                        self._hedged(algorithms[0].batch_predict, models[0],
                                     supplemented)
                    ]
            if record and queries:
                # the batched path is the PRIMARY path when the batcher is
                # on (query() is bypassed), so auto-warm must hook here
                # too; the warm calls pass record=False and cannot recurse
                self._auto_warm_buckets(queries[0])
            with span("serve", arm=arm):
                predictions = [
                    serving.serve(q, [algo_out[i] for algo_out in per_algo])
                    for i, q in enumerate(queries)
                ]
        except Exception:
            if rollout is not None and observe_batch_errors:
                dt = time.monotonic() - arm_t0
                for q in queries:
                    rollout.observe(arm, q, None, dt, error=True)
            raise
        return predictions, instance_id, time.monotonic() - arm_t0

    def _postprocess(self, q, prediction, instance_id, record, t0):
        events: list = []
        prediction = self._output(q, prediction, instance_id, record, events)
        self._answered(events, 1, record, t0)
        return prediction

    def _output(self, q, prediction, instance_id, record, events: list):
        """The feedback ``prId`` and the output blockers, which may raise
        to reject the request. The feedback event is appended to
        ``events``, not written: a rejected request writes none."""
        if record and self.config.feedback:
            prediction, event = self._feedback_event(q, prediction,
                                                     instance_id)
            events.append(event)
        for blocker in self.plugins.output_blockers:
            prediction = blocker.process(
                q, prediction, {"engineInstanceId": instance_id}
            )
        return prediction

    def _answered(self, events: list, n: int, record: bool, t0) -> None:
        """Write the feedback events of ``n`` answered queries and record
        each in the query histogram."""
        if events:
            self._send_feedback(events)
        if record:
            dt = time.monotonic() - t0
            for _ in range(n):
                self.tracer.record("query", dt)

    def _feedback_event(self, query: dict, prediction: Any,
                        instance_id: str) -> tuple:
        """The prediction as a pio_pr 'predict' event (reference
        CreateServer.scala:536-598) -> (prediction, event): a prediction
        that carries a ``prId`` answers with the event's id in its
        place."""
        import secrets

        pr_id = None
        if isinstance(prediction, dict):
            pr_id = prediction.get("prId") or None
        new_pr_id = pr_id or secrets.token_urlsafe(48)[:64]
        event = Event(
            event="predict",
            entity_type="pio_pr",
            entity_id=new_pr_id,
            properties={
                "engineInstanceId": instance_id,
                "query": query,
                "prediction": prediction,
            },
            pr_id=query.get("prId") if isinstance(query, dict) else None,
        )
        if isinstance(prediction, dict) and "prId" in prediction:
            prediction = dict(prediction, prId=new_pr_id)
        return prediction, event

    def _send_feedback(self, events: list) -> None:
        """Insert the events in process on a detached thread, never on
        the request's budget."""

        def send():
            for event in events:
                try:
                    app = self.storage.get_metadata_apps().get_by_name(
                        self.config.feedback_app_name
                    )
                    if app is None:
                        log.error(
                            "feedback app %r not found",
                            self.config.feedback_app_name,
                        )
                        return
                    self.storage.get_events().insert(event, app.id)
                except Exception:  # noqa: BLE001 - must not fail serving
                    log.error("feedback event failed", exc_info=True)

        # pio: lint-ok[context-loss] deliberate detach: the feedback
        # insert must not be cancelled by the request's exhausted
        # budget, and it runs after the response is already decided
        threading.Thread(target=send, daemon=True).start()

    # -- streaming fold-in (freshness/) -------------------------------------
    def foldin_upsert(self, rows, staleness_s: float | None = None,
                      items=None) -> dict:
        """Hot-swap refreshed user factor rows into the serving model
        (the freshness subsystem's apply surface): existing users'
        rows are replaced in place, new users are APPENDED — id index
        and factor table extended together, so ``recommend_topk`` and
        the id decode stay aligned. Last-good semantics: the new model
        is built completely OUTSIDE the lock and swapped atomically; a
        failure anywhere leaves the previous model serving untouched.
        ``rows`` maps user id → (k,)-float sequence.

        ``items`` maps item id → (k,)-float sequence and upserts
        EXISTING items' factor rows in the same atomic swap — including
        the two-stage retrieval sidecar (ops/retrieval.py): the cached
        quantized table and cluster assignments are re-encoded for
        exactly the touched rows and the device index rebuilt from
        them, so an upserted item is retrievable through the candidate
        tier immediately after this call returns, not after a lazy
        rebuild. Unknown item ids are REJECTED (appending an item needs
        a dense index that only a retrain assigns).

        With a rollout in flight the rows land on BOTH arms (or queue
        for the candidate), so streaming freshness never silently
        diverges the experiment."""
        rows = rows or {}
        items = items or {}
        if not rows and not items:
            with self._lock:
                return {"applied": 0, "new": 0,
                        "engineInstanceId": self.instance.id}
        with self._lock:
            models = list(self.models)
            instance_id = self.instance.id
        mi, model, new_model, new_ids = _fold_rows_into(models, rows)
        items_applied, items_rejected = 0, []
        if items:
            new_model, items_applied, items_rejected = \
                _fold_item_rows_into(new_model, items)
        with self._lock:
            # the model may have moved while we built the new one: a
            # /reload (new instance — applying stale rows onto it would
            # mix factor spaces) or a CONCURRENT fold-in apply (swapping
            # over it would silently drop the other batch's rows, which
            # the folder then never refolds — its cursor advanced).
            # Object identity catches both; report instead of guessing
            if (self.instance.id != instance_id
                    or self.models[mi] is not model):
                raise ValueError(
                    f"serving model changed (instance {instance_id} -> "
                    f"{self.instance.id}, or a concurrent fold-in apply) "
                    "during fold-in apply; retry")
            models = list(self.models)
            models[mi] = new_model
            self.models = models
            self.foldin_applied_users += len(rows)
            self.foldin_applied_items += items_applied
            self.foldin_last_time = utcnow()
            if staleness_s is not None:
                self.foldin_last_staleness_s = float(staleness_s)
        out = {"applied": len(rows), "new": len(new_ids),
               "engineInstanceId": instance_id}
        if items:
            out["itemsApplied"] = items_applied
            out["itemsRejected"] = items_rejected
        # second arm: the ACTIVE apply above is the durable one (the
        # folder's cursor advances on it); the candidate apply is
        # best-effort-with-queue — a failure parks the rows in
        # _candidate_foldin_pending and retries on the next apply (and
        # at promote), never blocking freshness on the experiment
        with self._lock:
            has_candidate = self.candidate is not None
        if has_candidate:
            out["candidateQueued"] = self._apply_foldin_to_candidate(
                rows, items)
        return out

    def _apply_foldin_to_candidate(self, rows, items=None) -> int:
        """Apply `rows`/`items` (plus anything previously queued) to the
        candidate arm. Returns the queue depth left behind (0 = fully
        applied). Never raises: the active apply already succeeded and
        the folder must not re-solve the window for a canary hiccup."""
        with self._lock:
            cand = self.candidate
            if cand is None:
                self._candidate_foldin_pending = {}
                self._candidate_item_pending = {}
                return 0
            pending = dict(self._candidate_foldin_pending)
            pending.update(rows)
            pending_items = dict(self._candidate_item_pending)
            pending_items.update(items or {})
            models = list(cand.models)
        try:
            mi, model, new_model, _ = _fold_rows_into(models, pending)
            if pending_items:
                new_model, _, _ = _fold_item_rows_into(
                    new_model, pending_items)
        except ValueError as e:
            with self._lock:
                self._candidate_foldin_pending = pending
                self._candidate_item_pending = pending_items
            log.warning("fold-in rows queued for candidate arm (%d "
                        "users, %d items): %s", len(pending),
                        len(pending_items), e)
            return len(pending) + len(pending_items)
        with self._lock:
            cand = self.candidate
            if cand is None:
                self._candidate_foldin_pending = {}
                self._candidate_item_pending = {}
                return 0
            if cand.models[mi] is not model:
                # the arm moved mid-build (promote/drop/another apply):
                # queue and let the next apply land on the new arm
                self._candidate_foldin_pending = pending
                self._candidate_item_pending = pending_items
                return len(pending) + len(pending_items)
            cand_models = list(cand.models)
            cand_models[mi] = new_model
            self.candidate = _CandidateArm(
                instance=cand.instance, models=cand_models,
                algorithms=cand.algorithms, serving=cand.serving)
            self._candidate_foldin_pending = {}
            self._candidate_item_pending = {}
        return 0

    def _flush_candidate_foldin(self) -> None:
        """Drain queued candidate fold-ins (called before promote so
        the promoted arm is as fresh as the active one was)."""
        with self._lock:
            pending = dict(self._candidate_foldin_pending)
            pending_items = dict(self._candidate_item_pending)
        if pending or pending_items:
            self._apply_foldin_to_candidate(pending, pending_items)

    def foldin_status(self) -> dict:
        """Bounded-staleness accounting for GET /, /readyz and
        /metrics.json."""
        with self._lock:
            return {
                "appliedUsers": self.foldin_applied_users,
                "appliedItems": self.foldin_applied_items,
                "lastAppliedTime": (format_time(self.foldin_last_time)
                                    if self.foldin_last_time else None),
                "stalenessSeconds": self.foldin_last_staleness_s,
                "candidateQueued": (len(self._candidate_foldin_pending)
                                    + len(self._candidate_item_pending)),
            }

    # -- status -------------------------------------------------------------
    @property
    def request_count(self) -> int:
        return self.tracer.histogram("query").count

    @property
    def avg_serving_sec(self) -> float:
        h = self.tracer.histogram("query")
        return h.total / h.count if h.count else 0.0

    @property
    def last_serving_sec(self) -> float:
        return self.tracer.histogram("query").last

    def status(self) -> dict:
        with self._lock:
            return {
                "status": "alive",
                "engineInstance": {
                    "id": self.instance.id,
                    "engineId": self.instance.engine_id,
                    "engineVersion": self.instance.engine_version,
                    "engineVariant": self.instance.engine_variant,
                    "startTime": format_time(self.instance.start_time),
                },
                "startTime": format_time(self.start_time),
                "device": str(self.ctx.device),
                "requestCount": self.request_count,
                "avgServingSec": round(self.avg_serving_sec, 6),
                "lastServingSec": round(self.last_serving_sec, 6),
                "foldin": self.foldin_status(),
            }

    def metrics(self) -> dict:
        """Per-stage latency histograms (p50/p90/p95/p99 over the recent
        window, all-time count/avg) — the serving observability surface —
        the recorded device dispatches of each rollout arm
        (``armDispatches``) and the launches of each CUDA kernel in this
        process (``kernelLaunches``; the CPU's plain versions do not
        count).
        ``exemplars`` link each span's slowest recent occurrence to a
        trace id."""
        from pio_tpu_torch.ops.kernels import launch_counts

        with self._lock:
            arm_dispatches = dict(self.arm_dispatches)
        out = {
            "startTime": format_time(self.start_time),
            "spans": self.tracer.snapshot(),
            "hedgedDispatches": self.hedged_dispatches,
            "armDispatches": arm_dispatches,
            "kernelLaunches": launch_counts(),
            "foldin": self.foldin_status(),
        }
        if self.recorder is not None:
            out["exemplars"] = self.recorder.exemplars()
        return out


def _observe_served(rollout, served: list) -> None:
    """Record the queries of each answered sub-batch (``query_batch``'s
    ``served``) in the rollout's stats, at its arm's seconds a query."""
    for arm, _, sub, predictions, _, dt in served:
        for q, p in zip(sub, predictions):
            rollout.observe(arm, q, p, dt)


def _predict_on(models, algorithms, serving, q: dict) -> Any:
    """One query through an arm's supplement, predict and serve, with no
    span, stats, feedback or plugins (shadow scoring, a candidate's warm
    query)."""
    supplemented = serving.supplement(dict(q))
    predictions = [
        a.predict(m, supplemented) for a, m in zip(algorithms, models)
    ]
    return serving.serve(q, predictions)


def _fold_rows_into(models: list, rows) -> tuple:
    """Build an updated factor-table model with `rows` upserted —
    existing users replaced in place, new users appended with the id
    index extended in lockstep. Pure with respect to serving state (the
    caller swaps under its lock): returns
    ``(model_index, old_model, new_model, new_ids)``. Raises ValueError
    when no deployed model has a factor table or a row's rank
    mismatches."""
    for mi, model in enumerate(models):
        factors = getattr(model, "factors", None)
        if (getattr(factors, "user_factors", None) is not None
                and getattr(model, "users", None) is not None):
            break
    else:
        raise ValueError(
            "fold-in needs a factor-table model (factors.user_factors "
            "+ users index); none of the deployed models qualifies")
    uf = model.factors.user_factors
    k = int(uf.shape[1])
    users = model.users
    existing: list[tuple[int, list[float]]] = []
    new_ids: list = []
    new_rows: list = []
    for uid, row in rows.items():
        if len(row) != k:
            raise ValueError(
                f"fold-in row for {uid!r} has {len(row)} dims, model "
                f"rank is {k}")
        if uid in users:
            existing.append((users.index_of(uid), row))
        else:
            new_ids.append(uid)
            new_rows.append(row)
    new_uf = uf
    if existing:
        idx = torch.as_tensor([i for i, _ in existing], dtype=torch.long,
                              device=uf.device)
        vals = np.asarray([r for _, r in existing], np.float32)
        new_uf = new_uf.clone()
        new_uf[idx] = torch.from_numpy(vals).to(uf.device)
    if new_ids:
        new_uf = torch.cat([new_uf, torch.from_numpy(
            np.asarray(new_rows, np.float32)).to(uf.device)])
    new_model = dataclasses.replace(
        model,
        factors=dataclasses.replace(model.factors, user_factors=new_uf),
        users=users.extended(new_ids) if new_ids else users,
    )
    # a user-only fold-in leaves item_factors the SAME tensor object, so
    # the retrieval sidecar cache (keyed by item-table identity in
    # models/recommendation.py) stays valid — carry it so a user upsert
    # never forces a k-means rebuild on the next clustered query
    cache = getattr(model, "_retrieval_cache", None)
    if cache is not None:
        new_model._retrieval_cache = cache
    return mi, model, new_model, new_ids


def _fold_item_rows_into(model, items) -> tuple:
    """Upsert EXISTING items' factor rows on `model` — the item-side
    half of streaming fold-in. Returns ``(new_model, applied,
    rejected_ids)``; unknown ids are rejected, not appended (appending
    an item needs the retrieval tier's dense index space to grow, which
    only a retrain assigns). When the model carries a two-stage
    retrieval cache for its current item table, the quantized rows and
    cluster assignments are re-encoded for the touched positions IN THIS
    BUILD and the device index is rebuilt from them, so the swap that
    publishes the f32 rows publishes the candidate tier's view of them
    too — never a stale quantized row serving beside a fresh f32 one.
    Raises ValueError on rank mismatch."""
    itf = getattr(getattr(model, "factors", None), "item_factors", None)
    if itf is None or getattr(model, "items", None) is None:
        raise ValueError(
            "item fold-in needs a factor-table model (factors."
            "item_factors + items index); the deployed model "
            "does not qualify")
    k = int(itf.shape[1])
    positions: list[int] = []
    vals: list = []
    rejected: list = []
    for iid, row in items.items():
        if len(row) != k:
            raise ValueError(
                f"fold-in row for item {iid!r} has {len(row)} dims, "
                f"model rank is {k}")
        if iid in model.items:
            positions.append(model.items.index_of(iid))
            vals.append(row)
        else:
            rejected.append(iid)
    if not positions:
        return model, 0, rejected
    pos = np.fromiter(positions, np.int64, count=len(positions))
    rows_f32 = np.asarray(vals, np.float32)
    new_itf = itf.clone()
    new_itf[torch.from_numpy(pos).to(itf.device)] = \
        torch.from_numpy(rows_f32).to(itf.device)
    new_model = dataclasses.replace(
        model,
        factors=dataclasses.replace(model.factors, item_factors=new_itf),
    )
    cache = getattr(model, "_retrieval_cache", None)
    if cache is not None and cache[0] is itf:
        idx, _didx = cache[1]
        new_idx = idx.updated(pos, rows_f32)
        new_model._retrieval_cache = (
            new_itf, (new_idx, rt.build_device_index(new_idx,
                                                     new_itf.device)))
    return new_model, len(positions), rejected


def _depth_for_rtt(rtt_s: float) -> int:
    """Dispatch-RTT -> pipeline depth. High-RTT (remote) devices want
    several batches in flight to hide the link; local devices get TWO:
    with one batch in flight any stall serializes the whole queue behind
    it, and two is the minimal depth that overlaps the collection window
    with the in-flight batch while bounding how deep a queue can build
    behind a stalled batch."""
    return 4 if rtt_s > 0.005 else 2


_auto_depth_cache: dict[str, int] = {}
_auto_depth_lock = threading.Lock()


def _auto_pipeline_depth(device) -> int:
    """Resolve ServingConfig.batch_pipeline=0: measure the dispatch
    round trip on ``device`` once per process (cached — re-deploys and
    multi-engine processes skip the probe) and map it via
    _depth_for_rtt. The probe is a one-element add and, on a card, a
    ``torch.cuda.synchronize``; a device error propagates (a broken
    card must fail the deploy, not size its pipeline). Probe and cache
    write run under a lock: two engines deploying concurrently must not
    both pay the probe."""
    device = torch.device(device)
    key = str(device)
    with _auto_depth_lock:
        if key in _auto_depth_cache:
            return _auto_depth_cache[key]

        def round_trip() -> None:
            one.add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        one = torch.zeros((), device=device)
        # pio: lint-ok[blocking-under-lock] one-time boot probe: the lock
        # exists to serialize exactly this measurement (docstring above);
        # steady state returns the cache
        round_trip()  # first call: context and allocator, not measured
        samples = []
        for _ in range(5):
            t0 = time.monotonic()
            round_trip()
            samples.append(time.monotonic() - t0)
        depth = _depth_for_rtt(sorted(samples)[len(samples) // 2])
        _auto_depth_cache[key] = depth
        return depth


class QueryBatcher:
    """Dynamic micro-batching: requests enqueue, a collector thread drains
    up to `max_batch` of them within `window_s`, and each batch executes as
    one `query_batch` ON A POOL — so several batches stay in flight at once.
    One batched top-k replaces N small ones and the pipelining keeps
    throughput up even when a device dispatch is round-trip-dominated;
    cost is up to window_s added latency, so it is off unless
    ServingConfig.batch_window_ms is set.

    window_s < 0 selects ADAPTIVE batching: the collector never waits —
    it drains everything already queued and hands it off, so while a
    batch executes the next one accumulates. Batch size then self-tunes
    to arrival_rate x execution_time with ZERO added latency at low
    load; a fixed window can only lose against it when execution is
    RTT-dominated."""

    def __init__(self, server: QueryServer, window_s: float, max_batch: int,
                 pipeline_depth: int):
        self.server = server
        self.window_s = window_s
        self.max_batch = max_batch
        self._q: queue.Queue[tuple[dict, Future]] = queue.Queue()
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=pipeline_depth, thread_name_prefix="batch-exec"
        )
        # backpressure: ThreadPoolExecutor.submit never blocks, so without
        # this bound the collector shreds the queue into 1-sized batches
        # that pile up in the executor's unbounded queue — no batch ever
        # forms and latency becomes queue wait. Acquired BEFORE draining,
        # so requests accumulate while all pipeline slots are busy and
        # each freed slot takes a real batch.
        self._slots = threading.BoundedSemaphore(pipeline_depth)
        self._thread = threading.Thread(
            target=self._run, name="query-batcher", daemon=True
        )
        self._thread.start()

    def query(self, q: dict) -> Any:
        fut: Future = Future()
        self._q.put((q, fut))
        # batch execution runs on the batcher pool, which does not
        # inherit the caller's Deadline contextvar — enforce the budget
        # here, at the wait (the batch result lands harmlessly later)
        timeout = Deadline.remaining()
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeoutError:
            raise DeadlineExceeded(
                "request budget exhausted waiting for batch execution"
            ) from None

    def _run(self):
        while not self._closed:
            try:
                first = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            self._slots.acquire()  # wait for a pipeline slot FIRST
            batch = [first]
            if self.window_s < 0:  # adaptive: take what's there, no wait
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._q.get_nowait())
                    except queue.Empty:
                        break
            else:
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
            # hand off and go straight back to collecting the next batch
            try:
                self._pool.submit(self._execute, batch)
            except RuntimeError as e:
                self._slots.release()
                # close() raced the collection: fail the batch's waiters
                # rather than stranding them on never-set futures
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return

    def _execute(self, batch: list[tuple[dict, Future]]):
        queries = [q for q, _ in batch]
        try:
            self._do_execute(batch, queries)
        finally:
            self._slots.release()

    def _do_execute(self, batch, queries):
        try:
            # observe_batch_errors=False: the per-query retry below
            # records each member's rollout stats exactly once on a
            # batch failure (see query_batch's docstring)
            results = self.server.query_batch(
                queries, observe_batch_errors=False)
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
        except Exception:  # noqa: BLE001 - isolate the bad query
            # one malformed query must not fail its batch-mates: retry
            # each one alone so only the offender sees the error
            for q, fut in batch:
                if fut.done():
                    continue
                try:
                    fut.set_result(self.server.query(q))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)

    def close(self):
        self._closed = True
        self._pool.shutdown(wait=False)


def build_serving_app(server: QueryServer) -> HttpApp:
    app = HttpApp("serving")
    config = server.config

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, config.server_key)

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, server.status()

    def _budgeted(fn):
        """Run one query dispatch under the per-request Deadline budget
        (ServingConfig.request_budget_s); exhausted budgets and tripped
        storage breakers surface as 503 + Retry-After instead of a 500
        or a connection held past its usefulness."""
        try:
            if config.request_budget_s > 0:
                with Deadline.budget(config.request_budget_s):
                    return 200, fn()
            return 200, fn()
        except KeyError as e:
            return 400, {"message": f"query missing field {e}"}
        except DeadlineExceeded as e:
            return 503, json_response(
                {"message": f"request budget exhausted: {e}"},
                {"Retry-After": "1"},
            )
        except CircuitOpenError as e:
            return 503, json_response(
                {"message": str(e)},
                {"Retry-After": f"{max(1, round(e.retry_after_s))}"},
            )

    @app.route("POST", r"/queries\.json")
    def queries(req: Request):
        try:
            q = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid query: {e}"}
        if not isinstance(q, dict):
            return 400, {"message": "query must be a JSON object"}
        if server.batcher is not None:
            return _budgeted(lambda: server.batcher.query(q))
        return _budgeted(lambda: server.query(q))

    @app.route("POST", r"/batch/queries\.json")
    def batch_queries(req: Request):
        """Bulk endpoint: a JSON array of queries answered by one
        batch_predict per algorithm."""
        try:
            qs = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid query batch: {e}"}
        if not isinstance(qs, list) or not all(isinstance(q, dict) for q in qs):
            return 400, {"message": "body must be a JSON array of objects"}
        if not qs:
            return 200, []
        return _budgeted(lambda: server.query_batch(qs))

    @app.route("POST", r"/model/upsert_users")
    def upsert_users(req: Request):
        """Streaming fold-in apply surface (freshness/): body
        ``{"users": {id: [row]}, "items"?: {id: [row]},
        "stalenessSeconds"?: s}``. Item rows upsert existing items AND
        their two-stage retrieval sidecar in the same swap. Guarded
        like /reload — it mutates the serving model."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            body = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid body: {e}"}
        users = body.get("users") if isinstance(body, dict) else None
        items = body.get("items") if isinstance(body, dict) else None
        if not isinstance(users, dict) and not isinstance(items, dict):
            return 400, {"message": "body must be {\"users\": {id: [row]}}"
                                    " and/or {\"items\": {id: [row]}}"}
        try:
            out = server.foldin_upsert(
                users if isinstance(users, dict) else {},
                body.get("stalenessSeconds"),
                items=items if isinstance(items, dict) else {})
        except ValueError as e:
            return 400, {"message": str(e)}
        return 200, out

    @app.route("POST", r"/reload")
    @app.route("GET", r"/reload")  # deprecated alias: reload MUTATES
    # serving state, so POST is the canonical route
    def reload(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            instance_id = server.reload()
        except Exception as e:  # noqa: BLE001 - degrade, don't die
            # last-good serving: the failed load left the previous
            # instance fully in place (see QueryServer._load), so report
            # the failure AND what is still serving
            with server._lock:
                still = server.instance.id
            return 503, json_response(
                {"message": f"Reload failed ({type(e).__name__}: {e}); "
                            "still serving last-good model",
                 "engineInstanceId": still},
                {"Retry-After": "1"},
            )
        return 200, {"message": "Reloaded", "engineInstanceId": instance_id}

    @app.route("POST", r"/stop")
    def stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        server._stop_requested.set()
        return 200, {"message": "Shutting down."}

    @app.route("GET", r"/metrics\.json")
    def metrics(req: Request):
        return 200, server.metrics()

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """Prometheus text exposition of the same data as /metrics.json
        (span latency summaries + counters) for scrape-based stacks —
        through the shared renderer with the uniform `surface` label."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.httpclient import pool_counters
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE,
            prometheus_text,
        )

        counters = {
            "hedged_dispatches_total": float(server.hedged_dispatches),
            "foldin_applied_users_total":
                float(server.foldin_applied_users),
            "uptime_seconds":
                (utcnow() - server.start_time).total_seconds(),
        }
        # outbound keep-alive pool: the serving process's storage DAO
        # RPCs ride it
        counters.update(pool_counters())
        text = prometheus_text(server.tracer.snapshot(), counters,
                               labels={"surface": "serving"})
        batcher = server.batcher
        if batcher is not None and hasattr(batcher, "occupancy_exposition"):
            # continuous batching: batch-occupancy distribution (fraction
            # of batch_max per coalesced dispatch) as a real histogram
            # family — the occupancy-pinned-at-1.0 saturation signal
            from pio_tpu_torch.utils.tracing import prometheus_histogram

            buckets, counts, total, occ_sum = batcher.occupancy_exposition()
            text += "\n".join(prometheus_histogram(
                "serving_batch_occupancy", buckets, counts, total, occ_sum,
                labels={"surface": "serving"})) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    @app.route("GET", r"/batcher\.json")
    def batcher_status(req: Request):
        """Admission-stage visibility: which batcher fronts the device
        program (continuous / micro / none) and its live counters —
        dispatches, coalesced queries, occupancy, coalesce wait, solo
        bypasses and deadline sheds."""
        batcher = server.batcher
        if batcher is None:
            return 200, {"mode": None, "enabled": False}
        if hasattr(batcher, "stats"):
            return 200, {"enabled": True, **batcher.stats()}
        return 200, {
            "enabled": True, "mode": "micro",
            "windowMs": config.batch_window_ms,
            "maxBatch": config.batch_max,
        }

    @app.route("POST", r"/batcher/window")
    def batcher_window(req: Request):
        """Live coalesce-window retune (server-key guarded, like /reload):
        widen a window whose batches run near-empty, narrow one pinned at
        occupancy 1.0 — without a redeploy. Continuous batcher only."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        batcher = server.batcher
        if batcher is None or not hasattr(batcher, "set_window"):
            return 409, {"message": "continuous batching is not enabled "
                                    "(ServingConfig.coalesce_window_ms)"}
        try:
            body = req.json()
            window_ms = float(body["windowMs"])
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"body must be {{\"windowMs\": ms}}: "
                                    f"{e}"}
        if not (0 < window_ms <= 1000):
            return 400, {"message": "windowMs must be in (0, 1000]"}
        batcher.set_window(window_ms / 1e3)
        return 200, {"message": "window updated", **batcher.stats()}

    @app.route("POST", r"/profile/start")
    def profile_start(req: Request):
        """Capture a device trace (torch.profiler: CPU and CUDA activity)
        while serving. Guarded like /stop."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        from pio_tpu_torch.utils.tracing import start_device_profile

        logdir = req.params.get("logdir", "/tmp/pio_tpu_profile")
        if not start_device_profile(logdir):
            return 409, {"message": "profile already running"}
        return 200, {"message": "profiling", "logdir": logdir}

    @app.route("POST", r"/profile/stop")
    def profile_stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        from pio_tpu_torch.utils.tracing import stop_device_profile

        logdir = stop_device_profile()
        if logdir is None:
            return 409, {"message": "no profile running"}
        return 200, {"message": "profile written", "logdir": logdir}

    def readiness() -> dict:
        """model loaded + storage breakers not open + warm buckets +
        async-transport queue under its shed watermark
        (resilience/health.py contract)."""
        checks = breaker_checks(server.storage)
        with server._lock:
            inst = getattr(server, "instance", None)
        checks["model"] = {
            "ok": inst is not None,
            "engineInstanceId": inst.id if inst is not None else None,
            "lastReloadError": server.last_reload_error,
        }
        # fold-in visibility, NEVER a readiness gate: a stale/absent
        # folder means batch-stale serving (degraded freshness), and
        # flipping serving readyz for it would turn that degradation
        # into an outage
        checks["freshness"] = {"ok": True, **server.foldin_status()}
        # bucket-warm gate: NOT ready while a micro-batch warm sweep is
        # owed or in flight. Always-true when batching is off or no warm
        # query is configured (the sweep then rides the first real
        # request, which readiness must not deadlock on).
        if server.batcher is not None:
            checks["buckets"] = {
                "ok": server._buckets_ready.is_set(),
                "warmed": server._buckets_warmed,
                "sweep": server.warm_sweep,
            }
        # rollout visibility, never a readiness gate: a breached canary
        # auto-rolls-back to the active arm — the server stays ready
        # throughout (that atomic revert is the whole point)
        rollout = server.rollout
        if rollout is not None:
            st = rollout.status()
            checks["rollout"] = {
                "ok": True,
                "stagePct": st["stagePct"],
                "verdict": st["verdict"],
                "candidateInstanceId": st["candidateInstanceId"],
            }
        checks.update(shedder_check(getattr(app, "transport", None)))
        return checks

    install_health_routes(app, readiness)
    # distributed tracing (obs/): /debug/traces.json + /debug/spans.json,
    # and app.recorder switches the dispatch edge into traced mode;
    # app.tracer feeds the per-surface `request` histogram
    from pio_tpu_torch.obs.http import install_trace_routes

    app.tracer = server.tracer
    install_trace_routes(app, server.recorder, check_server_key)
    # guarded rollout verbs (rollout/): /rollout/deploy, /rollout/promote,
    # /rollout/rollback (server-key guarded) + /rollout/status
    install_rollout_routes(app, server, server.storage, check_server_key)

    @app.route("GET", r"/plugins\.json")
    def plugins_list(req: Request):
        return 200, {
            "plugins": {
                p.plugin_name: {"type": p.plugin_type}
                for p in server.plugins.plugins
            }
        }

    @app.route("GET", r"/plugins/([^/]+)(/.*)?")
    def plugin_rest(req: Request):
        name = req.path_args[0]
        plugin = server.plugins.get(name)
        if plugin is None:
            return 404, {"message": f"plugin {name} not found"}
        return 200, plugin.handle_rest(req.path_args[1] or "/", req.params)

    return app


def create_query_server(
    engine: Engine,
    engine_params: EngineParams,
    storage: Storage,
    config: ServingConfig,
    ctx: WorkflowContext | None = None,
    plugin_context: PluginContext | None = None,
    instance_id: str | None = None,
) -> tuple[HttpServer, QueryServer]:
    """The deploy verb's server: models restored onto ``ctx.device`` (CUDA
    unless the context says otherwise) behind the async transport (or the
    threaded one, ``config.backend``), HTTPS with ``certfile``/``keyfile``,
    the output plugins of ``plugin_context``. Call ``start()`` on the
    returned server to bind and serve."""
    qs = QueryServer(engine, engine_params, storage, config, ctx=ctx,
                     plugin_context=plugin_context, instance_id=instance_id)
    from pio_tpu_torch.server.security import server_ssl_context

    app = build_serving_app(qs)
    ssl_ctx = server_ssl_context(config.certfile, config.keyfile)
    if config.backend == "async":
        kwargs = {}
        if config.coalesce_window_ms > 0:
            # admission sized for coalescing: parked waiters are the
            # mechanism, not the overload — admit what one full batch per
            # pipeline slot (plus one forming) can absorb before the
            # LoadShedder starts answering 503
            depth = config.batch_pipeline or _auto_pipeline_depth(
                qs.ctx.device)
            kwargs["shed_watermark"] = max(
                128, config.batch_max * (depth + 1))
        http = AsyncHttpServer(
            app, host=config.ip, port=config.port, ssl_context=ssl_ctx,
            **kwargs)
    else:
        http = HttpServer(
            app, host=config.ip, port=config.port, ssl_context=ssl_ctx)
    return http, qs
