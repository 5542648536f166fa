"""The fold-in worker: tail → solve → apply, with a durable cursor.

One cycle (``run_once``):

  1. tail the event stream from the cursor (columnar window) and merge
     newly-touched users into the pending set, each stamped with its
     oldest unserved event time — the ``staleness_seconds`` numerator;
  2. read the pending users' FULL histories and solve refreshed rows
     (``FoldInSolver`` → the trainer's normal-equations kernel), under
     the ``foldin.solve`` chaos point;
  3. apply the rows to serving under the ``foldin.apply`` chaos point,
     inside a circuit breaker (a down serving layer trips it and the
     folder backs off instead of hammering);
  4. only when every window user is served does the durable cursor
     advance — a crash ANYWHERE in the cycle replays the window
     (idempotently) instead of losing it.

The whole cycle runs under an optional ``Deadline`` budget so a wedged
storage backend cannot hang the folder forever; every failure mode
degrades to batch-stale serving (the pending set and staleness gauge
grow, ``/readyz`` flips once past the staleness budget) and NEVER
touches serving availability.

The solve runs on the worker's device: CUDA unless the caller asks for
the CPU (``device="cpu"``), as every entry point of the port. The
folder's health server has the threaded transport only; the reference's
``async`` backend waits for the port's async transport.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

from pio_tpu_torch.data.eventstore import make_value_fn
from pio_tpu_torch.freshness.apply import FoldInApplyError
from pio_tpu_torch.freshness.cursor import CursorStore, FoldCursor
from pio_tpu_torch.freshness.solver import FoldInSolver
from pio_tpu_torch.freshness.tail import LocalEventSource, _micros
from pio_tpu_torch.ops import als
from pio_tpu_torch.resilience import (
    CircuitBreaker, CircuitOpenError, Deadline,
)
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.server.http import HttpApp, HttpServer, Request
from pio_tpu_torch.utils.time import format_time, utcnow
from pio_tpu_torch.workflow.context import resolve_device

log = logging.getLogger("pio_tpu_torch.freshness")


@dataclass
class FoldInConfig:
    """Folder wiring. The training-read fields (event_names/value_*)
    and the ALS params MUST mirror the deployed engine's — ``pio
    foldin`` derives both from the same engine.json the trainer and
    deploy read, so they cannot drift by hand."""

    app_name: str = ""
    channel_name: str | None = None
    engine_id: str = ""
    engine_version: str = "1"
    engine_variant: str = "default"
    # training-read semantics (mirror models.recommendation.DataSourceParams)
    entity_type: str = "user"
    target_entity_type: str = "item"
    event_names: Sequence[str] = ("rate", "buy")
    value_key: str | None = "rating"
    default_value: float = 4.0
    value_event: str | None = "rate"
    # solver params (mirror the deployed ALSAlgorithmParams; only
    # rank/reg/alpha/implicit matter — ops/als.fold_in_params pins the
    # rest to the bit-conservative fold-in variant)
    als_params: als.ALSParams = field(default_factory=als.ALSParams)
    # worker knobs
    state_path: str = "foldin_cursor.bin"   # durable cursor location
    # a FRESH cursor (no state file) starts at "now" by default: only
    # events ingested from here on fold in, and the trained rows keep
    # serving untouched until their users act again. replay=True starts
    # from the beginning of the event log instead — every historical
    # user gets re-folded against the current item factors (a full
    # fold-in rebuild; the oracle tests use it)
    replay: bool = False
    poll_interval_s: float = 0.5
    cycle_budget_s: float = 30.0            # Deadline around one cycle; 0=off
    max_batch_users: int = 1024             # users per solve/apply batch
    staleness_budget_s: float = 60.0        # readyz + doctor warn threshold
    # health server (create_foldin_server)
    ip: str = "127.0.0.1"
    port: int = 8100
    server_key: str = ""    # guards /debug trace routes ("" = open)


class FoldInWorker:
    """See module docstring. Thread-safe: the loop thread mutates state
    under ``_lock``; the health app and tests read snapshots. ``device``
    is where the item factors live and the solve runs (CUDA unless
    "cpu" is asked for)."""

    def __init__(self, storage, config: FoldInConfig, applier,
                 source=None, device=None):
        self.device = resolve_device(device)
        self.storage = storage
        self.config = config
        self.applier = applier
        self.source = source or LocalEventSource(
            storage, config.app_name, config.channel_name,
            entity_type=config.entity_type,
            target_entity_type=config.target_entity_type,
            event_names=config.event_names,
        )
        self.solver = FoldInSolver(config.als_params,
                                   max_batch_users=config.max_batch_users)
        self.value_fn = make_value_fn(
            config.value_key, config.default_value, config.value_event)
        self.cursor_store = CursorStore(config.state_path)
        self.cursor = self.cursor_store.load()
        if self.cursor.time_us < 0 and not config.replay:
            # fresh start, no replay: pin the boundary at "now" and
            # persist it immediately so a restart before the first
            # successful cycle resumes from the same point
            self.cursor = FoldCursor(time_us=_micros(utcnow()))
            self.cursor_store.save(self.cursor)
        self.start_time = utcnow()
        # distributed tracing (obs/): each fold cycle is one
        # root trace (there is no inbound HTTP to join), so a slow or
        # failed cycle is inspectable span-by-span — tail read, solve,
        # apply — and the apply's outbound HTTP (router/serving upsert)
        # carries the trace into the serving fleet
        from pio_tpu_torch.obs import make_recorder
        from pio_tpu_torch.utils.tracing import Tracer

        self.recorder = make_recorder("folder")
        self.tracer = Tracer(recorder=self.recorder)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # apply-side breaker: serving down -> open -> folder backs off
        # (half-open re-probes; fold-ins meanwhile accumulate pending)
        self.apply_breaker = CircuitBreaker(
            "foldin.apply", min_calls=3, failure_rate=0.5, open_s=2.0)
        # state (under _lock)
        self._pending: dict = {}        # user id -> oldest unserved event µs
        self.folded_total = self.cursor.folded_total
        self.applied_batches = 0
        self.skipped_unknown_items = 0
        self.failures = 0
        self.last_error: str | None = None
        self.last_apply_time = None
        self.last_fold_staleness_s: float | None = None
        self.instance_skew = 0
        self._model = None
        self._instance_id: str | None = None

    # -- model (item factors + item index) ----------------------------------
    def _refresh_model(self) -> None:
        """(Re)load the latest COMPLETED instance's factor model; cheap
        id check per cycle, blob read only on change. Fold-in solves
        against THESE item factors, which are the ones serving scores
        with — the oracle contract."""
        from pio_tpu_torch.rollout.state import latest_eligible_completed
        from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model

        c = self.config
        # rollout-eligibility (rollout/state.py): fold-in must solve
        # against the instance traffic actually rides — never a
        # rolled-back or still-in-canary one serving wouldn't auto-load
        latest = latest_eligible_completed(
            self.storage, c.engine_id, c.engine_version, c.engine_variant)
        if latest is None:
            raise ValueError(
                f"no COMPLETED instance of engine {c.engine_id} "
                f"{c.engine_version} {c.engine_variant}; train first")
        if self._model is not None and latest.id == self._instance_id:
            return
        instance, model = resolve_fleet_model(
            self.storage, c.engine_id, c.engine_version, c.engine_variant,
            instance_id=latest.id, device=self.device)
        with self._lock:
            self._model = model
            self._instance_id = instance.id
        log.info("fold-in solving against instance %s", instance.id)

    # -- one cycle -----------------------------------------------------------
    def run_once(self) -> dict:
        """One tail→solve→apply cycle; returns cycle stats. Raises on
        failure (the loop catches; tests call this directly). With
        tracing on the cycle is one root trace — failed cycles are
        always retained (tail-based error retention), so the runbook's
        first stop for a wedged folder is its /debug/traces.json."""
        if self.recorder is not None:
            with self.recorder.trace("foldin.cycle"):
                return self._run_budgeted()
        return self._run_budgeted()

    def _run_budgeted(self) -> dict:
        if self.config.cycle_budget_s > 0:
            with Deadline.budget(self.config.cycle_budget_s):
                return self._cycle()
        return self._cycle()

    def _cycle(self) -> dict:
        self._refresh_model()
        with self.tracer.span("tail"):
            window = self.source.window(self.cursor)
        with self._lock:
            for u, oldest in window.to_fold.items():
                prev = self._pending.get(u)
                self._pending[u] = oldest if prev is None \
                    else min(prev, oldest)
        stats = {"windowRows": window.n_rows,
                 "touched": len(window.to_fold),
                 "folded": 0, "skipped": 0}
        # drain the WHOLE pending set in max_batch_users-sized apply
        # batches before touching the cursor: folding only one batch per
        # cycle would wedge the cursor forever whenever a window holds
        # more distinct users than one batch (--replay on a big log,
        # or a traffic burst) — the next poll re-reads the same window
        # from the stuck cursor and re-pends the users just served, so
        # `done` below could never become true. Each iteration pops
        # every user it took (applied or skipped), so the loop
        # terminates; the cycle Deadline still bounds total time (a
        # deadline mid-drain leaves the cursor put — replay, not loss).
        while True:
            with self._lock:
                batch_users = list(
                    self._pending)[:self.config.max_batch_users]
            if not batch_users:
                break
            Deadline.check("foldin batch")
            with self.tracer.span("solve", users=len(batch_users)):
                histories = {u: self.source.history(u)
                             for u in batch_users}
                rows = self.solver.solve(
                    self._model.factors.item_factors, self._model.items,
                    histories, self.value_fn)
            unplaceable = [u for u in batch_users if u not in rows]
            if rows:
                with self._lock:
                    oldest_us = min(self._pending[u] for u in rows
                                    if u in self._pending)
                staleness = max(
                    0.0, (_micros(utcnow()) - oldest_us) / 1e6)
                with self.tracer.span("apply", users=len(rows)), \
                        self.apply_breaker.guard():
                    chaos.maybe_inject("foldin.apply")
                    result = self.applier.apply(rows, staleness)
                with self._lock:
                    for u in rows:
                        self._pending.pop(u, None)
                    for u in unplaceable:
                        self._pending.pop(u, None)
                    self.folded_total += len(rows)
                    self.applied_batches += 1
                    self.skipped_unknown_items += len(unplaceable)
                    self.last_apply_time = utcnow()
                    self.last_fold_staleness_s = staleness
                served = result.get("engineInstanceId")
                if served and served != self._instance_id:
                    with self._lock:
                        self.instance_skew += 1
                    log.warning(
                        "fold-in solved against instance %s but serving "
                        "runs %s; rows applied — `/reload` serving to "
                        "converge", self._instance_id, served)
                stats["folded"] += len(rows)
                stats["skipped"] += len(unplaceable)
            else:
                with self._lock:
                    for u in unplaceable:
                        self._pending.pop(u, None)
                    self.skipped_unknown_items += len(unplaceable)
                stats["skipped"] += len(unplaceable)
        # the durable cursor advances ONLY once nothing in this window
        # is still pending: a crash-restart then re-reads from the old
        # boundary and replays the unserved users instead of losing them
        with self._lock:
            done = not self._pending
        if done and (window.time_us != self.cursor.time_us
                     or window.boundary != self.cursor.boundary
                     or self.folded_total != self.cursor.folded_total):
            self.cursor = FoldCursor(
                time_us=window.time_us,
                boundary=window.boundary,
                folded_total=self.folded_total,
            )
            self.cursor_store.save(self.cursor)
        with self._lock:
            self.last_error = None
        return stats

    # -- loop ----------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        # pio: lint-ok[context-loss] deliberate detach: the fold-in loop
        # is a process-lifetime worker started at deploy time, not on a
        # request path — there is no Deadline/trace to carry
        self._thread = threading.Thread(
            target=self._loop, name="foldin", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.config.poll_interval_s):
            try:
                self.run_once()
            except CircuitOpenError as e:
                # serving down and breaker open: expected backoff, not
                # an error to page on; pending/staleness say the rest
                with self._lock:
                    self.last_error = f"apply breaker open: {e}"
            except Exception as e:  # noqa: BLE001 - degrade, never die:
                # a wedged folder means batch-stale serving, not outage
                with self._lock:
                    self.failures += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                log.warning("fold-in cycle failed: %s", e, exc_info=True)

    # -- observability -------------------------------------------------------
    def staleness_seconds(self) -> float:
        """Age of the OLDEST event seen by the tail but not yet
        servable (0.0 when fully caught up) — the event-ingest →
        servable gauge the freshness contract is written against."""
        with self._lock:
            if not self._pending:
                return 0.0
            oldest = min(self._pending.values())
        return max(0.0, (_micros(utcnow()) - oldest) / 1e6)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def snapshot(self) -> dict:
        staleness = self.staleness_seconds()
        with self._lock:
            return {
                "stalenessSeconds": round(staleness, 3),
                "stalenessBudgetSeconds": self.config.staleness_budget_s,
                "queueDepth": len(self._pending),
                "foldedTotal": self.folded_total,
                "appliedBatches": self.applied_batches,
                "skippedUnknownItems": self.skipped_unknown_items,
                "failures": self.failures,
                "lastError": self.last_error,
                "lastApplyTime": (format_time(self.last_apply_time)
                                  if self.last_apply_time else None),
                "lastFoldStalenessSeconds": self.last_fold_staleness_s,
                "instanceSkew": self.instance_skew,
                "cursorTimeUs": self.cursor.time_us,
                "modelInstanceId": self._instance_id,
                "applyBreaker": self.apply_breaker.snapshot().state,
                "startTime": format_time(self.start_time),
            }


def build_foldin_app(worker: FoldInWorker) -> HttpApp:
    """The folder's own health surface. ``/healthz`` carries the
    freshness gauges inline (the contract: staleness_seconds and queue
    depth are liveness-cheap, no storage round-trip); ``/readyz`` flips
    once staleness exceeds its budget or the apply breaker is open —
    "stop trusting freshness", which routes nothing away from serving
    (serving has its own readyz) but pages the operator via doctor."""
    app = HttpApp("foldin")

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, {"status": "alive", "role": "foldin",
                     **worker.snapshot()}

    @app.route("GET", r"/healthz")
    def healthz(req: Request):
        return 200, {
            "status": "alive",
            "staleness_seconds": round(worker.staleness_seconds(), 3),
            "foldin_queue_depth": worker.queue_depth(),
        }

    @app.route("GET", r"/readyz")
    def readyz(req: Request):
        snap = worker.snapshot()
        checks = {
            "freshness": {
                "ok": (snap["stalenessSeconds"]
                       <= worker.config.staleness_budget_s),
                "stalenessSeconds": snap["stalenessSeconds"],
                "budgetSeconds": worker.config.staleness_budget_s,
                "queueDepth": snap["queueDepth"],
            },
            "applyBreaker": {
                "ok": snap["applyBreaker"] != "open",
                "state": snap["applyBreaker"],
            },
        }
        ready = all(c["ok"] for c in checks.values())
        return (200 if ready else 503), {"ready": ready, "checks": checks}

    @app.route("GET", r"/metrics\.json")
    def metrics(req: Request):
        out = worker.snapshot()
        out["spans"] = worker.tracer.snapshot()
        if worker.recorder is not None:
            out["exemplars"] = worker.recorder.exemplars()
        return 200, out

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """Prometheus twin of /metrics.json through the shared renderer:
        the freshness SLO gauges (staleness_seconds, queue depth) become
        scrapeable — not just doctor-visible — plus the cycle-stage span
        summaries, all under `surface="folder"`."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.httpclient import pool_counters
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_text,
        )

        snap = worker.snapshot()
        counters = {
            "staleness_seconds": snap["stalenessSeconds"],
            "staleness_budget_seconds": snap["stalenessBudgetSeconds"],
            "foldin_queue_depth": float(snap["queueDepth"]),
            "foldin_folded_total": float(snap["foldedTotal"]),
            "foldin_applied_batches_total": float(snap["appliedBatches"]),
            "foldin_failures_total": float(snap["failures"]),
            "uptime_seconds":
                (utcnow() - worker.start_time).total_seconds(),
        }
        # the folder's tail long-poll + apply fans ride the keep-alive
        # pool (docs/performance.md "Internal RPC plane")
        counters.update(pool_counters())
        return 200, RawResponse(
            prometheus_text(worker.tracer.snapshot(), counters,
                            labels={"surface": "folder"}),
            PROMETHEUS_CONTENT_TYPE)

    # distributed tracing (obs/): per-cycle traces fetchable
    # from the folder's own surface (FoldInConfig.server_key guards)
    from pio_tpu_torch.obs.http import install_trace_routes
    from pio_tpu_torch.server.http import server_key_ok

    app.tracer = worker.tracer
    install_trace_routes(
        app, worker.recorder,
        lambda req: server_key_ok(req, worker.config.server_key))

    return app


def create_foldin_server(worker: FoldInWorker) -> HttpServer:
    """-> http transport for the folder's health surface (start() it;
    with port=0 the bound port is known after start)."""
    c = worker.config
    return HttpServer(build_foldin_app(worker), host=c.ip, port=c.port)
