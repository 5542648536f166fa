"""Deploy server — REST query serving with models resident on the device.

Counterpart of ``pio_tpu.workflow.serve`` (reference CreateServer.scala):

  GET  /                    -> engine status (instance info + latency stats)
  POST /queries.json        -> supplement -> per-algo predict -> serve
  POST /batch/queries.json  -> a JSON array of queries, one batch_predict
                               per algorithm

with the same body shapes and error codes. Ported so far: model restore
(latest COMPLETED instance or a pinned id, falling back past a corrupt
blob), the two query routes and the threaded transport. The reference's
rollout arms, fold-in upserts, hedged dispatch, plugins, feedback events,
micro/continuous batchers, bucket warm sweep, tracing and async transport
are not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.server.http import HttpApp, HttpServer, Request
from pio_tpu_torch.utils.durable import ModelIntegrityError
from pio_tpu_torch.utils.time import format_time, utcnow
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


class QueryServer:
    """Serving runtime: engine + params + restored models."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        storage: Storage,
        config: ServingConfig,
        ctx: WorkflowContext | None = None,
        instance_id: str | None = None,
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.storage = storage
        self.config = config
        self.ctx = ctx or create_workflow_context(storage)
        self._lock = threading.RLock()
        self.start_time = utcnow()
        # query latency bookkeeping for GET / (count, total, last)
        self._n_queries = 0
        self._total_s = 0.0
        self._last_s = 0.0
        # serializes whole reloads (resolve + restore + swap) without
        # blocking queries, which only take self._lock for a snapshot
        self._load_lock = threading.Lock()
        self._load(instance_id)

    # -- model lifecycle ----------------------------------------------------
    def _load(self, instance_id: str | None = None) -> None:
        """Restore an instance's models and swap them in atomically: every
        failable step runs before the swap, so a failed load leaves the
        previous instance serving."""
        with self._load_lock:
            self._load_locked(instance_id)

    def _load_locked(self, instance_id: str | None) -> None:
        c = self.config
        instances = self.storage.get_metadata_engine_instances()
        if instance_id is None:
            candidates = instances.get_completed(
                c.engine_id, c.engine_version, c.engine_variant
            )
            if not candidates:
                raise ValueError(
                    f"No COMPLETED engine instance for engine "
                    f"{c.engine_id} {c.engine_version} {c.engine_variant}. "
                    "Run train first."
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
        # a corrupt blob (CRC32C mismatch) on the latest instance falls
        # back to the previous COMPLETED one: integrity failures are
        # permanent for that blob, and an older good model beats none.
        # An explicit instance id does not fall back.
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
            self.instance = instance
            self.models = models
            self.algorithms = algorithms
            self.serving = serving
        log.info("deployed engine instance %s", instance.id)

    def _snapshot(self):
        with self._lock:
            return self.models, self.algorithms, self.serving

    def close(self) -> None:
        """Release algorithm-held resources; the HTTP transport's stop()
        does not know about them."""
        for algo in list(getattr(self, "algorithms", [])):
            close = getattr(algo, "close", None)
            if callable(close):
                close()

    # -- query path ---------------------------------------------------------
    def _record(self, t0: float) -> None:
        dt = time.monotonic() - t0
        with self._lock:
            self._n_queries += 1
            self._total_s += dt
            self._last_s = dt

    def query(self, q: dict) -> Any:
        t0 = time.monotonic()
        models, algorithms, serving = self._snapshot()
        supplemented = serving.supplement(q)
        predictions = [
            a.predict(m, supplemented) for a, m in zip(algorithms, models)
        ]
        prediction = serving.serve(q, predictions)
        self._record(t0)
        return prediction

    def query_batch(self, queries: list[dict]) -> list:
        """Serve several queries as one batch_predict per algorithm (the
        bulk path behind /batch/queries.json)."""
        t0 = time.monotonic()
        models, algorithms, serving = self._snapshot()
        supplemented = [serving.supplement(q) for q in queries]
        per_algo = [
            a.batch_predict(m, supplemented)
            for a, m in zip(algorithms, models)
        ]
        predictions = [
            serving.serve(q, [algo_out[i] for algo_out in per_algo])
            for i, q in enumerate(queries)
        ]
        self._record(t0)
        return predictions

    # -- status -------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            n = self._n_queries
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
                "requestCount": n,
                "avgServingSec": round(self._total_s / n if n else 0.0, 6),
                "lastServingSec": round(self._last_s, 6),
            }


def build_serving_app(server: QueryServer) -> HttpApp:
    app = HttpApp("serving")

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, server.status()

    def _answer(fn):
        try:
            return 200, fn()
        except KeyError as e:
            return 400, {"message": f"query missing field {e}"}

    @app.route("POST", r"/queries\.json")
    def queries(req: Request):
        try:
            q = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid query: {e}"}
        if not isinstance(q, dict):
            return 400, {"message": "query must be a JSON object"}
        return _answer(lambda: server.query(q))

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
        return _answer(lambda: server.query_batch(qs))

    return app


def create_query_server(
    engine: Engine,
    engine_params: EngineParams,
    storage: Storage,
    config: ServingConfig,
    ctx: WorkflowContext | None = None,
    instance_id: str | None = None,
) -> tuple[HttpServer, QueryServer]:
    """The deploy verb's server: models restored onto ``ctx.device`` (CUDA
    unless the context says otherwise) behind the threaded transport.
    Call ``start()`` on the returned HttpServer to bind and serve."""
    qs = QueryServer(engine, engine_params, storage, config, ctx=ctx,
                     instance_id=instance_id)
    return HttpServer(app=build_serving_app(qs), host=config.ip,
                      port=config.port), qs
