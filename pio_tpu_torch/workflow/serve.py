"""Deploy server — REST query serving with models resident on the device.

Counterpart of ``pio_tpu.workflow.serve`` (reference CreateServer.scala):

  GET  /                    -> engine status (instance info + latency stats
                               + fold-in accounting)
  GET  /readyz             -> readiness (model loaded; fold-in shown,
                               never gating)
  POST /queries.json        -> supplement -> per-algo predict -> serve
  POST /batch/queries.json  -> a JSON array of queries, one batch_predict
                               per algorithm
  POST /model/upsert_users  -> streaming fold-in apply (server-key guarded)

with the same body shapes and error codes. Ported so far: model restore
(latest COMPLETED instance or a pinned id, falling back past a corrupt
blob), the query routes, the fold-in apply surface (``foldin_upsert``:
user rows replaced or appended, existing item rows replaced with the
clustered-retrieval sidecar re-encoded for exactly those rows, in one
last-good swap) and the threaded transport. The reference's rollout arms
(and with them the fold-in's candidate arm), hedged dispatch, plugins,
feedback events, micro/continuous batchers, bucket warm sweep, tracing,
/reload, /stop and the async transport are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.ops import retrieval as rt
from pio_tpu_torch.server.http import (
    HttpApp,
    HttpServer,
    Request,
    server_key_ok,
)
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
    server_key: str = ""          # guards /model/upsert_users


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
        # streaming fold-in accounting (foldin_upsert): how many user
        # and item rows were applied, and the newest batch's staleness
        self.foldin_applied_users = 0
        self.foldin_applied_items = 0
        self.foldin_last_time = None
        self.foldin_last_staleness_s: float | None = None
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
        a dense index that only a retrain assigns)."""
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
            # reload (new instance — applying stale rows onto it would
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
        return out

    def foldin_status(self) -> dict:
        """Bounded-staleness accounting for GET / and /readyz."""
        with self._lock:
            return {
                "appliedUsers": self.foldin_applied_users,
                "appliedItems": self.foldin_applied_items,
                "lastAppliedTime": (format_time(self.foldin_last_time)
                                    if self.foldin_last_time else None),
                "stalenessSeconds": self.foldin_last_staleness_s,
            }

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
                "foldin": self.foldin_status(),
            }


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


def build_serving_app(server: QueryServer) -> HttpApp:
    app = HttpApp("serving")
    config = server.config

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, config.server_key)

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, server.status()

    @app.route("GET", r"/readyz")
    def readyz(req: Request):
        """Ready once a model is loaded. Fold-in is shown and NEVER
        gates: a stale or absent folder means batch-stale serving
        (degraded freshness), and flipping readyz for it would turn
        that degradation into an outage."""
        with server._lock:
            inst = getattr(server, "instance", None)
        checks = {
            "model": {"ok": inst is not None,
                      "engineInstanceId": inst.id if inst else None},
            "freshness": {"ok": True, **server.foldin_status()},
        }
        ready = all(c["ok"] for c in checks.values())
        return (200 if ready else 503), {"ready": ready, "checks": checks}

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

    @app.route("POST", r"/model/upsert_users")
    def upsert_users(req: Request):
        """Streaming fold-in apply surface (freshness/): body
        ``{"users": {id: [row]}, "items"?: {id: [row]},
        "stalenessSeconds"?: s}``. Item rows upsert existing items AND
        their two-stage retrieval sidecar in the same swap. Guarded by
        the server key — it mutates the serving model."""
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
