"""Storage server — the networked, multi-host-shareable storage backend.

Exposes the FULL DAO surface (events + metadata + models) of any local
backend over HTTP so that every host in a multi-host training job — and any
number of event servers, deploy servers, and CLIs on other machines — share
ONE store. This fills the role of the reference's networked backends
(JDBC/Postgres `data/.../storage/jdbc/JDBCLEvents.scala:106`, HBase
`hbase/HBEventsUtil.scala:74-142`, Elasticsearch metadata): this image has
no database server or drivers, so instead of speaking someone else's wire
protocol the framework ships its own storage service — one process owns the
(sqlite/eventlog/memory) store and everyone else mounts it via the `remote`
backend (data/backends/remote.py).

Protocol: POST /rpc with {"family", "method", "kwargs"} — an explicit
allowlisted method table per DAO family (no reflective dispatch), JSON wire
codecs from data/backends/wire.py. GET /health for liveness. Optional
server key (?accessKey=) + TLS, same as the other three servers.

Run: `python -m pio_tpu_torch storageserver --port 7072`, or in-process via
create_storage_server for tests.

Copy of ``pio_tpu.server.storageserver``, imports rewritten to the port; it
trims nothing.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from pio_tpu_torch.data import dao as daomod
from pio_tpu_torch.data.backends import wire as w
from pio_tpu_torch.data.storage import Storage, StorageError, get_storage
from pio_tpu_torch.server.http import HttpApp, HttpServer, Request

log = logging.getLogger("pio_tpu_torch.storageserver")


@dataclass
class StorageServerConfig:
    # Loopback by default: this server exposes the FULL DAO surface
    # (including access keys and model blobs), so a non-loopback bind
    # requires a server_key (enforced in create_storage_server).
    ip: str = "127.0.0.1"
    port: int = 7072
    server_key: str = ""          # shared secret required on every call
    certfile: str | None = None
    keyfile: str | None = None


def _opt(conv, v):
    return conv(v) if v is not None else None


# family -> method -> handler(dao, kwargs) -> jsonable result.
# Explicit table: adding a DAO method to the protocol is a deliberate act.
_METHODS = {
    "apps": {
        "insert": lambda dao, kw: dao.insert(w.app_from_wire(kw["app"])),
        "get": lambda dao, kw: _opt(w.app_to_wire, dao.get(kw["app_id"])),
        "get_by_name": lambda dao, kw: _opt(
            w.app_to_wire, dao.get_by_name(kw["name"])),
        "get_all": lambda dao, kw: [w.app_to_wire(a) for a in dao.get_all()],
        "update": lambda dao, kw: dao.update(w.app_from_wire(kw["app"])),
        "delete": lambda dao, kw: dao.delete(kw["app_id"]),
    },
    "access_keys": {
        "insert": lambda dao, kw: dao.insert(
            w.access_key_from_wire(kw["access_key"])),
        "get": lambda dao, kw: _opt(
            w.access_key_to_wire, dao.get(kw["key"])),
        "get_all": lambda dao, kw: [
            w.access_key_to_wire(k) for k in dao.get_all()],
        "get_by_appid": lambda dao, kw: [
            w.access_key_to_wire(k) for k in dao.get_by_appid(kw["appid"])],
        "update": lambda dao, kw: dao.update(
            w.access_key_from_wire(kw["access_key"])),
        "delete": lambda dao, kw: dao.delete(kw["key"]),
    },
    "channels": {
        "insert": lambda dao, kw: dao.insert(
            w.channel_from_wire(kw["channel"])),
        "get": lambda dao, kw: _opt(
            w.channel_to_wire, dao.get(kw["channel_id"])),
        "get_by_appid": lambda dao, kw: [
            w.channel_to_wire(c) for c in dao.get_by_appid(kw["appid"])],
        "delete": lambda dao, kw: dao.delete(kw["channel_id"]),
    },
    "engine_instances": {
        "insert": lambda dao, kw: dao.insert(
            w.engine_instance_from_wire(kw["instance"])),
        "get": lambda dao, kw: _opt(
            w.engine_instance_to_wire, dao.get(kw["instance_id"])),
        "get_all": lambda dao, kw: [
            w.engine_instance_to_wire(i) for i in dao.get_all()],
        "update": lambda dao, kw: dao.update(
            w.engine_instance_from_wire(kw["instance"])),
        "delete": lambda dao, kw: dao.delete(kw["instance_id"]),
    },
    "engine_manifests": {
        "insert": lambda dao, kw: dao.insert(
            w.engine_manifest_from_wire(kw["manifest"])),
        "get": lambda dao, kw: _opt(
            w.engine_manifest_to_wire,
            dao.get(kw["manifest_id"], kw["version"])),
        "get_all": lambda dao, kw: [
            w.engine_manifest_to_wire(m) for m in dao.get_all()],
        "update": lambda dao, kw: dao.update(
            w.engine_manifest_from_wire(kw["manifest"]),
            upsert=bool(kw.get("upsert", False))),
        "delete": lambda dao, kw: dao.delete(kw["manifest_id"], kw["version"]),
    },
    "evaluation_instances": {
        "insert": lambda dao, kw: dao.insert(
            w.evaluation_instance_from_wire(kw["instance"])),
        "get": lambda dao, kw: _opt(
            w.evaluation_instance_to_wire, dao.get(kw["instance_id"])),
        "get_all": lambda dao, kw: [
            w.evaluation_instance_to_wire(i) for i in dao.get_all()],
        "update": lambda dao, kw: dao.update(
            w.evaluation_instance_from_wire(kw["instance"])),
        "delete": lambda dao, kw: dao.delete(kw["instance_id"]),
    },
    "models": {
        "insert": lambda dao, kw: dao.insert(w.model_from_wire(kw["model"])),
        "get": lambda dao, kw: _opt(w.model_to_wire, dao.get(kw["model_id"])),
        "delete": lambda dao, kw: dao.delete(kw["model_id"]),
    },
    "events": {
        "init": lambda dao, kw: dao.init(kw["app_id"], kw.get("channel_id")),
        "remove": lambda dao, kw: dao.remove(
            kw["app_id"], kw.get("channel_id")),
        "insert": lambda dao, kw: dao.insert(
            w.event_from_wire(kw["event"]), kw["app_id"],
            kw.get("channel_id")),
        "insert_batch": lambda dao, kw: dao.insert_batch(
            [w.event_from_wire(e) for e in kw["events"]], kw["app_id"],
            kw.get("channel_id")),
        "get": lambda dao, kw: _opt(
            w.event_to_wire,
            dao.get(kw["event_id"], kw["app_id"], kw.get("channel_id"))),
        "delete": lambda dao, kw: dao.delete(
            kw["event_id"], kw["app_id"], kw.get("channel_id")),
        "delete_many": lambda dao, kw: dao.delete_many(
            kw["event_ids"], kw["app_id"], kw.get("channel_id")),
        "find": lambda dao, kw: _find_rpc(dao, kw),
        "columnarize": lambda dao, kw: _columnarize_rpc(dao, kw),
        "aggregate_properties": lambda dao, kw: {
            eid: w.property_map_to_wire(p)
            for eid, p in dao.aggregate_properties(
                kw["app_id"], kw["entity_type"], kw.get("channel_id"),
                start_time=w._undt(kw.get("startTime")),
                until_time=w._undt(kw.get("untilTime")),
                required=kw.get("required"),
            ).items()},
    },
}


def _find_rpc(dao, kw: dict) -> list:
    """find with a wire-only `excludeIds` keyset cursor: remote clients
    page unbounded reads (an export of millions of events must not
    arrive as one JSON response) by re-issuing find with start_time =
    last page's final event_time and the ids already seen AT that
    boundary time excluded here. Exact regardless of tie ordering (ids
    are unique), and each page costs an indexed start_time scan — not
    the O(offset) re-read + unstable-tie drop/dup of offset paging."""
    q = dict(kw.get("query") or {})
    exclude = set(q.pop("excludeIds", None) or ())
    fkw = w.find_kwargs_from_wire(q)
    limit = fkw.get("limit")
    if exclude and limit is not None and limit >= 0:
        # the backing DAO's limit applies BEFORE exclusion; widen so a
        # full page survives the boundary-tie filter, then truncate
        fkw["limit"] = limit + len(exclude)
    it = dao.find(kw["app_id"], kw.get("channel_id"), **fkw)
    out = []
    for e in it:
        if exclude and e.event_id in exclude:
            continue
        if limit is not None and 0 <= limit <= len(out):
            break   # before append: limit=0 + excludeIds must return []
        out.append(w.event_to_wire(e))
    return out


def _columnarize_rpc(dao, kw: dict) -> dict:
    """Server-side training read: filter + value-extract + dedup + dict-
    encode happen HERE, so a remote trainer receives compact COO columns
    (5 scalars/row) instead of full event JSON — the reference's
    region-side scan (HBPEvents.scala) rather than a client-side fold.
    Delegates to the backing DAO's native columnarize when it has one
    (eventlog: one C++ sweep); otherwise folds via find. times_us is
    only available on the native path (the generic fold dedups before
    times could be aligned) — empty means "not provided"."""
    from pio_tpu_torch.data.eventstore import (
        columnarize_via_find, interactions_to_columns,
    )

    q = kw.get("query") or {}
    fkw = w.find_kwargs_from_wire(q)
    common = dict(
        app_id=kw["app_id"], channel_id=kw.get("channel_id"),
        start_time=fkw["start_time"], until_time=fkw["until_time"],
        entity_type=fkw["entity_type"], event_names=fkw["event_names"],
        target_entity_type=fkw["target_entity_type"],
        value_key=kw.get("valueKey", "rating"),
        default_value=float(kw.get("defaultValue", 1.0)),
        dedup=kw.get("dedup", "last"),
        value_event=kw.get("valueEvent"),
    )
    if hasattr(dao, "columnarize"):
        cols = dao.columnarize(**common)
    else:
        cols = interactions_to_columns(columnarize_via_find(dao, **common))
    # timesUs deliberately not shipped: no remote consumer reads it, and
    # at 200k+ rows an extra int64 column is ~25% of the RPC payload
    return {
        "userIdx": cols.user_idx.tolist(),
        "itemIdx": cols.item_idx.tolist(),
        "values": cols.values.tolist(),
        "users": list(cols.users),
        "items": list(cols.items),
    }


def _dao_for(storage: Storage, family: str):
    getters = {
        "apps": storage.get_metadata_apps,
        "access_keys": storage.get_metadata_access_keys,
        "channels": storage.get_metadata_channels,
        "engine_instances": storage.get_metadata_engine_instances,
        "engine_manifests": storage.get_metadata_engine_manifests,
        "evaluation_instances": storage.get_metadata_evaluation_instances,
        "models": storage.get_model_data_models,
        "events": storage.get_events,
    }
    if family not in getters:
        return None
    return getters[family]()


def build_storage_app(
    storage: Storage | None = None,
    config: StorageServerConfig | None = None,
) -> HttpApp:
    from pio_tpu_torch.utils.tracing import Tracer

    from pio_tpu_torch.obs import make_recorder

    storage = storage or get_storage()
    config = config or StorageServerConfig()
    app = HttpApp("storage")
    # span per family.method: cardinality is bounded. With tracing on,
    # each RPC span joins the CALLER's trace (the remote backend's
    # JsonHttpClient carries traceparent), so a slow serving request
    # shows its storage hops in `pio trace`
    recorder = make_recorder("storage")
    tracer = Tracer(recorder=recorder)
    app.tracer = tracer  # exposed for tests / embedding processes

    @app.route("GET", r"/health")
    def health(req: Request):
        errors = storage.verify_all()
        status = 200 if not errors else 503
        return status, {"status": "ok" if not errors else "degraded",
                        "errors": errors}

    # /healthz (liveness) + /readyz (backing-store breakers closed) —
    # the shared health contract (resilience/health.py). /health above
    # stays: it actively touches every DAO, which is a deeper (and more
    # expensive) check than readiness polling should pay.
    from pio_tpu_torch.resilience.health import breaker_checks, install_health_routes

    install_health_routes(app, lambda: breaker_checks(storage))

    @app.route("GET", r"/metrics")
    def metrics(req: Request):
        """Prometheus text exposition of per-RPC latency summaries —
        the storage server is the multi-host hub, so its scrape surface
        matters most under load. Span names come from the fixed method
        table (never client data): no escaping or cardinality concerns.
        Served through the shared renderer under the uniform metric
        name + `surface="storage"` label (docs/observability.md; the
        pre-PR-9 `pio_storage_` prefix is replaced by the label)."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.httpclient import pool_counters
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_text,
        )

        return 200, RawResponse(
            prometheus_text(tracer.snapshot(), dict(pool_counters()),
                            labels={"surface": "storage"}),
            PROMETHEUS_CONTENT_TYPE)

    @app.route("GET", r"/metrics\.json")
    def metrics_json(req: Request):
        out = {"spans": tracer.snapshot()}
        if recorder is not None:
            out["exemplars"] = recorder.exemplars()
        return 200, out

    @app.route("POST", r"/rpc")
    def rpc(req: Request):
        if config.server_key and (
            req.params.get("accessKey", "") != config.server_key
        ):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict):
            return 400, {"message": "body must be a JSON object"}
        family = body.get("family")
        method = body.get("method")
        kwargs = body.get("kwargs") or {}
        table = _METHODS.get(family)
        if table is None:
            return 404, {"message": f"unknown DAO family {family!r}"}
        fn = table.get(method)
        if fn is None:
            return 404, {"message": f"unknown method {family}.{method}"}
        dao = _dao_for(storage, family)
        try:
            with tracer.span(f"{family}.{method}"):
                result = fn(dao, kwargs)
        except StorageError as e:
            return 409, {"message": str(e), "error": "StorageError"}
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"message": f"{type(e).__name__}: {e}",
                         "error": type(e).__name__}
        return 200, {"result": result}

    @app.route("POST", r"/rpc/columnar")
    def rpc_columnar(req: Request):
        """``find_columnar`` over the binary columnar wire format
        (data/columnar.py): the request is the usual JSON find-kwargs
        envelope, the response is ONE CRC32C-framed columnar batch —
        dictionary-coded columns + the lazy raw-JSON property sidecar —
        instead of per-event JSON. The remote backend decodes it by
        pointer-cast; the sharded backend fans this route out per shard
        and concatenates. A separate route (not a /rpc method) because
        the /rpc envelope is JSON by contract and re-encoding the frame
        into it would put the per-event tax right back."""
        from pio_tpu_torch.data.columnar import (
            COLUMNAR_CONTENT_TYPE, encode_columnar_events,
        )
        from pio_tpu_torch.server.http import RawResponse

        if config.server_key and (
            req.params.get("accessKey", "") != config.server_key
        ):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict):
            return 400, {"message": "body must be a JSON object"}
        fkw = w.find_kwargs_from_wire(body.get("query") or {})
        fkw.pop("limit", None)        # find_columnar is an unbounded read
        fkw.pop("reversed", None)
        dao = _dao_for(storage, "events")
        try:
            with tracer.span("events.find_columnar"):
                cols = dao.find_columnar(
                    app_id=body["app_id"],
                    channel_id=body.get("channel_id"), **fkw)
                blob = encode_columnar_events(cols)
        except StorageError as e:
            return 409, {"message": str(e), "error": "StorageError"}
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"message": f"{type(e).__name__}: {e}",
                         "error": type(e).__name__}
        return 200, RawResponse(blob, COLUMNAR_CONTENT_TYPE)

    # distributed tracing (pio_tpu/obs/): /debug routes + traced edge,
    # guarded by the server key like /rpc itself
    from pio_tpu_torch.obs.http import install_trace_routes
    from pio_tpu_torch.server.http import server_key_ok

    install_trace_routes(app, recorder,
                         lambda req: server_key_ok(req, config.server_key))

    return app


def create_storage_server(
    storage: Storage | None = None,
    config: StorageServerConfig | None = None,
) -> HttpServer:
    from pio_tpu_torch.server.security import server_ssl_context

    config = config or StorageServerConfig()
    if not config.server_key and config.ip not in ("127.0.0.1", "::1",
                                                   "localhost"):
        raise ValueError(
            "storage server on a non-loopback address requires a server_key "
            "— it exposes the full DAO surface (access keys, model blobs, "
            "events) to every host that can reach it"
        )
    app = build_storage_app(storage, config)
    return HttpServer(
        app, host=config.ip, port=config.port,
        ssl_context=server_ssl_context(config.certfile, config.keyfile),
    )
