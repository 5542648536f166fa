"""Event Server — the REST ingestion API.

Route + status-code parity with reference data/.../api/EventServer.scala:
  GET  /                         -> {"status": "alive"}
  POST /events.json              -> 201 {"eventId": ...} | 400 | 401 | 403
  GET  /events/<id>.json         -> 200 event | 404
  DELETE /events/<id>.json       -> 200 {"message":"Found"} | 404
  GET  /events.json              -> 200 [events] | 404 when empty | 400
  POST /batch/events.json        -> 200 [per-event {status,...}] | 400 if >50
  GET  /stats.json               -> 200 stats (when --stats)
  POST /webhooks/<name>.json     -> JSON connector ingest
  GET  /webhooks/<name>.json     -> connector presence check
  POST /webhooks/<name>          -> form connector ingest
Auth: ?accessKey= or Authorization header; per-key event-name whitelist
(EventServer.scala:90-140); optional ?channel= resolved against the app's
channels.

Copy of ``pio_tpu.server.eventserver``, imports rewritten to the port.
The per-codec wire counters gain ``insert_busy_seconds`` and
``handle_busy_seconds``: the time during which at least one batch was in
the store's ``insert_batch``, and in the batch route, so that an ingest
run splits its time on the server's clock however many batches the
server handles at once.
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Sequence

from pio_tpu_torch.data.backends.common import new_event_id
from pio_tpu_torch.data.dao import AccessKey, Channel
from pio_tpu_torch.data.event import Event, EventValidationError, validate_event
from pio_tpu_torch.data.storage import Storage, get_storage
from pio_tpu_torch.resilience import SpillQueue, SpillSaturated, is_transient
from pio_tpu_torch.resilience.health import (
    breaker_checks, install_health_routes, shedder_check,
)
from pio_tpu_torch.server.http import (
    AsyncHttpServer, HttpApp, HttpServer, Request, json_response,
)
from pio_tpu_torch.data.columnar import (
    COLUMNAR_CONTENT_TYPE, decode_api_batch_binary,
)
from pio_tpu_torch.server.plugins import PluginContext, PluginRejection
from pio_tpu_torch.server.stats import Stats
from pio_tpu_torch.server.webhooks import ConnectorException, default_connectors
from pio_tpu_torch.utils.time import parse_time

MAX_EVENTS_PER_BATCH = 50  # reference EventServer.scala:68
# the binary columnar route's own ceiling: the 50-event JSON limit is a
# reference-compat contract, but the binary frame exists precisely to
# amortize per-request costs over bulk batches — per-event isolation
# still applies slot by slot, and a 10k-event frame is well under the
# transport's 64 MB body cap (~100 bytes/event on the wire)
MAX_EVENTS_PER_BINARY_BATCH = 10_000
# ceiling on GET /tail/events.json?waitS= long-poll blocking: each
# waiting subscriber holds one worker-pool thread, so the cap bounds
# how much of the pool a slow consumer fleet can park (clients re-issue
# on timeout — that IS the poll fallback)
TAIL_WAIT_CAP_S = 30.0


@dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    # shared secret for GET /metrics. The event server faces untrusted
    # clients, and the cross-app Prometheus counters would let any of
    # them enumerate every tenant's app ids and event vocabulary (data
    # /stats.json deliberately gates per-app) — so /metrics is OFF
    # unless a key is configured, and then requires it.
    metrics_key: str = ""
    certfile: str | None = None   # TLS cert (PEM); with keyfile -> HTTPS
    keyfile: str | None = None
    backend: str = "async"        # "async" (event loop) | "threaded"
    # degraded-mode ingestion: when the event store is down (breaker
    # open / transport failures), up to this many events park in a
    # bounded in-memory queue and drain in the background once the store
    # recovers — the server keeps answering 201 through short outages.
    # 0 disables (transient failures then answer 503 + Retry-After).
    spill_capacity: int = 10000
    # end-to-end backpressure: past `spill_high_water` queued events the
    # server answers 429 + Retry-After (an explicit retryable signal)
    # instead of 201-spilling without bound, and resumes spilling once
    # the background drain brings the queue back to `spill_low_water`
    # (hysteresis — no 201/429 flutter at the boundary). high_water 0
    # (the default) disables the 429 path — the pre-existing behavior:
    # spill until the queue is literally full, then 503. An explicit
    # mark is clamped to capacity; low_water defaults to high_water/2.
    spill_high_water: int = 0
    spill_low_water: int = 0
    # per-app ingest quotas (multi-tenant plane, docs/serving.md
    # "Multi-tenant fleet"): each app's POSTs pass a token bucket IN
    # FRONT of the spill queue, so one flooding app answers 429 +
    # Retry-After at its own quota while co-resident apps keep their
    # full spill/backpressure headroom. 0 qps disables (the default);
    # burst 0 means max(rate, 1). Sheds count per app in
    # `pio_ingest_shed_total{app=}` on /metrics.
    ingest_quota_qps: float = 0.0
    ingest_quota_burst: float = 0.0


class AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def build_event_app(
    storage: Storage | None = None,
    config: EventServerConfig | None = None,
    plugin_context: PluginContext | None = None,
) -> HttpApp:
    storage = storage or get_storage()
    config = config or EventServerConfig()
    plugins = plugin_context or PluginContext()
    events_dao = storage.get_events()
    access_keys = storage.get_metadata_access_keys()
    channels = storage.get_metadata_channels()
    stats = Stats()
    json_connectors, form_connectors = default_connectors()

    app = HttpApp("eventserver")
    app.stats = stats  # exposed for tests/ops
    # distributed tracing (pio_tpu/obs/): the ingest edge joins client
    # traces (traceparent) and the `request` histogram feeds /metrics;
    # /debug routes installed at the bottom of this builder
    from pio_tpu_torch.obs import make_recorder
    from pio_tpu_torch.utils.tracing import Tracer

    recorder = make_recorder("eventserver")
    tracer = Tracer(recorder=recorder)
    app.tracer = tracer
    # degraded-mode buffer: events that could not reach the store park
    # here and drain in the background (resilience/spill.py)
    spill = (SpillQueue(events_dao.insert, config.spill_capacity,
                        high_water=config.spill_high_water,
                        low_water=config.spill_low_water)
             if config.spill_capacity > 0 else None)
    app.spill = spill  # exposed for tests/ops (and readiness below)

    # long-poll push subscription (GET /tail/events.json?waitS=): every
    # accepted ingest bumps the sequence and wakes blocked tail readers,
    # so the freshness folder sees an event within one store round trip
    # instead of one poll interval. Spill-drain re-inserts bypass this
    # hook; waiters cover that with a bounded re-read backstop.
    tail_cond = threading.Condition()
    tail_seq = [0]

    def tail_notify() -> None:
        with tail_cond:
            tail_seq[0] += 1
            tail_cond.notify_all()

    app.tail_notify = tail_notify  # exposed for tests

    def offer_or_shed(event: Event, app_id: int,
                      channel_id: int | None) -> bool:
        """Park an event in the spill queue, honoring the high-water
        backpressure mark: past it, raise SpillSaturated (mapped to 429
        + Retry-After) instead of growing the backlog; a literally full
        queue returns False (the caller re-raises the store error ->
        503). Hysteresis lives in SpillQueue.should_shed()."""
        if spill.should_shed():
            spill.record_shed()
            raise SpillSaturated(
                f"event spill queue past its high-water mark "
                f"({spill.size}/{spill.high_water}); retry later"
            )
        return spill.offer(event, app_id, channel_id)

    # stale-while-down access-key cache: auth rides the same storage
    # source as the event store, so a tripped breaker would otherwise
    # take ingestion down at the AUTH step and make the spill queue
    # unreachable. Successful lookups are cached; the cache is consulted
    # ONLY when the live lookup fails transiently (not a TTL — a healthy
    # store is always authoritative, so revocation lag is bounded by the
    # outage length).
    # per-app ingest admission: one token bucket per app id, in front
    # of the spill queue (quota sheds never consume spill headroom)
    from pio_tpu_torch.resilience import TenantAdmission, TenantQuota

    ingest_quota = (TenantAdmission()
                    if config.ingest_quota_qps > 0 else None)
    ingest_quota_apps: set[str] = set()
    ingest_shed: dict[int, int] = {}
    ingest_shed_lock = threading.Lock()
    app.ingest_shed = ingest_shed  # exposed for tests/ops (/metrics)

    def admit_ingest(ak: AccessKey) -> tuple[bool, float]:
        tenant = str(ak.appid)
        with ingest_shed_lock:
            if tenant not in ingest_quota_apps:
                # configure once — reconfiguring resets the bucket
                ingest_quota.configure(tenant, TenantQuota(
                    rate=config.ingest_quota_qps,
                    burst=config.ingest_quota_burst))
                ingest_quota_apps.add(tenant)
        ok, retry_after, _reason = ingest_quota.admit(tenant)
        if not ok:
            with ingest_shed_lock:
                ingest_shed[ak.appid] = ingest_shed.get(ak.appid, 0) + 1
        return ok, retry_after

    ak_cache: dict[str, AccessKey] = {}
    ak_cache_lock = threading.Lock()

    def lookup_access_key(key: str) -> AccessKey | None:
        try:
            ak = access_keys.get(key)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_transient(e):
                raise
            with ak_cache_lock:
                cached = ak_cache.get(key)
            if cached is None:
                raise
            return cached
        with ak_cache_lock:
            if ak is not None:
                ak_cache[key] = ak
            else:
                ak_cache.pop(key, None)
        return ak

    # -- auth (reference withAccessKey, EventServer.scala:90-128) -----------
    def authenticate(req: Request) -> tuple[AccessKey, int | None]:
        key = req.params.get("accessKey", "")
        if not key:
            # HTTP Basic: the access key is the username, empty password
            # (reference EventServer.scala:113-117)
            header = req.header("authorization")
            if header.startswith("Basic "):
                try:
                    decoded = base64.b64decode(header[6:]).decode("utf-8")
                    key = decoded.split(":", 1)[0]
                except (ValueError, UnicodeDecodeError):
                    raise AuthError(401, "Invalid accessKey.")
        if not key:
            raise AuthError(401, "Missing accessKey.")
        ak = lookup_access_key(key)
        if ak is None:
            raise AuthError(401, "Invalid accessKey.")
        channel_name = req.params.get("channel")
        if channel_name is None:
            return ak, None
        for ch in channels.get_by_appid(ak.appid):
            if ch.name == channel_name:
                return ak, ch.id
        raise AuthError(401, "Invalid channel.")

    def check_event_allowed(ak: AccessKey, event_name: str) -> None:
        # per-key whitelist (reference EventServer.scala:272)
        if ak.events and event_name not in ak.events:
            raise AuthError(
                403, f"{event_name} events are not allowed"
            )

    def insert_one(ak: AccessKey, channel_id: int | None, d: dict,
                   ) -> tuple[str, bool]:
        """-> (event_id, spilled). Validation/auth/plugin failures raise;
        a TRANSIENT store failure (breaker open, transport error after
        retries) degrades to the spill queue instead of failing the
        request — the id is assigned up front so the client's receipt is
        the id the drain later persists."""
        event = Event.from_api_dict(d)
        validate_event(event)
        check_event_allowed(ak, event.event)
        for blocker in plugins.input_blockers:
            blocker.process(d, {"appId": ak.appid, "channelId": channel_id})
        for sniffer in plugins.input_sniffers:
            try:
                sniffer.process(d, {"appId": ak.appid, "channelId": channel_id})
            except Exception:  # noqa: BLE001 - sniffers cannot fail requests
                pass
        # mint the id at the edge, BEFORE the store sees the event: the
        # resilient DAO may retry a transiently-failed insert that
        # actually committed (a phantom failure), and only an insert
        # carrying its id is idempotent across every backend (memory/
        # sql upsert by id; eventlog dedupes a supplied id)
        if event.event_id is None:
            event = event.with_id(new_event_id())
        spilled = False
        try:
            event_id = events_dao.insert(event, ak.appid, channel_id)
        except Exception as e:  # noqa: BLE001 - classified below
            if spill is None or not is_transient(e):
                raise
            if not offer_or_shed(event, ak.appid, channel_id):
                raise  # queue full: shed (503 via the authed wrapper)
            event_id, spilled = event.event_id, True
        if config.stats:  # gated like reference EventServer.scala:284-285
            stats.update(ak.appid, 201, event.event, event.entity_type)
        tail_notify()
        return event_id, spilled

    # -- per-wire-codec ingest counters (docs/observability.md): the
    # JSON -> binary migration must be visible on the Prometheus plane,
    # so the batch route records events/bytes/decode-seconds under a
    # `codec` label. Lifetime-monotonic, exported by GET /metrics.
    # The two busy counters are wall seconds during which at least one
    # batch was in the store's insert_batch (insert) or in the route
    # (handle), however many handler threads overlap.
    wire_lock = threading.Lock()
    wire_stats: dict[str, dict[str, float]] = {
        codec: {"batches": 0, "events": 0, "bytes": 0, "decode_seconds": 0.0,
                "insert_busy_seconds": 0.0, "handle_busy_seconds": 0.0}
        for codec in ("json", "binary")
    }
    app.wire_stats = wire_stats  # exposed for tests/ops
    busy_inside: dict[tuple[str, str], list] = {
        (codec, stage): [0, 0.0]  # [batches inside, since when]
        for codec in wire_stats for stage in ("insert", "handle")
    }

    @contextlib.contextmanager
    def busy(codec: str, stage: str):
        """Adds the wall time during which any batch is inside to the
        codec's ``<stage>_busy_seconds``."""
        inside = busy_inside[(codec, stage)]
        with wire_lock:
            if inside[0] == 0:
                inside[1] = time.monotonic()
            inside[0] += 1
        try:
            yield
        finally:
            with wire_lock:
                inside[0] -= 1
                if inside[0] == 0:
                    wire_stats[codec][f"{stage}_busy_seconds"] += (
                        time.monotonic() - inside[1])

    def record_wire(codec: str, results: list, nbytes: int,
                    decode_s: float) -> None:
        accepted = sum(1 for r in results
                       if isinstance(r, dict) and r.get("status") == 201)
        with wire_lock:
            w = wire_stats[codec]
            w["batches"] += 1
            w["events"] += accepted
            w["bytes"] += nbytes
            w["decode_seconds"] += decode_s

    def insert_decoded(ak: AccessKey, channel_id: int | None,
                       decoded: Sequence[Event | EventValidationError],
                       codec: str,
                       dicts: Sequence | None = None) -> list[dict]:
        """The Python batch-ingest pipeline behind BOTH wire codecs: the
        decode pass (columnar.decode_api_batch for JSON bodies,
        columnar.decode_api_batch_binary for binary frames — shared
        receive timestamp, fast Event construction) happens at the
        route, ids are minted in bulk (one entropy syscall), and ONE
        insert_batch DAO call replaces a guarded per-event insert.
        Per-event isolation is preserved: a slot's validation/auth/
        plugin failure becomes its own 400/403 while the rest of the
        batch proceeds, and a store failure falls back to the per-event
        insert/spill path so degraded-mode semantics match the
        single-event route exactly. ``dicts`` carries the original API
        dicts for the plugin hooks (the JSON route); the binary route
        materializes one per slot only when plugins are registered."""
        from pio_tpu_torch.data.backends.common import new_event_ids

        have_plugins = bool(plugins.input_blockers or plugins.input_sniffers)

        results: list[dict | None] = [None] * len(decoded)
        ctx = {"appId": ak.appid, "channelId": channel_id}
        to_insert: list[tuple[int, Event]] = []
        whitelist = bool(ak.events)
        for i, item in enumerate(decoded):
            if isinstance(item, EventValidationError):
                results[i] = {"status": 400, "message": str(item)}
                continue
            event = item
            if not whitelist and not have_plugins:
                # nothing left that can reject this slot pre-insert
                to_insert.append((i, event))
                continue
            # ONE dict per slot shared by every hook (the JSON route's
            # body[i] aliasing: a blocker's annotation is visible to
            # later blockers and sniffers), materialized only when
            # plugins are registered
            d = None
            if have_plugins:
                d = dicts[i] if dicts is not None else event.to_api_dict()
            try:
                if whitelist:
                    check_event_allowed(ak, event.event)
                if have_plugins:
                    for blocker in plugins.input_blockers:
                        blocker.process(d, ctx)
            except AuthError as e:
                results[i] = {"status": e.status, "message": e.message}
                continue
            except PluginRejection as e:
                results[i] = {"status": 403, "message": str(e)}
                continue
            except ValueError as e:
                # client-error class (the single-event route's authed
                # wrapper maps it to 400 the same way)
                results[i] = {"status": 400, "message": str(e)}
                continue
            except Exception as e:  # noqa: BLE001 - per-event isolation:
                # a misbehaving blocker (or any unexpected per-event
                # failure) fails ITS slot, never its batch-mates — the
                # same net the old per-event loop cast
                results[i] = {
                    "status": 503 if is_transient(e) else 500,
                    "message": str(e),
                }
                continue
            if have_plugins:
                for sniffer in plugins.input_sniffers:
                    try:
                        sniffer.process(d, ctx)
                    except Exception:  # noqa: BLE001 - sniffers cannot fail
                        pass
            to_insert.append((i, event))
        # mint ids at the edge in bulk (same idempotency contract as
        # insert_one: a retried/spilled insert always carries its id).
        # Assigned IN PLACE: these Events came fresh out of the decode
        # pass and are aliased nowhere else, so skipping 50 with_id
        # copies is safe — the one spot allowed to touch a frozen
        # Event's __dict__ besides with_id itself.
        missing = [e for _, e in to_insert if e.event_id is None]
        for e, eid in zip(missing, new_event_ids(len(missing))):
            e.__dict__["event_id"] = eid

        def ok(i: int, event: Event, spilled: bool) -> None:
            r: dict = {"status": 201, "eventId": event.event_id}
            if spilled:
                r["spilled"] = True
            results[i] = r
            if config.stats:
                stats.update(ak.appid, 201, event.event, event.entity_type)

        def insert_fallback(i: int, event: Event) -> None:
            """Single-event degraded path: insert, spill on transient
            failure, per-event 503/500 otherwise (the old loop's net)."""
            try:
                events_dao.insert(event, ak.appid, channel_id)
                ok(i, event, False)
            except ValueError as e:
                # 400 like the old loop (and the single-event route):
                # a ValueError out of the store is a client-error class,
                # not a server fault
                results[i] = {"status": 400, "message": str(e)}
            except Exception as e:  # noqa: BLE001 - per-event isolation
                if spill is not None and is_transient(e):
                    try:
                        if offer_or_shed(event, ak.appid, channel_id):
                            ok(i, event, True)
                            return
                    except SpillSaturated as sat:
                        # per-slot 429: same backpressure signal the
                        # single-event route answers past high water
                        results[i] = {"status": 429, "message": str(sat)}
                        return
                results[i] = {
                    "status": 503 if is_transient(e) else 500,
                    "message": str(e),
                }

        if to_insert:
            try:
                with busy(codec, "insert"):
                    events_dao.insert_batch(
                        [e for _, e in to_insert], ak.appid, channel_id)
            except Exception:  # noqa: BLE001 - degrade per event
                for i, event in to_insert:
                    insert_fallback(i, event)
            else:
                if config.stats:
                    for i, event in to_insert:
                        ok(i, event, False)
                else:
                    # the all-accepted hot path: result dicts inline
                    for i, event in to_insert:
                        results[i] = {"status": 201,
                                      "eventId": event.event_id}
        if any(isinstance(r, dict) and r.get("status") == 201
               for r in results):
            tail_notify()  # wake long-poll tail subscribers
        return results  # type: ignore[return-value]

    # -- routes -------------------------------------------------------------
    def authed(fn):
        """Wrap a handler with authentication + the AuthError/403/400 status
        mapping all routes share (the reference's withAccessKey directive)."""

        def wrapper(req: Request):
            try:
                ak, channel_id = authenticate(req)
                if ingest_quota is not None and req.method == "POST":
                    ok, retry_after = admit_ingest(ak)
                    if not ok:
                        return 429, json_response(
                            {"message": f"app {ak.appid} over its "
                                        f"ingest quota "
                                        f"({config.ingest_quota_qps:g}"
                                        f" events/s); retry later"},
                            {"Retry-After":
                                 f"{max(1, round(retry_after))}"},
                        )
                    try:
                        return fn(req, ak, channel_id)
                    finally:
                        ingest_quota.release(str(ak.appid))
                return fn(req, ak, channel_id)
            except AuthError as e:
                return e.status, {"message": e.message}
            except PluginRejection as e:
                return 403, {"message": str(e)}
            except (
                EventValidationError,
                ConnectorException,
                json.JSONDecodeError,
                ValueError,
            ) as e:
                return 400, {"message": str(e)}
            except SpillSaturated as e:
                # end-to-end backpressure: the spill queue crossed its
                # high-water mark — 429 tells well-behaved clients to
                # back off while the drain catches up (resumes at the
                # low-water mark; see resilience/spill.py hysteresis)
                return 429, json_response(
                    {"message": str(e)}, {"Retry-After": "1"},
                )
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise  # real bug: dispatch_safe's 500 applies
                # event store down and spill unavailable/full: shed with
                # an honest 503 + Retry-After instead of a 500 (clients
                # and balancers treat 503 as retryable; reference spray
                # returns 503 on ask-timeout the same way)
                return 503, json_response(
                    {"message": f"event store unavailable: {e}"},
                    {"Retry-After": "1"},
                )

        wrapper.__name__ = fn.__name__
        return wrapper

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, {"status": "alive"}

    def _native_fast_path():
        """The native C++ ingest path (parse+validate+append in one call)
        applies when the events DAO exposes it and no input plugins are
        registered (plugins see parsed dicts, which the fast path never
        materializes). Stats stay accurate: the native results carry the
        event name + entity type."""
        fast = getattr(events_dao, "insert_api_batch", None)
        if fast is None:
            return None
        if plugins.input_blockers or plugins.input_sniffers:
            return None
        return fast

    def _one_native(fast, req: Request, ak, channel_id):
        results = fast(
            req.body, ak.appid, channel_id,
            allowed_events=list(ak.events or ()), single=True,
        )
        status, payload, event_name, entity_type = results[0]
        if status == 0:
            if config.stats:
                stats.update(ak.appid, 201, event_name, entity_type)
            tail_notify()
            return 201, {"eventId": payload}
        if status == 2:
            return 403, {"message": payload}
        if payload == "event must be a JSON object":
            payload = "request body must be a JSON object"
        return 400, {"message": payload}

    @app.route("POST", r"/events\.json")
    @authed
    def create_event(req: Request, ak, channel_id):
        fast = _native_fast_path()
        if fast is not None:
            try:
                return _one_native(fast, req, ak, channel_id)
            except ValueError:
                pass  # malformed body: Python path produces the message
            except Exception as e:  # noqa: BLE001 - transient -> spill path
                if not is_transient(e):
                    raise
                # store down mid-fast-path: fall through to the Python
                # path, whose insert_one degrades into the spill queue
        body = req.json()
        if not isinstance(body, dict):
            return 400, {"message": "request body must be a JSON object"}
        event_id, spilled = insert_one(ak, channel_id, body)
        if spilled:
            return 201, {"eventId": event_id, "spilled": True}
        return 201, {"eventId": event_id}

    @app.route("GET", r"/events/([^/]+)\.json")
    @authed
    def get_event(req: Request, ak, channel_id):
        event = events_dao.get(req.path_args[0], ak.appid, channel_id)
        if event is None:
            return 404, {"message": "Not Found"}
        return 200, event.to_api_dict()

    @app.route("DELETE", r"/events/([^/]+)\.json")
    @authed
    def delete_event(req: Request, ak, channel_id):
        found = events_dao.delete(req.path_args[0], ak.appid, channel_id)
        if found:
            return 200, {"message": "Found"}
        return 404, {"message": "Not Found"}

    @app.route("GET", r"/events\.json")
    @authed
    def find_events(req: Request, ak, channel_id):
        p = req.params

        def opt_time(name):
            return parse_time(p[name]) if name in p else None

        def opt_nullable(name):
            # "&targetEntityType=" (empty) means must-be-absent; missing
            # means don't-care — mirroring Option[Option[String]]
            if name not in p:
                return ...
            return p[name] or None

        limit = int(p.get("limit", 20))
        out = list(
            events_dao.find(
                app_id=ak.appid,
                channel_id=channel_id,
                start_time=opt_time("startTime"),
                until_time=opt_time("untilTime"),
                entity_type=p.get("entityType"),
                entity_id=p.get("entityId"),
                event_names=[p["event"]] if "event" in p else None,
                target_entity_type=opt_nullable("targetEntityType"),
                target_entity_id=opt_nullable("targetEntityId"),
                limit=limit,
                reversed=p.get("reversed", "false").lower() == "true",
            )
        )
        if not out:
            return 404, {"message": "Not Found"}
        return 200, [e.to_api_dict() for e in out]

    @app.route("GET", r"/tail/events\.json")
    @authed
    def tail_events(req: Request, ak, channel_id):
        """Subscription tail over the columnar batch path (the
        freshness subsystem's remote window read): events at or after
        ``sinceUs`` (event-time µs; -1 = from the beginning) as a
        columnar JSON batch — parallel arrays, no per-event objects —
        plus ``nextUs``, the boundary to resume from (INCLUSIVE re-read;
        consumers dedupe the boundary microsecond, see
        pio_tpu/freshness/cursor.py). ``events`` is a comma-separated
        event-name filter; ``entityType``/``targetEntityType`` filter
        like GET /events.json.

        ``Accept: application/x-pio-columnar`` negotiates the binary
        columnar frame instead (the same sorted/limited window as one
        CRC32C-framed ColumnarEvents batch — consumers derive count and
        nextUs from the time column); JSON stays the default.

        ``waitS`` turns the poll into a LONG-POLL push subscription:
        when the window holds nothing strictly newer than ``sinceUs``,
        the request blocks until an ingest lands (the notify hook) or
        the wait elapses, then answers the normal shape — a pre-waitS
        server ignores the parameter and degrades to plain polling
        transparently. Capped at TAIL_WAIT_CAP_S; a 1s re-read backstop
        inside the wait covers spill-drain inserts, which bypass the
        notify hook."""
        import numpy as np

        from pio_tpu_torch.data.columnar import (
            ColumnarEvents, _restore_time, encode_columnar_events,
        )

        p = req.params
        since_us = int(p.get("sinceUs", -1))
        limit = max(1, min(int(p.get("limit", 20000)), 100_000))
        wait_s = min(max(float(p.get("waitS", 0.0)), 0.0), TAIL_WAIT_CAP_S)
        names = [s for s in (p.get("events") or "").split(",") if s]

        def read_window():
            cols = events_dao.find_columnar(
                app_id=ak.appid,
                channel_id=channel_id,
                start_time=(_restore_time(since_us, 0)
                            if since_us >= 0 else None),
                entity_type=p.get("entityType"),
                event_names=names or None,
                target_entity_type=(p["targetEntityType"]
                                    if "targetEntityType" in p else ...),
            )
            t = np.asarray(cols.time_us)
            return cols, t, np.argsort(t, kind="stable")[:limit]

        def has_new(t, order) -> bool:
            if not order.shape[0]:
                return False
            if since_us < 0:
                return True
            # boundary-microsecond rows re-read every poll are not news;
            # only a strictly-newer row ends the wait
            return int(t[order].max()) > since_us

        deadline = time.monotonic() + wait_s if wait_s > 0 else None
        while True:
            with tail_cond:
                seen = tail_seq[0]
            cols, t, order = read_window()
            if deadline is None or has_new(t, order):
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with tail_cond:
                if tail_seq[0] == seen:
                    tail_cond.wait(min(remaining, 1.0))
        if COLUMNAR_CONTENT_TYPE in req.header("accept").lower():
            from pio_tpu_torch.server.http import RawResponse

            def compact(codes: np.ndarray, table):
                """Renumber codes over the SHIPPED rows only — a
                limit-truncated window must not drag the whole store's
                dictionary onto the wire (-1 absent markers survive)."""
                uniq, inv = np.unique(codes, return_inverse=True)
                if len(uniq) and uniq[0] == -1:
                    return (inv.astype(np.int32) - 1,
                            [table[c] for c in uniq[1:]])
                return inv.astype(np.int32), [table[c] for c in uniq]

            ev_c, ev_tab = compact(
                np.asarray(cols.event_code)[order], cols.event_names)
            en_c, en_tab = compact(
                np.asarray(cols.entity_code)[order], cols.entity_ids)
            tg_c, tg_tab = compact(
                np.asarray(cols.target_code)[order], cols.target_ids)
            sub = ColumnarEvents(
                event_code=ev_c, entity_code=en_c, target_code=tg_c,
                time_us=t[order],
                tz_min=np.asarray(cols.tz_min)[order],
                event_names=ev_tab, entity_ids=en_tab,
                target_ids=tg_tab,
                # parity with the JSON tail: no property payload ships
                properties=[None] * int(order.shape[0]),
            )
            return 200, RawResponse(encode_columnar_events(sub),
                                    COLUMNAR_CONTENT_TYPE)
        ent = np.asarray(cols.entity_ids, dtype=object)
        evn = np.asarray(cols.event_names, dtype=object)
        tgt = np.asarray(cols.target_ids, dtype=object)
        tcode = np.asarray(cols.target_code)[order]
        out_t = t[order]
        return 200, {
            "count": int(order.shape[0]),
            "sinceUs": since_us,
            "nextUs": int(out_t.max()) if order.shape[0] else since_us,
            "timesUs": out_t.tolist(),
            "entityIds": ent[np.asarray(cols.entity_code)[order]].tolist(),
            "events": evn[np.asarray(cols.event_code)[order]].tolist(),
            "targetEntityIds": [
                (tgt[c] if c >= 0 else None) for c in tcode
            ],
        }

    @app.route("POST", r"/batch/events\.json")
    @authed
    def batch_events(req: Request, ak, channel_id):
        """Batch ingest, two wire codecs on ONE route:

          * ``Content-Type: application/x-pio-columnar`` — the binary
            columnar frame (data/columnar.py): CRC32C-verified at the
            edge (corrupt/truncated frames 400 with nothing stored),
            columns decoded by frombuffer pointer-cast, per-event
            verdicts/spill fallback identical to the JSON route.
          * anything else — the JSON array (kept for compatibility),
            through the native C fast path when available.
        """
        ctype = req.header("content-type").split(";")[0].strip().lower()
        with busy("binary" if ctype == COLUMNAR_CONTENT_TYPE else "json",
                  "handle"):
            return batch_route(req, ak, channel_id, ctype)

    def batch_route(req: Request, ak, channel_id, ctype: str):
        if ctype == COLUMNAR_CONTENT_TYPE:
            from pio_tpu_torch.data.columnar import wire_batch_row_count

            over_limit = {
                "message": "Batch request must have less than or "
                f"equal to {MAX_EVENTS_PER_BINARY_BATCH} events"
            }
            # size check BEFORE the decode pass (the JSON route's
            # ordering): the row count sits at a fixed header offset,
            # so an oversized frame costs microseconds, not a
            # million-event construction loop thrown away at the end
            peek = wire_batch_row_count(req.body)
            if peek is not None and peek > MAX_EVENTS_PER_BINARY_BATCH:
                return 400, over_limit
            t0 = time.monotonic()
            decoded = decode_api_batch_binary(req.body)
            decode_s = time.monotonic() - t0
            if len(decoded) > MAX_EVENTS_PER_BINARY_BATCH:
                return 400, over_limit  # backstop: peek declined to read
            results = insert_decoded(ak, channel_id, decoded, "binary")
            record_wire("binary", results, len(req.body), decode_s)
            return 200, results
        fast = _native_fast_path()
        if fast is not None:
            from pio_tpu_torch.native.eventlog import BatchTooLarge

            try:
                results = fast(
                    req.body, ak.appid, channel_id,
                    allowed_events=list(ak.events or ()),
                    max_events=MAX_EVENTS_PER_BATCH,
                )
            except BatchTooLarge:
                return 400, {
                    "message": "Batch request must have less than or equal "
                    f"to {MAX_EVENTS_PER_BATCH} events"
                }
            except ValueError:
                results = None  # malformed body: Python path for messages
            except Exception as e:  # noqa: BLE001 - transient -> spill path
                if not is_transient(e):
                    raise
                results = None  # store down: Python path spills per event
            if results is not None:
                out = []
                for status, payload, event_name, entity_type in results:
                    if status == 0:
                        if config.stats:
                            stats.update(ak.appid, 201, event_name,
                                         entity_type)
                        out.append({"status": 201, "eventId": payload})
                    elif status == 2:
                        out.append({"status": 403, "message": payload})
                    else:
                        out.append({"status": 400, "message": payload})
                # decode is fused with the append inside the C call, so
                # only events/bytes are separable for the native exit
                record_wire("json", out, len(req.body), 0.0)
                if any(s.get("status") == 201 for s in out):
                    tail_notify()
                return 200, out
        from pio_tpu_torch.data.columnar import decode_api_batch

        t0 = time.monotonic()
        body = req.json()
        if not isinstance(body, list):
            return 400, {"message": "request body must be a JSON array"}
        if len(body) > MAX_EVENTS_PER_BATCH:
            return 400, {
                "message": "Batch request must have less than or equal to "
                f"{MAX_EVENTS_PER_BATCH} events"
            }
        decoded = decode_api_batch(body)
        decode_s = time.monotonic() - t0
        results = insert_decoded(ak, channel_id, decoded, "json", dicts=body)
        record_wire("json", results, len(req.body), decode_s)
        return 200, results

    @app.route("GET", r"/stats\.json")
    @authed
    def get_stats(req: Request, ak, channel_id):
        if not config.stats:
            return 404, {
                "message": "To see stats, launch Event Server with --stats"
            }
        return 200, stats.get(ak.appid)

    @app.route("GET", r"/metrics")
    def get_metrics(req: Request):
        """Prometheus text exposition through the SHARED renderer
        (uniform `surface` label, docs/observability.md): request-span
        summaries always, plus the lifetime ingest counters when
        --stats is on (monotonic, unlike /stats.json's hourly windows).
        Requires a configured metrics key: the counters span every app,
        so /stats.json's per-app accessKey gate cannot apply, and an
        open endpoint would leak tenant app ids + event vocabulary to
        any ingest client."""
        if not config.metrics_key:
            return 404, {
                "message": "To see metrics, launch Event Server with "
                           "--metrics-key (and --stats for ingest "
                           "counters)"
            }
        if req.params.get("accessKey", "") != config.metrics_key:
            return 401, {"message": "Invalid accessKey."}
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_histogram,
            prometheus_labeled_counter, prometheus_text,
        )

        counters = {}
        if spill is not None:
            s = spill.snapshot()
            counters["spill_queue_depth"] = float(s["size"])
            # drain health (docs/resilience.md): the drain-rate counter
            # and the oldest-spilled-event age gauge make an aging
            # backlog visible long before the high-water 429s start
            counters["spill_spilled_total"] = float(s["spilled"])
            counters["spill_drained_total"] = float(s["drained"])
            counters["spill_dropped_total"] = float(s["dropped"])
            counters["spill_oldest_age_seconds"] = float(
                s["oldestAgeSeconds"])
        # connection reuse, both directions (docs/performance.md
        # "Internal RPC plane"): outbound = the spill drain / remote
        # storage RPC pool; inbound = requests per accepted keep-alive
        # connection (SDK ingest + tail long-pollers — a fleet stuck at
        # ~1 request/connection re-dials per call: a proxy stripping
        # keep-alive, visible here before it is a latency page)
        from pio_tpu_torch.utils.httpclient import pool_counters

        counters.update(pool_counters())
        conn_stats = getattr(getattr(app, "transport", None),
                             "connection_stats", None)
        if callable(conn_stats):
            cs = conn_stats()
            counters["http_connections_accepted_total"] = float(
                cs["connectionsAccepted"])
            counters["http_requests_served_total"] = float(
                cs["requestsServed"])
            counters["http_requests_per_connection"] = float(
                cs["requestsPerConnection"])
        text = prometheus_text(tracer.snapshot(), counters,
                               labels={"surface": "eventserver"})
        # replicated event store (docs/storage.md "Replication"): hint
        # depth per replica, scrub divergence, and the quorum-write
        # latency histogram, exported whenever the events DAO is a
        # ReplicatedEventsDAO (duck-typed so every other backend skips)
        repl_status = getattr(events_dao, "replication_status", None)
        if callable(repl_status):
            try:
                rst = repl_status()
            except Exception:  # noqa: BLE001 - metrics must never 500
                rst = None
            if rst:
                base_l = {"surface": "eventserver"}
                rows = [
                    ({**base_l, "replica": str(r["replica"])},
                     float(r["hintDepth"]))
                    for r in rst["replicas"]
                ]
                # depth drains back to 0 and divergence clears: gauges,
                # not counters (a counter TYPE would make every drain
                # look like a reset to rate())
                text += "\n".join(prometheus_labeled_counter(
                    "replica_hint_depth", rows, mtype="gauge")) + "\n"
                scrub_last = (rst.get("scrub") or {}).get("lastResult") or {}
                text += "\n".join(prometheus_labeled_counter(
                    "scrub_divergent_buckets",
                    [(base_l, float(scrub_last.get("divergentBuckets", 0)))],
                    mtype="gauge")) + "\n"
                c = rst.get("counters", {})
                for name, key in (("replica_hints_total", "hinted"),
                                  ("replica_hints_drained_total", "drained"),
                                  ("replica_read_repairs_total",
                                   "readRepairs")):
                    text += "\n".join(prometheus_labeled_counter(
                        name, [(base_l, float(c.get(key, 0)))])) + "\n"
                # one proper histogram family through the shared
                # renderer (utils/tracing.prometheus_histogram):
                # _bucket/_sum/_count, cumulative le convention
                lat = rst.get("quorumLatency") or {}
                text += "\n".join(prometheus_histogram(
                    "quorum_write_seconds",
                    lat.get("bucketsS", []), lat.get("counts", []),
                    lat.get("count", 0), lat.get("sumSeconds", 0.0),
                    labels=base_l)) + "\n"
        # per-wire-codec ingest counters: the JSON -> binary migration
        # shows up as rate moving between the codec labels
        with wire_lock:
            wire_snap = {c: dict(v) for c, v in wire_stats.items()}
        for metric in ("events", "bytes", "batches", "decode_seconds",
                       "insert_busy_seconds", "handle_busy_seconds"):
            rows = [
                ({"surface": "eventserver", "codec": c}, v[metric])
                for c, v in sorted(wire_snap.items())
            ]
            text += "\n".join(prometheus_labeled_counter(
                f"ingest_wire_{metric}_total", rows)) + "\n"
        # per-app ingest-quota sheds (multi-tenant plane): which app is
        # being rate-limited, and how hard
        with ingest_shed_lock:
            shed_snap = dict(ingest_shed)
        if shed_snap:
            rows = [
                ({"surface": "eventserver", "app": str(app_id)},
                 float(n))
                for app_id, n in sorted(shed_snap.items())
            ]
            text += "\n".join(prometheus_labeled_counter(
                "ingest_shed_total", rows)) + "\n"
        if config.stats:
            rows = [
                ({"surface": "eventserver", "app_id": k.app_id,
                  "event": k.event, "entity_type": k.entity_type,
                  "status": k.status}, float(n))
                for k, n in sorted(stats.totals().items(),
                                   key=lambda kv: (kv[0].app_id,
                                                   kv[0].event,
                                                   kv[0].status))
            ]
            lines = prometheus_labeled_counter("events_ingested_total",
                                               rows)
            text += "\n".join(lines) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    # -- webhooks (reference api/Webhooks.scala:44-151) ---------------------
    @app.route("POST", r"/webhooks/([^/]+)\.json")
    @authed
    def webhook_json(req: Request, ak, channel_id):
        name = req.path_args[0]
        connector = json_connectors.get(name)
        if connector is None:
            return 404, {"message": f"webhook {name} not supported"}
        data = req.json()
        if not isinstance(data, dict):
            return 400, {"message": "webhook body must be a JSON object"}
        event_json = connector.to_event_json(data)
        event_id, spilled = insert_one(ak, channel_id, event_json)
        if spilled:
            return 201, {"eventId": event_id, "spilled": True}
        return 201, {"eventId": event_id}

    @app.route("GET", r"/webhooks/([^/]+)\.json")
    @authed
    def webhook_json_check(req: Request, ak, channel_id):
        name = req.path_args[0]
        if name in json_connectors:
            return 200, {"message": f"Ok. Will interpret JSON in {name} format"}
        return 404, {"message": f"webhook {name} not supported"}

    @app.route("POST", r"/webhooks/([^/.]+)")
    @authed
    def webhook_form(req: Request, ak, channel_id):
        name = req.path_args[0]
        connector = form_connectors.get(name)
        if connector is None:
            return 404, {"message": f"webhook {name} not supported"}
        event_json = connector.to_event_json(req.form())
        event_id, spilled = insert_one(ak, channel_id, event_json)
        if spilled:
            return 201, {"eventId": event_id, "spilled": True}
        return 201, {"eventId": event_id}

    @app.route("GET", r"/webhooks/([^/.]+)")
    @authed
    def webhook_form_check(req: Request, ak, channel_id):
        name = req.path_args[0]
        if name in form_connectors:
            return 200, {"message": f"Ok. Will interpret form in {name} format"}
        return 404, {"message": f"webhook {name} not supported"}

    def readiness() -> dict:
        """storage breakers not open + spill queue under its high-water
        mark (the snapshot exports depth/watermarks/saturation so
        balancers and `pio doctor` see backpressure building before the
        429s start) + async transport queue under its shed watermark."""
        checks = breaker_checks(storage)
        if spill is not None:
            s = spill.snapshot()
            checks["spill"] = {
                "ok": not s["saturated"] and s["size"] < s["capacity"],
                **s,
            }
        checks.update(shedder_check(getattr(app, "transport", None)))
        return checks

    install_health_routes(app, readiness)

    # distributed tracing (pio_tpu/obs/): the event server faces
    # untrusted ingest clients and trace records carry request paths +
    # timing, so the /debug routes REQUIRE the metrics key (401 until
    # --metrics-key is configured) — stricter than the other surfaces'
    # optional server_key by design. The traced edge itself (trace ids
    # on every ingest request) costs nothing to expose.
    from pio_tpu_torch.obs.http import install_trace_routes

    install_trace_routes(
        app, recorder,
        lambda req: bool(config.metrics_key)
        and req.params.get("accessKey", "") == config.metrics_key)

    return app


def create_event_server(
    storage: Storage | None = None,
    config: EventServerConfig | None = None,
    plugin_context: PluginContext | None = None,
) -> HttpServer | AsyncHttpServer:
    from pio_tpu_torch.server.security import server_ssl_context

    config = config or EventServerConfig()
    app = build_event_app(storage, config, plugin_context)
    server_cls = AsyncHttpServer if config.backend == "async" else HttpServer
    return server_cls(
        app, host=config.ip, port=config.port,
        ssl_context=server_ssl_context(config.certfile, config.keyfile),
    )
