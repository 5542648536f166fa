"""HTTP core shared by the event server, admin server, dashboard, and
deploy server: one regex route table (`HttpApp`), two interchangeable
transports.

Replaces the reference's spray/akka actor HTTP stack (EventServer.scala:219,
CreateServer.scala:463). `HttpServer` is a stdlib ThreadingHTTPServer —
thread per connection, zero moving parts, fine for admin surfaces.
`AsyncHttpServer` is the serving/ingest transport: an asyncio HTTP/1.1
server (keep-alive, bounded worker pool for the sync handlers) that plays
the role of spray's event-loop IO without akka — connection handling stays
on the event loop, handler work is bounded instead of thread-per-request.
Both are dependency-free stdlib. Handlers return (status,
json-serializable body) either way.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import socket
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from pio_tpu_torch.obs import context as _tracectx
from pio_tpu_torch.obs.recorder import SpanRecord as _SpanRecord
from pio_tpu_torch.resilience.policies import LoadShedder, RetryPolicy

log = logging.getLogger("pio_tpu_torch.http")

# fixed-port binds retry briefly before giving up (reference
# CreateServer.scala:365-375): a just-stopped predecessor's socket can
# linger in TIME_WAIT across a redeploy. port=0 never collides, so
# ephemeral binds fail fast.
BIND_ATTEMPTS = 3
BIND_RETRY_DELAY_S = 1.0


def bind_retry_policy(port: int) -> RetryPolicy:
    """Shared bind-retry schedule for both transports (fixed delay, no
    jitter — redeploys race a TIME_WAIT socket, not a thundering herd).
    One place so the sync and async servers cannot drift."""
    return RetryPolicy(
        attempts=BIND_ATTEMPTS if port else 1,
        base_delay_s=BIND_RETRY_DELAY_S, multiplier=1.0,
        jitter=0.0, retry_on=(OSError,),
    )


def _log_bind_retry(port: int):
    def on_retry(attempt: int, err: BaseException, delay: float):
        log.warning("bind to port %d failed (%s); retry %d/%d in %.0fs",
                    port, err, attempt + 1, BIND_ATTEMPTS - 1, delay)
    return on_retry


def bind_with_retry(make, port: int):
    """Call make() (which binds a socket), retrying OSError up to
    BIND_ATTEMPTS times for fixed ports (resilience.RetryPolicy)."""
    return bind_retry_policy(port).call(
        make, on_retry=_log_bind_retry(port))


def _reject_nonfinite(token: str):
    # JSONDecodeError (a ValueError subclass) so dispatch_safe's 400
    # mapping applies on EVERY server, not only handlers that catch
    # ValueError themselves — a NaN body must never 500
    raise json.JSONDecodeError(
        f"non-finite JSON constant {token!r} is not valid JSON", token, 0)


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]            # query params (first value wins)
    headers: dict[str, str]
    body: bytes = b""
    path_args: tuple[str, ...] = ()   # regex captures from the route pattern

    def json(self) -> Any:
        if not self.body:
            return None
        # strict JSON: NaN/Infinity are not valid JSON and the
        # reference's json4s rejects them; accepting NaN here would let
        # it flow into stored properties and poison downstream math and
        # re-serialization (found by the event-server garbage fuzz)
        return json.loads(
            self.body.decode("utf-8"),
            parse_constant=_reject_nonfinite)

    def form(self) -> dict[str, str]:
        parsed = urllib.parse.parse_qs(
            self.body.decode("utf-8"), keep_blank_values=True
        )
        return {k: v[0] for k, v in parsed.items()}

    def header(self, name: str, default: str = "") -> str:
        """Case-insensitive header lookup (headers are stored lowercased)."""
        return self.headers.get(name.lower(), default)


Handler = Callable[[Request], tuple[int, Any]]


class HttpApp:
    """Route table: (method, compiled path regex) -> handler."""

    def __init__(self, name: str = "pio"):
        self.name = name
        self.routes: list[tuple[str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str):
        compiled = re.compile("^" + pattern + "$")

        def deco(fn: Handler) -> Handler:
            # pio: lint-ok[attr-no-lock] route table is built while the
            # app is constructed, before any server thread serves from it
            self.routes.append((method.upper(), compiled, fn))
            return fn

        return deco

    def dispatch(self, req: Request) -> tuple[int, Any]:
        path_matched = False
        for method, pattern, fn in self.routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            req.path_args = m.groups()
            return fn(req)
        if path_matched:
            return 405, {"message": "Method Not Allowed"}
        return 404, {"message": "Not Found"}


def _dispatch_plain(app: HttpApp, req: Request) -> tuple[int, Any]:
    """Dispatch with the error policy both transports share."""
    try:
        return app.dispatch(req)
    except json.JSONDecodeError:
        return 400, {"message": "Invalid JSON body"}
    except Exception as e:  # noqa: BLE001 - last-resort 500
        return 500, {"message": f"{type(e).__name__}: {e}"}


def dispatch_safe(app: HttpApp, req: Request) -> tuple[int, Any]:
    """Dispatch with the shared error policy — and, on surfaces that
    installed a TraceRecorder (``app.recorder``, set by
    obs/http.py install_trace_routes), the DISTRIBUTED TRACING EDGE:

      * the inbound ``traceparent`` header joins the caller's trace (a
        missing/malformed header starts a fresh one), activated for the
        handler's dynamic extent so every ``Tracer.span`` and outbound
        ``JsonHttpClient`` call underneath parents correctly;
      * the whole request becomes the surface-local edge span
        (status=error on 5xx), the per-surface ``request`` histogram is
        fed (``app.tracer``), and tail-based retention runs;
      * a client that sent ``X-Pio-Trace: 1`` gets the trace id echoed
        back as ``X-Pio-Trace-Id`` and the trace pinned on every
        surface it crossed (the pin rides the traceparent flags).

    Health probes, metrics scrapes, the /debug read surfaces, and the
    prober's /shard/info poll stay untraced (UNTRACED_PATHS) — their
    fixed cadence would only churn the recorders they serve.
    """
    recorder = getattr(app, "recorder", None)
    if recorder is None or req.path in UNTRACED_PATHS:
        return _dispatch_plain(app, req)
    ctx = _tracectx.parse_traceparent(
        req.header(_tracectx.TRACEPARENT_HEADER))
    echo = bool(req.header(_tracectx.TRACE_ECHO_REQUEST_HEADER))
    if ctx is None:
        ctx = _tracectx.new_trace(pinned=echo)
    elif echo and not ctx.pinned:
        import dataclasses

        ctx = dataclasses.replace(ctx, pinned=True)
    t0 = time.monotonic()
    # pio: lint-ok[bench-clock] span start is wall-clock on purpose: it
    # orders spans across processes in the merged tree; duration rides
    # the monotonic clock
    t0_wall = time.time()
    with _tracectx.use(ctx, recorder):
        status, payload = _dispatch_plain(app, req)
    dt = time.monotonic() - t0
    tracer = getattr(app, "tracer", None)
    if tracer is not None:
        tracer.record("request", dt)
    error = None
    if status >= 500 and isinstance(payload, dict):
        error = str(payload.get("message", ""))[:200] or None
    recorder.record(_SpanRecord(
        trace_id=ctx.trace_id, span_id=ctx.span_id,
        parent_id=ctx.parent_id, name=f"{req.method} {req.path}",
        surface=recorder.surface, start_s=t0_wall, duration_s=dt,
        status="error" if status >= 500 else "ok", error=error,
        labels={"method": req.method, "path": req.path,
                "status": str(status)}))
    recorder.finish_trace(ctx.trace_id, pinned=ctx.pinned)
    if echo:
        payload = _with_header(
            payload, _tracectx.TRACE_ECHO_RESPONSE_HEADER, ctx.trace_id)
    return status, payload


def _with_header(payload: Any, name: str, value: str) -> "RawResponse":
    """Attach one response header to any handler payload shape (the
    trace-id echo): RawResponse gains the header on a copy; plain
    payloads are pre-encoded into one."""
    if isinstance(payload, RawResponse):
        return RawResponse(payload.body, payload.content_type,
                           {**(payload.headers or {}), name: value})
    if isinstance(payload, (bytes, str)):
        return RawResponse(payload, "text/html; charset=utf-8",
                           {name: value})
    return RawResponse(json.dumps(payload).encode("utf-8"),
                       "application/json; charset=utf-8", {name: value})


@dataclass
class RawResponse:
    """Handler payload with an explicit content type (plain str/bytes
    default to text/html — wrong for e.g. Prometheus exposition, whose
    strict scrapers reject unknown content types) and optional extra
    response headers (e.g. Retry-After on a 503)."""

    body: bytes | str
    content_type: str = "text/plain; charset=utf-8"
    headers: dict[str, str] | None = None


def json_response(payload: Any, headers: dict[str, str]) -> RawResponse:
    """JSON payload that carries extra response headers (the shape
    degraded-mode 503s use for Retry-After)."""
    return RawResponse(
        json.dumps(payload).encode("utf-8"),
        "application/json; charset=utf-8", headers,
    )


def server_key_ok(req: "Request", server_key: str) -> bool:
    """The operator-endpoint accessKey guard (/reload, /stop) shared by
    the single-host server, the fleet router, and the shard servers —
    one place to harden (e.g. constant-time compare) for all three. An
    empty configured key disables the check."""
    if not server_key:
        return True
    return req.params.get("accessKey", "") == server_key


def encode_payload(payload: Any) -> tuple[bytes, str, dict[str, str]]:
    """-> (body bytes, content-type, extra headers). str/bytes pass
    through as HTML; RawResponse carries its own content type/headers."""
    if isinstance(payload, RawResponse):
        body = (payload.body.encode()
                if isinstance(payload.body, str) else payload.body)
        return body, payload.content_type, payload.headers or {}
    if isinstance(payload, (bytes, str)):
        data = payload.encode() if isinstance(payload, str) else payload
        return data, "text/html; charset=utf-8", {}
    return (
        json.dumps(payload).encode("utf-8"),
        "application/json; charset=utf-8",
        {},
    )


class HttpServer:
    """Threaded HTTP server wrapping an HttpApp; bind/serve/shutdown.

    Pass `ssl_context` (see server/security.py) to serve HTTPS — the
    counterpart of the reference deploy server's JKS-keystore TLS
    (common/.../SSLConfiguration.scala:10-60, CreateServer.scala:316-321).
    """

    def __init__(self, app: HttpApp, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self.app = app
        # connection-reuse accounting, mirroring AsyncHttpServer's
        # (docs/operations.md); handler threads are concurrent here, so
        # the counters take a lock
        self.connections_accepted = 0
        self.requests_served = 0
        self._stats_lock = threading.Lock()
        # sockets of live keep-alive connections: stop() severs them —
        # shutdown() only stops ACCEPTING, and with pooled clients
        # parking persistent connections, handler threads would
        # otherwise keep serving a "stopped" server indefinitely
        self._open_socks: set = set()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: the response is written as two sends
            # (header block, then body); on a persistent keep-alive
            # connection past the kernel's quick-ACK startup window,
            # Nagle would hold the body segment for the client's
            # delayed ACK (~40ms per response). The asyncio transport
            # sets this by default; the threaded server must ask.
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                with outer._stats_lock:
                    outer.connections_accepted += 1
                    outer._open_socks.add(self.connection)

            def finish(self):
                with outer._stats_lock:
                    outer._open_socks.discard(self.connection)
                super().finish()

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _handle(self):
                with outer._stats_lock:
                    outer.requests_served += 1
                parsed = urllib.parse.urlparse(self.path)
                params = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req = Request(
                    method=self.command,
                    path=parsed.path,
                    params=params,
                    # lowercase keys: HTTP header names are case-insensitive
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=body,
                )
                status, payload = dispatch_safe(outer.app, req)
                data, ctype, extra = encode_payload(payload)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in extra.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_DELETE = do_PUT = _handle

        self._server = bind_with_retry(
            lambda: ThreadingHTTPServer((host, port), _Handler), port)
        # readiness probes (resilience/health.py) reach the transport —
        # and its load shedder, when it has one — through the app
        app.transport = self
        if ssl_context is not None:
            self._server.socket = ssl_context.wrap_socket(
                self._server.socket, server_side=True
            )
        self.tls = ssl_context is not None
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def connection_stats(self) -> dict:
        with self._stats_lock:
            conns, reqs = self.connections_accepted, self.requests_served
        return {
            "connectionsAccepted": conns,
            "requestsServed": reqs,
            "requestsPerConnection": round(reqs / conns, 3) if conns
            else 0.0,
        }

    def start(self) -> "HttpServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"{self.app.name}-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self._server.serve_forever()

    def wait(self):
        """Block until the server (started with start()) shuts down."""
        if self._thread:
            self._thread.join()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        with self._stats_lock:
            socks = list(self._open_socks)
            self._open_socks.clear()
        for sock in socks:
            # sever parked keep-alive connections so their handler
            # threads exit (readline sees EOF); without this a
            # "stopped" server keeps serving pooled clients forever
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)


_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}
_MAX_HEADER = 64 * 1024
_MAX_BODY = 64 * 1024 * 1024

# the liveness/readiness probe paths (handlers installed by
# resilience/health.py, which imports this constant): the async
# transport special-cases them — no shedding, no worker pool
HEALTH_PATHS = ("/healthz", "/readyz")

# paths the tracing edge skips (dispatch_safe): health probes, the
# observability READ surfaces themselves, and the router prober's
# /shard/info poll. All of these are polled on a fixed cadence
# (Prometheus scrape, `pio top --watch`, the replica prober), so
# tracing them would let the pollers churn the recorders they read —
# on a low-traffic surface, scrape traces would fill the slowest-N
# retention and dominate the span table, evicting real query traces.
UNTRACED_PATHS = HEALTH_PATHS + (
    "/metrics", "/metrics.json",
    "/debug/traces.json", "/debug/spans.json",
    "/shard/info",
)

# observability READ surfaces exempt from load shedding (they still run
# on the worker pool): saturation is exactly when the occupancy/shedding
# runbooks need the scrape and the batcher status to answer — shedding
# the diagnostics of an overload makes the overload undiagnosable. All
# of these are lock-snapshot cheap and never touch the device.
SHED_EXEMPT_PATHS = HEALTH_PATHS + (
    "/metrics", "/metrics.json", "/batcher.json",
)


class AsyncHttpServer:
    """asyncio HTTP/1.1 server over the same HttpApp (keep-alive, bounded
    handler pool). Interface-compatible with HttpServer: start()/stop()/
    serve_forever()/.port/.tls.

    Connection handling (parse, keep-alive, write-back) runs on one event
    loop; sync handlers run on a bounded ThreadPoolExecutor, so a burst of
    slow requests queues instead of spawning unbounded threads — the role
    spray's actor dispatcher plays for the reference's event server
    (EventServer.scala:219)."""

    def __init__(self, app: HttpApp, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None, workers: int = 16,
                 shed_watermark: int = 0, shed_retry_after_s: float = 1.0):
        self.app = app
        self.host = host
        self.port = port          # rebound to the real port once listening
        self.tls = ssl_context is not None
        self._ssl = ssl_context
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"{app.name}-worker"
        )
        # load shedding: once this many requests are admitted (running on
        # the pool + queued behind it), new work is answered 503 with
        # Retry-After instead of deepening an unservable queue. Default
        # watermark = 8x the worker pool — past that, queue wait alone
        # exceeds any sane client timeout. /healthz + /readyz are exempt
        # (probes must answer precisely when the server is saturated).
        self.shedder = LoadShedder(
            shed_watermark or workers * 8, shed_retry_after_s
        )
        app.transport = self  # readiness probes read shedder depth
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.Server | None = None
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()
        self._failed: BaseException | None = None
        self._main_task: asyncio.Task | None = None
        self._conns: set[asyncio.Task] = set()
        # connection tasks with a request mid-dispatch: what _shutdown
        # grace-drains (idle keep-alive connections are cancelled
        # outright — see _shutdown)
        self._busy: set[asyncio.Task] = set()
        # connection-reuse accounting (docs/operations.md): requests per
        # accepted connection is the server-side keep-alive reuse ratio
        # — a client fleet stuck at 1.0 (e.g. a proxy stripping
        # keep-alive) re-dials per request and shows up here before it
        # shows up as a latency page. Mutated only on the event loop.
        self.connections_accepted = 0
        self.requests_served = 0

    def connection_stats(self) -> dict:
        conns, reqs = self.connections_accepted, self.requests_served
        return {
            "connectionsAccepted": conns,
            "requestsServed": reqs,
            "requestsPerConnection": round(reqs / conns, 3) if conns
            else 0.0,
        }

    # -- connection handling -------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        # pio: lint-ok[attr-no-lock] counter writes happen only on the
        # single event loop thread
        self.connections_accepted += 1
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return  # client closed between requests
                except asyncio.LimitOverrunError:
                    await self._respond(
                        writer, 413, {"message": "headers too large"}, True
                    )
                    return
                # a request is in flight from here until its response is
                # written: _shutdown grace-drains busy tasks and cancels
                # idle (parked keep-alive) ones outright
                if task is not None:
                    self._busy.add(task)
                try:
                    done = await self._serve_one(reader, writer, head)
                finally:
                    if task is not None:
                        self._busy.discard(task)
                if done:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_one(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         head: bytes) -> bool:
        """Parse + dispatch + respond for one request whose header block
        was already read. Returns True when the connection is done
        (Connection: close, HTTP/1.0, or a fatal parse error)."""
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            await self._respond(
                writer, 400, {"message": "malformed request line"}, True
            )
            return True
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            await self._respond(
                writer, 400, {"message": "bad Content-Length"}, True
            )
            return True
        if length > _MAX_BODY:
            await self._respond(
                writer, 413, {"message": "body too large"}, True
            )
            return True
        try:
            body = await reader.readexactly(length) if length else b""
        except asyncio.IncompleteReadError:
            return True  # client closed mid-body
        parsed = urllib.parse.urlparse(target)
        req = Request(
            method=method.upper(),
            path=parsed.path,
            params={
                k: v[0]
                for k, v in urllib.parse.parse_qs(
                    parsed.query, keep_blank_values=True
                ).items()
            },
            headers=headers,
            body=body,
        )
        close = (
            headers.get("connection", "").lower() == "close"
            or version == "HTTP/1.0"
        )
        # pio: lint-ok[attr-no-lock] event-loop-thread only
        self.requests_served += 1
        # health probes bypass the shedder AND the worker pool
        # (dispatched inline on the loop): a saturated pool is
        # precisely when a balancer most needs /readyz to answer,
        # and the probe handlers are lock-snapshot cheap
        if parsed.path in HEALTH_PATHS:
            status, payload = dispatch_safe(self.app, req)
            await self._respond(writer, status, payload, close)
            return close
        # load shedding: bounded-queue backpressure. Above the
        # watermark new work answers 503 + Retry-After — how a
        # balancer learns to STOP sending the traffic being shed.
        # Observability reads are exempt (SHED_EXEMPT_PATHS).
        exempt = parsed.path in SHED_EXEMPT_PATHS
        shed = not exempt and not self.shedder.try_acquire()
        if shed:
            await self._respond(
                writer, 503,
                json_response(
                    {"message": "server overloaded, retry later"},
                    {"Retry-After":
                     f"{self.shedder.retry_after_s:.0f}"},
                ),
                close,
            )
            return close
        try:
            status, payload = await asyncio.get_running_loop() \
                .run_in_executor(
                    self._pool, dispatch_safe, self.app, req)
        finally:
            if not exempt:  # exempt paths never acquired
                self.shedder.release()
        await self._respond(writer, status, payload, close)
        return close

    async def _respond(self, writer, status: int, payload: Any, close: bool):
        data, ctype, extra = encode_payload(payload)
        extra_lines = "".join(f"{k}: {v}\r\n" for k, v in extra.items())
        writer.write(
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Status')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{extra_lines}"
            f"Connection: {'close' if close else 'keep-alive'}\r\n"
            "\r\n".encode("latin-1") + data
        )
        await writer.drain()

    # -- lifecycle -----------------------------------------------------------
    async def _amain(self):
        self._main_task = asyncio.current_task()
        # same bind-retry schedule as the sync transport, driven manually
        # because the sleep must be awaited (RetryPolicy.delays yields
        # the schedule; RetryPolicy.call would block the loop)
        log_retry = _log_bind_retry(self.port)
        delays = list(bind_retry_policy(self.port).delays())
        for attempt in range(len(delays) + 1):
            try:
                self._server = await asyncio.start_server(
                    self._handle_conn, self.host, self.port, ssl=self._ssl,
                    limit=_MAX_HEADER,
                )
                break
            except OSError as e:
                if attempt >= len(delays):
                    raise
                log_retry(attempt, e, delays[attempt])
                await asyncio.sleep(delays[attempt])
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        async with self._server:
            await self._server.serve_forever()

    async def _shutdown(self, grace_s: float = 2.0):
        """Drain in-flight responses briefly, cancel lingering
        connections, then close the listener and the accept loop.

        Ordering is load-bearing twice over. (1) Only BUSY connections
        (a request mid-dispatch) get the grace wait: with keep-alive
        clients parked in the shared connection pool, idle connections
        routinely outlive the server and would eat the full grace on
        every stop — they are cancelled immediately instead, and the
        short post-cancel wait lets their finally blocks close
        transports while the loop is still alive (closing them after
        the loop died raises unraisable "Event loop is closed" errors).
        (2) ``Server.close()`` cancels ``serve_forever``, which unwinds
        ``_amain`` and CLOSES THE LOOP — so it must come after the last
        ``await`` here, or this coroutine dies mid-drain and ``stop()``
        blocks on a future that never resolves."""
        # a busy task leaves self._busy when its response is written —
        # it does NOT complete (it parks on the next keep-alive read),
        # so poll the set instead of awaiting the tasks, or any
        # in-flight request would burn the full grace every stop
        deadline = asyncio.get_running_loop().time() + grace_s
        while (any(not t.done() for t in self._busy)
               and asyncio.get_running_loop().time() < deadline):
            await asyncio.sleep(0.02)
        conns = {t for t in self._conns if not t.done()}
        for t in conns:
            t.cancel()
        if conns:
            await asyncio.wait(conns, timeout=1.0)
        if self._server is not None:
            self._server.close()
        if self._main_task is not None:
            self._main_task.cancel()

    def _run_loop(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._amain())
        except asyncio.CancelledError:
            pass
        except BaseException as e:  # noqa: BLE001 - surface bind errors
            self._failed = e
            self._ready.set()
        finally:
            try:
                self._loop.run_until_complete(
                    self._loop.shutdown_asyncgens()
                )
            finally:
                self._loop.close()

    def start(self) -> "AsyncHttpServer":
        self._thread = threading.Thread(
            target=self._run_loop, name=f"{self.app.name}-asyncio", daemon=True
        )
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._failed is not None:
            raise self._failed
        return self

    def serve_forever(self):
        self._run_loop()

    def wait(self):
        """Block until the server (started with start()) shuts down."""
        if self._thread:
            self._thread.join()

    def stop(self):
        loop = self._loop
        if loop is None or not loop.is_running():
            self._pool.shutdown(wait=False)
            return
        fut = asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
        try:
            fut.result(timeout=15)
        except Exception:  # noqa: BLE001 - loop may already be tearing down
            pass
        if self._thread:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)
