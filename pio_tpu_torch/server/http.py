"""HTTP core shared by the port's servers: one regex route table
(`HttpApp`) and a threaded transport (`HttpServer`).

Copy of ``pio_tpu.server.http`` trimmed to the threaded transport: the
asyncio transport (``AsyncHttpServer`` with its ``LoadShedder``), the
distributed-tracing edge of ``dispatch_safe`` and the
``resilience.RetryPolicy`` bind retry are not ported yet. Handlers return
(status, json-serializable body).
"""

from __future__ import annotations

import json
import logging
import re
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

log = logging.getLogger("pio_tpu_torch.http")

# fixed-port binds retry briefly before giving up (reference
# CreateServer.scala:365-375): a just-stopped predecessor's socket can
# linger in TIME_WAIT across a redeploy. port=0 never collides, so
# ephemeral binds fail fast.
BIND_ATTEMPTS = 3
BIND_RETRY_DELAY_S = 1.0


def bind_with_retry(make, port: int):
    """Call make() (which binds a socket), retrying OSError up to
    BIND_ATTEMPTS times for fixed ports."""
    attempts = BIND_ATTEMPTS if port else 1
    for attempt in range(attempts):
        try:
            return make()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise
            log.warning("bind to port %d failed (%s); retry %d/%d in %.0fs",
                        port, e, attempt + 1, attempts - 1,
                        BIND_RETRY_DELAY_S)
            time.sleep(BIND_RETRY_DELAY_S)


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
    """Dispatch with the shared error policy (the JAX package's tracing
    edge is not ported)."""
    return _dispatch_plain(app, req)


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
