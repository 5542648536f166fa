"""Shared stdlib JSON-over-HTTP client transport with keep-alive pooling.

One implementation of the HTTP dance (TLS-noverify context, JSON bodies,
error-message extraction, timeout/reset normalization) for every in-repo
client: the SDK (pio_tpu/sdk.py), the remote storage backend
(data/backends/remote.py), the fleet router's shard RPCs, and the
fold-in appliers. All failures surface as HttpClientError with `status`
(0 = transport-level: unreachable, timeout, reset) and the server's
message when one exists.

Connection pooling (docs/performance.md "Internal RPC plane"): every
server surface already speaks HTTP/1.1 keep-alive, but the old urllib
transport sent ``Connection: close`` on every call — each router→shard
top-k fan, storage DAO RPC, quorum write, fold-in apply, and rollout
control call paid TCP connect + slow-start + teardown. Requests now ride
a process-wide bounded pool of persistent ``http.client`` connections
keyed by (scheme, host, port, TLS verification): LIFO reuse (the most
recently used socket is the least likely to have been idle-reaped by the
peer), idle-age reaping, and ONE transparent retry on a stale reused
socket (the peer closed it between requests — EPIPE/ECONNRESET/
BadStatusLine before the first response byte) for IDEMPOTENT requests
only; a non-idempotent POST surfaces the error to the caller's existing
RetryPolicy, because the server may have processed it. Every
``JsonHttpClient`` user inherits reuse with zero call-site changes;
``pooled=False`` (or ``PIO_TPU_HTTP_POOL=off``) restores the
connection-per-request behavior.

Being the ONE outbound client is load-bearing for observability: when a
trace context is active (pio_tpu/obs/context.py), every request injects
a child ``traceparent`` header — so the receiving surface joins the
caller's trace — and emits a client span record to the ambient
TraceRecorder. Raw urllib/http.client calls elsewhere in pio_tpu/ would
silently drop both trace context and chaos/deadline instrumentation;
the ``obs:raw-http`` lint rule keeps them out.

Chaos points: ``http.<METHOD> <path>`` fires per request (as before) and
``http.pool.<host>:<port>`` fires at connection acquisition, so a drill
can fail exactly the dial/reuse step of one peer.

Deliberately NOT carried over from the urllib transport: ``http_proxy``
/ ``https_proxy`` environment proxies (the pool dials peers directly —
every in-repo client talks to in-repo surfaces) and redirect following
(no surface issues 3xx; one is answered with a loud HttpClientError,
never a silent empty success).
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import ssl
import threading
import time
import urllib.parse
from typing import Any, Callable

from pio_tpu_torch.obs import context as tracectx
from pio_tpu_torch.obs.recorder import SpanRecord, error_fields
from pio_tpu_torch.resilience.chaos import maybe_inject


class HttpClientError(Exception):
    def __init__(self, status: int, message: str,
                 retry_after: float | None = None):
        super().__init__(f"HTTP {status}: {message}" if status
                         else message)
        self.status = status
        self.message = message
        # the server's Retry-After hint (seconds), when the error
        # response carried one — backpressure-aware callers (the SDK's
        # 429 retry loop) floor their backoff at it
        self.retry_after = retry_after


# methods safe to resend after a stale reused socket died BEFORE the
# first response byte (RFC 9110 §9.2.2 idempotent methods); POST callers
# opt in per call with request(idempotent=True) — the fleet router's
# read-only shard RPCs do
_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})

# failure shapes a dead keep-alive socket produces on reuse: the peer
# closed between requests, so the send EPIPEs/ECONNRESETs or the
# response line never arrives. Anything else (read timeout, mid-body
# reset) means the server saw the request and is NOT transparently
# retried.
_STALE_SOCKET_ERRORS = (
    ConnectionResetError, BrokenPipeError, ConnectionAbortedError,
    http.client.BadStatusLine, http.client.CannotSendRequest,
)


class _PooledConn:
    """One persistent connection + the bookkeeping reuse needs."""

    __slots__ = ("conn", "idle_since", "reused")

    def __init__(self, conn: http.client.HTTPConnection):
        self.conn = conn
        self.idle_since = time.monotonic()
        self.reused = False          # True once it has served >= 1 request


class ConnectionPool:
    """Bounded per-(scheme, host, port, TLS) pool of persistent
    ``http.client`` connections.

    * ``acquire`` pops LIFO (freshest socket first) after reaping
      entries idle past ``max_idle_s``; a miss builds + connects a new
      connection (the connect itself is the caller's to error-map).
    * ``release`` returns a healthy connection; past ``max_per_host``
      idle entries the surplus is closed (counted as an eviction), so a
      burst can never strand hundreds of open sockets. Exhaustion never
      blocks: demand beyond the idle set just dials fresh connections —
      fairness by construction, bounded by what callers run in parallel.
    * ``retire`` closes a connection that errored or was marked
      non-reusable by the server (``Connection: close``).

    Lifetime counters (opened/reused/evicted/stale retries) feed every
    surface's /metrics via ``pool_counters()``.
    """

    def __init__(self, max_per_host: int = 8, max_idle_s: float = 60.0):
        self.max_per_host = max_per_host
        self.max_idle_s = max_idle_s
        self._idle: dict[tuple, list[_PooledConn]] = {}
        self._lock = threading.Lock()
        self.opened = 0
        self.reused = 0
        self.evicted_idle = 0
        self.evicted_error = 0
        self.evicted_overflow = 0
        self.stale_retries = 0
        # per-key lifetime counters: {key: {"opened": n, "reused": n}} —
        # what the router's per-replica connection-reuse column reads
        self._per_host: dict[tuple, dict[str, int]] = {}

    def _host_entry(self, key: tuple) -> dict[str, int]:
        # pio: lint-ok[attr-no-lock] internal helper, only called with
        # self._lock held (acquire() and count_fresh_dial())
        return self._per_host.setdefault(key, {"opened": 0, "reused": 0})

    def count_fresh_dial(self, key: tuple) -> None:
        """Book a dial made OUTSIDE acquire() — the stale-retry path
        dials fresh without consulting the idle set, and the per-host
        reuse ratios must still count it."""
        with self._lock:
            self.opened += 1
            self._host_entry(key)["opened"] += 1

    def acquire(self, key: tuple,
                build: Callable[[], http.client.HTTPConnection],
                ) -> tuple[http.client.HTTPConnection, bool]:
        """-> (connection, was_reused). ``build`` must return a NEW
        unconnected connection object; the caller connects it (so
        connect-phase errors keep their distinct error mapping)."""
        now = time.monotonic()
        with self._lock:
            stack = self._idle.get(key)
            reaped: list[_PooledConn] = []
            picked: _PooledConn | None = None
            while stack:
                entry = stack.pop()          # LIFO: freshest socket first
                if now - entry.idle_since > self.max_idle_s:
                    reaped.append(entry)
                    continue
                picked = entry
                break
            if picked is not None:
                self.reused += 1
                self._host_entry(key)["reused"] += 1
            self.evicted_idle += len(reaped)
        for entry in reaped:                 # close outside the lock
            _close_quietly(entry.conn)
        if picked is not None:
            return picked.conn, True
        conn = build()
        with self._lock:
            self.opened += 1
            self._host_entry(key)["opened"] += 1
        return conn, False

    def release(self, key: tuple, conn: http.client.HTTPConnection) -> None:
        entry = _PooledConn(conn)
        entry.reused = True
        overflow: _PooledConn | None = None
        with self._lock:
            stack = self._idle.setdefault(key, [])
            if len(stack) >= self.max_per_host:
                # keep the FRESH socket, retire the stalest idle one
                overflow = stack.pop(0)
                self.evicted_overflow += 1
            stack.append(entry)
        if overflow is not None:
            _close_quietly(overflow.conn)

    def retire(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            self.evicted_error += 1
        _close_quietly(conn)

    def record_stale_retry(self) -> None:
        with self._lock:
            self.stale_retries += 1

    def close_all(self) -> None:
        """Close every idle connection (tests / process teardown)."""
        with self._lock:
            entries = [e for stack in self._idle.values() for e in stack]
            self._idle.clear()
        for entry in entries:
            _close_quietly(entry.conn)

    def stats(self) -> dict:
        with self._lock:
            return {
                "opened": self.opened,
                "reused": self.reused,
                "evictedIdle": self.evicted_idle,
                "evictedError": self.evicted_error,
                "evictedOverflow": self.evicted_overflow,
                "staleRetries": self.stale_retries,
                "idle": sum(len(s) for s in self._idle.values()),
                "hosts": {
                    f"{k[0]}://{k[1]}:{k[2]}": dict(v)
                    for k, v in self._per_host.items()
                },
            }

    def host_stats(self, url: str) -> dict[str, int]:
        """Lifetime opened/reused for a base URL's pool key (both TLS
        variants summed — the column cares about reuse, not handshakes)."""
        scheme, host, port = _split_base(url)
        with self._lock:
            out = {"opened": 0, "reused": 0}
            for k, v in self._per_host.items():
                if k[:3] == (scheme, host, port):
                    out["opened"] += v["opened"]
                    out["reused"] += v["reused"]
        return out


def _close_quietly(conn: http.client.HTTPConnection) -> None:
    try:
        conn.close()
    except OSError:
        pass


def _split_base(url: str) -> tuple[str, str, int]:
    parsed = urllib.parse.urlsplit(url)
    scheme = parsed.scheme or "http"
    port = parsed.port or (443 if scheme == "https" else 80)
    return scheme, parsed.hostname or "", port


# the process-wide shared pool: throwaway JsonHttpClient objects (CLI
# probes, doctor loops) still reuse connections because the pool outlives
# them. Sizing knobs ride the environment so operators can tune without
# touching call sites.
_POOL = ConnectionPool(
    max_per_host=int(os.environ.get("PIO_TPU_HTTP_POOL_SIZE", "8") or 8),
    max_idle_s=float(os.environ.get("PIO_TPU_HTTP_POOL_IDLE_S", "60")
                     or 60.0),
)


def default_pool() -> ConnectionPool:
    return _POOL


def pool_enabled() -> bool:
    return os.environ.get("PIO_TPU_HTTP_POOL", "").lower() not in (
        "off", "0", "false", "no")


def pool_counters(pool: ConnectionPool | None = None) -> dict[str, float]:
    """The pool's lifetime counters in /metrics shape — merged into
    every surface's Prometheus exposition (docs/operations.md), so a
    0%-reuse surface (misconfigured proxy re-dialing per request) is
    visible before it becomes a latency page."""
    s = (pool or _POOL).stats()
    return {
        "http_client_connections_opened_total": float(s["opened"]),
        "http_client_connections_reused_total": float(s["reused"]),
        "http_client_connections_evicted_total": float(
            s["evictedIdle"] + s["evictedError"] + s["evictedOverflow"]),
        "http_client_stale_retries_total": float(s["staleRetries"]),
        "http_client_connections_idle": float(s["idle"]),
    }


class JsonHttpClient:
    def __init__(self, url: str, timeout: float = 30.0,
                 verify_tls: bool = True, pooled: bool = True,
                 pool: ConnectionPool | None = None):
        self.base = url.rstrip("/")
        self.timeout = timeout
        self._scheme, self._host, self._port = _split_base(self.base)
        # a base URL may carry a path prefix (a reverse proxy mounting a
        # surface under /pio): every request target is prefixed with it,
        # exactly like the pre-pool urllib transport's base + path join
        self._base_path = urllib.parse.urlsplit(self.base).path.rstrip("/")
        self._verify_tls = verify_tls
        self._ctx = None
        if self._scheme == "https":
            self._ctx = ssl.create_default_context()
            if not verify_tls:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
        self._pooled = pooled and pool_enabled()
        self._pool = pool if pool is not None else _POOL
        self._pool_key = (self._scheme, self._host, self._port, verify_tls)

    def request(self, method: str, path: str, body: Any = None,
                params: dict | None = None, *,
                raw: bytes | None = None,
                content_type: str | None = None,
                accept: str | None = None,
                idempotent: bool | None = None,
                headers: dict | None = None) -> Any:
        """-> parsed JSON body (None when empty). Raises HttpClientError.

        Binary wire support (the columnar codec, data/columnar.py, and
        the fleet RPC wire, serving_fleet/rpcwire.py): ``raw`` sends
        pre-encoded bytes with ``content_type`` instead of a JSON body;
        ``accept`` adds an Accept header, and a response whose
        Content-Type matches it is returned as raw bytes — a server that
        ignores the negotiation still answers JSON and the caller sees
        the parsed object, so old servers degrade cleanly.

        ``idempotent`` opts a request in or out of the ONE transparent
        resend after a stale reused pool socket (default: derived from
        the method — GET/HEAD/PUT/DELETE yes, POST no). Read-only POST
        RPCs (the router's shard fan-out) pass True; a resend there can
        at worst recompute a pure read.

        ``headers`` adds extra request headers verbatim (the fleet's
        ``X-Pio-Plan-Version`` topology pin during a live reshard); they
        cannot displace the transport-managed ones (Content-Type,
        Accept, traceparent, Connection).

        Under an active trace context the call becomes one client span:
        a child context rides the outbound ``traceparent`` header (the
        receiving server parents its own spans under it) and the span
        record — error status, chaos point label when the failure was
        injected — lands in the ambient recorder."""
        ctx = tracectx.current()
        if ctx is None:
            return self._request(method, path, body, params, None,
                                 raw, content_type, accept, idempotent,
                                 headers)
        child = ctx.child()
        recorder = tracectx.current_recorder()
        t0 = time.monotonic()
        # pio: lint-ok[bench-clock] span start is wall-clock on purpose
        # (cross-process ordering in the merged tree); duration is
        # monotonic
        t0_wall = time.time()
        status, errmsg = "ok", None
        labels = {"method": method, "path": path}
        try:
            return self._request(method, path, body, params,
                                 tracectx.format_traceparent(child),
                                 raw, content_type, accept, idempotent,
                                 headers)
        except BaseException as e:
            status = "error"
            errmsg, labels = error_fields(e, labels)
            raise
        finally:
            if recorder is not None:
                recorder.record(SpanRecord(
                    trace_id=ctx.trace_id, span_id=child.span_id,
                    parent_id=ctx.span_id, name=f"call {path}",
                    surface=recorder.surface, start_s=t0_wall,
                    duration_s=time.monotonic() - t0,
                    status=status, error=errmsg, labels=labels))

    # -- transport -----------------------------------------------------------
    def _build_conn(self) -> http.client.HTTPConnection:
        if self._scheme == "https":
            # pio: lint-ok[raw-http] this IS the sanctioned client — the
            # one place the raw http.client construction may live
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self.timeout,
                context=self._ctx)
        # pio: lint-ok[raw-http] same: the sanctioned client itself
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.timeout)

    def _acquire(self, fresh: bool = False,
                 ) -> tuple[http.client.HTTPConnection, bool]:
        """-> (connected conn, was_reused). Connect-phase failures map to
        the "unreachable" error shape (what a down server has always
        looked like to callers). ``fresh=True`` bypasses the idle set —
        the stale-retry path: a peer that reaped one idle socket has
        usually reaped its neighbors in the same sweep, so retrying from
        the pool can hit a SECOND dead socket; a fresh dial cannot be
        stale."""
        # drill point: fail exactly the dial/reuse step of one peer —
        # the injected ConnectionError surfaces as transport-level
        # (status 0), like a real dial failure
        try:
            maybe_inject(f"http.pool.{self._host}:{self._port}")
        except (ConnectionError, OSError) as e:
            raise HttpClientError(
                0, f"{self.base} unreachable: {e}") from e
        if self._pooled and not fresh:
            conn, reused = self._pool.acquire(self._pool_key,
                                              self._build_conn)
        else:
            conn, reused = self._build_conn(), False
            if self._pooled:
                self._pool.count_fresh_dial(self._pool_key)
        if reused:
            # the pool key ignores timeout so clients with different
            # budgets share sockets; re-arm per request
            conn.timeout = self.timeout
            if conn.sock is not None:
                conn.sock.settimeout(self.timeout)
            return conn, True
        try:
            conn.connect()
        except (OSError, ssl.SSLError) as e:
            _close_quietly(conn)
            raise HttpClientError(
                0, f"{self.base} unreachable: {e}") from e
        if conn.sock is not None:
            # persistent connections leave the kernel's quick-ACK
            # startup mode, so Nagle + the peer's delayed ACK would add
            # ~40ms to any request the stack splits across segments —
            # measured as a 20x p50 regression on the shard fan-out
            # before this line existed
            try:
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            except OSError:
                pass
        return conn, False

    def _finish(self, conn: http.client.HTTPConnection,
                will_close: bool) -> None:
        """Return a healthy connection to the pool (or close it when the
        server asked to, or pooling is off)."""
        if not self._pooled or will_close:
            _close_quietly(conn)
            return
        self._pool.release(self._pool_key, conn)

    def _request(self, method: str, path: str, body: Any,
                 params: dict | None, traceparent: str | None,
                 raw: bytes | None = None,
                 content_type: str | None = None,
                 accept: str | None = None,
                 idempotent: bool | None = None,
                 extra_headers: dict | None = None) -> Any:
        # chaos point: injected ConnectionError/reset/stall surfaces to
        # callers exactly like a real transport failure (normalized to
        # HttpClientError(status=0) below)
        target = self._base_path + path
        if params:
            qs = {k: v for k, v in params.items() if v is not None}
            if qs:
                target += "?" + urllib.parse.urlencode(qs)
        # allow_nan=False: the servers reject the non-standard NaN token
        # (server/http.py Request.json), so fail at the SENDER with a
        # clear error instead of a 400/500 round trip
        if raw is not None:
            data = raw
        else:
            data = (json.dumps(body, allow_nan=False).encode()
                    if body is not None else None)
        headers = {"Content-Type": content_type or "application/json"}
        if extra_headers:
            # caller extras first: the transport-managed headers below
            # (Accept, traceparent, Connection) always win on collision
            for k, v in extra_headers.items():
                headers[str(k)] = str(v)
        if accept is not None:
            headers["Accept"] = accept
        if traceparent is not None:
            headers[tracectx.TRACEPARENT_HEADER] = traceparent
        if not self._pooled:
            # the pre-pool behavior, byte for byte: one connection per
            # request, announced so the server tears it down too
            headers["Connection"] = "close"
        if idempotent is None:
            idempotent = method.upper() in _IDEMPOTENT_METHODS
        try:
            maybe_inject(f"http.{method} {path}")
        except (ConnectionError, OSError) as e:
            raise HttpClientError(
                0, f"{self.base} transport failure: {e}") from e
        conn, reused = self._acquire()
        try:
            return self._exchange(conn, method, target, data, headers,
                                  accept)
        except HttpClientError:
            raise
        except _STALE_SOCKET_ERRORS as e:
            self._pool.retire(conn)
            if not (reused and idempotent):
                raise HttpClientError(
                    0, f"{self.base} transport failure: {e}") from e
            # stale reused socket, idempotent request: the peer closed
            # the connection between requests — reconnect ONCE on a
            # GUARANTEED-fresh socket (not the pool, which may hold
            # more sockets the peer reaped in the same sweep) and
            # resend. The retry is invisible to callers (and their
            # CircuitBreakers): nothing was processed, so nothing
            # failed.
            self._pool.record_stale_retry()
            conn2, _ = self._acquire(fresh=True)
            try:
                return self._exchange(conn2, method, target, data,
                                      headers, accept)
            except _STALE_SOCKET_ERRORS as e2:
                self._pool.retire(conn2)
                raise HttpClientError(
                    0, f"{self.base} transport failure: {e2}") from e2
            except (http.client.HTTPException, OSError) as e2:
                self._pool.retire(conn2)
                raise HttpClientError(
                    0, f"{self.base} transport failure: {e2}") from e2
        except (http.client.HTTPException, TimeoutError, ConnectionError,
                OSError) as e:
            # read timeouts / mid-response resets: the server may have
            # seen the request — never transparently resent
            self._pool.retire(conn)
            raise HttpClientError(
                0, f"{self.base} transport failure: {e}") from e

    def _exchange(self, conn: http.client.HTTPConnection, method: str,
                  target: str, data: bytes | None,
                  headers: dict[str, str], accept: str | None) -> Any:
        """One request/response on an open connection. Success paths
        (including HTTP error statuses — the server answered) return the
        connection to the pool; transport exceptions propagate for the
        caller to classify (the connection is NOT returned)."""
        conn.request(method, target, body=data, headers=headers)
        resp = conn.getresponse()
        status = resp.status
        payload = resp.read()        # drain fully: required for reuse
        will_close = resp.will_close
        retry_after_hdr = resp.getheader("Retry-After")
        location = resp.getheader("Location")
        resp_ct = (resp.getheader("Content-Type") or "") \
            .split(";")[0].strip().lower()
        self._finish(conn, will_close)
        if 300 <= status < 400:
            # the pooled transport does not follow redirects (none of
            # the in-repo surfaces issue them); a misrouted base URL
            # must fail LOUDLY, not return the redirect's empty body as
            # a successful None
            raise HttpClientError(
                status, "unexpected redirect"
                + (f" to {location}" if location else "")
                + " (redirects are not followed; fix the base URL)")
        if status >= 400:
            err_body = payload.decode(errors="replace")
            msg = err_body or f"HTTP Error {status}"
            try:
                parsed = json.loads(err_body)
                if isinstance(parsed, dict):
                    msg = parsed.get("message", err_body)
            except json.JSONDecodeError:
                pass
            try:
                retry_after = float(retry_after_hdr or "")
            except (TypeError, ValueError):
                retry_after = None
            raise HttpClientError(status, msg, retry_after=retry_after)
        if accept is not None and resp_ct == accept.lower():
            return payload  # negotiated binary body, verbatim
        try:
            return json.loads(payload) if payload else None
        except ValueError as e:
            # a corrupted 200 body must surface as the client's
            # error type, not leak past callers that catch
            # HttpClientError (RemoteBackend.call's StorageError
            # mapping). ValueError covers JSONDecodeError AND
            # the UnicodeDecodeError json.loads raises on a
            # non-UTF-8 body
            raise HttpClientError(
                status, f"malformed JSON response body: {e}") from e
