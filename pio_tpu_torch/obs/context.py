"""Distributed trace context: W3C-traceparent-style ids in a contextvar.

One request = one trace. Every hop carries ``trace_id`` (the request),
``span_id`` (the current operation), and ``parent_id`` (the operation
that caused it) in a contextvar — the same ambient-propagation shape the
resilience ``Deadline`` rides — so the serving stack joins a trace with
ZERO per-call-site changes:

  * ``server/http.py``'s dispatch edge EXTRACTS the inbound
    ``traceparent`` header (or starts a fresh trace) and activates the
    context for the handler's dynamic extent;
  * ``utils/httpclient.py`` INJECTS a child context into the outbound
    ``traceparent`` header on every request, so router→shard fan-outs,
    fold-in applies, serving→storage DAO RPCs, and rollout control fans
    all join the caller's trace;
  * ``utils/tracing.py``'s ``Tracer.span`` opens a child span per stage
    and emits a span record to the ambient ``TraceRecorder``.

Wire format (the W3C trace-context header, so off-the-shelf proxies and
clients interoperate)::

    traceparent: 00-<32 hex trace id>-<16 hex span id>-<2 hex flags>

Flags bit 0 is the W3C "sampled" bit (always set — sampling here is
tail-based, decided at retention time, not at the head); bit 1 is the
pio extension "pinned" bit: a client that sent ``X-Pio-Trace: 1`` asked
for THIS request's trace, so every surface retains it unconditionally
and the response carries ``X-Pio-Trace-Id`` for the fetch-back.

This module is stdlib-only and imports nothing from pio_tpu — it sits
below both the transports and the tracing layer.
"""

from __future__ import annotations

import itertools
import os
import random
import re
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

TRACEPARENT_HEADER = "traceparent"
# request header: any non-empty value asks for the response to echo the
# trace id (and pins the trace in every surface's recorder)
TRACE_ECHO_REQUEST_HEADER = "x-pio-trace"
TRACE_ECHO_RESPONSE_HEADER = "X-Pio-Trace-Id"

ENV_VAR = "PIO_TPU_TRACE"   # "off"/"0"/"false" disables recorder creation

_FLAG_SAMPLED = 0x01
_FLAG_PINNED = 0x02

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-(?P<trace>[0-9a-f]{32})-(?P<span>[0-9a-f]{16})"
    r"-(?P<flags>[0-9a-f]{2})$"
)


@dataclass(frozen=True, slots=True)
class TraceContext:
    """One node of the distributed span tree (immutable; children are
    derived, never mutated in place; slotted — several per request)."""

    trace_id: str               # 32 hex chars, shared by the whole request
    span_id: str                # 16 hex chars, this operation
    parent_id: str | None = None
    pinned: bool = False        # client asked to retain this trace

    def child(self) -> "TraceContext":
        """A fresh span under this one (same trace, same pin)."""
        return TraceContext(trace_id=self.trace_id, span_id=_span_id(),
                            parent_id=self.span_id, pinned=self.pinned)


# ids are IDENTIFIERS, not secrets, and a query opens 5+ of them — id
# cost is most of the recorder's hot-path budget (the bench smoke
# <=5%-p50 gate). secrets.token_hex costs an os.urandom syscall per id
# (~10us); instead span ids are a urandom-drawn per-process base plus an
# atomic counter (unique within the process by construction; the random
# base makes a cross-process collision inside one trace ~2^-64), and
# trace ids (one per request, off the per-span path) come from a
# urandom-seeded PRNG under a lock.
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))
_id_lock = threading.Lock()
_span_base = _id_rng.getrandbits(64)
_span_counter = itertools.count().__next__   # C-level next(): atomic/GIL


def _span_id() -> str:
    return f"{(_span_base + _span_counter()) & 0xFFFFFFFFFFFFFFFF:016x}"


def new_trace(pinned: bool = False) -> TraceContext:
    """A fresh root context (no parent) — what a request edge opens when
    the client sent no traceparent."""
    with _id_lock:
        trace_id = f"{_id_rng.getrandbits(128):032x}"
    return TraceContext(trace_id=trace_id, span_id=_span_id(),
                        parent_id=None, pinned=pinned)


def format_traceparent(ctx: TraceContext) -> str:
    flags = _FLAG_SAMPLED | (_FLAG_PINNED if ctx.pinned else 0)
    return f"00-{ctx.trace_id}-{ctx.span_id}-{flags:02x}"


def parse_traceparent(value: str | None) -> TraceContext | None:
    """Inbound header -> the SERVER's context: a fresh span id whose
    parent is the sender's span. Malformed or all-zero ids return None
    (the edge then starts a fresh trace — garbage on the wire must never
    break a request)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace, span = m.group("trace"), m.group("span")
    if trace == "0" * 32 or span == "0" * 16:
        return None
    pinned = bool(int(m.group("flags"), 16) & _FLAG_PINNED)
    return TraceContext(trace_id=trace, span_id=_span_id(),
                        parent_id=span, pinned=pinned)


# -- ambient propagation -----------------------------------------------------

_trace_var: ContextVar[TraceContext | None] = ContextVar(
    "pio_tpu_trace", default=None)
# the surface-local TraceRecorder bound for the request's dynamic extent
# (typed as object to keep this module import-free; recorder.py owns the
# real type)
_recorder_var: ContextVar[object | None] = ContextVar(
    "pio_tpu_trace_recorder", default=None)


def current() -> TraceContext | None:
    return _trace_var.get()


def current_recorder():
    return _recorder_var.get()


def push(ctx: TraceContext):
    """Activate `ctx`; returns the token for pop(). Prefer use() — this
    pair exists for the hot span path, which cannot afford a nested
    context-manager frame."""
    return _trace_var.set(ctx)


def pop(token) -> None:
    _trace_var.reset(token)


@contextmanager
def use(ctx: TraceContext | None, recorder=None):
    """Activate a trace context (and optionally bind the surface's
    recorder) for the block — the request edge's wrapper."""
    t_ctx = _trace_var.set(ctx)
    t_rec = _recorder_var.set(recorder) if recorder is not None else None
    try:
        yield ctx
    finally:
        if t_rec is not None:
            _recorder_var.reset(t_rec)
        _trace_var.reset(t_ctx)


# -- kill switch -------------------------------------------------------------

_enabled_override: bool | None = None


def tracing_enabled() -> bool:
    """False when PIO_TPU_TRACE=off/0/false (or set_tracing(False)):
    surfaces then create no recorder and the whole layer collapses to
    the pre-existing histogram-only tracing."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(ENV_VAR, "").strip().lower() not in (
        "off", "0", "false", "no")


def set_tracing(on: bool | None) -> None:
    """Override the env switch (None restores env behavior) — the bench
    tracing-overhead cell and tests flip this around server builds."""
    global _enabled_override
    # pio: lint-ok[global-no-lock] single-writer test/bench toggle,
    # flipped around surface CONSTRUCTION (make_recorder reads it once
    # per server build), never on a concurrent request path; a torn
    # read is a bool either way
    _enabled_override = on
