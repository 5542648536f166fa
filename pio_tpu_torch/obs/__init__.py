"""Distributed request tracing + the uniform Prometheus plane.

Layering (docs/observability.md):

  * ``obs/context.py``  — trace ids in a contextvar + the W3C-style
    ``traceparent`` wire format (stdlib-only, imported by the
    transports);
  * ``obs/recorder.py`` — per-surface ``TraceRecorder``: span records,
    tail-based retention (errors + slowest-N + pinned + sampled), the
    live span table, slow-trace exemplars;
  * ``obs/http.py``     — ``/debug/traces.json`` + ``/debug/spans.json``
    route installer (server-key guarded);
  * ``obs/assemble.py`` (the cross-process merge behind ``pio trace
    <id>`` and ``pio top``) is not copied yet: the port has neither
    verb.

``make_recorder(surface)`` is the one constructor surfaces call: it
returns None when tracing is disabled (PIO_TPU_TRACE=off), and a None
recorder collapses the whole layer back to histogram-only tracing.
"""

from pio_tpu_torch.obs.context import (
    TRACE_ECHO_REQUEST_HEADER,
    TRACE_ECHO_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    TraceContext,
    current,
    current_recorder,
    format_traceparent,
    new_trace,
    parse_traceparent,
    set_tracing,
    tracing_enabled,
    use,
)
from pio_tpu_torch.obs.recorder import SpanRecord, TraceRecorder, chaos_point_of


def make_recorder(surface: str, **kwargs) -> TraceRecorder | None:
    """The surface-side constructor: None when PIO_TPU_TRACE disables
    tracing (surfaces then skip /debug routes and edge recording)."""
    if not tracing_enabled():
        return None
    return TraceRecorder(surface, **kwargs)


__all__ = [
    "TRACEPARENT_HEADER",
    "TRACE_ECHO_REQUEST_HEADER",
    "TRACE_ECHO_RESPONSE_HEADER",
    "SpanRecord",
    "TraceContext",
    "TraceRecorder",
    "chaos_point_of",
    "current",
    "current_recorder",
    "format_traceparent",
    "make_recorder",
    "new_trace",
    "parse_traceparent",
    "set_tracing",
    "tracing_enabled",
    "use",
]
