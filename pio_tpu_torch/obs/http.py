"""Observability HTTP surface shared by every server.

``install_trace_routes(app, recorder, check_key)`` wires, onto any
``HttpApp``:

  * ``GET /debug/traces.json``          — retained-trace summaries;
  * ``GET /debug/traces.json?traceId=`` — one trace's span records
    (what ``pio trace`` collects from each surface and merges);
  * ``GET /debug/spans.json``           — the live span table over the
    recent window (what ``pio top`` renders).

Both are server-key guarded through the surface's own ``check_key``
(the same guard as /reload — traces carry request paths and timing).
Installing also sets ``app.recorder``, which is what switches the
transport's dispatch edge (server/http.py ``dispatch_safe``) into
traced mode — one wiring point per surface.
"""

from __future__ import annotations

from pio_tpu_torch.obs.recorder import TraceRecorder


def install_trace_routes(app, recorder: TraceRecorder | None,
                         check_key=None) -> None:
    """No-op when tracing is disabled (recorder None) — the surface then
    serves neither /debug route and the dispatch edge stays untraced."""
    if recorder is None:
        return
    app.recorder = recorder

    def _guarded(req) -> tuple[int, dict] | None:
        if check_key is not None and not check_key(req):
            return 401, {"message": "Invalid accessKey."}
        return None

    @app.route("GET", r"/debug/traces\.json")
    def debug_traces(req):
        denied = _guarded(req)
        if denied:
            return denied
        trace_id = req.params.get("traceId")
        if trace_id:
            trace = recorder.trace_of(trace_id)
            if trace is None:
                return 404, {"message":
                             f"trace {trace_id} not retained on this "
                             "surface (expired, never sampled, or never "
                             "passed through)"}
            return 200, trace
        try:
            limit = int(req.params.get("limit", 50))
        except ValueError:
            return 400, {"message": "limit must be an integer"}
        return 200, {"surface": recorder.surface,
                     "traces": recorder.traces(limit=limit),
                     "recorder": recorder.stats()}

    @app.route("GET", r"/debug/spans\.json")
    def debug_spans(req):
        denied = _guarded(req)
        if denied:
            return denied
        return 200, {"surface": recorder.surface,
                     "spans": recorder.span_table()}
