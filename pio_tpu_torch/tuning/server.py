"""The sweep's observability surface — ``python -m pio_tpu_torch eval
--sweep --metrics-port``. Copy of ``pio_tpu.tuning.server``.

A sweep is a batch job, but a LONG one (it trains the whole grid), so it
gets the same plane every other surface has: ``/healthz`` with progress,
``/metrics.json``, Prometheus ``/metrics`` (the ``eval_sweep_seconds``
histogram + best-score gauge under ``surface="eval"``), and the
``/debug`` trace routes: ``/debug/spans.json`` shows the ``eval.fold`` /
``eval.candidate`` span table live (the reference's ``pio top`` and
``pio trace`` read the same routes; the port has neither verb yet).
"""

from __future__ import annotations

import threading

from pio_tpu_torch.server.http import (
    HttpApp,
    HttpServer,
    RawResponse,
    Request,
    server_key_ok,
)
from pio_tpu_torch.utils.tracing import (
    PROMETHEUS_CONTENT_TYPE,
    prometheus_histogram,
    prometheus_text,
)

# fixed wall-clock buckets (seconds): sweeps span smoke-test seconds to
# overnight grids
_BUCKETS_S = (1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 7200.0)


class EvalStatus:
    """Thread-safe sweep progress the HTTP surface reads."""

    def __init__(self, tracer, recorder=None):
        self.tracer = tracer
        self.recorder = recorder
        self._lock = threading.Lock()
        self._state = {
            "phase": "starting", "evalId": None, "mode": None,
            "unitsTotal": 0, "unitsDone": 0,
            "bestScore": None, "metric": None,
        }
        self._sweep_counts = [0] * (len(_BUCKETS_S) + 1)
        self._sweep_sum = 0.0
        self._sweep_n = 0

    def update(self, **kv) -> None:
        with self._lock:
            self._state.update(kv)

    def observe_sweep_seconds(self, dt: float) -> None:
        with self._lock:
            self._sweep_sum += dt
            self._sweep_n += 1
            for i, ub in enumerate(_BUCKETS_S):
                if dt <= ub:
                    self._sweep_counts[i] += 1
                    return
            self._sweep_counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                self._state,
                sweepSeconds={
                    "bucketsS": list(_BUCKETS_S),
                    "counts": list(self._sweep_counts[:-1]),
                    "count": self._sweep_n,
                    "sumSeconds": self._sweep_sum,
                },
            )


def build_eval_app(status: EvalStatus, server_key: str = "") -> HttpApp:
    app = HttpApp("eval")

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, {"status": "alive", "role": "eval",
                     **status.snapshot()}

    @app.route("GET", r"/healthz")
    def healthz(req: Request):
        snap = status.snapshot()
        return 200, {"status": "alive", "phase": snap["phase"],
                     "unitsDone": snap["unitsDone"],
                     "unitsTotal": snap["unitsTotal"]}

    @app.route("GET", r"/metrics\.json")
    def metrics_json(req: Request):
        out = status.snapshot()
        out["spans"] = status.tracer.snapshot()
        if status.recorder is not None:
            out["exemplars"] = status.recorder.exemplars()
        return 200, out

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        from pio_tpu_torch.utils.httpclient import pool_counters

        snap = status.snapshot()
        counters = {
            "eval_units_done": float(snap["unitsDone"]),
            "eval_units_total": float(snap["unitsTotal"]),
        }
        counters.update(pool_counters())
        if snap["bestScore"] is not None:
            counters["eval_best_score"] = float(snap["bestScore"])
        text = prometheus_text(
            status.tracer.snapshot(), counters,
            labels={"surface": "eval"})
        h = snap["sweepSeconds"]
        lines = prometheus_histogram(
            "eval_sweep_seconds", h["bucketsS"], h["counts"],
            h["count"], h["sumSeconds"], labels={"surface": "eval"})
        return 200, RawResponse(
            text + "\n".join(lines) + "\n", PROMETHEUS_CONTENT_TYPE)

    from pio_tpu_torch.obs.http import install_trace_routes

    app.tracer = status.tracer
    install_trace_routes(
        app, status.recorder,
        lambda req: server_key_ok(req, server_key))
    return app


def create_eval_server(status: EvalStatus, ip: str = "127.0.0.1",
                       port: int = 0, server_key: str = "") -> HttpServer:
    """-> started-on-demand HTTP transport (port=0: bound port known
    after start())."""
    return HttpServer(build_eval_app(status, server_key),
                      host=ip, port=port)
