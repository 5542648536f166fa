"""Tracing: per-request latency histograms and their Prometheus text.

The reference's only serving observability is a rolling average in the
server actor (CreateServer.scala:420-422,605-612) and hourly ingest counters
(api/Stats.scala); SURVEY.md §5 calls for real tracing in the TPU build.
This module provides:

 * `LatencyHistogram` — all-time count/avg/last plus windowed quantiles
   (p50/p90/p95/p99) over a bounded reservoir of recent samples;
 * `Tracer` — named span histograms (`with tracer.span("predict"): ...`),
   one histogram per pipeline stage, thread-safe, cheap enough for the
   serve hot path (a monotonic clock read + a ring-buffer store);
 * the Prometheus text exposition of the span histograms and counters.

The reference's device profiling (start/stop wrappers around
``jax.profiler`` and ``annotate``) is not copied: the port has no JAX.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Sequence

# stdlib-only modules, hot-path imported once (a per-span `from ... import`
# costs ~1us in sys.modules lookups — measurable against the bench smoke
# tracing-overhead gate)
from pio_tpu_torch.obs import context as _tracectx
from pio_tpu_torch.obs.recorder import SpanRecord as _SpanRecord
from pio_tpu_torch.obs.recorder import error_fields as _error_fields


class LatencyHistogram:
    """Bounded-reservoir latency recorder.

    All-time aggregates (count, mean, last) never lose data; quantiles are
    computed over the most recent `capacity` samples (a ring buffer), which
    is the operationally useful window for serving dashboards.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._ring: list[float] = []
        self._pos = 0
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.last = seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            if len(self._ring) < self.capacity:
                self._ring.append(seconds)
            else:
                self._ring[self._pos] = seconds
                self._pos = (self._pos + 1) % self.capacity

    def quantiles(self, qs=(0.5, 0.9, 0.95, 0.99)) -> dict[str, float]:
        with self._lock:
            window = sorted(self._ring)
        if not window:
            return {f"p{int(q * 100)}": 0.0 for q in qs}
        n = len(window)
        return {
            f"p{int(q * 100)}": window[min(n - 1, int(q * (n - 1) + 0.5))]
            for q in qs
        }

    def snapshot(self) -> dict:
        with self._lock:
            count, total, last = self.count, self.total, self.last
            mn, mx = self.min, self.max
        out = {
            "count": count,
            "avg": total / count if count else 0.0,
            # exact cumulative seconds: the Prometheus _sum must not be
            # reconstructed from avg (precision loss freezes rate())
            "total": total,
            "last": last,
            "min": 0.0 if mn == float("inf") else mn,
            "max": mx,
        }
        out.update(self.quantiles())
        return out


class Tracer:
    """Named span histograms for a request pipeline.

    With a ``TraceRecorder`` attached (pio_tpu/obs/), every
    ``span(...)`` entered under an active trace context ALSO emits a
    span record — a child of the ambient span, with the given labels
    (``shard=3 arm=candidate ...``), error status on exception, and the
    chaos injection point when the failure was injected — so the same
    one-liner that feeds the histograms feeds the distributed span
    tree. Without a recorder (or outside any trace) the span is exactly
    the pre-existing histogram-only fast path.
    """

    def __init__(self, recorder=None):
        self._spans: dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()
        self.recorder = recorder          # obs.recorder.TraceRecorder | None

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._spans.get(name)
            if h is None:
                h = self._spans[name] = LatencyHistogram()
            return h

    @contextmanager
    def span(self, name: str, **labels):
        recorder = self.recorder
        ctx = _tracectx.current() if recorder is not None else None
        if ctx is None:
            t0 = time.monotonic()
            try:
                yield
            finally:
                self.histogram(name).record(time.monotonic() - t0)
            return
        child = ctx.child()
        token = _tracectx.push(child)  # nested spans/outbound RPCs parent here
        t0 = time.monotonic()
        # pio: lint-ok[bench-clock] span start is wall-clock on purpose
        # (cross-process ordering in the merged tree); duration is
        # monotonic
        t0_wall = time.time()
        status, errmsg = "ok", None
        try:
            yield
        except BaseException as e:
            status = "error"
            errmsg, labels = _error_fields(e, labels)
            raise
        finally:
            _tracectx.pop(token)
            dt = time.monotonic() - t0
            self.histogram(name).record(dt)
            recorder.record(_SpanRecord(
                trace_id=ctx.trace_id, span_id=child.span_id,
                parent_id=ctx.span_id, name=name,
                surface=recorder.surface, start_s=t0_wall, duration_s=dt,
                status=status, error=errmsg,
                labels={str(k): str(v) for k, v in labels.items()}))

    def record(self, name: str, seconds: float) -> None:
        self.histogram(name).record(seconds)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            names = list(self._spans)
        return {n: self._spans[n].snapshot() for n in names}


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Prometheus 3.x rejects scrapes whose Content-Type is not a known
# exposition format; every /metrics endpoint must send this constant.


def escape_label_value(v: str) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline) — REQUIRED for any user-controlled string (event names,
    entity types): one bad value otherwise corrupts the whole scrape."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_value(v: float) -> str:
    """Integers verbatim (a %.6g 7-digit counter would freeze
    increase()/rate() in lossy scientific notation); floats at full
    precision."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def prometheus_labeled_counter(
    name: str, rows, prefix: str = "pio", mtype: str = "counter",
) -> list[str]:
    """One `# TYPE` header + one sample per (labels, value) row, with
    every label value escaped. The single renderer for labeled scalar
    families so callers cannot drift on quoting/format details; `mtype`
    selects the declared metric type (a drain-able depth is a `gauge` —
    declaring it a counter makes every drain look like a counter reset
    to rate())."""
    lines = [f"# TYPE {prefix}_{name} {mtype}"]
    for labels, value in rows:
        lab = ",".join(
            f'{k}="{escape_label_value(str(v))}"'
            for k, v in labels.items())
        lines.append(f"{prefix}_{name}{{{lab}}} {_prom_value(value)}")
    return lines


def prometheus_histogram(
    name: str,
    buckets: Sequence[float],
    counts: Sequence[float],
    total_count: float,
    total_sum: float,
    labels: dict[str, str] | None = None,
    prefix: str = "pio",
) -> list[str]:
    """One proper histogram family: ONE `# TYPE` header + samples named
    `_bucket` (cumulative `le` convention, `+Inf` last), `_sum`,
    `_count`. The single renderer for histogram exposition so surfaces
    cannot drift on the le/cumulation format (used by the event
    server's quorum-latency family and the eval sweep's duration)."""
    lab = "".join(
        f'{k}="{escape_label_value(str(v))}",'
        for k, v in (labels or {}).items())
    lines = [f"# TYPE {prefix}_{name} histogram"]
    cum = 0.0
    for ub, cnt in zip(buckets, counts):
        cum += cnt
        lines.append(
            f'{prefix}_{name}_bucket{{{lab}le="{ub:g}"}} {float(cum)}')
    lines.append(
        f'{prefix}_{name}_bucket{{{lab}le="+Inf"}} {float(total_count)}')
    lines.append(
        f'{prefix}_{name}_sum{{{lab[:-1]}}} {float(total_sum)}')
    lines.append(
        f'{prefix}_{name}_count{{{lab[:-1]}}} {float(total_count)}')
    return lines


def prometheus_text(spans: dict[str, dict], counters: dict[str, float],
                    prefix: str = "pio",
                    labels: dict[str, str] | None = None) -> str:
    """Prometheus text exposition of the tracer's span histograms plus
    scalar counters — the scrape surface every monitoring stack expects
    next to the JSON `/metrics.json`. Quantiles map to the summary-type
    convention; `_count` is all-time, quantiles are over the recent
    window (same semantics as LatencyHistogram.snapshot).

    `labels` are rendered into EVERY sample (span summaries AND
    counters/gauges) — the uniform-plane convention (docs/
    observability.md): every surface stamps ``surface=...`` (plus
    ``shard=...`` on shard servers), so one scrape config aggregates the
    whole topology without per-surface relabeling."""
    base = "".join(
        f'{k}="{escape_label_value(str(v))}",'
        for k, v in (labels or {}).items())
    lines = [f"# TYPE {prefix}_span_latency_seconds summary"]
    for name in sorted(spans):
        h = spans[name]
        if not h.get("count"):
            continue
        esc = escape_label_value(name)
        for q in ("p50", "p90", "p95", "p99"):
            if q in h:
                lines.append(
                    f'{prefix}_span_latency_seconds'
                    f'{{{base}span="{esc}",quantile="0.{q[1:]}"}} {h[q]:.6g}')
        lines.append(
            f'{prefix}_span_latency_seconds_count{{{base}span="{esc}"}} '
            f'{h["count"]}')
        # exact cumulative sum at full precision: .6g on a week-old
        # server quantizes the sum and freezes rate() over it. KeyError
        # on a dict without "total" is deliberate — a silent count*avg
        # fallback would reintroduce exactly that bug
        lines.append(
            f'{prefix}_span_latency_seconds_sum{{{base}span="{esc}"}} '
            f'{h["total"]!r}')
    scalar_labels = f"{{{base[:-1]}}}" if base else ""
    for cname in sorted(counters):
        lines.append(f"# TYPE {prefix}_{cname} "
                     + ("counter" if cname.endswith("_total") else "gauge"))
        lines.append(f"{prefix}_{cname}{scalar_labels} "
                     f"{_prom_value(counters[cname])}")
    return "\n".join(lines) + "\n"
