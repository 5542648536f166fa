"""Per-request span records with tail-based retention.

A ``TraceRecorder`` lives on each serving surface (query server, fleet
router, shard server, event server, storage server, fold-in folder) and
collects ``SpanRecord``s as spans FINISH — emitted by the HTTP dispatch
edge (``server/http.py``), the outbound client (``utils/httpclient.py``),
and every ``Tracer.span(...)`` stage. Records assemble per trace id; when
the surface-local edge span completes, ``finish_trace`` decides retention
TAIL-BASED — with the whole trace in hand, not a head-of-request coin
flip:

  * ERROR traces (any failed span) are always kept (bounded FIFO);
  * the SLOWEST-N traces are kept (min-heap on duration);
  * PINNED traces (client sent ``X-Pio-Trace: 1``) are always kept;
  * everything else survives with probability ``sample_rate``.

Everything is bounded: active assemblies, each retention class, the
recent-span ring the live span table aggregates over, and the exemplar
map — a recorder can never grow with traffic. ``GET /debug/traces.json``
(obs/http.py) exposes retained traces per surface; ``pio trace <id>``
(obs/assemble.py) merges the surfaces into one tree.
"""

from __future__ import annotations

import heapq
import random
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from pio_tpu_torch.obs import context as tracectx


def chaos_point_of(exc: BaseException | None) -> str | None:
    """The chaos injection point attached to `exc` or anything in its
    cause chain (resilience/chaos.py stamps ``.point``) — failed spans
    get it as a ``chaos=<point>`` label so a drill's fault is visible in
    the tree as exactly the injected hop."""
    seen: set[int] = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        point = getattr(e, "point", None)
        if isinstance(point, str) and point:
            return point
        e = e.__cause__ or e.__context__
    return None


def error_fields(exc: BaseException,
                 labels: dict) -> tuple[str, dict]:
    """THE formatting of a failed span — error message + the
    ``chaos=<point>`` label when the failure was injected — shared by
    every emit site (Tracer.span, the HTTP client span, background
    root traces) so the fields cannot drift between them."""
    point = chaos_point_of(exc)
    if point:
        labels = {**labels, "chaos": point}
    return f"{type(exc).__name__}: {exc}", labels


@dataclass(slots=True)
class SpanRecord:
    """One finished span. ``start_s`` is wall-clock epoch seconds (for
    cross-process ordering in the merged tree); ``duration_s`` comes
    from the monotonic clock (immune to NTP steps). Slotted: recorders
    hold thousands of these and the hot path builds several per
    request."""

    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    surface: str
    start_s: float
    duration_s: float
    status: str = "ok"            # "ok" | "error"
    error: str | None = None
    labels: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "surface": self.surface,
            "startS": round(self.start_s, 6),
            "durationS": round(self.duration_s, 6),
            "status": self.status,
            "error": self.error,
            "labels": self.labels,
        }

    @staticmethod
    def from_dict(d: dict) -> "SpanRecord":
        return SpanRecord(
            trace_id=d["traceId"], span_id=d["spanId"],
            parent_id=d.get("parentId"), name=d["name"],
            surface=d.get("surface", "?"),
            start_s=float(d.get("startS", 0.0)),
            duration_s=float(d.get("durationS", 0.0)),
            status=d.get("status", "ok"), error=d.get("error"),
            labels=dict(d.get("labels") or {}),
        )


class TraceRecorder:
    """See module docstring. Thread-safe; every operation is O(spans in
    one trace) or O(1) amortized under one lock — cheap enough for the
    serve hot path (the bench smoke gate holds it to <= 5% p50)."""

    def __init__(self, surface: str, *, max_errors: int = 64,
                 max_slow: int = 32, max_sampled: int = 64,
                 max_pinned: int = 64, sample_rate: float = 0.01,
                 recent_capacity: int = 2048, max_active: int = 512,
                 max_spans_per_trace: int = 512,
                 rng: random.Random | None = None):
        self.surface = surface
        self.max_errors = max_errors
        self.max_slow = max_slow
        self.max_sampled = max_sampled
        self.max_pinned = max_pinned
        self.sample_rate = sample_rate
        self.max_active = max_active
        # hard per-TRACE span cap: a reused trace id (a client replaying
        # the same traceparent, a retry loop hammering one pinned trace)
        # must not grow a retained entry without bound — every other
        # limit here caps entry COUNT, this one caps entry SIZE
        self.max_spans_per_trace = max_spans_per_trace
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        # trace id -> [SpanRecord] still assembling (edge not finished)
        self._active: OrderedDict[str, list[SpanRecord]] = OrderedDict()
        # retained traces: trace id -> entry dict; membership tracked by
        # the per-class structures below (a trace may be in several)
        self._traces: dict[str, dict] = {}
        self._errors: deque[str] = deque()
        self._pinned: deque[str] = deque()
        self._slow: list[tuple[float, int, str]] = []   # min-heap
        self._sampled: deque[str] = deque()
        self._seq = 0
        # ALL recently finished spans, retention-independent — the live
        # span table (`pio top`) aggregates over this bounded window,
        # and exemplars() derives the slowest-recent-per-span from it
        # on the READ side (nothing exemplar-shaped on the hot path)
        self._recent: deque[SpanRecord] = deque(maxlen=recent_capacity)
        self.dropped_traces = 0
        self.dropped_spans = 0

    # -- ingest --------------------------------------------------------------
    def record(self, span: SpanRecord) -> None:
        with self._lock:
            self._recent.append(span)
            spans = self._active.get(span.trace_id)
            if spans is None:
                if len(self._active) >= self.max_active:
                    # an assembly whose edge never finished (crashed
                    # connection, missing finish) must not leak
                    self._active.popitem(last=False)
                    self.dropped_traces += 1
                spans = self._active[span.trace_id] = []
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)
            else:
                self.dropped_spans += 1

    def finish_trace(self, trace_id: str, pinned: bool = False) -> None:
        """The surface-local edge span completed: decide retention for
        everything assembled under `trace_id` (see module docstring).
        A later edge span of the SAME trace (the router fanning to one
        shard twice) merges into the already-retained entry."""
        with self._lock:
            spans = self._active.pop(trace_id, None)
            if not spans:
                return
            duration = max(s.duration_s for s in spans)
            is_error = any(s.status == "error" for s in spans)
            entry = self._traces.get(trace_id)
            if entry is not None:
                # merge, but never past the per-trace span cap: a client
                # replaying one trace id (reused traceparent, retry
                # loop on a pinned trace) must not grow this entry
                # linearly with traffic
                room = self.max_spans_per_trace - len(entry["spans"])
                entry["spans"].extend(spans[:max(0, room)])
                self.dropped_spans += max(0, len(spans) - max(0, room))
                entry["durationS"] = max(entry["durationS"], duration)
                if is_error and entry["status"] != "error":
                    entry["status"] = "error"
                    self._keep(self._errors, self.max_errors, trace_id)
                return
            entry = {"traceId": trace_id, "spans": spans,
                     "durationS": duration,
                     "status": "error" if is_error else "ok",
                     # pio: lint-ok[bench-clock] retention recency is
                     # wall-clock (compared against span start_s, also
                     # wall); no interval is measured with it
                     "endS": time.time()}
            keep = False
            if pinned:
                self._traces[trace_id] = entry
                self._keep(self._pinned, self.max_pinned, trace_id)
                keep = True
            if is_error:
                self._traces[trace_id] = entry
                self._keep(self._errors, self.max_errors, trace_id)
                keep = True
            self._seq += 1
            if len(self._slow) < self.max_slow:
                heapq.heappush(self._slow, (duration, self._seq, trace_id))
                self._traces[trace_id] = entry
                keep = True
            elif duration > self._slow[0][0]:
                _, _, evicted = heapq.heapreplace(
                    self._slow, (duration, self._seq, trace_id))
                self._traces[trace_id] = entry
                keep = True
                self._drop_if_unreferenced(evicted)
            if not keep and self._rng.random() < self.sample_rate:
                self._traces[trace_id] = entry
                self._keep(self._sampled, self.max_sampled, trace_id)
                keep = True
            if not keep:
                self.dropped_traces += 1

    def _keep(self, dq: deque, cap: int, trace_id: str) -> None:
        """Append to a FIFO retention class, evicting its oldest member
        (dropped entirely unless another class still references it)."""
        dq.append(trace_id)
        while len(dq) > cap:
            self._drop_if_unreferenced(dq.popleft())

    def _drop_if_unreferenced(self, trace_id: str) -> None:
        # pio: lint-ok[attr-no-lock] only called from finish_trace/_keep,
        # both already under self._lock (the same lock that serializes
        # every retention structure)
        if (trace_id in self._errors or trace_id in self._pinned
                or trace_id in self._sampled
                or any(t == trace_id for _, _, t in self._slow)):
            return
        # pio: lint-ok[attr-no-lock] still under self._lock — see above
        if self._traces.pop(trace_id, None) is not None:
            self.dropped_traces += 1  # pio: lint-ok[attr-no-lock] see above

    # -- convenience: a non-HTTP root trace (the fold-in folder's cycle) -----
    @contextmanager
    def trace(self, name: str, **labels):
        """Open a NEW root trace around a unit of background work, bind
        this recorder, and retain per the usual tail policy on exit.
        Outbound HTTP inside the block joins the trace automatically."""
        ctx = tracectx.new_trace()
        t0 = time.monotonic()
        # pio: lint-ok[bench-clock] span START is wall-clock on purpose —
        # it orders spans ACROSS processes in the merged tree (monotonic
        # clocks don't compare across hosts); the duration uses monotonic
        t0_wall = time.time()
        status, errmsg = "ok", None
        labels = {str(k): str(v) for k, v in labels.items()}
        with tracectx.use(ctx, self):
            try:
                yield ctx
            except BaseException as e:
                status = "error"
                errmsg, labels = error_fields(e, labels)
                raise
            finally:
                self.record(SpanRecord(
                    trace_id=ctx.trace_id, span_id=ctx.span_id,
                    parent_id=None, name=name, surface=self.surface,
                    start_s=t0_wall,
                    duration_s=time.monotonic() - t0,
                    status=status, error=errmsg, labels=labels))
                self.finish_trace(ctx.trace_id)

    # -- read side -----------------------------------------------------------
    def trace_of(self, trace_id: str) -> dict | None:
        """The retained (or still-assembling) trace as a JSON-ready dict."""
        with self._lock:
            entry = self._traces.get(trace_id)
            spans = list(entry["spans"]) if entry is not None else []
            spans.extend(self._active.get(trace_id, ()))
            if not spans:
                return None
            return {
                "traceId": trace_id,
                "surface": self.surface,
                "status": (entry["status"] if entry is not None
                           else "active"),
                "durationS": round(
                    entry["durationS"] if entry is not None
                    else max(s.duration_s for s in spans), 6),
                "spans": [s.to_dict() for s in spans],
            }

    def traces(self, limit: int = 50) -> list[dict]:
        """Retained-trace summaries, most recent first."""
        with self._lock:
            entries = sorted(self._traces.values(),
                             key=lambda e: e["endS"], reverse=True)[:limit]
            return [{
                "traceId": e["traceId"],
                "status": e["status"],
                "durationS": round(e["durationS"], 6),
                "spanCount": len(e["spans"]),
                "endS": round(e["endS"], 3),
            } for e in entries]

    def span_table(self) -> list[dict]:
        """Live per-(span, arm) stats over the recent-span window —
        what `pio top` renders: rate, p50, p99, error%."""
        with self._lock:
            recent = list(self._recent)
        if not recent:
            return []
        # pio: lint-ok[bench-clock] rate window = now minus span
        # start_s, which is wall-clock by design (cross-process
        # ordering) — both ends on the same clock
        now = time.time()
        window_s = max(1e-3, now - min(s.start_s for s in recent))
        groups: dict[tuple[str, str], list[SpanRecord]] = {}
        for s in recent:
            key = (s.name, s.labels.get("arm", "active"))
            groups.setdefault(key, []).append(s)
        out = []
        for (name, arm), spans in sorted(groups.items()):
            durs = sorted(s.duration_s for s in spans)
            n = len(durs)
            errors = sum(1 for s in spans if s.status == "error")
            out.append({
                "span": name,
                "arm": arm,
                "surface": self.surface,
                "count": n,
                "ratePerSec": round(n / window_s, 3),
                "p50Ms": round(durs[n // 2] * 1e3, 3),
                "p99Ms": round(durs[min(n - 1, int(n * 0.99))] * 1e3, 3),
                "errorPct": round(100.0 * errors / n, 2),
            })
        return out

    def exemplars(self) -> dict[str, dict]:
        """Slowest RECENT trace id per span name — the /metrics.json
        bridge from a p99 row to `pio trace <id>`. Computed on the read
        side from the recent-span window and restricted to traces still
        fetchable (retained or assembling), so an exemplar can never be
        an all-time-max relic whose trace 404s — it decays with the
        window like the span table does."""
        with self._lock:
            best: dict[str, SpanRecord] = {}
            for s in self._recent:
                if (s.trace_id not in self._traces
                        and s.trace_id not in self._active):
                    continue
                cur = best.get(s.name)
                if cur is None or s.duration_s > cur.duration_s:
                    best[s.name] = s
            return {
                name: {"traceId": s.trace_id,
                       "seconds": round(s.duration_s, 6)}
                for name, s in sorted(best.items())
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "surface": self.surface,
                "retainedTraces": len(self._traces),
                "activeTraces": len(self._active),
                "droppedTraces": self.dropped_traces,
                "droppedSpans": self.dropped_spans,
                "errorTraces": len(self._errors),
                "pinnedTraces": len(self._pinned),
                "slowTraces": len(self._slow),
                "sampledTraces": len(self._sampled),
            }
