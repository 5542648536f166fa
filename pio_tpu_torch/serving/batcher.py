"""Cross-request continuous batching: coalesce concurrent queries into one
device dispatch.

QueryBatcher (workflow/serve.py) already micro-batches, but it is purely
window-driven: every batch waits out the window even when the device sits
idle, and it knows nothing about per-request Deadlines. ContinuousBatcher
is the admission stage ROADMAP item 3 calls for: requests enqueue, and the
dispatcher drains whenever a device pipeline slot is free OR the coalesce
window (default ~2 ms) elapses — whichever comes first — so under load the
device never idles waiting for a window, and at low load a lone query pays
at most one window of added latency (usually far less: once the queue goes
quiet for window/8 the burst is over and the batch dispatches early). The drained set executes as ONE
batched einsum+top_k via `QueryServer.query_batch`, whose scoring products
run at the one dispatch shape the warm sweep primed (ops/bucketing.py
DISPATCH_ROWS).

Deadline contract (docs/serving.md "Continuous batching"): a query whose
ambient Deadline cannot survive the next window is never parked — it is
dispatched solo immediately (budget still covers the dispatch) — and a
query whose budget is already exhausted is shed with DeadlineExceeded,
which the serving edge maps to 503 + Retry-After. Members whose deadline
expires while queued are failed at drain time instead of wasting a batch
slot. No request ever waits past its Deadline in here (regression-tested
in tests/test_batching.py).

Rollout arm split, blackList/whiteList, and retrieval semantics are the
batch route's: `query_batch` sub-batches per arm with per-ARM per-QUERY
stats, so coalesced answers are bit-identical to the solo path (the
parity suite pins this)."""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field
from typing import Any

from pio_tpu_torch.resilience import Deadline, DeadlineExceeded

# occupancy histogram upper bounds (fraction of max_batch filled per
# dispatch). Rendered on /metrics as `pio_serving_batch_occupancy`; a
# distribution pinned at the 1.0 bucket under load means every dispatch
# hits max_batch — the queue is saturated and the window/max_batch are
# misconfigured (pio doctor --fleet warns on the router-side analogue).
OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.5, 0.75, 1.0)


@dataclass
class _Pending:
    q: dict
    fut: Future
    # absolute monotonic deadline (None = no ambient budget) — captured at
    # enqueue because the dispatcher thread does not inherit the caller's
    # Deadline contextvar
    deadline: float | None
    t_enq: float = field(default_factory=time.monotonic)


class ContinuousBatcher:
    """Slot-gated continuous batcher in front of `QueryServer.query_batch`.

    Same pipeline shape as QueryBatcher (bounded executor + BoundedSemaphore
    acquired BEFORE draining, so batches form while all slots are busy and
    each freed slot takes a real batch), plus: deadline-aware admission and
    drain, a window cut when any member's deadline would not survive the
    full window, and batch-occupancy / coalesce-wait observability."""

    def __init__(self, server, window_s: float = 0.002, max_batch: int = 64,
                 pipeline_depth: int = 2):
        self.server = server
        self.window_s = window_s
        self.max_batch = max_batch
        self.tracer = server.tracer
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        # counters (all under _lock): dispatches = batched executions,
        # queries = members of those batches, bypass = deadline-doomed
        # queries dispatched solo, shed = queries refused/failed on an
        # exhausted budget
        self.dispatch_count = 0
        self.query_count = 0
        self.bypass_count = 0
        self.shed_count = 0
        self._occ_counts = [0] * len(OCCUPANCY_BUCKETS)
        self._occ_total = 0
        self._occ_sum = 0.0
        self._pool = ThreadPoolExecutor(
            max_workers=pipeline_depth, thread_name_prefix="coalesce-exec"
        )
        self._slots = threading.BoundedSemaphore(pipeline_depth)
        self._thread = threading.Thread(
            target=self._run, name="continuous-batcher", daemon=True
        )
        self._thread.start()

    # -- admission -----------------------------------------------------------
    def query(self, q: dict) -> Any:
        remaining = Deadline.remaining()
        if remaining is not None:
            if remaining <= 0:
                with self._lock:
                    self.shed_count += 1
                raise DeadlineExceeded(
                    "request budget exhausted before batch admission"
                )
            if remaining <= self.window_s:
                # cannot survive the next coalesce window: dispatch solo
                # NOW rather than park a waiter that must time out
                with self._lock:
                    self.bypass_count += 1
                return self.server.query(q)
        item = _Pending(
            q, Future(),
            None if remaining is None else time.monotonic() + remaining,
        )
        self._q.put(item)
        # batch execution runs on the batcher pool, which does not inherit
        # the caller's Deadline contextvar — enforce the budget here, at
        # the wait (the batch result lands harmlessly later)
        try:
            return item.fut.result(timeout=remaining)
        except FuturesTimeoutError:
            with self._lock:
                self.shed_count += 1
            raise DeadlineExceeded(
                "request budget exhausted waiting for coalesced dispatch"
            ) from None

    # -- dispatcher ----------------------------------------------------------
    def _run(self):
        while not self._closed:
            try:
                first = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            self._slots.acquire()  # device/pipeline slot FIRST
            batch = [first]
            window = self.window_s
            if window > 0:
                # window anchored at the FIRST member's arrival: if all
                # slots were busy, its wait already covered the window and
                # the drain below takes whatever queued meanwhile
                end = first.t_enq + window
                if first.deadline is not None:
                    end = min(end, first.deadline)
                # idle-gap early cut: the window bounds the MAX wait, but a
                # concurrent burst arrives in well under it — once the queue
                # goes quiet for a fraction of the window, the batch is as
                # full as it is going to get, so dispatch instead of pinning
                # the device idle for the remainder
                gap = max(window / 8.0, 0.0002)
                while len(batch) < self.max_batch:
                    rem = end - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        item = self._q.get(timeout=min(rem, gap))
                    except queue.Empty:
                        break
                    batch.append(item)
                    # a member whose deadline lands inside the window cuts
                    # the window short: dispatch so it still makes it
                    if item.deadline is not None and item.deadline < end:
                        end = item.deadline
            # free coalescing: take whatever queued while collecting (and,
            # with window <= 0, this IS the adaptive drain — zero wait)
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            now = time.monotonic()
            live = []
            for item in batch:
                if item.deadline is not None and now >= item.deadline:
                    # its waiter has already timed out into a 503 — fail
                    # the future rather than waste a batch slot on it
                    with self._lock:
                        self.shed_count += 1
                    if not item.fut.done():
                        item.fut.set_exception(DeadlineExceeded(
                            "deadline expired in coalesce queue"
                        ))
                else:
                    live.append(item)
            if not live:
                self._slots.release()
                continue
            self._observe(live, now)
            try:
                self._pool.submit(self._execute, live)
            except RuntimeError as e:
                self._slots.release()
                # close() raced the collection: fail the batch's waiters
                # rather than stranding them on never-set futures
                for item in live:
                    if not item.fut.done():
                        item.fut.set_exception(e)
                return

    def _observe(self, live: list[_Pending], now: float) -> None:
        occ = len(live) / float(self.max_batch)
        with self._lock:
            self.dispatch_count += 1
            self.query_count += len(live)
            self._occ_total += 1
            self._occ_sum += occ
            for i, ub in enumerate(OCCUPANCY_BUCKETS):
                if occ <= ub:
                    self._occ_counts[i] += 1
                    break
        self.tracer.histogram("serve.batch_occupancy").record(occ)
        for item in live:
            self.tracer.record("serve.coalesce_wait", now - item.t_enq)

    # -- execution -----------------------------------------------------------
    def _execute(self, batch: list[_Pending]):
        try:
            self._do_execute(batch)
        finally:
            self._slots.release()

    def _do_execute(self, batch: list[_Pending]):
        queries = [item.q for item in batch]
        try:
            # observe_batch_errors=False: on a batch failure the solo
            # retry below records each query's rollout stats exactly once
            # (the double-count audit — see query_batch's docstring)
            results = self.server.query_batch(
                queries, observe_batch_errors=False)
            for item, res in zip(batch, results):
                item.fut.set_result(res)
        except Exception:  # noqa: BLE001 - isolate the bad query
            # one malformed query must not fail its batch-mates: retry
            # each one alone so only the offender sees the error
            for item in batch:
                if item.fut.done():
                    continue
                try:
                    item.fut.set_result(self.server.query(item.q))
                except Exception as e:  # noqa: BLE001
                    item.fut.set_exception(e)

    # -- observability / control ---------------------------------------------
    def set_window(self, window_s: float) -> None:
        """Live window retune (guarded POST /batcher/window): takes effect
        on the next collection cycle; in-flight batches are unaffected."""
        self.window_s = float(window_s)

    def occupancy_exposition(self):
        """(buckets, per-bucket counts, total count, total sum) for
        utils.tracing.prometheus_histogram — the
        `pio_serving_batch_occupancy` family on /metrics."""
        with self._lock:
            return (OCCUPANCY_BUCKETS, list(self._occ_counts),
                    self._occ_total, self._occ_sum)

    def stats(self) -> dict:
        with self._lock:
            dispatches = self.dispatch_count
            queries = self.query_count
            bypass = self.bypass_count
            shed = self.shed_count
            occ_total, occ_sum = self._occ_total, self._occ_sum
        occ = self.tracer.histogram("serve.batch_occupancy")
        wait = self.tracer.histogram("serve.coalesce_wait")
        return {
            "mode": "continuous",
            "windowMs": self.window_s * 1e3,
            "maxBatch": self.max_batch,
            "dispatches": dispatches,
            "coalescedQueries": queries,
            "bypassSolo": bypass,
            "shed": shed,
            "queued": self._q.qsize(),
            "meanOccupancy": round(occ_sum / occ_total, 4) if occ_total
            else 0.0,
            "occupancy": occ.quantiles(),
            "coalesceWaitMs": {
                k: round(v * 1e3, 3)
                for k, v in wait.quantiles().items()
            },
        }

    def close(self):
        self._closed = True
        self._pool.shutdown(wait=False)
