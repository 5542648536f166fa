"""Bounded in-memory spill queue with background drain.

Degraded-mode ingestion for the event server: when the event store is
down (breaker open, transport failures exhausted their retries), events
are parked in a bounded deque and a daemon drain thread re-inserts them
once the store recovers — the event server keeps answering 201 through
a storage outage shorter than the queue's capacity. When the queue is
full the caller sheds (503 + Retry-After) instead of growing without
bound: memory is the one resource an ingest tier must never gamble.

Delivery contract: event ids are assigned BEFORE spilling, so the id
returned to the client is the id the drain later persists; order within
the queue is preserved (FIFO), but events inserted live while a drain
is pending can interleave — same as the reference's HBase client-side
write buffering. Drain retries re-insert with the same id, which every
backend handles without duplicating: memory/sql upsert by event_id, and
the append-only eventlog dedupes supplied ids over a bounded
recent-insert window (phantom retries land within seconds, well inside
it) — so a drain racing a phantom-failed original lands exactly one
record.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from pio_tpu_torch.resilience.policies import is_transient

log = logging.getLogger("pio_tpu_torch.resilience.spill")


class SpillSaturated(Exception):
    """The spill queue crossed its high-water mark: the caller should
    answer 429 + Retry-After (an explicit, retryable backpressure
    signal) instead of parking yet more memory behind a dead store.
    Raised by callers, not the queue — ``should_shed()`` is the
    query."""


class SpillQueue:
    """Bounded FIFO of (event, app_id, channel_id) awaiting re-insert.

    `insert_fn(event, app_id, channel_id)` is the (already resilient)
    DAO insert. The drain thread starts lazily on first spill and runs
    for the queue's lifetime; `close()` stops it.

    Backpressure hysteresis: once depth reaches ``high_water`` the queue
    reports ``should_shed()`` — the event server then answers 429 +
    Retry-After instead of 201-spilling — and keeps shedding until the
    drain brings depth back to ``low_water``, so a store outage long
    enough to fill the buffer produces ONE clean flip to shedding and
    ONE flip back, not a 201/429 flutter at the boundary.
    ``high_water <= 0`` (0 is the default) disables backpressure
    entirely — exactly the pre-hysteresis behavior: offers are accepted
    until the queue is literally full, and a full queue refuses the
    offer (the caller's 503 path). An explicit mark is clamped to
    ``capacity`` so a misconfigured mark above it cannot silently
    disable the feature.
    """

    def __init__(self, insert_fn: Callable[..., Any], capacity: int = 10000,
                 base_interval_s: float = 0.2, max_interval_s: float = 5.0,
                 high_water: int = 0, low_water: int = 0):
        self._insert = insert_fn
        self.capacity = int(capacity)
        self.high_water = (min(int(high_water), self.capacity)
                           if int(high_water) > 0 else 0)
        self.low_water = (max(0, min(int(low_water) or self.high_water // 2,
                                     self.high_water - 1))
                          if self.high_water else 0)
        self._base_interval_s = base_interval_s
        self._max_interval_s = max_interval_s
        # (event, app_id, channel_id, enqueue monotonic time): the
        # timestamp feeds the oldest-spilled-event age gauge — an aging
        # backlog is the early-warning signal that the drain is losing
        # to the spill rate, visible on /metrics before 429s start
        self._q: deque[tuple[Any, int, int | None, float]] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._saturated = False
        self.spilled_total = 0
        self.drained_total = 0
        self.dropped_total = 0   # offers refused because the queue was full
        self.shed_total = 0      # callers turned away above high water

    # -- producer side ------------------------------------------------------
    def offer(self, event: Any, app_id: int,
              channel_id: int | None = None) -> bool:
        """Park an event for background insertion. False = queue full
        (caller must shed). event.event_id must already be assigned."""
        with self._lock:
            if self._closed or len(self._q) >= self.capacity:
                self.dropped_total += 1
                return False
            self._q.append((event, app_id, channel_id, time.monotonic()))
            self.spilled_total += 1
            if self.high_water and len(self._q) >= self.high_water:
                self._saturated = True
            if self._thread is None:
                # pio: lint-ok[context-loss] deliberate detach: the
                # drain loop outlives the request that spilled the
                # event — inheriting its Deadline would cancel retries
                self._thread = threading.Thread(
                    target=self._drain_loop, name="event-spill-drain",
                    daemon=True,
                )
                self._thread.start()
        self._wake.set()
        return True

    def should_shed(self) -> bool:
        """True while depth has crossed high_water and has not yet
        drained back to low_water (hysteresis — see class docstring).
        Callers that turn a request away on this MUST call
        ``record_shed()`` so the counter stays honest."""
        with self._lock:
            if self._saturated and len(self._q) <= self.low_water:
                self._saturated = False
            return self._saturated

    def record_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._q)

    def snapshot(self) -> dict:
        with self._lock:
            if self._saturated and len(self._q) <= self.low_water:
                self._saturated = False
            oldest_age = (time.monotonic() - self._q[0][3]
                          if self._q else 0.0)
            return {
                "size": len(self._q), "capacity": self.capacity,
                "highWater": self.high_water, "lowWater": self.low_water,
                "saturated": self._saturated,
                "spilled": self.spilled_total, "drained": self.drained_total,
                "dropped": self.dropped_total, "shed": self.shed_total,
                "oldestAgeSeconds": oldest_age,
            }

    # -- drain side ---------------------------------------------------------
    def _pop(self) -> tuple[Any, int, int | None, float] | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def _requeue_front(self, item: tuple[Any, int, int | None, float]
                       ) -> None:
        with self._lock:
            self._q.appendleft(item)

    def _drain_loop(self) -> None:
        interval = self._base_interval_s
        while True:
            self._wake.wait(timeout=interval)
            # pio: lint-ok[attr-no-lock] threading.Event.clear is
            # internally synchronized; a racing offer() re-sets it
            self._wake.clear()
            if self._closed:
                return
            made_progress = False
            while (item := self._pop()) is not None:
                event, app_id, channel_id, _ = item
                try:
                    self._insert(event, app_id, channel_id)
                except Exception as e:  # noqa: BLE001 - classified below
                    if is_transient(e):
                        # store still down: put it back (FIFO head) and
                        # back off before the next pass
                        self._requeue_front(item)
                        break
                    # permanent error (e.g. the app was deleted while the
                    # event sat in the queue): drop it, loudly — blocking
                    # the queue on an uninsertable event would wedge every
                    # event behind it
                    log.error("spill drain dropping event %s: %s",
                              getattr(event, "event_id", "?"), e)
                else:
                    made_progress = True
                    with self._lock:
                        self.drained_total += 1
            interval = (self._base_interval_s if made_progress
                        else min(self._max_interval_s, interval * 2))

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
