"""Resilience policies: retry with backoff, request deadlines, circuit
breaking, and load shedding.

The reference PredictionIO leans on spray/akka supervision and the
HBase/JDBC client libraries for transient-failure handling; this port
runs its own transports (server/http.py, utils/httpclient.py, the wire
pools), so systematic failure policy lives here and every I/O boundary
composes the same four primitives:

  * ``RetryPolicy``   — exponential backoff with full jitter, capped by a
    total sleep budget AND the ambient ``Deadline``; fail-fast on
    ``CircuitOpenError``/``DeadlineExceeded`` so retries never pile onto
    an already-declared outage.
  * ``Deadline``      — a contextvar-carried absolute deadline. The serve
    path opens a per-request budget and every storage DAO call checks it
    before doing work (`workflow/serve.py` -> `data/storage.py`).
  * ``CircuitBreaker``— closed/open/half-open over a rolling error-rate
    window; only *transient* (transport-class) failures count, so a 404
    or a validation error can never trip a breaker.
  * ``LoadShedder``   — a watermark on concurrent admitted work; the
    async HTTP transport sheds with 503 + Retry-After above it.

Deterministic by construction: every sleep/clock/RNG is injectable, and
`resilience/chaos.py` drives the whole stack in tests.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

__all__ = [
    "CircuitBreaker", "CircuitOpenError", "Deadline", "DeadlineExceeded",
    "LoadShedder", "RetryPolicy", "is_transient",
]


class DeadlineExceeded(TimeoutError):
    """The ambient request budget ran out before the operation started
    (or between retry attempts). TimeoutError subclass so existing
    transport-error handling (spill, 503 mapping) applies."""


class CircuitOpenError(ConnectionError):
    """A circuit breaker refused the call without attempting it.

    ConnectionError subclass: downstream degradation paths (eventserver
    spill, serve-path fallback) treat it like any other transport
    failure — but RetryPolicy fails fast on it by default, because
    retrying against a declared outage only adds load and latency.
    """

    def __init__(self, name: str, retry_after_s: float = 1.0):
        super().__init__(f"circuit breaker '{name}' is open")
        self.breaker = name
        self.retry_after_s = retry_after_s


# -- transient classification ------------------------------------------------

# OSError subclasses that mean "the target is misconfigured/absent", not
# "the target hiccuped" — retrying cannot help and must not trip breakers
# differently from any other permanent error.
_PERMANENT_OS_ERRORS = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, FileExistsError,
)
_TRANSIENT_HTTP_STATUSES = frozenset({0, 408, 429, 502, 503, 504})


def is_transient(exc: BaseException) -> bool:
    """True when `exc` (or anything in its cause chain) looks like a
    transient transport-level failure worth retrying / counting against
    a breaker: connection errors, timeouts, interrupted syscalls,
    5xx-gateway/unreachable HTTP client errors, and chaos injections
    (ChaosError subclasses ConnectionError). Application-level errors —
    validation, not-found, unsupported-DAO StorageErrors — are not."""
    seen: set[int] = set()
    e: BaseException | None = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, (ConnectionError, TimeoutError, InterruptedError)):
            return True
        # duck-typed HttpClientError (utils/httpclient.py): a `status`
        # int attribute, 0 = transport-level. Not imported by name to
        # keep this module import-cycle-free under any import order.
        status = getattr(e, "status", None)
        if isinstance(status, int):
            if status in _TRANSIENT_HTTP_STATUSES:
                return True
        elif isinstance(e, OSError) and not isinstance(
                e, _PERMANENT_OS_ERRORS):
            return True
        e = e.__cause__ or e.__context__
    return False


# -- Deadline ----------------------------------------------------------------

_deadline_var: ContextVar[float | None] = ContextVar(
    "pio_tpu_deadline", default=None
)


class Deadline:
    """Contextvar-carried absolute deadline (monotonic seconds).

    `with Deadline.budget(0.5):` at the request edge; `Deadline.check()`
    at every I/O boundary underneath; `Deadline.remaining()` caps retry
    sleeps. Nested budgets take the tighter deadline. Contextvars follow
    the thread that runs the request handler — work handed to other
    threads (feedback inserts, background drains) deliberately escapes
    the budget, which is correct: those are not on the caller's clock.
    """

    @staticmethod
    @contextmanager
    def budget(seconds: float):
        now = time.monotonic()
        new = now + max(0.0, float(seconds))
        cur = _deadline_var.get()
        token = _deadline_var.set(new if cur is None else min(cur, new))
        try:
            yield
        finally:
            _deadline_var.reset(token)

    @staticmethod
    def remaining() -> float | None:
        """Seconds left, or None when no budget is active."""
        d = _deadline_var.get()
        return None if d is None else d - time.monotonic()

    @staticmethod
    def check(what: str = "operation") -> None:
        rem = Deadline.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceeded(
                f"deadline exhausted before {what} "
                f"({-rem * 1e3:.0f}ms over budget)"
            )


# -- RetryPolicy -------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter, budget- and deadline-capped.

    `attempts` is the TOTAL number of tries (1 = no retry). Delay before
    retry k (1-based) is drawn uniformly from
    (0, min(max_delay_s, base_delay_s * multiplier**(k-1))] when
    jitter=1.0 (full jitter, the AWS-architecture-blog scheme); jitter=0
    makes the schedule deterministic at the cap values. Total sleep is
    capped by `budget_s` and by the ambient Deadline: when either would
    be exceeded the last error is re-raised immediately instead of
    sleeping into certain failure.
    """

    attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 1.0          # 0 = deterministic, 1 = full jitter
    budget_s: float | None = None  # cap on total sleep across retries
    retry_on: tuple[type[BaseException], ...] = (
        ConnectionError, TimeoutError, OSError,
    )
    # declared outages / exhausted budgets never get retried, whatever
    # retry_on or retry_if say
    no_retry: tuple[type[BaseException], ...] = (
        CircuitOpenError, DeadlineExceeded,
    )

    def delay(self, retry_index: int, rng: random.Random | None = None
              ) -> float:
        """Backoff before the retry_index-th retry (0-based)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (self.multiplier ** retry_index))
        if self.jitter <= 0:
            return cap
        r = (rng or random).random()
        return cap * (1.0 - self.jitter) + cap * self.jitter * r

    def delays(self, rng: random.Random | None = None) -> Iterator[float]:
        """The full backoff schedule (attempts - 1 delays) — for callers
        that drive their own loop (e.g. async binds that must
        `await asyncio.sleep`)."""
        for i in range(max(0, self.attempts - 1)):
            yield self.delay(i, rng)

    def _should_retry(self, exc: BaseException,
                      retry_if: Callable[[BaseException], bool] | None
                      ) -> bool:
        if isinstance(exc, self.no_retry):
            return False
        if retry_if is not None:
            return retry_if(exc)
        return isinstance(exc, self.retry_on)

    def call(self, fn: Callable[..., Any], *args: Any,
             retry_if: Callable[[BaseException], bool] | None = None,
             rng: random.Random | None = None,
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Callable[[int, BaseException, float], None]
             | None = None,
             **kwargs: Any) -> Any:
        """Run fn(*args, **kwargs) under this policy. `retry_if`
        overrides the retry_on isinstance test (no_retry still wins);
        `on_retry(attempt_index, exc, delay_s)` observes each retry
        (logging hooks); `sleep`/`rng` are injectable for tests."""
        slept = 0.0
        last: BaseException | None = None
        for attempt in range(max(1, self.attempts)):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - classified below
                if not self._should_retry(e, retry_if):
                    raise
                last = e
                if attempt >= self.attempts - 1:
                    raise
                d = self.delay(attempt, rng)
                if self.budget_s is not None:
                    d = min(d, self.budget_s - slept)
                    if d < 0:
                        raise
                rem = Deadline.remaining()
                if rem is not None:
                    if rem <= 0:
                        raise DeadlineExceeded(
                            "deadline exhausted during retry backoff"
                        ) from e
                    d = min(d, rem)
                if on_retry is not None:
                    on_retry(attempt, e, d)
                if d > 0:
                    sleep(d)
                    slept += d
        raise last  # unreachable; keeps type-checkers honest


# -- CircuitBreaker ----------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass
class BreakerSnapshot:
    name: str
    state: str
    calls: int            # calls in the rolling window
    failures: int         # transient failures in the rolling window
    failure_rate: float
    opened_count: int     # lifetime open transitions


class CircuitBreaker:
    """Closed/open/half-open circuit breaker over a rolling error-rate
    window (the Hystrix/resilience4j state machine, sized for the storage
    backends this repo fronts).

    * CLOSED: calls flow; outcomes land in a `window_s`-second rolling
      window. Once the window holds >= `min_calls` calls and the failure
      rate >= `failure_rate`, the breaker OPENs.
    * OPEN: every `allow()` is refused for `open_s` seconds, then the
      breaker lets `half_open_max` concurrent probes through
      (HALF_OPEN).
    * HALF_OPEN: a probe success closes the breaker (window cleared); a
      probe failure re-opens it for another `open_s`.

    Only transient failures should be recorded as failures — the
    `guard()` context manager applies `is_transient` so callers get that
    classification for free. Thread-safe; `clock` is injectable.
    """

    def __init__(self, name: str = "", *, window_s: float = 30.0,
                 min_calls: int = 10, failure_rate: float = 0.5,
                 open_s: float = 5.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.window_s = window_s
        self.min_calls = min_calls
        self.failure_rate = failure_rate
        self.open_s = open_s
        self.half_open_max = half_open_max
        self._clock = clock
        self._lock = threading.Lock()
        self._window: deque[tuple[float, bool]] = deque()  # (t, ok)
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes = 0
        self.opened_count = 0

    # -- internals (call with self._lock held) ------------------------------
    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    def _tick(self, now: float) -> None:
        """open -> half_open transition when the cool-down elapsed."""
        if self._state == OPEN and now - self._opened_at >= self.open_s:
            self._state = HALF_OPEN
            self._probes = 0

    def _trip(self, now: float) -> None:
        self._state = OPEN
        self._opened_at = now
        # pio: lint-ok[attr-no-lock] internal helper, only called with
        # self._lock held (see "call with self._lock held" section note)
        self.opened_count += 1
        # pio: lint-ok[attr-no-lock] same: under self._lock
        self._window.clear()

    # -- public API ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._tick(self._clock())
            return self._state

    def allow(self) -> bool:
        """True when a call may proceed (reserves a probe slot in
        half-open). Callers MUST follow up with record(ok) — `guard()`
        does both."""
        with self._lock:
            now = self._clock()
            self._tick(now)
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes < self.half_open_max:
                    self._probes += 1
                    return True
                return False
            return False

    def record(self, ok: bool) -> None:
        with self._lock:
            now = self._clock()
            self._tick(now)
            if self._state == HALF_OPEN:
                if ok:
                    self._state = CLOSED
                    self._window.clear()
                else:
                    self._trip(now)
                return
            if self._state == OPEN:
                # late completion from before the trip: ignore
                return
            self._window.append((now, ok))
            self._prune(now)
            if not ok and len(self._window) >= self.min_calls:
                failures = sum(1 for _, o in self._window if not o)
                if failures / len(self._window) >= self.failure_rate:
                    self._trip(now)

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.open_s - (self._clock() - self._opened_at))

    @contextmanager
    def guard(self):
        """allow() or raise CircuitOpenError; record the outcome —
        transient exceptions count as failures, everything else
        (including app-level errors: the backend DID respond) as
        success."""
        if not self.allow():
            raise CircuitOpenError(
                self.name, retry_after_s=self.retry_after_s() or 1.0
            )
        try:
            result = yield
        except BaseException as e:
            self.record(not is_transient(e))
            raise
        else:
            self.record(True)
        return result

    def snapshot(self) -> BreakerSnapshot:
        with self._lock:
            self._tick(self._clock())
            calls = len(self._window)
            failures = sum(1 for _, ok in self._window if not ok)
            return BreakerSnapshot(
                name=self.name, state=self._state, calls=calls,
                failures=failures,
                failure_rate=failures / calls if calls else 0.0,
                opened_count=self.opened_count,
            )

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._window.clear()
            self._probes = 0


# -- LoadShedder -------------------------------------------------------------

class LoadShedder:
    """Watermark on concurrently admitted work. `try_acquire()` admits
    while depth < watermark; above it callers shed (the async transport
    answers 503 + Retry-After). Thread-safe (the async server calls it
    only from its loop, but the class does not rely on that)."""

    def __init__(self, watermark: int, retry_after_s: float = 1.0):
        self.watermark = max(1, int(watermark))
        self.retry_after_s = retry_after_s
        self._depth = 0
        self._lock = threading.Lock()
        self.shed_count = 0

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def try_acquire(self) -> bool:
        with self._lock:
            if self._depth >= self.watermark:
                self.shed_count += 1
                return False
            self._depth += 1
            return True

    def release(self) -> None:
        with self._lock:
            if self._depth > 0:
                self._depth -= 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"depth": self._depth, "watermark": self.watermark,
                    "shed": self.shed_count}
