"""Transparent resilience proxy for storage DAOs.

``ResilientDAO`` wraps any DAO object so that every public method call
passes through the full policy stack, in order:

    Deadline.check  ->  CircuitBreaker.guard  ->  chaos.maybe_inject
                    ->  the real DAO method

wrapped in a ``RetryPolicy`` whose retry predicate is ``is_transient``
(cause chains included, so a RemoteBackend StorageError wrapping an
unreachable-server HttpClientError retries, while an "unsupported DAO"
StorageError does not). Chaos injection sits INSIDE the breaker guard,
so injected faults count toward the error-rate window exactly like real
ones — that is what lets the chaos tests prove the breaker opens.

Transparency contract: non-callable attributes pass through untouched,
``__class__`` reports the wrapped DAO's class (isinstance keeps
working — e.g. tests that check ShardedEventsDAO and reach into
``.shards``), and wrapped methods are cached in the proxy ``__dict__``
so repeated lookups cost a dict hit.

Semantics note: retrying a non-idempotent insert after a transport
failure is at-least-once delivery — the same contract the reference
accepts from its HBase/JDBC clients. Methods returning lazy iterators
are guarded at call time; failures raised during iteration propagate
unretried (page-level retry would need cursor state the DAO API does
not expose).
"""

from __future__ import annotations

import functools
from typing import Any

from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.resilience.policies import (
    CircuitBreaker, Deadline, RetryPolicy, is_transient,
)

# storage-boundary default: 3 attempts, fast first retry, bounded total
# sleep so a dead backend costs tens of milliseconds, not seconds
STORAGE_RETRY = RetryPolicy(
    attempts=3, base_delay_s=0.02, max_delay_s=0.25, budget_s=1.0,
)


class ResilientDAO:
    """See module docstring. One instance per (DAO, breaker) pair."""

    def __init__(self, dao: Any, *, breaker: CircuitBreaker,
                 retry: RetryPolicy = STORAGE_RETRY, point: str = "storage"):
        self._dao = dao
        self._breaker = breaker
        self._retry = retry
        self._point = point

    @property  # type: ignore[misc]
    def __class__(self):  # noqa: D401 - isinstance transparency
        return type(self._dao)

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._dao, name)
        if name.startswith("_") or not callable(attr):
            return attr
        point = f"{self._point}.{name}"
        breaker = self._breaker
        retry = self._retry

        def attempt(*args: Any, **kwargs: Any) -> Any:
            Deadline.check(point)
            with breaker.guard():
                chaos.maybe_inject(point)
                return attr(*args, **kwargs)

        @functools.wraps(attr)
        def guarded(*args: Any, **kwargs: Any) -> Any:
            return retry.call(attempt, *args, retry_if=is_transient,
                              **kwargs)

        # cache so the next lookup skips __getattr__ (and so the method
        # is a stable object, like on a plain DAO)
        self.__dict__[name] = guarded
        return guarded

    def __repr__(self) -> str:
        return f"ResilientDAO({self._dao!r}, breaker={self._breaker.name})"
