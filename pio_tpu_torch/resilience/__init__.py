"""Resilience subsystem: retry/backoff, deadlines, circuit breaking,
load shedding, degraded-mode spill, and deterministic chaos injection.

Composition map (who uses what):

  * ``data/storage.py``       wraps every repository DAO in a
    ``ResilientDAO`` (retry + per-source ``CircuitBreaker`` + deadline
    check + chaos point ``storage.<SOURCE>.<method>``).
  * ``server/http.py``        sheds load in the async transport via
    ``LoadShedder`` (503 + Retry-After above the queue watermark) and
    retries binds through ``RetryPolicy``.
  * ``workflow/serve.py``     opens a per-request ``Deadline`` budget,
    keeps the last-good model when ``/reload`` fails, and exposes
    ``/healthz`` + ``/readyz``.
  * ``server/eventserver.py`` spills to a bounded ``SpillQueue`` with
    background drain when the event store's breaker trips.
  * ``tools/cli.py``          ``pio doctor`` aggregates every surface's
    ``/readyz`` (breaker states, queue depths, spill backlog).

Policy semantics are documented in docs/resilience.md; the chaos spec
grammar lives in ``resilience/chaos.py``.
"""

from pio_tpu_torch.resilience.guard import STORAGE_RETRY, ResilientDAO
from pio_tpu_torch.resilience.policies import (
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
    LoadShedder,
    RetryPolicy,
    is_transient,
)
from pio_tpu_torch.resilience.quota import TenantAdmission, TenantQuota, TokenBucket
from pio_tpu_torch.resilience.spill import SpillQueue, SpillSaturated

__all__ = [
    "STORAGE_RETRY",
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "LoadShedder",
    "ResilientDAO",
    "RetryPolicy",
    "SpillQueue",
    "SpillSaturated",
    "TenantAdmission",
    "TenantQuota",
    "TokenBucket",
    "is_transient",
]
