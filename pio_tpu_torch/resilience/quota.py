"""Per-tenant admission control: token-bucket quotas, concurrency caps,
and weighted-fair sharing of a pooled serving plane.

Three independent gates, checked in order by ``TenantAdmission.admit``:

  1. **Rate quota** — a classic token bucket per tenant (``rate`` tokens
     per second, ``burst`` capacity). A tenant flooding at 10x its quota
     is answered 429 + Retry-After by the caller while every other
     tenant's bucket is untouched.
  2. **Concurrency cap** — per-tenant in-flight ceiling, so a single
     tenant with slow queries cannot occupy the whole worker pool even
     inside its rate quota.
  3. **Weighted-fair share** — only under global pressure: when total
     in-flight work crosses the shared ``watermark`` (the same notion the
     transport-level ``LoadShedder`` uses), tenants running ABOVE their
     weight-proportional share of the watermark are shed first; tenants
     at or below their share keep flowing. With no pressure the gate is
     inert, so fairness costs nothing on the happy path.

All three answer the same way — shed, with a suggested ``Retry-After``
— which the serving surfaces map onto the existing 429 discipline
(docs/resilience.md). Counters are lifetime-monotonic per tenant and
feed the ``tenant=``-labeled Prometheus plane.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

__all__ = ["TenantAdmission", "TenantQuota", "TokenBucket"]


class TokenBucket:
    """Thread-safe token bucket. ``rate`` tokens/second refill up to
    ``burst`` capacity; ``rate <= 0`` means unlimited (always allows).

    ``try_acquire`` never blocks: it answers ``(allowed, retry_after_s)``
    where ``retry_after_s`` is how long until the requested tokens will
    have refilled — the honest hint for a 429 Retry-After header.
    """

    def __init__(self, rate: float, burst: float = 0.0,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(self.rate, 1.0)
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> tuple[bool, float]:
        if self.rate <= 0:
            return True, 0.0
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            deficit = n - self._tokens
            return False, deficit / self.rate

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tokens": round(self._tokens, 3)}


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission knobs. Zeros disable the matching gate."""

    rate: float = 0.0          # requests/second; 0 = unlimited
    burst: float = 0.0         # bucket capacity; 0 = max(rate, 1)
    weight: float = 1.0        # fair-share weight under global pressure
    max_concurrency: int = 0   # in-flight ceiling; 0 = unlimited


class TenantAdmission:
    """Weighted-fair, quota-enforcing admission over many tenants.

    ``admit(tenant)`` -> ``(allowed, retry_after_s, reason)`` where
    ``reason`` is one of ``""`` (admitted), ``"quota"``, ``"concurrency"``
    or ``"fair-share"``. Every admitted request MUST be paired with a
    ``release(tenant)`` (use try/finally), mirroring the LoadShedder's
    try_acquire/release contract.

    An unknown tenant gets the default ``TenantQuota()`` — unlimited
    rate, weight 1 — so admission is never a routing gate, only a
    fairness one.
    """

    def __init__(self, watermark: int = 0, retry_after_s: float = 1.0,
                 clock=time.monotonic):
        self.watermark = int(watermark)
        self.retry_after_s = float(retry_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self._admitted: dict[str, int] = {}
        self._shed: dict[str, dict[str, int]] = {}

    def configure(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota
            self._buckets[tenant] = TokenBucket(
                quota.rate, quota.burst, clock=self._clock)
            self._inflight.setdefault(tenant, 0)
            self._admitted.setdefault(tenant, 0)
            self._shed.setdefault(
                tenant, {"quota": 0, "concurrency": 0, "fair-share": 0})

    def remove(self, tenant: str) -> None:
        with self._lock:
            for d in (self._quotas, self._buckets, self._inflight,
                      self._admitted, self._shed):
                d.pop(tenant, None)

    def _ensure(self, tenant: str) -> TenantQuota:
        q = self._quotas.get(tenant)
        if q is None:
            q = TenantQuota()
            self._quotas[tenant] = q
            self._buckets[tenant] = TokenBucket(0.0, clock=self._clock)
            # pio: lint-ok[attr-no-lock] _ensure is only called with
            # self._lock held (admit/release/snapshot lock first)
            self._inflight.setdefault(tenant, 0)
            # pio: lint-ok[attr-no-lock] same: caller holds self._lock
            self._admitted.setdefault(tenant, 0)
            # pio: lint-ok[attr-no-lock] same: caller holds self._lock
            self._shed.setdefault(
                tenant, {"quota": 0, "concurrency": 0, "fair-share": 0})
        return q

    def admit(self, tenant: str) -> tuple[bool, float, str]:
        with self._lock:
            quota = self._ensure(tenant)
            bucket = self._buckets[tenant]
            # 1. rate quota (cheapest, and the per-tenant signal)
            allowed, retry_after = bucket.try_acquire(1.0)
            if not allowed:
                self._shed[tenant]["quota"] += 1
                return False, max(retry_after, 0.001), "quota"
            # 2. per-tenant concurrency ceiling
            mine = self._inflight[tenant]
            if quota.max_concurrency > 0 and mine >= quota.max_concurrency:
                self._shed[tenant]["concurrency"] += 1
                return False, self.retry_after_s, "concurrency"
            # 3. weighted-fair share, only under global pressure
            if self.watermark > 0:
                total = sum(self._inflight.values())
                if total >= self.watermark:
                    weights = sum(
                        q.weight for q in self._quotas.values()) or 1.0
                    share = self.watermark * (quota.weight / weights)
                    if mine >= max(share, 1.0):
                        self._shed[tenant]["fair-share"] += 1
                        return False, self.retry_after_s, "fair-share"
            self._inflight[tenant] = mine + 1
            self._admitted[tenant] += 1
            return True, 0.0, ""

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 0:
                self._inflight[tenant] = n - 1

    def shed_total(self, tenant: str) -> int:
        with self._lock:
            return sum(self._shed.get(tenant, {}).values())

    def snapshot(self) -> dict[str, dict]:
        """Per-tenant admission state for /fleet.json, doctor, and the
        tenant= Prometheus labels."""
        with self._lock:
            out = {}
            for tenant in sorted(self._quotas):
                q = self._quotas[tenant]
                shed = dict(self._shed.get(tenant, {}))
                out[tenant] = {
                    "quotaQps": q.rate,
                    "burst": self._buckets[tenant].burst
                    if q.rate > 0 else 0.0,
                    "weight": q.weight,
                    "maxConcurrency": q.max_concurrency,
                    "inflight": self._inflight.get(tenant, 0),
                    "admitted": self._admitted.get(tenant, 0),
                    "shed": shed,
                    "shedTotal": sum(shed.values()),
                }
            return out
