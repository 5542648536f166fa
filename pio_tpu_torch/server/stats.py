"""In-memory ingest statistics with hourly cutoff.

Reference data/.../api/Stats.scala:27-96 + StatsActor.scala:28-75: per-app
counters keyed by (event name, entityType, status), kept for the previous
and current hour, served at /stats.json.
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass
from datetime import datetime, timedelta

from pio_tpu_torch.utils.time import utcnow


@dataclass(frozen=True)
class KV:
    app_id: int
    status: int
    event: str
    entity_type: str


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self._hour_start = self._floor_hour(utcnow())
        self._current: Counter = Counter()
        self._previous: Counter = Counter()
        # lifetime totals: the hourly windows above serve /stats.json
        # (reference parity), but Prometheus counters must be monotonic.
        # Keys are client-controlled (event/entity_type strings), so the
        # table is CAPPED: past TOTAL_KEY_CAP distinct keys, new ones
        # fold into one overflow bucket — without it, unique event names
        # (IDs/timestamps embedded by a buggy integration, or a hostile
        # client) grow memory and scrape size without bound, where the
        # hourly windows were naturally pruned.
        self._total: Counter = Counter()

    TOTAL_KEY_CAP = 10_000
    OVERFLOW_KEY = KV(-1, 0, "_overflow", "_overflow")

    @staticmethod
    def _floor_hour(dt: datetime) -> datetime:
        return dt.replace(minute=0, second=0, microsecond=0)

    def _cutoff(self, now: datetime):
        hour = self._floor_hour(now)
        if hour > self._hour_start:
            if hour - self._hour_start == timedelta(hours=1):
                self._previous = self._current
            else:
                self._previous = Counter()
            self._current = Counter()
            self._hour_start = hour

    def update(self, app_id: int, status: int, event: str, entity_type: str):
        with self._lock:
            self._cutoff(utcnow())
            kv = KV(app_id, status, event, entity_type)
            self._current[kv] += 1
            if kv in self._total or len(self._total) < self.TOTAL_KEY_CAP:
                self._total[kv] += 1
            else:
                self._total[self.OVERFLOW_KEY] += 1

    def totals(self) -> dict:
        """Lifetime (KV -> count) snapshot for the Prometheus surface."""
        with self._lock:
            return dict(self._total)

    def get(self, app_id: int) -> dict:
        """Counts for the previous full hour + current hour so far."""
        with self._lock:
            self._cutoff(utcnow())

            def rows(c: Counter):
                return [
                    {
                        "event": k.event,
                        "entityType": k.entity_type,
                        "status": k.status,
                        "count": n,
                    }
                    for k, n in sorted(
                        c.items(), key=lambda kv: (kv[0].event, kv[0].status)
                    )
                    if k.app_id == app_id
                ]

            return {
                "hourStart": self._hour_start.isoformat(),
                "currentHour": rows(self._current),
                "previousHour": rows(self._previous),
            }
