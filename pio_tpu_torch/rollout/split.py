"""Deterministic canary traffic split.

One pure function decides which arm serves a user: bucket
``crc32c(user_id) % 100`` (utils/durable.py's CRC32C — NEVER the
stdlib ``hash()``, which is salted per process; the single-host server,
every router replica, and every test oracle must agree across processes
and restarts). A user's bucket is a permanent property of their id, so

  * the split is STICKY: the same user hits the same arm for the whole
    rollout (no A/B flapping mid-session), and
  * ramping ``pct`` upward only ADDS users to the canary — everyone
    already in stays in, so per-user state (fold-ins, feedback) never
    oscillates between factor spaces.

This is the same determinism contract as the fleet's shard plan
(serving_fleet/plan.py ``shard_of``), applied to the traffic dimension.
"""

from __future__ import annotations

from pio_tpu_torch.utils.durable import crc32c


def canary_bucket(user_id) -> int:
    """The user's permanent 0-99 bucket (stable across processes)."""
    return crc32c(str(user_id).encode("utf-8")) % 100


def in_canary(user_id, pct: float) -> bool:
    """True when `user_id` belongs to a `pct`-percent canary. pct <= 0
    selects nobody; pct >= 100 selects everybody (the promote ramp's
    final stage)."""
    if pct <= 0:
        return False
    if pct >= 100:
        return True
    return canary_bucket(user_id) < pct
