"""Shared compile-cache bucketing.

Dynamic sizes (serving batch dims, per-query k) hitting a jitted
function compile one XLA program per distinct value; padding to the next
power of two bounds the cache at O(log) programs. One helper so the
rule has one spelling (used by ops/als.py, ops/similarity.py, and the
model batch_predict paths).
"""

from __future__ import annotations


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= max(n, 1), optionally capped at `cap`."""
    b = 1 << (max(int(n), 1) - 1).bit_length()
    return min(b, cap) if cap is not None else b
