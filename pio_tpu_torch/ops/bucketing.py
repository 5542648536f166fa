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


#: rows every serving scoring product runs at: ``ServingConfig.batch_max``'s
#: default, the most the batchers coalesce. A query's row of a product is
#: then computed by the same kernel at the same shape whether the query is
#: scored alone, micro-batched or coalesced, so it answers the same bits
#: (the serving path's batch-invariance contract); a product's kernel, and
#: with it the order of its sums, otherwise follows the row count.
DISPATCH_ROWS = 64


def dispatch_rows(b: int) -> int:
    """Rows a scoring product of ``b`` live rows runs at: DISPATCH_ROWS, or
    the batch's power-of-two bucket above it (a bulk batch)."""
    return max(pow2_bucket(b), DISPATCH_ROWS)


def padded_rows(x, n: int):
    """``x`` with zero rows appended along dim 0 up to ``n`` rows."""
    if x.shape[0] >= n:
        return x
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out
