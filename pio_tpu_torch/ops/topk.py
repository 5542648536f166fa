"""Top-k in the reference's order.

``jax.lax.top_k`` orders by score and, among equal scores, puts the lower
index first; that rule also decides which of several tied entries makes
the cut at k. ``torch.topk`` promises no order among ties, and ALS gives
identical factors to items with identical rating sets, so exact ties do
reach the served rankings. Every ranking the port's serving does on the
device goes through ``topk_lowest_index``.
"""

from __future__ import annotations

import torch


def topk_lowest_index(x: torch.Tensor, k: int):
    """The k largest entries along the last dim of ``x``, ordered by
    (-score, index): (values, indices), as ``jax.lax.top_k`` gives them.
    A stable descending sort keeps equal scores in index order, so the
    first k of it are the reference's selection in the reference's
    order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
