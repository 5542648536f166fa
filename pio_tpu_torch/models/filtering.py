"""Shared serve-time candidate filtering + ranking for the recommender
templates (similarproduct, ecommerce).

Counterpart of ``pio_tpu.models.filtering``: the reference templates'
isCandidateItem / whiteList / blackList / categories filtering before
their cosine/score loops (examples/scala-parallel-ecommercerecommendation/
train-with-rate-event/src/main/scala/ALSAlgorithm.scala:148-341,
examples/scala-parallel-similarproduct ALSAlgorithm.scala). The candidate
set is selected on the host (id-space work, ``invert_categories`` and
``candidate_ids`` as in the reference), then scored in ONE gather +
product + top-k on the factors' device (``rank_candidates``): candidate
counts are padded to powers of two, as in the reference, and the product
runs at ``ops.bucketing.DISPATCH_ROWS`` rows, as every serving product of
the port does.
"""

from __future__ import annotations

import numpy as np
import torch

from pio_tpu_torch.ops.bucketing import DISPATCH_ROWS, padded_rows, pow2_bucket
from pio_tpu_torch.ops.similarity import normalize_rows
from pio_tpu_torch.ops.topk import topk_lowest_index


def invert_categories(item_categories: dict) -> dict:
    """item id -> categories  =>  category -> [item ids]. Built once per
    model (cached by callers) so category-filtered queries select candidates
    in O(matching items), not O(catalog)."""
    inv: dict = {}
    for iid, cats in item_categories.items():
        for c in cats:
            inv.setdefault(c, []).append(iid)
    return inv


def candidate_ids(
    items_index,
    item_categories: dict,
    white,
    categories,
    exclude,
    cat_index: dict | None = None,
):
    """The candidate id list to rank within when selective filters apply;
    None when no selective filter is present (callers then use the
    full-catalog top-k path).

    items_index: EntityIdIndex; white/categories: sets or None; exclude: set;
    cat_index: invert_categories() result, or a zero-arg callable returning
    it (resolved only when a category filter is actually present, so
    filterless queries never pay the O(catalog) inversion). Used when
    categories is set and white is not, making selection cost O(matching
    items) not O(catalog).
    """
    if white is None and categories is None:
        return None
    if white is not None:
        ids = white
    else:
        if callable(cat_index):
            cat_index = cat_index()
        if cat_index is None:
            cat_index = invert_categories(item_categories)
        ids = set()
        for c in categories:
            ids.update(cat_index.get(c, ()))
        categories = None  # already applied via the index
    out = []
    # sorted: candidate order (and so top-k tie-breaks) must not depend on
    # per-process string-hash order — evals and serving stay reproducible
    for i in sorted(ids):
        if i in exclude or i not in items_index:
            continue
        if categories is not None and not (
            set(item_categories.get(i, ())) & categories
        ):
            continue
        out.append(i)
    return out


def rank_candidates(
    item_factors: torch.Tensor,
    qv,
    cidx: np.ndarray,
    num: int,
    normalize: bool = False,
):
    """Score candidate rows `cidx` of item_factors against query vector `qv`
    and return (positions_into_cidx, scores) for the top `num`, best first,
    as host arrays.

    The candidate count and k are padded/bucketed to powers of two, as the
    reference does; padded positions score -inf and are dropped. The query
    row is one of DISPATCH_ROWS rows of the product."""
    cidx = np.asarray(cidx, dtype=np.int64)
    n = len(cidx)
    if n == 0:
        return np.array([], np.int64), np.array([], np.float32)
    dev = item_factors.device
    bucket = pow2_bucket(n)
    cidx_p = np.concatenate([cidx, np.zeros(bucket - n, np.int64)])
    k = min(num, n)
    kb = pow2_bucket(k, cap=bucket)
    vecs = item_factors[torch.as_tensor(cidx_p, device=dev)]   # (C, d)
    q = torch.as_tensor(qv, dtype=item_factors.dtype,
                        device=dev).reshape(1, -1)
    if normalize:
        vecs = normalize_rows(vecs)
        q = normalize_rows(q)
    scores = (padded_rows(q, DISPATCH_ROWS) @ vecs.T)[0]
    scores = torch.where(torch.arange(bucket, device=dev) < n, scores,
                         torch.full_like(scores, -torch.inf))
    scores, pos = topk_lowest_index(scores, kb)
    scores, pos = scores[:k].cpu().numpy(), pos[:k].cpu().numpy()
    keep = pos < n  # drop any padding rows that slipped into top-k
    return pos[keep], scores[keep]
