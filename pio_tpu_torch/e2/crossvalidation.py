"""k-fold cross-validation splitters.

Reference e2/.../evaluation/CrossValidation.scala:9-39 `splitData`: fold i's
test set is every example whose index % k == i; train is the rest. Same
index-mod-k contract here, vectorized over numpy columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np

from pio_tpu_torch.data.eventstore import Interactions


@dataclass(frozen=True)
class FoldInfo:
    fold: int
    k: int


def split_indices(n: int, k: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """-> [(train_idx, test_idx)] per fold, index-mod-k."""
    idx = np.arange(n)
    return [((idx % k) != f, (idx % k) == f) for f in range(k)]


def split_data(
    rows: Sequence[Any], k: int
) -> list[tuple[list[Any], FoldInfo, list[Any]]]:
    """Generic splitter over a row list (reference splitData shape)."""
    out = []
    for f in range(k):
        train = [r for i, r in enumerate(rows) if i % k != f]
        test = [r for i, r in enumerate(rows) if i % k == f]
        out.append((train, FoldInfo(f, k), test))
    return out


def split_interactions(
    data: Interactions,
    k: int,
    num: int = 10,
    exclude_seen: bool = True,
) -> list[tuple[Interactions, FoldInfo, list[tuple[dict, Any]]]]:
    """Interactions -> k folds of (train, info, [(query, actual)]).

    Queries follow the recommendation template shape {"user", "num"}; the
    actual is the list of held-out item ids for that user (what the metric
    layer scores against, reference MetricEvaluator input shape).

    exclude_seen (default): each query carries the user's TRAIN-fold items
    as blackList, and heldout actuals are deduped against that blackList
    (a blacklisted item is unhittable by construction — leaving it in the
    actuals would deflate every engine's score). Without the blacklist the
    metric mostly measures how much of the top-k an engine wastes on
    reconstruction (standard unseen-item evaluation; the reference's
    ecommerce template applies the same seen-filter at serve time)."""
    if k <= 1:
        return []
    n = len(data)
    # one numpy group-by over the FULL dataset (per-user row slices +
    # fold tags), instead of k Python passes over the train folds
    order = np.lexsort((data.item_idx, data.user_idx))
    u_sorted = data.user_idx[order]
    i_sorted = data.item_idx[order]
    f_sorted = (order % k).astype(np.int64)  # fold of each row
    bounds = np.flatnonzero(
        np.concatenate([[True], u_sorted[1:] != u_sorted[:-1], [True]])
    )
    folds: list[tuple[Interactions, FoldInfo, list[tuple[dict, Any]]]] = []
    for train_mask, test_mask in split_indices(n, k):
        f = len(folds)
        train = Interactions(
            user_idx=data.user_idx[train_mask],
            item_idx=data.item_idx[train_mask],
            values=data.values[train_mask],
            users=data.users,
            items=data.items,
        )
        qa: list[tuple[dict, Any]] = []
        for s, e in zip(bounds[:-1], bounds[1:]):
            in_test = f_sorted[s:e] == f
            test_items = i_sorted[s:e][in_test]
            if not len(test_items):
                continue
            u = int(u_sorted[s])
            q: dict = {"user": data.users.id_of(u), "num": num}
            if exclude_seen:
                seen = np.unique(i_sorted[s:e][~in_test])
                if len(seen):
                    q["blackList"] = data.items.decode(seen)
                    # actuals the blacklist makes unhittable are dropped
                    test_items = test_items[
                        ~np.isin(test_items, seen)]
                    if not len(test_items):
                        qa.append((q, []))  # metric scores this as None
                        continue
            qa.append((q, data.items.decode(test_items)))
        folds.append((train, FoldInfo(f, k), qa))
    return folds
