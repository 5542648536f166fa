"""Deterministic evaluation splits over the columnar event path.

Copy of ``pio_tpu.tuning.splits`` (numpy only). Two split families
feed the sweep, both
seeded and bit-reproducible — rerunning a sweep over unchanged data
produces byte-identical fold assignments, which is what makes the
crash-resume drill's "resume == uninterrupted" contract checkable at
all:

 * ``seeded_kfold`` — k-fold over deduped COO interaction rows. Fold
   tags come from ``np.random.default_rng(seed).permutation(n) % k``:
   exactly balanced, seeded, and independent of the storage backend's
   row order beyond the deterministic stable time sort
   ``columnar_interactions`` already applies. (The legacy
   ``e2.crossvalidation.split_interactions`` index-mod-k split is the
   seed==None degenerate case and stays for the reference-parity
   tests.)
 * ``time_rolling_folds`` — event-time rolling ("forward chaining")
   splits straight off the columnar read (``find_columnar`` ->
   ``columnar_interactions``): fold f trains on every event before
   boundary b_f and tests on the window [b_f, b_{f+1}), boundaries at
   event-count quantiles. This is the split that respects the serving
   reality (models predict the future, not a random subsample).

Every fold's train split keeps the FULL user/item id tables, so factor
shapes are identical across folds and candidates — one compiled train
program serves the whole sweep (the compile-cache lever), and item
indices are comparable across folds at scoring time.

Determinism contract:
nothing in this module may read the wall clock, draw from an unseeded
RNG, or iterate a set where order reaches the fold assignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.columnar import ColumnarEvents, columnar_interactions
from pio_tpu_torch.data.eventstore import Interactions


@dataclass
class EvalFold:
    """One fold: a train split plus per-user heldout relevance.

    ``train`` shares the FULL id tables (see module doc); the test side
    is already index-encoded — ``actual_idx[j]`` / ``seen_idx[j]`` are
    the heldout / train-seen item indices of ``test_user_idx[j]``.
    Users whose heldout set is empty after the exclude-seen dedup are
    dropped (the Option-metric None semantics: unscorable, excluded)."""

    info: dict
    train: Interactions
    test_user_idx: np.ndarray            # (B,) int32
    actual_idx: list[np.ndarray] = field(default_factory=list)
    seen_idx: list[np.ndarray] = field(default_factory=list)

    @property
    def n_test_users(self) -> int:
        return len(self.test_user_idx)

    def qa_pairs(self, num: int = 10) -> list[tuple[dict, list]]:
        """The (query, actual) shape the generic Engine.eval path and
        the QPA metric contract consume — the recommendation template's
        {"user", "num", "blackList"} query against heldout item ids."""
        users = self.train.users
        items = self.train.items
        out = []
        for j, u in enumerate(self.test_user_idx):
            q: dict = {"user": users.id_of(int(u)), "num": num}
            seen = self.seen_idx[j]
            if len(seen):
                q["blackList"] = items.decode(seen)
            out.append((q, items.decode(self.actual_idx[j])))
        return out


def _user_groups(user_idx: np.ndarray, item_idx: np.ndarray,
                 tag: np.ndarray):
    """Sort rows by user and yield (user, items_in_group, tags_in_group)
    slices — one vectorized lexsort instead of a per-user Python scan."""
    order = np.lexsort((item_idx, user_idx))
    u_s = user_idx[order]
    i_s = item_idx[order]
    t_s = tag[order]
    bounds = np.flatnonzero(
        np.concatenate([[True], u_s[1:] != u_s[:-1], [True]]))
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield int(u_s[s]), i_s[s:e], t_s[s:e]


def _fold_from_masks(data: Interactions, train_mask: np.ndarray,
                     test_mask: np.ndarray, info: dict,
                     exclude_seen: bool) -> EvalFold:
    train = Interactions(
        user_idx=data.user_idx[train_mask],
        item_idx=data.item_idx[train_mask],
        values=data.values[train_mask],
        users=data.users,
        items=data.items,
    )
    test_users: list[int] = []
    actuals: list[np.ndarray] = []
    seens: list[np.ndarray] = []
    # tag: 1 = test row, 0 = train row, -1 = neither (other folds' train
    # rows in the rolling split still count as "seen" only when they
    # precede the boundary — callers encode that in the masks)
    tag = np.full(len(data), -1, np.int8)
    tag[train_mask] = 0
    tag[test_mask] = 1
    involved = train_mask | test_mask
    for u, items, tags in _user_groups(
            data.user_idx[involved], data.item_idx[involved],
            tag[involved]):
        test_items = np.unique(items[tags == 1]).astype(np.int32)
        if not len(test_items):
            continue
        seen = np.unique(items[tags == 0]).astype(np.int32)
        if exclude_seen and len(seen):
            test_items = test_items[~np.isin(test_items, seen)]
            if not len(test_items):
                continue
        test_users.append(u)
        actuals.append(test_items)
        seens.append(seen if exclude_seen else np.zeros(0, np.int32))
    return EvalFold(
        info=info,
        train=train,
        test_user_idx=np.array(test_users, np.int32),
        actual_idx=actuals,
        seen_idx=seens,
    )


def seeded_kfold(
    data: Interactions,
    k: int,
    seed: int = 42,
    exclude_seen: bool = True,
) -> list[EvalFold]:
    """Seeded, balanced k-fold over deduped interaction rows (see
    module doc). ``seed`` fully determines the assignment for a given
    row count — same data, same seed, same folds, bit-for-bit."""
    if k <= 1:
        raise ValueError(f"k-fold needs k >= 2, got {k}")
    n = len(data)
    tags = np.random.default_rng(seed).permutation(n) % k
    folds = []
    for f in range(k):
        test_mask = tags == f
        folds.append(_fold_from_masks(
            data, ~test_mask, test_mask,
            info={"kind": "kfold", "fold": f, "k": k, "seed": seed},
            exclude_seen=exclude_seen,
        ))
    return folds


def _interactions_with_times(
    cols: ColumnarEvents,
    value_key: str | None,
    default_value: float,
    dedup: str,
    value_event: str | None,
) -> tuple[Interactions, np.ndarray]:
    """Full-data Interactions plus each deduped row's effective event
    time (dedup="last": the pair's LAST occurrence — the time at which
    that interaction reached its final value; "sum"/"none": likewise the
    last/own occurrence). The time column is what the rolling split cuts
    on; the COO construction itself is columnar_interactions verbatim,
    so values/dedup semantics cannot drift from the training read."""
    full_cols = columnar_interactions(
        cols, value_key=value_key, default_value=default_value,
        dedup=dedup, value_event=value_event,
    )
    users = EntityIdIndex(full_cols.users)
    items = EntityIdIndex(full_cols.items)
    inter = Interactions(
        user_idx=full_cols.user_idx.astype(np.int32),
        item_idx=full_cols.item_idx.astype(np.int32),
        values=full_cols.values,
        users=users,
        items=items,
    )
    # effective time per deduped row: max event time over the (user,
    # item) pair's occurrences, computed with the same stable time sort
    # + target filter columnar_interactions applies
    n = len(cols)
    order = (np.argsort(cols.time_us, kind="stable") if n
             else np.zeros(0, np.int64))
    keep = order[cols.target_code[order] >= 0]
    ent_ids = np.array(cols.entity_ids, dtype=object)
    tgt_ids = np.array(cols.target_ids, dtype=object)
    # map raw event rows -> dense COO indices through the id tables
    u_raw = users.encode(ent_ids[cols.entity_code[keep]])
    i_raw = items.encode(tgt_ids[cols.target_code[keep]])
    pair_raw = u_raw.astype(np.int64) * max(len(items), 1) + i_raw
    pair_coo = (inter.user_idx.astype(np.int64) * max(len(items), 1)
                + inter.item_idx)
    times_raw = cols.time_us[keep]
    uniq, inverse = np.unique(pair_raw, return_inverse=True)
    last_t = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
    np.maximum.at(last_t, inverse, times_raw)
    times = last_t[np.searchsorted(uniq, pair_coo)]
    return inter, times


def time_rolling_folds(
    cols: ColumnarEvents,
    n_folds: int,
    value_key: str | None = "rating",
    default_value: float = 1.0,
    dedup: str = "last",
    value_event: str | None = None,
    exclude_seen: bool = True,
) -> list[EvalFold]:
    """Event-time rolling splits: boundaries at interaction-count
    quantiles; fold f trains on interactions strictly before b_f and
    tests on [b_f, b_{f+1}). Fully deterministic — no RNG at all; the
    boundaries are a pure function of the event times."""
    if n_folds < 1:
        raise ValueError(f"rolling split needs n_folds >= 1, got {n_folds}")
    data, times = _interactions_with_times(
        cols, value_key, default_value, dedup, value_event)
    n = len(data)
    if n < (n_folds + 1) * 2:
        raise ValueError(
            f"rolling split needs at least {(n_folds + 1) * 2} "
            f"interactions for {n_folds} fold(s), got {n}")
    t_sorted = np.sort(times, kind="stable")
    # boundary f sits at count-quantile (f+1)/(n_folds+1): the first
    # fold still trains on a meaningful prefix, the last tests on the
    # most recent window
    bounds = [
        int(t_sorted[min(n - 1, (f + 1) * n // (n_folds + 1))])
        for f in range(n_folds)
    ]
    bounds.append(int(t_sorted[-1]) + 1)
    folds = []
    for f in range(n_folds):
        lo, hi = bounds[f], bounds[f + 1]
        train_mask = times < lo
        test_mask = (times >= lo) & (times < hi)
        folds.append(_fold_from_masks(
            data, train_mask, test_mask,
            info={"kind": "time", "fold": f, "k": n_folds,
                  "boundaryUs": lo, "untilUs": hi},
            exclude_seen=exclude_seen,
        ))
    return folds


def folds_for(
    data_or_cols,
    split: str,
    k: int,
    seed: int = 42,
    exclude_seen: bool = True,
    value_key: str | None = "rating",
    default_value: float = 1.0,
    dedup: str = "last",
    value_event: str | None = None,
) -> list[EvalFold]:
    """Dispatch: ``split="kfold"`` takes an Interactions (or columnar
    events, folded here); ``split="time"`` needs ColumnarEvents (times
    live only on the raw event rows)."""
    if split == "kfold":
        if isinstance(data_or_cols, ColumnarEvents):
            data_or_cols, _ = _interactions_with_times(
                data_or_cols, value_key, default_value, dedup,
                value_event)
        return seeded_kfold(data_or_cols, k, seed=seed,
                            exclude_seen=exclude_seen)
    if split == "time":
        if not isinstance(data_or_cols, ColumnarEvents):
            raise ValueError(
                "time_rolling_folds needs the columnar event rows "
                "(find_columnar output) — Interactions carry no times")
        return time_rolling_folds(
            data_or_cols, k, value_key=value_key,
            default_value=default_value, dedup=dedup,
            value_event=value_event, exclude_seen=exclude_seen)
    raise ValueError(f"unknown split kind {split!r} "
                     "(expected 'kfold' or 'time')")
