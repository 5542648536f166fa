"""Batched fold-in solve: pending users → refreshed factor rows.

One solve call takes the pending users' FULL event histories, folds
them to (item, value) pairs with EXACTLY the training read's semantics
(``make_value_fn`` + the "last"-dedup rule of ``to_interactions``), and
solves one ridge system per user against the fixed item factors through
``ops/als.als_fold_in`` — the same ``_normal_equations`` the trainer
runs, not a fork of it — on the device the item factors are on.

Batches are pow2-bucketed on BOTH axes (pending users, total events) by
``als_fold_in`` itself, as in the reference. The solve is
batch-composition invariant bit-for-bit, on the CPU and on CUDA (see
``als_fold_in``): user u's refreshed row does not depend on who shares
the batch — the property the oracle parity tests pin.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from pio_tpu_torch.data.event import Event
from pio_tpu_torch.ops import als
from pio_tpu_torch.resilience import chaos

log = logging.getLogger("pio_tpu_torch.freshness")


def user_pairs(events: Iterable[Event],
               value_fn: Callable[[Event], float | None]) -> list[tuple]:
    """One user's events → deduplicated (item_id, value) pairs, with the
    training fold's exact semantics (``to_interactions`` dedup="last"):
    latest value per item by event time wins, pair order is first
    occurrence in time order. Shared by the folder AND the oracle tests
    so value extraction cannot drift from the solve contract."""
    vals: dict = {}
    for e in sorted(events, key=lambda ev: ev.event_time):
        if e.target_entity_id is None:
            continue
        v = value_fn(e)
        if v is None:
            continue
        vals[e.target_entity_id] = float(v)
    return list(vals.items())


class FoldInSolver:
    """See module docstring. ``max_batch_users`` bounds one device
    dispatch (and keeps the dense-id bucket well under the ops layer's
    ``auto_cg_rows`` exact-solve threshold)."""

    def __init__(self, params: als.ALSParams, max_batch_users: int = 1024):
        self.params = params
        self.max_batch_users = max(1, int(max_batch_users))

    def solve(
        self,
        item_factors,
        items_index,
        histories: Mapping[object, Sequence[Event]],
        value_fn: Callable[[Event], float | None],
    ) -> dict:
        """-> {user_id: (k,) float32 row} for every user with ≥ 1 known
        item. Users whose events reference only items absent from the
        model's item index are skipped (there is nothing to score them
        against until the next train) — callers leave them pending-free:
        re-tailing them without new events would busy-loop."""
        per_user: list[tuple] = []   # (user_id, item_idx arr, values arr)
        for uid, events in histories.items():
            pairs = user_pairs(events, value_fn)
            known = [(items_index.bimap.get(it, -1), v) for it, v in pairs]
            known = [(i, v) for i, v in known if i >= 0]
            if not known:
                continue
            idx = np.fromiter((i for i, _ in known), np.int32,
                              count=len(known))
            val = np.fromiter((v for _, v in known), np.float32,
                              count=len(known))
            per_user.append((uid, idx, val))
        out: dict = {}
        for lo in range(0, len(per_user), self.max_batch_users):
            chunk = per_user[lo:lo + self.max_batch_users]
            # chaos drill point: a spec targeting foldin.solve fails the
            # batch HERE — after histories were read, before any row is
            # produced — the "killed mid-batch" shape the freshness-chaos
            # CI job replays
            chaos.maybe_inject("foldin.solve")
            u = np.concatenate([
                np.full(len(idx), j, np.int32)
                for j, (_, idx, _) in enumerate(chunk)
            ])
            i = np.concatenate([idx for _, idx, _ in chunk])
            v = np.concatenate([val for _, _, val in chunk])
            rows = als.als_fold_in(
                item_factors, u, i, v, len(chunk), self.params).cpu().numpy()
            for j, (uid, _, _) in enumerate(chunk):
                out[uid] = rows[j]
        return out
