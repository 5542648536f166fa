"""Event-stream tail over the columnar batch path.

A tail poll answers one question cheaply: WHICH users gained
interactions since the cursor? It rides ``find_columnar`` (the
struct-of-arrays read — no per-event Python objects) and feeds the
window computation in :func:`tail_window`. The reference's
``HttpEventSource`` (the event server's ``GET /tail/events.json``) waits
for the port's event server.

The tail orders by EVENT TIME (the only time axis the storage query API
exposes). Server-stamped events — the normal ingest path, where
``eventTime`` defaults to receive time — tail losslessly; a client that
back-dates an event BEHIND the cursor is invisible to fold-in and is
picked up by the next full ``pio train`` (documented staleness
contract, docs/freshness.md). Events at exactly the boundary
microsecond are re-read every poll and deduplicated by the cursor's
per-user signatures, so the boundary can never drop a same-microsecond
straggler.

Folding then re-reads the touched users' FULL histories (per-entity
row reads — each is small) so the solve is a pure function of
(all of u's events, item factors): idempotent under replay, and
bit-comparable to a cold solve of the same events.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from pio_tpu_torch.data.event import Event
from pio_tpu_torch.freshness.cursor import FoldCursor

# microseconds <-> datetime helpers shared with the columnar layer
from pio_tpu_torch.data.columnar import _micros, _restore_time  # noqa: F401


@dataclass
class TailWindow:
    """One tail poll's verdict (see module docstring)."""

    to_fold: dict = field(default_factory=dict)   # user id -> oldest new µs
    time_us: int = -1                             # new cursor boundary
    boundary: dict = field(default_factory=dict)  # new boundary signatures
    n_rows: int = 0                               # rows scanned this poll


def tail_window(user_ids: Sequence, time_us: np.ndarray,
                cursor: FoldCursor) -> TailWindow:
    """Window verdict from decoded (user id, event µs) rows at or after
    the cursor. Pure and source-agnostic: the local columnar read and
    the HTTP tail payload both land here."""
    n = len(time_us)
    if n == 0:
        return TailWindow(time_us=cursor.time_us,
                          boundary=dict(cursor.boundary))
    t = np.asarray(time_us, dtype=np.int64)
    ids = np.asarray(user_ids, dtype=object)
    new_time = int(t.max())
    # per-user: any strictly-newer row, or a changed count at the old
    # boundary microsecond, triggers a refold
    uniq_users: dict = {}
    for j in range(n):
        u = ids[j]
        rec = uniq_users.get(u)
        if rec is None:
            uniq_users[u] = rec = {"newer": False, "at_boundary": 0,
                                   "oldest": int(t[j])}
        else:
            rec["oldest"] = min(rec["oldest"], int(t[j]))
        if t[j] > cursor.time_us:
            rec["newer"] = True
        elif t[j] == cursor.time_us:
            rec["at_boundary"] += 1
    to_fold: dict = {}
    for u, rec in uniq_users.items():
        if rec["newer"] or rec["at_boundary"] != cursor.boundary.get(u, 0):
            to_fold[u] = rec["oldest"]
    at_new = t == new_time
    boundary: dict = {}
    for u in ids[at_new]:
        boundary[u] = boundary.get(u, 0) + 1
    return TailWindow(to_fold=to_fold, time_us=new_time, boundary=boundary,
                      n_rows=n)


class LocalEventSource:
    """Tail + per-user history straight off the storage DAO (the
    in-process folder shape: ``pio foldin`` next to the event store)."""

    def __init__(self, storage, app_name: str,
                 channel_name: str | None = None,
                 entity_type: str = "user",
                 target_entity_type: str = "item",
                 event_names: Sequence[str] = ("rate", "buy")):
        from pio_tpu_torch.data.storage import StorageError

        self.storage = storage
        app = storage.get_metadata_apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"App {app_name!r} does not exist")
        self.app_id = app.id
        self.channel_id = None
        if channel_name is not None:
            for ch in storage.get_metadata_channels().get_by_appid(app.id):
                if ch.name == channel_name:
                    self.channel_id = ch.id
                    break
            else:
                raise StorageError(
                    f"Channel {channel_name!r} does not exist in app "
                    f"{app_name!r}")
        self.entity_type = entity_type
        self.target_entity_type = target_entity_type
        self.event_names = list(event_names)

    def window(self, cursor: FoldCursor) -> TailWindow:
        cols = self.storage.get_events().find_columnar(
            app_id=self.app_id,
            channel_id=self.channel_id,
            start_time=(_restore_time(cursor.time_us, 0)
                        if cursor.time_us >= 0 else None),
            entity_type=self.entity_type,
            event_names=self.event_names,
            target_entity_type=self.target_entity_type,
        )
        keep = np.asarray(cols.target_code) >= 0   # interactions only
        ids = np.asarray(cols.entity_ids, dtype=object)[
            np.asarray(cols.entity_code)[keep]]
        return tail_window(ids, np.asarray(cols.time_us)[keep], cursor)

    def history(self, user_id) -> list[Event]:
        return list(self.storage.get_events().find(
            app_id=self.app_id,
            channel_id=self.channel_id,
            entity_type=self.entity_type,
            entity_id=user_id,
            event_names=self.event_names,
            target_entity_type=self.target_entity_type,
            limit=-1,
        ))
