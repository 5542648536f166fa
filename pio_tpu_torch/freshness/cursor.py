"""Durable fold-in cursor: where the folder resumes after a restart.

The cursor is a boundary on EVENT TIME (microseconds since epoch, the
columnar path's native clock) plus per-user signatures AT the boundary
microsecond:

  * every tail poll re-reads from the boundary INCLUSIVE — an event
    that lands at exactly the boundary microsecond between polls is
    seen, never skipped;
  * the signatures (user → matching-event count in the boundary window)
    make that re-read cheap to deduplicate: a boundary user refolds
    only when its count changed, so steady state does no repeat work;
  * re-folding is idempotent anyway (a fold is a pure function of the
    user's FULL history and the item factors), so the crash contract is
    at-least-once per event with identical results — the cursor only
    advances AFTER a successful apply.

Persistence rides utils/durable.py (``durable_write``: tmp + fsync +
atomic rename + CRC32C frame): a folder killed mid-save leaves either
the previous complete cursor or the new complete cursor, and bit-rot is
detected at load instead of silently rewinding to event 0. The ``pio
lint`` ``foldin-cursor`` rule enforces that no cursor/offset
persistence in this package bypasses that module.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field

from pio_tpu_torch.utils.durable import (
    ModelIntegrityError, durable_read, durable_write,
)

log = logging.getLogger("pio_tpu_torch.freshness")

CURSOR_VERSION = 1


@dataclass
class FoldCursor:
    """Resume state. ``time_us < 0`` means "from the beginning"."""

    time_us: int = -1
    # user id -> matching-event count in the window ending at time_us
    # (only users whose NEWEST event sits exactly at the boundary are
    # kept, so the map stays bounded by one microsecond of traffic)
    boundary: dict[str, int] = field(default_factory=dict)
    folded_total: int = 0          # lifetime applied fold-ins (observability)

    def to_json(self) -> str:
        return json.dumps({
            "version": CURSOR_VERSION,
            "timeUs": self.time_us,
            "boundary": self.boundary,
            "foldedTotal": self.folded_total,
        }, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "FoldCursor":
        d = json.loads(text)
        return FoldCursor(
            time_us=int(d.get("timeUs", -1)),
            boundary={str(k): int(v)
                      for k, v in (d.get("boundary") or {}).items()},
            folded_total=int(d.get("foldedTotal", 0)),
        )


class CursorStore:
    """Load/save a FoldCursor at a filesystem path, durably."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> FoldCursor:
        """The persisted cursor, or a fresh one when absent. A corrupt
        cursor file (failed CRC) is treated as absent — the folder then
        replays from the beginning, which is slow but correct (re-folds
        are idempotent); losing fold-ins would not be."""
        if not os.path.exists(self.path):
            return FoldCursor()
        try:
            return FoldCursor.from_json(
                durable_read(self.path).decode("utf-8"))
        except (ModelIntegrityError, ValueError, KeyError) as e:
            log.error("fold-in cursor %s unreadable (%s); replaying from "
                      "the beginning", self.path, e)
            return FoldCursor()

    def save(self, cursor: FoldCursor) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        durable_write(self.path, cursor.to_json().encode("utf-8"))
