"""Event storage backend on the native C++ append-only log.

The port's answer to the reference's HBase event store
(data/.../storage/hbase/HBLEvents.scala, HBPEvents.scala,
HBEventsUtil.scala:74-412): durable high-throughput ingest plus filtered
bulk scans for training, with the scan/columnarize inner loop in C++
(``pio_tpu_torch/native/eventlog.cpp``). One log file per (app, channel) namespace; deletes
are tombstones in a sidecar (the log itself is immutable, like HBase's
LSM model).

This source is events-only — pair it with sqlite/memory for METADATA and
localfs for MODELDATA, exactly how the reference pairs HBase (events) with
Elasticsearch (metadata) + HDFS (models).

Copy of ``pio_tpu.data.backends.eventlog``, imports rewritten to the port;
it trims nothing. A log written by either package reads in the other.
"""

from __future__ import annotations

import os
import shutil
import threading
from collections import deque
from datetime import datetime
from typing import Iterator, Sequence

from pio_tpu_torch.data import dao as d
from pio_tpu_torch.data.backends.common import apply_limit, match_event, new_event_id
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Backend, StorageError
from pio_tpu_torch.native.eventlog import (
    DEDUP_LAST,
    DEDUP_NONE,
    DEDUP_SUM,
    Columns,
    EventLog,
    ScanFilter,
    pack_tombstones,
)


def _default_root() -> str:
    home = os.environ.get(
        "PIO_TPU_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu")
    )
    return os.path.join(home, "eventlog")


class EventLogBackend(Backend):
    def __init__(self, config):
        super().__init__(config)
        self.root = config.properties.get("PATH", _default_root())
        os.makedirs(self.root, exist_ok=True)
        self._events = _EventLogEvents(self.root)

    def events(self):
        return self._events

    def close(self):
        self._events.close()


class _Namespace:
    """Open handles + tombstone cache for one (app, channel)."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self.log = EventLog(os.path.join(dir_path, "events.log"))
        self.tomb_path = os.path.join(dir_path, "tombstones.bin")
        self.tombstones: set[str] = set()
        self._tomb_blob = b""
        if os.path.exists(self.tomb_path):
            with open(self.tomb_path, "rb") as f:
                self._tomb_blob = f.read()
            import struct

            pos = 0
            while pos + 2 <= len(self._tomb_blob):
                # pio: lint-ok[wire-codec] reads the tombstone file
                # pack_tombstones (native/eventlog.py, the sanctioned
                # record-codec owner) writes — same module-pair as the
                # event records themselves, not a second codec
                (n,) = struct.unpack_from("<H", self._tomb_blob, pos)
                pos += 2
                self.tombstones.add(
                    self._tomb_blob[pos:pos + n].decode("utf-8")
                )
                pos += n

    def add_tombstone(self, event_id: str) -> None:
        blob = pack_tombstones([event_id])
        with open(self.tomb_path, "ab") as f:
            f.write(blob)
        # pio: lint-ok[attr-no-lock] only called under _EventLogEvents._lock
        self._tomb_blob += blob
        # pio: lint-ok[attr-no-lock] only called under _EventLogEvents._lock
        self.tombstones.add(event_id)

    @property
    def tomb_blob(self) -> bytes:
        return self._tomb_blob

    def close(self):
        self.log.close()


class _EventLogEvents(d.EventsDAO):
    def __init__(self, root: str):
        self.root = root
        # warm the native library before anyone holds self._lock: the
        # first _Namespace would otherwise trigger the one-time g++
        # build inside the lock, stalling every concurrent insert/find
        # behind a compiler run (deep lint baselines the residual
        # static findings in deep_baseline.json)
        from pio_tpu_torch.native import load_library
        try:
            load_library("eventlog")
        except Exception:
            pass  # surfaced properly on first real use
        self._ns_cache: dict[tuple[int, int | None], _Namespace] = {}
        self._lock = threading.RLock()
        # per-namespace recent supplied-id window (see insert): FIFO of
        # ids + membership set, both bounded by RECENT_ID_WINDOW
        self._recent_ids: dict[
            tuple[int, int | None], tuple[deque, set]] = {}

    def _dir(self, app_id: int, channel_id: int | None) -> str:
        name = f"app_{app_id}" if channel_id is None else f"app_{app_id}_ch_{channel_id}"
        return os.path.join(self.root, name)

    def _ns(self, app_id: int, channel_id: int | None) -> _Namespace:
        key = (app_id, channel_id)
        with self._lock:
            ns = self._ns_cache.get(key)
            if ns is None:
                path = self._dir(app_id, channel_id)
                if not os.path.isdir(path):
                    raise StorageError(
                        f"events namespace not initialized for app {app_id} "
                        f"channel {channel_id} (call init first)"
                    )
                ns = _Namespace(path)
                self._ns_cache[key] = ns
            return ns

    # -- namespace lifecycle -------------------------------------------------
    def init(self, app_id, channel_id=None):
        with self._lock:
            os.makedirs(self._dir(app_id, channel_id), exist_ok=True)
            return True

    def remove(self, app_id, channel_id=None):
        with self._lock:
            ns = self._ns_cache.pop((app_id, channel_id), None)
            # removed data's ids may legitimately reappear (re-import)
            self._recent_ids.pop((app_id, channel_id), None)
            if ns is not None:
                ns.close()
            path = self._dir(app_id, channel_id)
            if os.path.isdir(path):
                shutil.rmtree(path)
                return True
            return False

    def close(self):
        with self._lock:
            for ns in self._ns_cache.values():
                ns.close()
            self._ns_cache.clear()

    # -- CRUD ----------------------------------------------------------------
    # supplied-id dedupe window size (per namespace). Phantom retries —
    # resilience.RetryPolicy re-inserting after a failure whose original
    # actually committed, or a spill-drain racing its original — land
    # within the retry budget (~seconds), so a bounded recent-id window
    # catches them all at O(1) per insert and bounded memory. A full
    # get() scan per insert would be O(log size) under the append lock
    # (ingest collapse as the log grows); an unbounded id set would be
    # O(total events) RAM.
    RECENT_ID_WINDOW = 4096

    def insert(self, event: Event, app_id, channel_id=None):
        # id-idempotent on a CALLER-supplied id within the recent window:
        # the log is append-only, so a retried insert would otherwise
        # append a second record that find()/columnarize() count twice.
        # Check and append under ONE lock hold — a get-then-append would
        # let two concurrent retries of the same id both pass the check.
        with self._lock:
            ns = self._ns(app_id, channel_id)
            eid = event.event_id or new_event_id()
            if event.event_id is not None:
                order, seen = self._recent_ids.setdefault(
                    (app_id, channel_id), (deque(), set()))
                if eid in seen:
                    return eid
                order.append(eid)
                seen.add(eid)
                if len(order) > self.RECENT_ID_WINDOW:
                    seen.discard(order.popleft())
            ns.log.append(event.with_id(eid))
            return eid

    def insert_batch(self, events, app_id, channel_id=None):
        """Bulk append under ONE lock hold, with the same supplied-id
        dedupe window as insert (a retried batch whose original partially
        committed must not double-append)."""
        with self._lock:
            ns = self._ns(app_id, channel_id)
            order = seen = None
            out = []
            for event in events:
                eid = event.event_id or new_event_id()
                if event.event_id is not None:
                    if order is None:
                        order, seen = self._recent_ids.setdefault(
                            (app_id, channel_id), (deque(), set()))
                    if eid in seen:
                        out.append(eid)
                        continue
                    order.append(eid)
                    seen.add(eid)
                    if len(order) > self.RECENT_ID_WINDOW:
                        seen.discard(order.popleft())
                ns.log.append(event.with_id(eid))
                out.append(eid)
            return out

    def insert_api_batch(
        self,
        raw: bytes,
        app_id,
        channel_id=None,
        allowed_events=None,
        single: bool = False,
        max_events: int = 0,
    ):
        """Native ingest fast path: raw JSON request body -> validated,
        packed, appended records, one C call (EventLog.ingest_batch).
        Returns [(status, id_or_message, event_name, entity_type)].
        Raises ValueError (malformed body) / BatchTooLarge."""
        from pio_tpu_torch.utils.time import utcnow

        with self._lock:
            ns = self._ns(app_id, channel_id)
            return ns.log.ingest_batch(
                raw, list(allowed_events or ()), utcnow(),
                single=single, max_events=max_events,
            )

    def get(self, event_id, app_id, channel_id=None):
        with self._lock:
            ns = self._ns(app_id, channel_id)
            if event_id in ns.tombstones:
                return None
            hits = ns.log.scan(ScanFilter(event_id=event_id), ns.tomb_blob)
        # exact check (hash prefilter can false-positive); last write wins
        hits = [e for e in hits if e.event_id == event_id]
        return hits[-1] if hits else None

    def delete(self, event_id, app_id, channel_id=None):
        with self._lock:
            if self.get(event_id, app_id, channel_id) is None:
                return False
            self._ns(app_id, channel_id).add_tombstone(event_id)
            return True

    def delete_many(self, event_ids, app_id, channel_id=None):
        """Bulk tombstone: ONE existence scan for the whole batch instead
        of the per-id get() (a full log scan each) the base loop would do
        — retention cleanups over large logs stay a single pass."""
        ids = [e for e in event_ids if e]
        if not ids:
            return 0
        with self._lock:
            ns = self._ns(app_id, channel_id)
            want = set(ids) - ns.tombstones
            if not want:
                return 0
            existing = {
                e.event_id
                for e in ns.log.scan(ScanFilter(), ns.tomb_blob)
                if e.event_id in want
            }
            for eid in existing:
                ns.add_tombstone(eid)
            return len(existing)

    # -- query ---------------------------------------------------------------
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            ns = self._ns(app_id, channel_id)
            f = ScanFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=list(event_names) if event_names is not None else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
            )
            evs = ns.log.scan(f, ns.tomb_blob)
        evs = [
            e
            for e in evs
            if match_event(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        ]
        return iter(apply_limit(evs, limit, reversed))

    # -- training fast path --------------------------------------------------
    def columnarize(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        value_key: str | None = "rating",
        default_value: float = 1.0,
        dedup: str = "last",
        value_event: str | None = None,
    ) -> Columns:
        """Native one-sweep interactions extraction (see EventLog.columnarize);
        the accelerated counterpart of eventstore.to_interactions."""
        mode = {"none": DEDUP_NONE, "last": DEDUP_LAST, "sum": DEDUP_SUM}[dedup]
        with self._lock:
            ns = self._ns(app_id, channel_id)
            return ns.log.columnarize(
                ScanFilter(
                    start_time=start_time,
                    until_time=until_time,
                    entity_type=entity_type,
                    event_names=list(event_names)
                    if event_names is not None else None,
                    target_entity_type=target_entity_type,
                ),
                value_key=value_key,
                default_value=default_value,
                dedup=mode,
                tombstones=ns.tomb_blob,
                value_event=value_event,
            )
