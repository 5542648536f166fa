"""Shared backend helpers: event filtering, id generation, and the
wire pools' per-thread connection reuse/reconnect policy."""

from __future__ import annotations

import os
import time
import uuid
from contextlib import contextmanager
from datetime import datetime
from typing import Sequence

from pio_tpu_torch.data.event import Event

DEFAULT_FIND_LIMIT = 20  # reference EventServer.scala:351 default page size


def new_event_id() -> str:
    return uuid.uuid4().hex


def new_event_ids(n: int) -> list[str]:
    """Mint n event ids with ONE entropy syscall. uuid4() costs a
    16-byte urandom read each — measured at ~25% of the whole Python
    ingest pipeline at batch sizes; one 16n-byte read amortizes it.
    Same 32-hex-char opaque format as new_event_id."""
    if n <= 0:
        return []
    blob = os.urandom(16 * n).hex()
    return [blob[i * 32:(i + 1) * 32] for i in range(n)]


def match_event(
    e: Event,
    start_time: datetime | None = None,
    until_time: datetime | None = None,
    entity_type: str | None = None,
    entity_id: str | None = None,
    event_names: Sequence[str] | None = None,
    target_entity_type=...,
    target_entity_id=...,
) -> bool:
    """Predicate form of the reference's find filters (LEvents.scala:220-280).

    start_time inclusive, until_time exclusive; `...` = don't-care for the
    target-entity filters, None = must-be-absent.
    """
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not ... and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not ... and e.target_entity_id != target_entity_id:
        return False
    return True


def apply_limit(events: list[Event], limit: int | None, reversed_: bool) -> list[Event]:
    """Sort by eventTime (reversed = newest first) and page.

    limit semantics follow the reference: None -> default 20, -1 -> all.
    """
    events.sort(key=lambda e: e.event_time, reverse=reversed_)
    if limit is None:
        limit = DEFAULT_FIND_LIMIT
    if limit is not None and limit >= 0:
        events = events[:limit]
    return events


PING_IDLE_SEC = 30.0


def pooled_thread_conn(local, all_conns, lock, idle_sec: float, build):
    """Per-thread connection reuse policy shared by the wire pools
    (PgPool/MyPool): reuse the thread's cached connection, but after an
    idle gap > idle_sec ping it and transparently rebuild if dead
    (server restart / idle-timeout kill). Pinging every call would
    double round trips; idle-timeout kills only happen across gaps.

    The cached slot is cleared BEFORE rebuilding so a failed build()
    (server still booting) leaves the thread with no stale closed
    connection — the next call retries the build instead of failing on
    a dead socket until the idle window re-elapses. A connection that
    dies UNDER the idle window is recovered by the pools' execute
    wrappers calling evict_thread_conn on socket-level errors.
    """
    c = getattr(local, "conn", None)
    now = time.monotonic()
    if (c is not None
            and now - getattr(local, "last_use", now) > idle_sec
            and not c.ping()):
        evict_thread_conn(local, all_conns, lock)
        c = None
    if c is None:
        c = build()
        local.conn = c
        with lock:
            all_conns.append(c)
    local.last_use = now
    return c


def evict_thread_conn(local, all_conns, lock) -> None:
    """Drop the calling thread's cached connection after a socket-level
    failure so the next acquisition rebuilds immediately instead of
    retrying a dead socket until the idle-ping window elapses. Server
    ERROR responses (PgError/MyError) must NOT evict — the connection
    is fine; only transport errors mean it is gone."""
    c = getattr(local, "conn", None)
    if c is None:
        return
    local.conn = None
    with lock:
        if c in all_conns:
            all_conns.remove(c)
    try:
        c.close()
    except OSError:
        pass


@contextmanager
def guard_parse(error_cls):
    """Normalize parse failures on SERVER-controlled bytes into the
    dialect's ProtocolError — the type the pools' evict logic catches.
    A leaked ValueError/IndexError/UnicodeDecodeError (int()/decode()/
    base64 on a corrupted or desynced stream) would leave the poisoned
    connection cached per-thread (found by tests/test_wire_fuzz.py).
    One shared implementation so the dialects' caught-exception sets
    cannot drift."""
    try:
        yield
    except (ValueError, IndexError, KeyError, UnicodeDecodeError) as e:
        raise error_cls(
            f"malformed server response: {type(e).__name__}: {e}") from e
