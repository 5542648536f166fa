"""Replicated, self-healing event store: quorum writes, hinted
handoff, anti-entropy repair.

The reference leans on HBase for a replicated event store (region
replicas + WAL shipping); every other backend here — and every shard of
``ShardedEventsDAO`` — is a single copy, so one lost storage backend
used to mean acknowledged events were gone. This module composes R
replica backends (any local ``EventsDAO`` or the ``remote`` client for a
storage server) into ONE events DAO that survives replica loss:

  * **quorum writes** — every write fans to all R replicas in parallel
    (per-replica ``CircuitBreaker`` + a short ``RetryPolicy``, chaos
    point ``storage.replica<i>.<method>``) and acks once W succeeded.
    Event ids are minted BEFORE the fan so replays are idempotent on
    every backend (memory/SQL upsert by id, eventlog dedupe window).
  * **hinted handoff** — a write that missed a down replica lands in a
    durable per-replica ``FrameLog`` (utils/durable: CRC32C frame per
    record, fsync'd append, atomic compaction) BEFORE the ack, and a
    background drain replays hints once the replica rejoins. A corrupt
    hint record is skipped and counted, never a crash or a half-applied
    write.
  * **read failover + bounded read-repair** — reads prefer a healthy
    replica (closed breaker, empty hint log) and fail over on transient
    errors; a ``get`` that misses on one replica but hits on another
    repairs the misser (bounded by a per-process budget — repair is an
    optimization, the scrubber is the guarantee).
  * **anti-entropy scrub** — per replica, the full columnar read
    (``find_columnar`` — the binary ``POST /rpc/columnar`` frame when
    the replica is remote) is bucketed by event-time hour and each
    bucket reduced to a CRC32C digest of its canonicalized rows; only
    buckets whose digests diverge are re-read as full events and the
    union re-shipped to the deficient replicas. Missed deletes rely on
    the hint log (anti-entropy without tombstones would resurrect
    them); the scrubber converges inserts.

Config (events-only source, metadata/models stay unsharded like the
``sharded`` backend)::

    PIO_STORAGE_SOURCES_R_TYPE=replicated
    # remote replicas (one storage server each):
    PIO_STORAGE_SOURCES_R_URLS=http://h1:7072,http://h2:7072,http://h3:7072
    # or in-process replicas (tests/bench/dev):
    PIO_STORAGE_SOURCES_R_TYPES=sqlite,sqlite,sqlite
    PIO_STORAGE_SOURCES_R_PATHS=/d1/pio.db,/d2/pio.db,/d3/pio.db
    PIO_STORAGE_SOURCES_R_WRITE_QUORUM=2       # default: majority
    PIO_STORAGE_SOURCES_R_HINT_DIR=/var/pio/hints
    PIO_STORAGE_SOURCES_R_SCRUB_INTERVAL_S=300   # 0 (default) = manual
    PIO_STORAGE_SOURCES_R_DRAIN_INTERVAL_S=0.5

Also composable under the sharded store for per-shard-group
replication: ``PIO_STORAGE_SOURCES_SH_URLS=a|b,c|d`` gives 2 shards x 2
replicas (data/backends/sharded.py).

Operational surface: ``pio doctor --storage`` (per-replica
live/breaker/hint-depth/last-scrub, exit 1 on lost quorum),
``/metrics`` on the event server (hint depth, scrub divergence, quorum
write latency histogram — see docs/storage.md "Replication").

Copy of ``pio_tpu.data.backends.replicated``, imports rewritten to the
port. The code trims nothing; of the operational surface above, the
port has no ``pio doctor`` yet: the scrub runs through ``scrub`` /
``scrub_all`` and the replicas' state reads from
``replication_status``. The event server's ``/metrics`` is as in the
reference.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from bisect import bisect_left
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Iterable, Iterator, Sequence

from pio_tpu_torch.data import dao as daomod
from pio_tpu_torch.data.backends import wire as w
from pio_tpu_torch.data.backends.common import new_event_ids
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import (
    Backend, StorageClientConfig, StorageError, _load_backend_class,
)
from pio_tpu_torch.resilience import CircuitBreaker, Deadline, RetryPolicy, is_transient
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.resilience.policies import OPEN
from pio_tpu_torch.utils.durable import FrameLog, crc32c, durable_write

log = logging.getLogger("pio_tpu_torch.replicated")

# Replica-level retry is deliberately SHORT: a replica failure is
# absorbed by the quorum + the hint log, so long per-replica retrying
# only adds write latency for everyone — unlike the single-backend
# STORAGE_RETRY, where a retry is the only alternative to failing the
# request.
REPLICA_RETRY = RetryPolicy(
    attempts=2, base_delay_s=0.01, max_delay_s=0.05, budget_s=0.2,
)

# anti-entropy bucket width: one digest per event-time hour — coarse
# enough that a steady store is a handful of digests, fine enough that
# repair re-ships an hour of one app, not the whole log
SCRUB_BUCKET_US = 3600 * 1_000_000

# quorum-write latency histogram bucket upper bounds (seconds)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5)


class QuorumLostError(ConnectionError):
    """Fewer than W replicas acknowledged a write. ConnectionError
    subclass so the whole resilience stack treats it as transient — the
    event server spills the batch, retries redeliver with the SAME
    event ids (minted before the fan), and every backend dedupes."""

    def __init__(self, message: str, acked: int = 0, needed: int = 0):
        super().__init__(message)
        self.acked = acked
        self.needed = needed


def _hint_dir_default() -> str:
    home = os.environ.get(
        "PIO_TPU_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu"))
    return os.path.join(home, "hints", "eventdata")


class ReplicatedEventsDAO(daomod.EventsDAO):
    """See module docstring. ``replicas`` are fully-formed EventsDAOs;
    each is ONE complete copy of the event data."""

    def __init__(self, replicas: list[daomod.EventsDAO], *,
                 write_quorum: int | None = None,
                 hint_dir: str | None = None,
                 probes: list | None = None,
                 drain_interval_s: float = 0.5,
                 scrub_interval_s: float = 0.0,
                 retry: RetryPolicy = REPLICA_RETRY,
                 read_repair_budget: int = 256,
                 point_prefix: str = "storage"):
        if not replicas:
            raise StorageError("replicated backend needs at least one replica")
        n = len(replicas)
        self.replicas = replicas
        self.write_quorum = write_quorum or (n // 2 + 1)
        if not 1 <= self.write_quorum <= n:
            raise StorageError(
                f"write quorum {self.write_quorum} out of range for "
                f"{n} replicas")
        self.hint_dir = hint_dir or _hint_dir_default()
        os.makedirs(self.hint_dir, exist_ok=True)
        self.hint_logs = [
            FrameLog(os.path.join(self.hint_dir, f"replica{i}.hints"))
            for i in range(n)
        ]
        self.breakers = [
            CircuitBreaker(f"{point_prefix}.replica{i}") for i in range(n)
        ]
        self.probes = probes
        self.retry = retry
        self._point_prefix = point_prefix
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, n), thread_name_prefix="replfan")
        self._lock = threading.Lock()
        self._namespaces: set[tuple[int, int | None]] = set()
        # counters (under self._lock)
        self.hinted_total = 0
        self.drained_total = 0
        self.hints_dropped_total = 0   # permanently uninsertable hints
        self.read_repairs_total = 0
        self._repair_budget = read_repair_budget
        # oldest pending hint enqueue time per replica (wall clock), for
        # the doctor's lag column; seeded from the surviving log
        self._hint_oldest: list[float | None] = [None] * n
        for i, hl in enumerate(self.hint_logs):
            if hl.depth():
                payloads, _, _ = hl.scan()
                self._hint_oldest[i] = self._first_hint_ts(payloads)
        # quorum-write latency histogram: cumulative counts per bucket
        self._lat_counts = [0] * (len(LATENCY_BUCKETS_S) + 1)
        self._lat_sum = 0.0
        self._lat_n = 0
        # scrub state persisted (durably) so doctor sees the last run
        # even from a fresh process
        self._scrub_state_path = os.path.join(self.hint_dir, "scrub.json")
        self._scrub_state = self._load_scrub_state()
        self._stop = threading.Event()
        self._drain_interval_s = drain_interval_s
        self._drain_thread: threading.Thread | None = None
        self._scrub_thread: threading.Thread | None = None
        if any(hl.depth() for hl in self.hint_logs):
            self._ensure_drain_thread()
        if scrub_interval_s > 0:
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, args=(scrub_interval_s,),
                name="replica-scrub", daemon=True)
            self._scrub_thread.start()

    # -- per-replica guarded call -------------------------------------------

    def _call(self, i: int, method: str, *args, **kwargs):
        """One replica call through the full policy stack: deadline ->
        breaker -> chaos point ``<prefix>.replica<i>.<method>`` -> the
        replica DAO, under the short replica RetryPolicy."""
        point = f"{self._point_prefix}.replica{i}.{method}"
        breaker = self.breakers[i]
        dao = self.replicas[i]

        def attempt(*a, **kw):
            Deadline.check(point)
            with breaker.guard():
                chaos.maybe_inject(point)
                return getattr(dao, method)(*a, **kw)

        return self.retry.call(attempt, *args, retry_if=is_transient,
                               **kwargs)

    # -- namespace lifecycle ------------------------------------------------

    def _note_namespace(self, app_id: int, channel_id: int | None) -> None:
        with self._lock:
            self._namespaces.add((app_id, channel_id))

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._note_namespace(app_id, channel_id)
        results = self._fan_write(
            "init", (app_id, channel_id),
            hint=lambda: {"op": "init", "appId": app_id,
                          "channelId": channel_id})
        return all(bool(r) for r in results)

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._namespaces.discard((app_id, channel_id))
        results = self._fan_write(
            "remove", (app_id, channel_id),
            hint=lambda: {"op": "remove", "appId": app_id,
                          "channelId": channel_id})
        return any(bool(r) for r in results)

    def close(self) -> None:
        self._stop.set()
        for t in (self._drain_thread, self._scrub_thread):
            if t is not None:
                t.join(timeout=2)
        for r in self.replicas:
            try:
                r.close()
            except Exception as e:  # noqa: BLE001 - a dead replica must
                # not block shutting the rest down
                log.debug("replica close failed: %s", e)
        self._pool.shutdown(wait=False)

    # -- quorum writes ------------------------------------------------------

    def _fan_write(self, method: str, args: tuple, hint) -> list:
        """Fan one write to every replica, wait for ALL outcomes, append
        a durable hint for each transiently-failed replica, then ack iff
        >= W succeeded. Waiting for all (instead of returning at W)
        keeps the hint-before-ack ordering: an acked write is either on
        a replica or in its hint log the moment the caller sees the
        ack. Non-transient failures (validation, uninitialized
        namespace) are config/usage bugs and surface immediately — a
        hint cannot fix them.

        ``hint`` is a zero-arg CALLABLE building the hint record —
        serializing a 500-event batch into hint shape costs more than
        the memory-backend insert itself, so the all-replicas-healthy
        hot path must never pay it."""
        t0 = time.perf_counter()
        futs = {
            i: self._pool.submit(self._call, i, method, *args)
            for i in range(len(self.replicas))
        }
        results: list = []
        failures: dict[int, BaseException] = {}
        for i in range(len(self.replicas)):
            try:
                results.append(futs[i].result())
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                failures[i] = e
        ok = len(self.replicas) - len(failures)
        if ok < self.write_quorum:
            first = next(iter(failures.values()))
            raise QuorumLostError(
                f"write quorum lost: {ok}/{len(self.replicas)} replicas "
                f"acknowledged {method} (need {self.write_quorum}): {first}",
                acked=ok, needed=self.write_quorum) from first
        if failures:
            rec = hint()
            for i in failures:
                self._append_hint(i, rec)
        self._observe_write(time.perf_counter() - t0)
        return results

    def insert(self, event: Event, app_id: int,
               channel_id: int | None = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: int | None = None) -> list[str]:
        # mint ids BEFORE the fan: replicas must store the same id, and
        # retries/hint replays/spill redeliveries must be idempotent
        events = list(events)
        missing = [k for k, e in enumerate(events) if e.event_id is None]
        for k, eid in zip(missing, new_event_ids(len(missing))):
            events[k] = events[k].with_id(eid)
        self._note_namespace(app_id, channel_id)
        self._fan_write(
            "insert_batch", (events, app_id, channel_id),
            hint=lambda: {"op": "insert_batch", "appId": app_id,
                          "channelId": channel_id,
                          "events": [self._event_to_hint(e)
                                     for e in events]})
        return [e.event_id for e in events]

    def delete(self, event_id: str, app_id: int,
               channel_id: int | None = None) -> bool:
        results = self._fan_write(
            "delete", (event_id, app_id, channel_id),
            hint=lambda: {"op": "delete_many", "appId": app_id,
                          "channelId": channel_id,
                          "eventIds": [event_id]})
        return any(bool(r) for r in results)

    def delete_many(self, event_ids: Sequence[str], app_id: int,
                    channel_id: int | None = None) -> int:
        ids = list(event_ids)
        results = self._fan_write(
            "delete_many", (ids, app_id, channel_id),
            hint=lambda: {"op": "delete_many", "appId": app_id,
                          "channelId": channel_id, "eventIds": ids})
        # replicas may transiently disagree (a diverged replica missed
        # some inserts); the max over acks is the true existed-count
        return max(int(r) for r in results)

    # -- reads: failover + bounded read-repair ------------------------------

    def _read_order(self) -> list[int]:
        """Healthy first: closed breaker and an empty hint log (pending
        hints mean the replica is KNOWN to be missing acked writes —
        reading it would serve a stale view while a healthy sibling
        exists). Open-breaker replicas go last, not skipped: with every
        sibling down they are still the only chance."""
        def key(i: int):
            return (self.breakers[i].state == OPEN,
                    self.hint_logs[i].depth() > 0, i)

        return sorted(range(len(self.replicas)), key=key)

    def _read(self, method: str, *args, **kwargs):
        last: BaseException | None = None
        for i in self._read_order():
            try:
                return self._call(i, method, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                last = e
        raise last  # every replica failed transiently

    def find(self, app_id: int, channel_id: int | None = None,
             start_time: datetime | None = None,
             until_time: datetime | None = None,
             entity_type: str | None = None,
             entity_id: str | None = None,
             event_names: Sequence[str] | None = None,
             target_entity_type=..., target_entity_id=...,
             limit: int | None = None,
             reversed: bool = False) -> Iterator[Event]:
        """Failover find. A remote replica's unbounded find is a LAZY
        keyset pager whose first RPC fires at iteration — after `_call`
        (and its breaker guard) already returned — so the first element
        is pulled EAGERLY here: a down replica fails over to a healthy
        sibling (and its breaker learns about it) instead of surfacing
        a ConnectionError in the caller's loop. A failure later in the
        iteration still propagates unretried — the same mid-iteration
        contract as ResilientDAO, documented there."""
        import itertools

        kw = dict(
            channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=reversed)
        last: BaseException | None = None
        for i in self._read_order():
            try:
                it = iter(self._call(i, "find", app_id, **kw))
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                last = e
                continue
            try:
                first = next(it)
            except StopIteration:
                return iter(())
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                # the guard closed before the lazy pager's first RPC:
                # record the failure so the breaker still learns
                self.breakers[i].record(False)
                last = e
                continue
            return itertools.chain([first], it)
        raise last

    def find_columnar(self, app_id: int, channel_id: int | None = None,
                      start_time: datetime | None = None,
                      until_time: datetime | None = None,
                      entity_type: str | None = None,
                      entity_id: str | None = None,
                      event_names: Sequence[str] | None = None,
                      target_entity_type=..., target_entity_id=...):
        return self._read(
            "find_columnar", app_id, channel_id=channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id)

    def columnarize(self, app_id: int, channel_id: int | None = None,
                    start_time: datetime | None = None,
                    until_time: datetime | None = None,
                    entity_type: str | None = None,
                    event_names: Sequence[str] | None = None,
                    target_entity_type=..., value_key: str | None = "rating",
                    default_value: float = 1.0, dedup: str = "last",
                    value_event: str | None = None):
        return self._read(
            "columnarize", app_id, channel_id=channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, event_names=event_names,
            target_entity_type=target_entity_type, value_key=value_key,
            default_value=default_value, dedup=dedup,
            value_event=value_event)

    def aggregate_properties(self, app_id: int, entity_type: str,
                             channel_id: int | None = None,
                             start_time: datetime | None = None,
                             until_time: datetime | None = None,
                             required: Iterable[str] | None = None) -> dict:
        return self._read(
            "aggregate_properties", app_id, entity_type, channel_id,
            start_time=start_time, until_time=until_time,
            required=required)

    def get(self, event_id: str, app_id: int,
            channel_id: int | None = None) -> Event | None:
        """Failover get with bounded read-repair: a miss on an earlier
        replica that a later replica answers is divergence observed
        first-hand — repair the missers (budget-bounded; the scrubber
        remains the convergence guarantee)."""
        missed: list[int] = []
        last: BaseException | None = None
        answered = False
        for i in self._read_order():
            try:
                ev = self._call(i, "get", event_id, app_id, channel_id)
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                last = e
                continue
            answered = True
            if ev is not None:
                for j in missed:
                    self._maybe_read_repair(j, ev, app_id, channel_id)
                return ev
            missed.append(i)
        if answered:
            return None
        raise last

    def _maybe_read_repair(self, i: int, event: Event, app_id: int,
                           channel_id: int | None) -> None:
        with self._lock:
            if self._repair_budget <= 0:
                return
            self._repair_budget -= 1
            self.read_repairs_total += 1

        def repair():
            try:
                self._call(i, "insert", event, app_id, channel_id)
            except Exception as e:  # noqa: BLE001 - best-effort: the
                # scrubber converges what a failed repair misses
                log.debug("read-repair of %s onto replica %d failed: %s",
                          event.event_id, i, e)

        self._pool.submit(repair)

    # -- hinted handoff ------------------------------------------------------

    @staticmethod
    def _event_to_hint(e: Event) -> dict:
        """The hint codec: the public wire dict PLUS exact-microsecond
        timestamps. The API wire's ISO timestamps are MILLISECOND-
        granular (reference compat), so a hint replayed through the
        plain wire shape would store an event 0-999µs off the copies
        the live replicas hold — a permanent false divergence the
        scrubber would chase forever. The µs fields restore the exact
        datetimes on replay."""
        from pio_tpu_torch.data.columnar import _micros, _tz_minutes

        d = w.event_to_wire(e)
        d["eventTimeUs"] = _micros(e.event_time)
        d["eventTzMin"] = _tz_minutes(e.event_time)
        d["creationTimeUs"] = _micros(e.creation_time)
        d["creationTzMin"] = _tz_minutes(e.creation_time)
        return d

    @staticmethod
    def _event_from_hint(d: dict) -> Event:
        from pio_tpu_torch.data.columnar import _restore_time

        e = w.event_from_wire(d)
        if "eventTimeUs" in d:
            # bare __dict__ write like with_id: Event is frozen, and
            # this hint-decoded instance is aliased nowhere else yet
            e.__dict__["event_time"] = _restore_time(
                d["eventTimeUs"], d.get("eventTzMin", 0))
        if "creationTimeUs" in d:
            e.__dict__["creation_time"] = _restore_time(
                d["creationTimeUs"], d.get("creationTzMin", 0))
        return e

    @staticmethod
    def _first_hint_ts(payloads: list[bytes]) -> float | None:
        for p in payloads:
            try:
                # pio: lint-ok[hot-loop-alloc] health/status path, not a
                # data plane: returns on the FIRST parseable record
                return float(json.loads(p)["t"])
            except (ValueError, KeyError, TypeError):
                continue
        return None

    def _append_hint(self, i: int, hint: dict) -> None:
        rec = dict(hint)
        # pio: lint-ok[bench-clock] wall-clock on purpose: the hint age
        # is read by doctor from OTHER processes/restarts, where a
        # monotonic origin is meaningless
        rec["t"] = time.time()
        # pio: lint-ok[attr-no-lock] FrameLog.append is internally
        # locked (utils/durable.py); the list itself is never mutated
        self.hint_logs[i].append(
            json.dumps(rec, separators=(",", ":")).encode("utf-8"))
        with self._lock:
            self.hinted_total += 1
            if self._hint_oldest[i] is None:
                self._hint_oldest[i] = rec["t"]
        self._ensure_drain_thread()

    def _ensure_drain_thread(self) -> None:
        with self._lock:
            if self._drain_thread is not None or self._stop.is_set():
                return
            self._drain_thread = threading.Thread(
                target=self._drain_loop, name="replica-hint-drain",
                daemon=True)
            self._drain_thread.start()

    def _call_ns(self, i: int, method: str, *args, app_id: int,
                 channel_id: int | None):
        """A namespaced replica call that survives a WIPED rejoiner: a
        replica that came back with a fresh store raises StorageError
        (namespace not initialized) on its first write — init it
        (idempotent on every backend) and retry once, so hint drain and
        scrub repair can rebuild it from zero. A TRANSIENT StorageError
        (remote wrapper around an unreachable server) propagates — the
        replica is down, not wiped."""
        try:
            return self._call(i, method, *args)
        except StorageError as e:
            if is_transient(e):
                raise
            self._call(i, "init", app_id, channel_id)
            return self._call(i, method, *args)

    def _apply_hint(self, i: int, payload: bytes) -> None:
        rec = json.loads(payload.decode("utf-8"))
        op = rec.get("op")
        app_id, channel_id = rec.get("appId"), rec.get("channelId")
        if op == "insert_batch":
            events = [self._event_from_hint(d) for d in rec["events"]]
            self._call_ns(i, "insert_batch", events, app_id, channel_id,
                          app_id=app_id, channel_id=channel_id)
        elif op == "delete_many":
            self._call_ns(i, "delete_many", rec["eventIds"], app_id,
                          channel_id, app_id=app_id, channel_id=channel_id)
        elif op == "init":
            self._call(i, "init", app_id, channel_id)
        elif op == "remove":
            self._call(i, "remove", app_id, channel_id)
        else:
            raise ValueError(f"unknown hint op {op!r}")

    def drain_hints(self, i: int) -> bool:
        """Replay replica i's pending hints in order. Returns True when
        the log is empty afterwards. A transient failure stops the
        replay (the replica is still down — remaining hints stay); a
        permanent failure (malformed record, validation error) drops
        THAT hint loudly and continues, so one poison record cannot
        wedge everything behind it. Applied and dropped records are
        compacted out atomically; records appended concurrently
        survive."""
        hl = self.hint_logs[i]
        if hl.depth() == 0:
            return True
        payloads, corrupt, scanned = hl.scan()
        remaining: list[bytes] = []
        stopped = False
        for p in payloads:
            if stopped:
                remaining.append(p)
                continue
            try:
                self._apply_hint(i, p)
            except Exception as e:  # noqa: BLE001 - classified below
                if is_transient(e):
                    stopped = True
                    remaining.append(p)
                else:
                    log.error(
                        "dropping uninsertable hint for replica %d: %s",
                        i, e)
                    with self._lock:
                        self.hints_dropped_total += 1
            else:
                with self._lock:
                    self.drained_total += 1
        hl.rewrite_prefix(remaining, scanned, corrupt_dropped=corrupt)
        with self._lock:
            self._hint_oldest[i] = (self._first_hint_ts(remaining)
                                    if remaining else None)
        return hl.depth() == 0

    def _drain_loop(self) -> None:
        interval = self._drain_interval_s
        while not self._stop.wait(timeout=interval):
            progressed = False
            for i in range(len(self.replicas)):
                if self.hint_logs[i].depth() == 0:
                    continue
                if self.breakers[i].state == OPEN:
                    continue  # replica declared down: wait out the open
                try:
                    before = self.hint_logs[i].depth()
                    self.drain_hints(i)
                    progressed |= self.hint_logs[i].depth() < before
                except Exception as e:  # noqa: BLE001 - the drain must
                    # never die; the next tick retries
                    log.warning("hint drain for replica %d failed: %s",
                                i, e)
            interval = (self._drain_interval_s if progressed
                        else min(5.0, interval * 2))

    # -- anti-entropy scrub ---------------------------------------------------

    def _canonical_rows(self, cols) -> dict[int, list]:
        """ColumnarEvents -> bucket -> canonical row tuples. Property
        payloads are JSON-canonicalized (sorted keys) so a dict-order
        difference between a local store and a wire round trip can
        never fake a divergence."""
        buckets: dict[int, list] = {}
        n = len(cols)
        for k in range(n):
            t = int(cols.time_us[k])
            tc = int(cols.target_code[k])
            props = cols.props(k)
            row = (
                t, int(cols.tz_min[k]),
                cols.event_names[int(cols.event_code[k])],
                cols.entity_ids[int(cols.entity_code[k])],
                cols.target_ids[tc] if tc >= 0 else "",
                json.dumps(props, sort_keys=True, separators=(",", ":"))
                if props else "",
            )
            buckets.setdefault(t // SCRUB_BUCKET_US, []).append(row)
        return buckets

    def _bucket_digests(self, i: int, app_id: int,
                        channel_id: int | None) -> dict[int, int] | None:
        """Per-bucket CRC32C digests of replica i's canonicalized rows,
        or None when the replica is unreachable (a dead replica cannot
        be scrubbed — it catches up via hints on rejoin). The read
        rides ``find_columnar``, i.e. the binary columnar frame over
        POST /rpc/columnar for remote replicas."""
        try:
            cols = self._call(i, "find_columnar", app_id,
                              channel_id=channel_id)
        except Exception as e:  # noqa: BLE001 - classified below
            # transience FIRST: a RemoteBackend wraps an unreachable
            # server in StorageError (transient via its cause chain),
            # and digesting a merely-DOWN replica as "empty" would fake
            # total divergence + a doomed repair storm
            if is_transient(e):
                return None
            if isinstance(e, StorageError):
                # namespace genuinely not initialized on this replica:
                # digest as empty so init divergence shows, not hides
                return {}
            raise
        out: dict[int, int] = {}
        for b, rows in self._canonical_rows(cols).items():
            rows.sort()
            out[b] = crc32c(json.dumps(
                rows, separators=(",", ":")).encode("utf-8"))
        return out

    def _repair_bucket(self, live: list[int], bucket: int, app_id: int,
                       channel_id: int | None) -> int:
        """Union-merge one divergent bucket: read the bucket window as
        FULL events (ids included) from every live replica, then ship
        each replica the events it lacks — idempotent by event id."""
        from pio_tpu_torch.data.columnar import _restore_time

        start = _restore_time(bucket * SCRUB_BUCKET_US, 0)
        until = _restore_time((bucket + 1) * SCRUB_BUCKET_US, 0)
        per_replica: dict[int, dict[str, Event]] = {}
        for i in live:
            try:
                per_replica[i] = {
                    e.event_id: e for e in self._call(
                        i, "find", app_id, channel_id=channel_id,
                        start_time=start, until_time=until, limit=-1)
                }
            except Exception as e:  # noqa: BLE001 - classified below
                if is_transient(e):
                    continue  # died mid-scrub: skipped this round
                if isinstance(e, StorageError):
                    # wiped rejoiner: nothing stored, still a target
                    per_replica[i] = {}
                else:
                    raise
        union: dict[str, Event] = {}
        for evs in per_replica.values():
            union.update(evs)
        repaired = 0
        for i, evs in per_replica.items():
            missing = [union[eid] for eid in union if eid not in evs]
            if not missing:
                continue
            self._call_ns(i, "insert_batch", missing, app_id, channel_id,
                          app_id=app_id, channel_id=channel_id)
            repaired += len(missing)
        return repaired

    def scrub(self, app_id: int, channel_id: int | None = None,
              repair: bool = True) -> dict:
        """One anti-entropy pass over one namespace. With repair=False
        this is a read-only convergence check (the doctor's mode)."""
        self._note_namespace(app_id, channel_id)
        digests: dict[int, dict[int, int]] = {}
        for i in range(len(self.replicas)):
            d = self._bucket_digests(i, app_id, channel_id)
            if d is not None:
                digests[i] = d
        live = sorted(digests)
        all_buckets = sorted({b for d in digests.values() for b in d})
        divergent = [
            b for b in all_buckets
            if len({digests[i].get(b) for i in live}) > 1
        ]
        repaired = 0
        if repair:
            for b in divergent:
                repaired += self._repair_bucket(live, b, app_id, channel_id)
        result = {
            "appId": app_id, "channelId": channel_id,
            "bucketsChecked": len(all_buckets),
            "divergentBuckets": len(divergent),
            "repairedEvents": repaired,
            "replicasScrubbed": len(live),
            "repair": repair,
        }
        self._record_scrub(result)
        return result

    def scrub_all(self, repair: bool = True) -> list[dict]:
        """Scrub every namespace this DAO has seen (init/insert)."""
        with self._lock:
            namespaces = sorted(
                self._namespaces,
                key=lambda ns: (ns[0], -1 if ns[1] is None else ns[1]))
        return [self.scrub(a, c, repair=repair) for a, c in namespaces]

    def _scrub_loop(self, interval_s: float) -> None:
        while not self._stop.wait(timeout=interval_s):
            try:
                self.scrub_all(repair=True)
            except Exception as e:  # noqa: BLE001 - the scrubber must
                # never die; the next tick retries
                log.warning("anti-entropy scrub failed: %s", e)

    def _load_scrub_state(self) -> dict:
        try:
            from pio_tpu_torch.utils.durable import durable_read

            return json.loads(durable_read(self._scrub_state_path))
        except (OSError, ValueError):
            return {}

    def _record_scrub(self, result: dict) -> None:
        state = {
            # pio: lint-ok[bench-clock] wall-clock on purpose: the
            # persisted scrub time is read across process restarts
            "lastScrubTs": time.time(),
            "lastResult": result,
        }
        with self._lock:
            self._scrub_state = state
        try:
            durable_write(
                self._scrub_state_path,
                json.dumps(state, separators=(",", ":")).encode("utf-8"))
        except OSError as e:
            log.warning("could not persist scrub state: %s", e)

    # -- observability --------------------------------------------------------

    def _observe_write(self, seconds: float) -> None:
        idx = bisect_left(LATENCY_BUCKETS_S, seconds)
        with self._lock:
            self._lat_counts[idx] += 1
            self._lat_sum += seconds
            self._lat_n += 1

    def replication_status(self, probe: bool = False) -> dict:
        """The doctor/metrics snapshot: per-replica breaker state, hint
        depth + oldest-hint age, optional live probes, lifetime
        counters, the quorum-latency histogram, and the last scrub."""
        # pio: lint-ok[bench-clock] hint ages are wall-clock by design
        # (cross-process, cross-restart — see _append_hint)
        now = time.time()
        replicas = []
        for i in range(len(self.replicas)):
            live = None
            if probe:
                if self.probes is not None:
                    try:
                        self.probes[i]()
                        live = True
                    except Exception:  # noqa: BLE001 - probe = down
                        live = False
                else:
                    live = self.breakers[i].state != OPEN
            with self._lock:
                oldest = self._hint_oldest[i]
            replicas.append({
                "replica": i,
                "breaker": self.breakers[i].state,
                "hintDepth": self.hint_logs[i].depth(),
                "hintOldestAgeSeconds":
                    (now - oldest) if oldest is not None else None,
                # finalized (compacted-out) + still-on-disk damage:
                # stable under repeated scans, counts each record once
                "hintsCorrupt": (self.hint_logs[i].corrupt_total
                                 + self.hint_logs[i].corrupt_pending),
                "live": live,
            })
        with self._lock:
            scrub_state = dict(self._scrub_state)
            lat = {
                "bucketsS": list(LATENCY_BUCKETS_S),
                "counts": list(self._lat_counts),
                "sumSeconds": self._lat_sum,
                "count": self._lat_n,
            }
            counters = {
                "hinted": self.hinted_total,
                "drained": self.drained_total,
                "hintsDropped": self.hints_dropped_total,
                "readRepairs": self.read_repairs_total,
            }
        out = {
            "replicas": replicas,
            "n": len(self.replicas),
            "writeQuorum": self.write_quorum,
            "hintDepthTotal": sum(r["hintDepth"] for r in replicas),
            "counters": counters,
            "quorumLatency": lat,
            "scrub": scrub_state,
        }
        if probe:
            live = sum(1 for r in replicas if r["live"])
            out["liveReplicas"] = live
            out["quorumOk"] = live >= self.write_quorum
        return out


class ReplicatedBackend(Backend):
    """Events-only composite over R replica backends (module docstring
    has the config grammar). Metadata/models stay on an unsharded,
    unreplicated-here source — same shape as the sharded backend."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        props = config.properties
        urls = [u.strip() for u in props.get("URLS", "").split(",")
                if u.strip()]
        types = [t.strip() for t in props.get("TYPES", "").split(",")
                 if t.strip()]
        self._children: list[Backend] = []
        probes: list = []
        if urls:
            from pio_tpu_torch.data.backends.remote import RemoteBackend
            from pio_tpu_torch.utils.httpclient import JsonHttpClient

            for u in urls:
                self._children.append(RemoteBackend(StorageClientConfig(
                    properties={
                        "URL": u,
                        "KEY": props.get("KEY", ""),
                        "TIMEOUT": props.get("TIMEOUT", "30"),
                        "VERIFY_TLS": props.get("VERIFY_TLS", "true"),
                    },
                    test=config.test,
                )))
                client = JsonHttpClient(u, timeout=3.0)
                probes.append(
                    lambda c=client: c.request("GET", "/healthz"))
        elif types:
            paths = [p.strip() for p in props.get("PATHS", "").split(",")
                     if p.strip()]
            # file-backed replicas MUST have one distinct PATH each: a
            # missing/short/duplicated PATHS list would default every
            # "replica" onto ONE store — quorum trivially green, doctor
            # happy, and losing that one file loses everything (the
            # exact failure class this backend exists to end). Memory
            # replicas are each their own store, so PATHS stays optional
            # for an all-memory (test/bench) set.
            if any(t != "memory" for t in types):
                if len(paths) != len(types):
                    raise StorageError(
                        "replicated backend: _TYPES with file-backed "
                        f"replicas needs one _PATHS entry per type "
                        f"({len(types)} types, {len(paths)} paths) — "
                        "pathless replicas would silently share one "
                        "default store")
                if len(set(paths)) != len(paths):
                    raise StorageError(
                        "replicated backend: _PATHS entries must be "
                        "distinct — replicas sharing a path are one "
                        "copy, not R")
            for k, t in enumerate(types):
                cls = _load_backend_class(t)
                child_props: dict[str, str] = {}
                if k < len(paths):
                    child_props["PATH"] = paths[k]
                self._children.append(cls(StorageClientConfig(
                    properties=child_props, test=config.test)))
                probes.append(lambda: True)
        else:
            raise StorageError(
                "replicated backend: set PIO_STORAGE_SOURCES_<N>_URLS "
                "(remote storage servers) or _TYPES (local backends)")
        quorum = int(props.get("WRITE_QUORUM", "0")) or None
        self._events = ReplicatedEventsDAO(
            [c.events() for c in self._children],
            write_quorum=quorum,
            hint_dir=props.get("HINT_DIR") or None,
            probes=probes,
            drain_interval_s=float(props.get("DRAIN_INTERVAL_S", "0.5")),
            scrub_interval_s=float(props.get("SCRUB_INTERVAL_S", "0")),
        )

    def events(self) -> daomod.EventsDAO:
        return self._events

    def close(self) -> None:
        self._events.close()
        for c in self._children:
            c.close()
