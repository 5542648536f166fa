"""Horizontally sharded event store: N storage servers, entity-hash routing.

The reference's horizontal-scale story for events is HBase: rowkeys are
prefixed with a hash of the entity so events spread evenly across region
servers and time-range scans run in parallel per region
(the reference's data/src/main/scala/org/apache/predictionio/data/storage/
hbase/HBEventsUtil.scala:74-142, HBPEvents.scala region-split reads). This
deployment has no HBase; its scale-out unit is the storage
server (server/storageserver.py) — one process per host, each owning a
local durable backend (eventlog/sqlite). This backend composes N of them
into one EventsDAO:

 * writes route by a stable hash of (entity_type, entity_id) — the same
   distribution key as the reference's rowkey prefix — so one entity's
   history lives on exactly one shard and per-entity reads touch one host;
 * serve-time reads with both entity filters push down to that one shard;
 * bulk reads (training's find, aggregate_properties) scatter to all
   shards in parallel threads and merge — the analogue of the reference's
   region-parallel scan, with the per-shard `limit` pushed down so the
   merge never materializes more than n_shards * limit events;
 * event_id gets/deletes scatter (ids are uuid4 hex: shard-blind, exactly
   like HBase's rowkey-by-entity design where an eventId lookup also
   cannot be routed — HBEventsUtil builds rowkeys from entity, not id).

Events only, by design (the reference's HBase backend is events-only too);
metadata/models stay on a (small, rarely-written) unsharded source.

Config:
    PIO_STORAGE_SOURCES_SH_TYPE=sharded
    PIO_STORAGE_SOURCES_SH_URLS=http://host1:7072,http://host2:7072
    PIO_STORAGE_SOURCES_SH_KEY=...        # shared server key (optional)
    PIO_STORAGE_SOURCES_SH_TIMEOUT=30

Copy of ``pio_tpu.data.backends.sharded``, imports rewritten to the port;
it trims nothing.
"""

from __future__ import annotations

import hashlib
import heapq
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from datetime import datetime
from typing import Iterable, Iterator, Sequence

from pio_tpu_torch.data import dao as daomod
from pio_tpu_torch.data.backends.common import DEFAULT_FIND_LIMIT
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Backend, StorageClientConfig, StorageError


def shard_for(entity_type: str, entity_id: str, n_shards: int) -> int:
    """Stable entity -> shard routing (the rowkey-prefix hash of
    HBEventsUtil.scala:74-142, modulo instead of prefix-bucketed). sha1
    rather than Python hash(): stable across processes and runs — every
    writer and reader in the fleet must agree."""
    h = hashlib.sha1(
        entity_type.encode() + b"\x00" + entity_id.encode()).digest()
    return int.from_bytes(h[:8], "big") % n_shards


class ShardedEventsDAO(daomod.EventsDAO):
    def __init__(self, shards: list[daomod.EventsDAO]):
        if not shards:
            raise StorageError("sharded backend needs at least one shard")
        self.shards = shards
        self._pool = ThreadPoolExecutor(
            max_workers=len(shards), thread_name_prefix="shardfan")

    # -- fan-out helpers ----------------------------------------------------

    def _all(self, fn, *args, **kwargs) -> list:
        """Run fn(shard, ...) on every shard in parallel; surface the
        first failure (a partial scatter answer is a wrong answer)."""
        futs = [self._pool.submit(fn, s, *args, **kwargs)
                for s in self.shards]
        return [f.result() for f in futs]

    def _route(self, event: Event) -> daomod.EventsDAO:
        return self.shards[
            shard_for(event.entity_type, event.entity_id, len(self.shards))]

    # -- namespace lifecycle ------------------------------------------------

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        return all(self._all(lambda s: s.init(app_id, channel_id)))

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return all(self._all(lambda s: s.remove(app_id, channel_id)))

    def close(self) -> None:
        for s in self.shards:
            s.close()
        self._pool.shutdown(wait=False)

    # -- writes (entity-routed) ---------------------------------------------

    def insert(self, event: Event, app_id: int,
               channel_id: int | None = None) -> str:
        return self._route(event).insert(event, app_id, channel_id)

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: int | None = None) -> list[str]:
        # group by shard, one parallel bulk write per shard, then stitch
        # the returned ids back into input order
        groups: dict[int, list[int]] = {}
        for pos, e in enumerate(events):
            groups.setdefault(
                shard_for(e.entity_type, e.entity_id, len(self.shards)),
                []).append(pos)
        futs = {
            si: self._pool.submit(
                self.shards[si].insert_batch,
                [events[p] for p in positions], app_id, channel_id)
            for si, positions in groups.items()
        }
        out: list[str | None] = [None] * len(events)
        for si, positions in groups.items():
            for p, eid in zip(positions, futs[si].result()):
                out[p] = eid
        return out  # type: ignore[return-value]

    # -- id-keyed ops (scatter: uuid ids carry no shard) ---------------------

    def get(self, event_id: str, app_id: int,
            channel_id: int | None = None) -> Event | None:
        # return on the FIRST shard that has it — ids are unique, so a
        # hit is authoritative and need not wait for a slow sibling; a
        # full miss still awaits every shard so errors surface
        futs = [self._pool.submit(s.get, event_id, app_id, channel_id)
                for s in self.shards]
        for f in as_completed(futs):
            ev = f.result()
            if ev is not None:
                return ev
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: int | None = None) -> bool:
        return any(self._all(
            lambda s: s.delete(event_id, app_id, channel_id)))

    def delete_many(self, event_ids: Sequence[str], app_id: int,
                    channel_id: int | None = None) -> int:
        # one parallel bulk delete per shard instead of the inherited
        # ids x shards sequential loop; exact because event ids are
        # disjoint across shards (each id exists on at most one)
        ids = list(event_ids)
        return sum(self._all(
            lambda s: s.delete_many(ids, app_id, channel_id)))

    # -- queries ------------------------------------------------------------

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        kw = dict(
            channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=reversed,
        )
        if entity_type is not None and entity_id is not None:
            # serve-time read: one entity lives on exactly one shard
            shard = self.shards[
                shard_for(entity_type, entity_id, len(self.shards))]
            yield from shard.find(app_id, **kw)
            return
        # scatter with the limit pushed down (each shard returns its own
        # top-`limit` in time order, so the merged top-`limit` is exact),
        # then a heap-merge on event time preserving the DAO ordering
        per_shard = self._all(lambda s: list(s.find(app_id, **kw)))
        eff_limit = DEFAULT_FIND_LIMIT if limit is None else limit
        merged = heapq.merge(
            *per_shard, key=lambda e: e.event_time, reverse=reversed)
        for n, ev in enumerate(merged):
            if eff_limit >= 0 and n >= eff_limit:
                break
            yield ev

    def find_columnar(
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
    ):
        """Region-parallel bulk columnar read: every shard answers its
        own binary columnar frame (the remote backend's /rpc/columnar,
        decoded by pointer-cast) concurrently, and the per-shard batches
        are concatenated with codes remapped into one global dictionary
        and rows stable-sorted by event time (columnar.concat_columnar)
        — the exact row sequence the scatter ``find`` heap-merge
        produces, so tail/aggregate/interaction folds are bit-identical
        to the single-host read. An entity-pinned read (both filters
        set) pushes down to the one shard that owns the entity."""
        from pio_tpu_torch.data.columnar import concat_columnar

        kw = dict(
            channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        if entity_type is not None and entity_id is not None:
            shard = self.shards[
                shard_for(entity_type, entity_id, len(self.shards))]
            return shard.find_columnar(app_id, **kw)
        return concat_columnar(
            self._all(lambda s: s.find_columnar(app_id, **kw)))

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
    ):
        """Region-parallel training read (HBPEvents.scala role): every
        shard columnarizes ITS events server-side concurrently, then the
        per-shard dense codes are remapped into one global id space and
        concatenated. Dedup correctness is structural — but ONLY when
        entity_type is pinned: the routing key is (entity_type,
        entity_id) while the dedup key is (entity_id, target_id), so
        with entity_type=None two types sharing an id can land on
        different shards and their per-shard folds would both survive.
        That case falls back to a global find+fold. times_us is dropped
        in the merge (shards' clocks interleave; no consumer reads it
        from the composite)."""
        import numpy as np

        from pio_tpu_torch.native.eventlog import Columns

        if entity_type is None:
            from pio_tpu_torch.data.eventstore import (
                columnarize_via_find, interactions_to_columns,
            )

            return interactions_to_columns(columnarize_via_find(
                self, app_id, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, event_names=event_names,
                target_entity_type=target_entity_type,
                value_key=value_key, default_value=default_value,
                dedup=dedup, value_event=value_event))
        parts = self._all(
            lambda s: s.columnarize(
                app_id, channel_id=channel_id, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                event_names=event_names,
                target_entity_type=target_entity_type,
                value_key=value_key, default_value=default_value,
                dedup=dedup, value_event=value_event))
        users: dict[str, int] = {}
        items: dict[str, int] = {}
        u_cols, i_cols, v_cols = [], [], []
        for part in parts:
            if not len(part.values):
                continue
            u_map = np.fromiter(
                (users.setdefault(u, len(users)) for u in part.users),
                dtype=np.int64, count=len(part.users))
            i_map = np.fromiter(
                (items.setdefault(i, len(items)) for i in part.items),
                dtype=np.int64, count=len(part.items))
            u_cols.append(u_map[part.user_idx].astype(np.uint32))
            i_cols.append(i_map[part.item_idx].astype(np.uint32))
            v_cols.append(part.values)
        cat = (lambda xs, dt: np.concatenate(xs) if xs
               else np.empty(0, dtype=dt))
        return Columns(
            user_idx=cat(u_cols, np.uint32),
            item_idx=cat(i_cols, np.uint32),
            values=cat(v_cols, np.float32),
            times_us=np.empty(0, dtype=np.int64),
            users=list(users),
            items=list(items),
        )

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Iterable[str] | None = None,
    ) -> dict:
        # entities of one type spread across all shards, but each ENTITY
        # is wholly on one shard (the routing key), so the per-shard
        # aggregates have disjoint keys and a dict-merge is exact
        parts = self._all(
            lambda s: s.aggregate_properties(
                app_id, entity_type, channel_id,
                start_time=start_time, until_time=until_time,
                required=required))
        out: dict = {}
        for part in parts:
            out.update(part)
        return out


class ReplicatedShardedEventsDAO(ShardedEventsDAO):
    """Sharded composite whose shard groups are each a
    ``ReplicatedEventsDAO``: aggregates the per-group replication
    surface so ``pio doctor --storage`` and the event server's
    ``/metrics`` replication gauges work on the composed topology too
    (without this, the production config with the most moving parts
    would be the one with zero replication observability)."""

    def replication_status(self, probe: bool = False) -> dict:
        per_group = [s.replication_status(probe=probe)
                     for s in self.shards]
        replicas = []
        for si, st in enumerate(per_group):
            for r in st["replicas"]:
                replicas.append({**r, "replica": f"shard{si}/"
                                                 f"{r['replica']}"})
        counters: dict[str, int] = {}
        for st in per_group:
            for k, v in st["counters"].items():
                counters[k] = counters.get(k, 0) + v
        lat = {
            "bucketsS": per_group[0]["quorumLatency"]["bucketsS"],
            "counts": [
                sum(st["quorumLatency"]["counts"][k]
                    for st in per_group)
                for k in range(len(per_group[0]["quorumLatency"]
                               ["counts"]))],
            "sumSeconds": sum(st["quorumLatency"]["sumSeconds"]
                              for st in per_group),
            "count": sum(st["quorumLatency"]["count"]
                         for st in per_group),
        }
        # most recent group scrub stands in for the composite's row
        scrubs = [st["scrub"] for st in per_group if st.get("scrub")]
        scrub = max(scrubs, key=lambda s: s.get("lastScrubTs", 0),
                    default={})
        out = {
            "replicas": replicas,
            "n": sum(st["n"] for st in per_group),
            # display-only on the composite: quorum is PER GROUP; the
            # authoritative verdict is quorumOk below
            "writeQuorum": max(st["writeQuorum"] for st in per_group),
            "hintDepthTotal": sum(st["hintDepthTotal"]
                                  for st in per_group),
            "counters": counters,
            "quorumLatency": lat,
            "scrub": scrub,
            "groups": [
                {"shard": si, "n": st["n"],
                 "writeQuorum": st["writeQuorum"],
                 **({"liveReplicas": st["liveReplicas"],
                     "quorumOk": st["quorumOk"]}
                    if "quorumOk" in st else {})}
                for si, st in enumerate(per_group)],
        }
        if probe:
            out["liveReplicas"] = sum(st["liveReplicas"]
                                      for st in per_group)
            # EVERY group must hold its own quorum: one group below W
            # means that slice of the keyspace is failing writes
            out["quorumOk"] = all(st["quorumOk"] for st in per_group)
        return out

    def scrub(self, app_id: int, channel_id: int | None = None,
              repair: bool = True) -> dict:
        """Scrub every shard group's replica set (groups hold disjoint
        slices, so per-group results sum)."""
        parts = [s.scrub(app_id, channel_id, repair=repair)
                 for s in self.shards]
        return {
            "appId": app_id, "channelId": channel_id,
            "bucketsChecked": sum(p["bucketsChecked"] for p in parts),
            "divergentBuckets": sum(p["divergentBuckets"] for p in parts),
            "repairedEvents": sum(p["repairedEvents"] for p in parts),
            "replicasScrubbed": sum(p["replicasScrubbed"] for p in parts),
            "repair": repair,
        }

    def scrub_all(self, repair: bool = True) -> list[dict]:
        out: list[dict] = []
        for s in self.shards:
            out.extend(s.scrub_all(repair=repair))
        return out


class ShardedBackend(Backend):
    """Events-only composite over N remote storage servers.

    Per-shard-group replication (docs/storage.md "Replication"): a URL
    entry may itself be a ``|``-separated replica group —
    ``URLS=a|b,c|d`` is 2 shards x 2 replicas, each shard group a
    ``ReplicatedEventsDAO`` (quorum writes, hinted handoff, scrub) over
    its replicas, with chaos points ``storage.shard<i>.replica<j>.*``
    and hint logs under ``HINT_DIR/shard<i>/``. ``WRITE_QUORUM``/
    ``SCRUB_INTERVAL_S``/``DRAIN_INTERVAL_S`` apply per group."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        from pio_tpu_torch.data.backends.remote import RemoteBackend

        props = config.properties
        groups = [
            [u.strip() for u in g.split("|") if u.strip()]
            for g in props.get("URLS", "").split(",") if g.strip()
        ]
        if not groups:
            raise StorageError(
                "sharded backend: set PIO_STORAGE_SOURCES_<N>_URLS to a "
                "comma-separated list of storage-server URLs (each entry "
                "optionally a |-separated replica group)")

        def remote(u: str) -> RemoteBackend:
            return RemoteBackend(StorageClientConfig(
                properties={
                    "URL": u,
                    "KEY": props.get("KEY", ""),
                    "TIMEOUT": props.get("TIMEOUT", "30"),
                    "VERIFY_TLS": props.get("VERIFY_TLS", "true"),
                },
                test=config.test,
            ))

        self._children = []
        shard_daos: list[daomod.EventsDAO] = []
        replicated = any(len(g) > 1 for g in groups)
        if replicated:
            from pio_tpu_torch.data.backends.replicated import (
                ReplicatedEventsDAO, _hint_dir_default,
            )

            from pio_tpu_torch.utils.httpclient import JsonHttpClient

            hint_root = props.get("HINT_DIR") or _hint_dir_default()
            quorum = int(props.get("WRITE_QUORUM", "0")) or None
            for si, g in enumerate(groups):
                members = [remote(u) for u in g]
                self._children.extend(members)
                probes = [
                    (lambda c=JsonHttpClient(u, timeout=3.0):
                     c.request("GET", "/healthz"))
                    for u in g
                ]
                shard_daos.append(ReplicatedEventsDAO(
                    [m.events() for m in members],
                    probes=probes,
                    write_quorum=min(quorum, len(g)) if quorum else None,
                    hint_dir=os.path.join(hint_root, f"shard{si}"),
                    drain_interval_s=float(
                        props.get("DRAIN_INTERVAL_S", "0.5")),
                    scrub_interval_s=float(
                        props.get("SCRUB_INTERVAL_S", "0")),
                    point_prefix=f"storage.shard{si}",
                ))
        else:
            self._children = [remote(g[0]) for g in groups]
            shard_daos = [c.events() for c in self._children]
        self._events = (ReplicatedShardedEventsDAO(shard_daos)
                        if replicated else ShardedEventsDAO(shard_daos))

    def events(self) -> daomod.EventsDAO:
        return self._events

    def close(self) -> None:
        self._events.close()
        for c in self._children:
            c.close()
