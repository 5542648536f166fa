"""`remote` storage backend — client for the storage server.

Mounts a storage server (server/storageserver.py) running on another host
as a full local DAO set, giving multi-host jobs and split deployments one
shared store. Counterpart of the reference pointing its JDBC/HBase/ES
backends at a networked database (jdbc/StorageClient.scala,
hbase/StorageClient.scala); the locator config is the same env-var shape:

    PIO_STORAGE_SOURCES_SHARED_TYPE=remote
    PIO_STORAGE_SOURCES_SHARED_URL=http://storage-host:7072
    PIO_STORAGE_SOURCES_SHARED_KEY=<server key, optional>
    PIO_STORAGE_SOURCES_SHARED_TIMEOUT=30       (seconds, optional)
    PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=SHARED
    ...

Transport: POST /rpc, JSON codecs shared with the server
(data/backends/wire.py). Failures surface as StorageError with the server's
message; connection errors mention the URL so `pio status` output is
actionable.

Copy of ``pio_tpu.data.backends.remote``, imports rewritten to the port; it
trims nothing. Columns come back as ``native.eventlog.Columns``.
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Iterator, Sequence

from pio_tpu_torch.data import dao as d
from pio_tpu_torch.data.backends import wire as w
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Backend, StorageError
from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient

log = logging.getLogger("pio_tpu_torch.remote")

# page size for unbounded (limit=-1) remote finds; bounds each RPC
# response while keeping round trips rare (10k events ≈ a few MB JSON)
FIND_PAGE = 10_000
# ceiling on the boundary-tie exclusion set. The cursor is (time, ids
# seen at that time); a dataset where one timestamp carries this many
# events would make each request ship the whole set and the server
# re-filter it (quadratic in the tie group) — fail loudly and point at
# time-windowed export instead of degrading into that.
EXCLUDE_IDS_CAP = 50_000


class RemoteBackend(Backend):
    def __init__(self, config):
        super().__init__(config)
        url = config.properties.get("URL", "http://127.0.0.1:7072")
        self._url = url.rstrip("/")
        self._key = config.properties.get("KEY", "")
        verify = config.properties.get("VERIFY_TLS", "true").lower()
        self._http = JsonHttpClient(
            self._url,
            timeout=float(config.properties.get("TIMEOUT", "30")),
            verify_tls=verify not in ("false", "0", "no"),
        )

    # -- transport ----------------------------------------------------------
    def storage_error(self, what: str, e: HttpClientError) -> StorageError:
        """The ONE HttpClientError -> StorageError translation (server
        fault vs unreachable) for every route this backend speaks —
        /rpc and /rpc/columnar must not drift on error reporting."""
        if e.status:
            return StorageError(
                f"storage server {self._url}: {what}: {e.message}")
        return StorageError(
            f"storage server {self._url} unreachable: {e.message}")

    def call(self, family: str, method: str, kwargs: dict):
        params = {"accessKey": self._key} if self._key else None
        try:
            payload = self._http.request(
                "POST", "/rpc",
                {"family": family, "method": method, "kwargs": kwargs},
                params,
            )
        except HttpClientError as e:
            raise self.storage_error(f"{family}.{method}", e) from e
        return (payload or {}).get("result")

    def close(self):
        pass

    # -- DAO factories ------------------------------------------------------
    def apps(self):
        return _RemoteApps(self)

    def access_keys(self):
        return _RemoteAccessKeys(self)

    def channels(self):
        return _RemoteChannels(self)

    def engine_instances(self):
        return _RemoteEngineInstances(self)

    def engine_manifests(self):
        return _RemoteEngineManifests(self)

    def evaluation_instances(self):
        return _RemoteEvaluationInstances(self)

    def models(self):
        return _RemoteModels(self)

    def events(self):
        return _RemoteEvents(self)


class _Remote:
    family = ""

    def __init__(self, b: RemoteBackend):
        self.b = b

    def call(self, method: str, **kwargs):
        return self.b.call(self.family, method, kwargs)


class _RemoteApps(_Remote, d.AppsDAO):
    family = "apps"

    def insert(self, app):
        return self.call("insert", app=w.app_to_wire(app))

    def get(self, app_id):
        r = self.call("get", app_id=app_id)
        return w.app_from_wire(r) if r else None

    def get_by_name(self, name):
        r = self.call("get_by_name", name=name)
        return w.app_from_wire(r) if r else None

    def get_all(self):
        return [w.app_from_wire(x) for x in self.call("get_all")]

    def update(self, app):
        self.call("update", app=w.app_to_wire(app))

    def delete(self, app_id):
        self.call("delete", app_id=app_id)


class _RemoteAccessKeys(_Remote, d.AccessKeysDAO):
    family = "access_keys"

    def insert(self, k):
        return self.call("insert", access_key=w.access_key_to_wire(k))

    def get(self, key):
        r = self.call("get", key=key)
        return w.access_key_from_wire(r) if r else None

    def get_all(self):
        return [w.access_key_from_wire(x) for x in self.call("get_all")]

    def get_by_appid(self, appid):
        return [
            w.access_key_from_wire(x)
            for x in self.call("get_by_appid", appid=appid)
        ]

    def update(self, k):
        self.call("update", access_key=w.access_key_to_wire(k))

    def delete(self, key):
        self.call("delete", key=key)


class _RemoteChannels(_Remote, d.ChannelsDAO):
    family = "channels"

    def insert(self, channel):
        return self.call("insert", channel=w.channel_to_wire(channel))

    def get(self, channel_id):
        r = self.call("get", channel_id=channel_id)
        return w.channel_from_wire(r) if r else None

    def get_by_appid(self, appid):
        return [
            w.channel_from_wire(x)
            for x in self.call("get_by_appid", appid=appid)
        ]

    def delete(self, channel_id):
        self.call("delete", channel_id=channel_id)


class _RemoteEngineInstances(_Remote, d.EngineInstancesDAO):
    family = "engine_instances"

    def insert(self, i):
        return self.call("insert", instance=w.engine_instance_to_wire(i))

    def get(self, instance_id):
        r = self.call("get", instance_id=instance_id)
        return w.engine_instance_from_wire(r) if r else None

    def get_all(self):
        return [
            w.engine_instance_from_wire(x) for x in self.call("get_all")
        ]

    def update(self, i):
        self.call("update", instance=w.engine_instance_to_wire(i))

    def delete(self, instance_id):
        self.call("delete", instance_id=instance_id)


class _RemoteEngineManifests(_Remote, d.EngineManifestsDAO):
    family = "engine_manifests"

    def insert(self, m):
        self.call("insert", manifest=w.engine_manifest_to_wire(m))

    def get(self, manifest_id, version):
        r = self.call("get", manifest_id=manifest_id, version=version)
        return w.engine_manifest_from_wire(r) if r else None

    def get_all(self):
        return [
            w.engine_manifest_from_wire(x) for x in self.call("get_all")
        ]

    def update(self, m, upsert=False):
        self.call("update", manifest=w.engine_manifest_to_wire(m),
                  upsert=upsert)

    def delete(self, manifest_id, version):
        self.call("delete", manifest_id=manifest_id, version=version)


class _RemoteEvaluationInstances(_Remote, d.EvaluationInstancesDAO):
    family = "evaluation_instances"

    def insert(self, i):
        return self.call("insert", instance=w.evaluation_instance_to_wire(i))

    def get(self, instance_id):
        r = self.call("get", instance_id=instance_id)
        return w.evaluation_instance_from_wire(r) if r else None

    def get_all(self):
        return [
            w.evaluation_instance_from_wire(x) for x in self.call("get_all")
        ]

    def update(self, i):
        self.call("update", instance=w.evaluation_instance_to_wire(i))

    def delete(self, instance_id):
        self.call("delete", instance_id=instance_id)


class _RemoteModels(_Remote, d.ModelsDAO):
    family = "models"

    def insert(self, m):
        self.call("insert", model=w.model_to_wire(m))

    def get(self, model_id):
        r = self.call("get", model_id=model_id)
        return w.model_from_wire(r) if r else None

    def delete(self, model_id):
        self.call("delete", model_id=model_id)


class _RemoteEvents(_Remote, d.EventsDAO):
    family = "events"

    def __init__(self, b: RemoteBackend):
        super().__init__(b)
        # sticky binary-read downgrade (the SDK wire downgrade's shape):
        # a 404/405 on POST /rpc/columnar means a pre-binary storage
        # server — logged ONCE per client, and every later
        # find_columnar goes straight to the paged-JSON path instead of
        # paying a doomed round trip (and silently hiding the downgrade)
        self._columnar_downgraded = False

    def init(self, app_id, channel_id=None):
        return bool(self.call("init", app_id=app_id, channel_id=channel_id))

    def remove(self, app_id, channel_id=None):
        return bool(self.call("remove", app_id=app_id, channel_id=channel_id))

    def close(self):
        pass

    def insert(self, event: Event, app_id, channel_id=None):
        return self.call(
            "insert", event=w.event_to_wire(event), app_id=app_id,
            channel_id=channel_id,
        )

    def insert_batch(self, events, app_id, channel_id=None):
        # one round trip for the whole batch (the server loops locally)
        return self.call(
            "insert_batch", events=[w.event_to_wire(e) for e in events],
            app_id=app_id, channel_id=channel_id,
        )

    def get(self, event_id, app_id, channel_id=None):
        r = self.call(
            "get", event_id=event_id, app_id=app_id, channel_id=channel_id
        )
        return w.event_from_wire(r) if r else None

    def delete(self, event_id, app_id, channel_id=None):
        return bool(self.call(
            "delete", event_id=event_id, app_id=app_id, channel_id=channel_id
        ))

    def find_columnar(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=...,
        target_entity_id=...,
    ):
        """Bulk columnar read over the BINARY wire (POST /rpc/columnar):
        the server ships one CRC32C-framed columnar batch — dictionary
        codes + µs timestamps + the lazy raw-JSON property sidecar —
        and this client decodes it by ``frombuffer`` pointer-cast
        (data/columnar.py), instead of paging per-event JSON through
        ``find`` and re-columnarizing client-side. A pre-binary server
        (404/405 on the route) downgrades to exactly that JSON path —
        STICKY for this client's lifetime and logged once (a silent
        per-call fallback would hide a 100x-payload regression from
        every operator dashboard)."""
        from pio_tpu_torch.data.columnar import (
            COLUMNAR_CONTENT_TYPE, WireFormatError, decode_columnar_events,
        )

        def json_fallback():
            return super(_RemoteEvents, self).find_columnar(
                app_id=app_id, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id)

        if self._columnar_downgraded:
            return json_fallback()
        q = w.find_kwargs_to_wire(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        params = {"accessKey": self.b._key} if self.b._key else None
        try:
            blob = self.b._http.request(
                "POST", "/rpc/columnar",
                {"app_id": app_id, "channel_id": channel_id, "query": q},
                params, accept=COLUMNAR_CONTENT_TYPE)
        except HttpClientError as e:
            if e.status in (404, 405):
                # pre-binary storage server: downgrade to the paged-JSON
                # path, once and loudly
                self._columnar_downgraded = True
                log.warning(
                    "storage server %s has no POST /rpc/columnar "
                    "(HTTP %d) — downgrading find_columnar to paged "
                    "JSON for this client's lifetime; upgrade the "
                    "server to restore the binary read path",
                    self.b._url, e.status)
                return json_fallback()
            raise self.b.storage_error("events.find_columnar", e) from e
        if not isinstance(blob, bytes):
            raise StorageError(
                f"storage server {self.b._url}: events.find_columnar "
                "answered JSON where a columnar frame was negotiated")
        try:
            return decode_columnar_events(blob)
        except WireFormatError as e:
            raise StorageError(
                f"storage server {self.b._url}: events.find_columnar "
                f"frame rejected: {e}") from e

    def columnarize(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        event_names=None,
        target_entity_type=...,
        value_key="rating",
        default_value=1.0,
        dedup="last",
        value_event=None,
    ):
        """Server-side training read: the scan/value-extract/dedup/encode
        fold runs on the storage server (its native C++ sweep when the
        backing store is the eventlog), and only compact COO columns
        cross the wire — the region-side scan of HBPEvents.scala, not a
        client-side fold over event JSON. Returns native.eventlog.Columns
        with times_us always empty (not shipped: no remote consumer
        reads it and it would be ~25% of the payload)."""
        import numpy as np

        from pio_tpu_torch.native.eventlog import Columns

        q = w.find_kwargs_to_wire(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, event_names=event_names,
            target_entity_type=target_entity_type,
        )
        r = self.call(
            "columnarize", app_id=app_id, channel_id=channel_id, query=q,
            valueKey=value_key, defaultValue=default_value, dedup=dedup,
            valueEvent=value_event,
        )
        return Columns(
            user_idx=np.asarray(r["userIdx"], dtype=np.uint32),
            item_idx=np.asarray(r["itemIdx"], dtype=np.uint32),
            values=np.asarray(r["values"], dtype=np.float32),
            # not on the wire by design (~25% payload, zero consumers)
            times_us=np.empty(0, dtype=np.int64),
            users=list(r["users"]),
            items=list(r["items"]),
        )

    def delete_many(self, event_ids, app_id, channel_id=None):
        # one round trip; the server delegates to its local DAO, which
        # may have a bulk primitive (eventlog tombstones) or loop locally
        return int(self.call(
            "delete_many", event_ids=list(event_ids), app_id=app_id,
            channel_id=channel_id,
        ))

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
        def q(lim, page_start=None, exclude_ids=None):
            return w.find_kwargs_to_wire(
                start_time=page_start if page_start is not None
                else start_time,
                until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=lim, reversed=reversed, exclude_ids=exclude_ids,
            )

        if limit == -1 and not reversed:
            # unbounded read: KEYSET-page so an export of millions of
            # events streams in bounded responses instead of one giant
            # JSON body. Cursor = the last page's final event_time
            # (inclusive start_time) + the ids already seen AT that
            # time (server-side excludeIds) — exact regardless of how
            # the backend orders equal-time ties, and each page is an
            # indexed start_time scan, not an O(offset) re-read.
            # (reversed unbounded reads stay a single call: until_time
            # is exclusive, so a descending cursor cannot re-include
            # its boundary ties.)
            def pages() -> Iterator[Event]:
                # boundary_t/_ids persist ACROSS pages: when several
                # consecutive pages sit at one timestamp, the exclusion
                # set keeps growing — resetting per page would let page
                # 3 re-return page 1's ties
                boundary_t = None
                boundary_ids: set[str] = set()
                while True:
                    rows = self.call(
                        "find", app_id=app_id, channel_id=channel_id,
                        query=q(FIND_PAGE, boundary_t, sorted(boundary_ids)),
                    )
                    for r in rows:
                        # pio: lint-ok[hot-loop-alloc] find()'s contract
                        # IS Event objects — the columnar training path
                        # is the columnarize RPC, which never pages here
                        e = w.event_from_wire(r)
                        if (e.event_time == boundary_t
                                and e.event_id in boundary_ids):
                            # the server returned an id we told it to
                            # exclude: it predates the excludeIds
                            # protocol — fail fast, silent paging here
                            # means duplicated exports or an infinite
                            # page loop
                            raise StorageError(
                                f"storage server {self.b._url} ignored "
                                "the excludeIds find cursor "
                                "(pre-pagination server?) — upgrade it "
                                "or read with an explicit limit")
                        if e.event_time != boundary_t:
                            boundary_t = e.event_time
                            boundary_ids = set()
                        boundary_ids.add(e.event_id)
                        yield e
                    if len(rows) < FIND_PAGE:
                        return   # complete: no further request carries
                                 # the exclusion set, cap is moot
                    if len(boundary_ids) > EXCLUDE_IDS_CAP:
                        raise StorageError(
                            f"more than {EXCLUDE_IDS_CAP} events share "
                            f"event_time {boundary_t}: the keyset cursor "
                            "would go quadratic — page manually with "
                            "start_time/until_time windows")

            return pages()
        rows = self.call(
            "find", app_id=app_id, channel_id=channel_id, query=q(limit)
        )
        return iter(w.event_from_wire(r) for r in rows)

    def aggregate_properties(
        self, app_id, entity_type, channel_id=None, start_time=None,
        until_time=None, required=None,
    ):
        # server-side fold: one round trip instead of shipping every
        # $set/$unset/$delete event over the wire
        kw = {"app_id": app_id, "entity_type": entity_type,
              "channel_id": channel_id}
        if start_time is not None:
            kw["startTime"] = w._dt(start_time)
        if until_time is not None:
            kw["untilTime"] = w._dt(until_time)
        if required is not None:
            kw["required"] = list(required)
        out = self.call("aggregate_properties", **kw)
        return {
            eid: w.property_map_from_wire(p) for eid, p in out.items()
        }
