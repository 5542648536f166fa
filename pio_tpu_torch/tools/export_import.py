"""Event export/import — JSON-lines and Parquet files <-> event store.

Reference tools/.../export/EventsToFile.scala:39 (PEvents -> JSON/Parquet
via Spark DataFrames) and imprt/FileToEvents.scala (JSON lines ->
PEvents.write). JSON-lines format matches the Event Server wire format, so
exports replay through `pio import` or the batch API. The Parquet path is
columnar (one column per Event field, properties as a JSON string column —
they are schemaless by design) and streams in record batches, so exports of
millions of events never hold them all in memory.
"""

from __future__ import annotations

import json
from typing import TextIO

from pio_tpu_torch.data.event import Event, validate_event
from pio_tpu_torch.data.storage import Storage


def export_events(
    storage: Storage,
    app_id: int,
    out: TextIO,
    channel_id: int | None = None,
) -> int:
    """Write all events of an app/channel as JSON lines; returns count."""
    n = 0
    for event in storage.get_events().find(app_id, channel_id=channel_id, limit=-1):
        out.write(json.dumps(event.to_api_dict(), sort_keys=True) + "\n")
        n += 1
    return n


IMPORT_BATCH = 500


def import_events(
    storage: Storage,
    app_id: int,
    infile: TextIO,
    channel_id: int | None = None,
) -> tuple[int, int]:
    """Read JSON lines into the event store; returns (imported, failed).

    Inserts in IMPORT_BATCH bulk writes — over the storage server that
    is one RPC per batch instead of one per event (the difference
    between ~1k/s and wire speed on a remote store). Per-line fault
    isolation is preserved: parse/validation failures never enter a
    batch, and a failed bulk write retries its events singly so exactly
    the bad ones count as failures (the reference's count+continue)."""
    from pio_tpu_torch.data.backends.common import new_event_id

    dao = storage.get_events()
    dao.init(app_id, channel_id)
    ok = failed = 0
    batch: list[Event] = []

    def flush():
        nonlocal ok, failed
        if not batch:
            return
        try:
            dao.insert_batch(batch, app_id, channel_id)
            ok += len(batch)
        except Exception:  # noqa: BLE001 - isolate: retry one by one.
            # A bulk write can fail PARTWAY (the default insert_batch is
            # a per-event loop; a remote RPC can time out after the
            # server committed) — ids were minted client-side above
            # precisely so this retry can skip what already landed
            # instead of duplicating it.
            for ev in batch:
                try:
                    if dao.get(ev.event_id, app_id, channel_id) is None:
                        dao.insert(ev, app_id, channel_id)
                    ok += 1
                except Exception:  # noqa: BLE001
                    failed += 1
        batch.clear()

    for line in infile:
        line = line.strip()
        if not line:
            continue
        try:
            event = Event.from_api_dict(json.loads(line))
            validate_event(event)
        except Exception:  # noqa: BLE001 - count+continue like the reference
            failed += 1
            continue
        if event.event_id is None:
            # client-side id minting makes the batch retry idempotent
            event = event.with_id(new_event_id())
        batch.append(event)
        if len(batch) >= IMPORT_BATCH:
            flush()
    flush()
    return ok, failed


# ---------------------------------------------------------------------------
# Parquet (columnar) path — reference EventsToFile.scala:39 "parquet" format
# ---------------------------------------------------------------------------

_PARQUET_BATCH = 65536


def _parquet_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("eventId", pa.string()),
            ("event", pa.string()),
            ("entityType", pa.string()),
            ("entityId", pa.string()),
            ("targetEntityType", pa.string()),
            ("targetEntityId", pa.string()),
            ("properties", pa.string()),  # schemaless JSON, one doc per row
            ("eventTime", pa.timestamp("us", tz="UTC")),
            ("tags", pa.list_(pa.string())),
            ("prId", pa.string()),
            ("creationTime", pa.timestamp("us", tz="UTC")),
        ]
    )


def _events_to_batch(events: list[Event], schema):
    import pyarrow as pa

    cols = {
        "eventId": [e.event_id for e in events],
        "event": [e.event for e in events],
        "entityType": [e.entity_type for e in events],
        "entityId": [e.entity_id for e in events],
        "targetEntityType": [e.target_entity_type for e in events],
        "targetEntityId": [e.target_entity_id for e in events],
        "properties": [
            json.dumps(dict(e.properties.fields), sort_keys=True)
            if e.properties.fields else None
            for e in events
        ],
        "eventTime": [e.event_time for e in events],
        "tags": [list(e.tags) if e.tags else None for e in events],
        "prId": [e.pr_id for e in events],
        "creationTime": [e.creation_time for e in events],
    }
    return pa.record_batch(
        [pa.array(cols[f.name], type=f.type) for f in schema], schema=schema
    )


def export_events_parquet(
    storage: Storage,
    app_id: int,
    path: str,
    channel_id: int | None = None,
) -> int:
    """Write all events of an app/channel to one Parquet file; returns count."""
    import pyarrow.parquet as pq

    schema = _parquet_schema()
    n = 0
    with pq.ParquetWriter(path, schema, compression="zstd") as writer:
        batch: list[Event] = []
        for event in storage.get_events().find(
            app_id, channel_id=channel_id, limit=-1
        ):
            batch.append(event)
            if len(batch) >= _PARQUET_BATCH:
                writer.write_batch(_events_to_batch(batch, schema))
                n += len(batch)
                batch = []
        if batch:
            writer.write_batch(_events_to_batch(batch, schema))
            n += len(batch)
    return n


def import_events_parquet(
    storage: Storage,
    app_id: int,
    path: str,
    channel_id: int | None = None,
) -> tuple[int, int]:
    """Read a Parquet export into the event store; returns (imported, failed)."""
    import pyarrow.parquet as pq

    dao = storage.get_events()
    dao.init(app_id, channel_id)
    ok = failed = 0
    pf = pq.ParquetFile(path)
    for rb in pf.iter_batches(batch_size=_PARQUET_BATCH):
        rows = rb.to_pylist()
        good: list[Event] = []
        for row in rows:
            try:
                props = json.loads(row["properties"]) if row["properties"] else {}
                event = Event(
                    event=row["event"],
                    entity_type=row["entityType"],
                    entity_id=row["entityId"],
                    target_entity_type=row["targetEntityType"],
                    target_entity_id=row["targetEntityId"],
                    properties=props,
                    event_time=row["eventTime"],
                    tags=tuple(row["tags"] or ()),
                    pr_id=row["prId"],
                    event_id=row["eventId"],
                    creation_time=row["creationTime"],
                )
                validate_event(event)
                good.append(event)
            except Exception:  # noqa: BLE001 - count+continue like the reference
                failed += 1
        if good:
            dao.insert_batch(good, app_id, channel_id)
            ok += len(good)
    return ok, failed
