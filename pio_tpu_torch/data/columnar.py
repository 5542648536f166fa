"""Columnar event representation — the zero-copy training read path.

The row path materializes one ``Event`` object (two tz-aware datetimes, a
``DataMap``, a frozen dataclass) per stored record and folds them in Python
loops.  At training-read scale that per-record deserialization dominates
wall clock — the same bottleneck the MLlib DataFrame work (arxiv
1505.06807) and the Spark-ML performance study (arxiv 1612.01437) identify
for row-at-a-time pipelines.  This module is the struct-of-arrays
alternative:

 * ``ColumnarEvents`` — contiguous numpy columns (dictionary-encoded
   strings, int64 microsecond timestamps) plus a ragged property sidecar
   that is only decoded for rows a fold actually touches;
 * ``columnar_interactions`` — the training fold (filter + value-extract +
   dedup + dict-encode) over columns, bit-identical to
   ``eventstore.to_interactions`` on the same find() ordering, with the
   sort/dedup in numpy instead of Python dict churn;
 * ``columnar_aggregate`` — the ``$set/$unset/$delete`` replay of
   ``data.aggregator`` driven by one stable numpy argsort, decoding
   properties only for special events.

Every ``EventsDAO`` grows a ``find_columnar`` (default: built from
``find``; SQL backends override to decode straight from rows) and a
default ``columnarize`` on top of it, so the train data-source stage
hands numpy columns to the trainer without ever materializing per-event
Python objects.

Copy of the first part of ``pio_tpu.data.columnar`` (up to
``columnar_aggregate``), imports rewritten to the port. The reference's
event-server and storage-server wire codecs (``decode_api_batch``, the
binary columnar wire format, ``concat_columnar``) come with the port's
event server. The reference's fold returns the ``Columns`` of its native
event-log module, which loads a native library; the port has no native
log backend, so ``Columns`` is a plain dataclass here with the same
fields.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Iterable

import numpy as np

from pio_tpu_torch.data.datamap import PropertyMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.utils.time import parse_time

@dataclass
class Columns:
    """COO interaction columns: the output of the training fold."""

    user_idx: np.ndarray    # uint32 codes into `users`
    item_idx: np.ndarray
    values: np.ndarray      # float32
    times_us: np.ndarray    # int64 event-time microseconds
    users: list[str]        # code -> entity_id
    items: list[str]        # code -> target_entity_id


_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_US = timedelta(microseconds=1)

# event-name classes for the aggregate fold (precomputed per dictionary
# entry so the per-row loop compares small ints, not strings)
_EV_OTHER, _EV_SET, _EV_UNSET, _EV_DELETE = 0, 1, 2, 3
_SPECIAL_CLASS = {"$set": _EV_SET, "$unset": _EV_UNSET, "$delete": _EV_DELETE}


def _micros(dt: datetime) -> int:
    return (dt - _EPOCH) // _US  # exact integer arithmetic


def _tz_minutes(dt: datetime) -> int:
    off = dt.utcoffset()
    return 0 if off is None else int(off.total_seconds() // 60)


def _restore_time(us: int, tz_min: int) -> datetime:
    dt = _EPOCH + timedelta(microseconds=int(us))
    return dt.astimezone(timezone(timedelta(minutes=int(tz_min))))


@dataclass
class ColumnarEvents:
    """Struct-of-arrays view of an event batch.

    Strings are dictionary-encoded: ``entity_code[i]`` indexes
    ``entity_ids``; ``target_code[i]`` is -1 when the event has no target
    entity.  ``properties[i]`` is a dict, a raw JSON string (decoded
    lazily via :meth:`props`), or None for an empty map — the ragged
    sidecar stays untouched unless a fold reads it.
    """

    event_code: np.ndarray   # int32 codes into event_names
    entity_code: np.ndarray  # int32 codes into entity_ids
    target_code: np.ndarray  # int32 codes into target_ids; -1 = absent
    time_us: np.ndarray      # int64 event-time microseconds since epoch
    tz_min: np.ndarray       # int16 original UTC-offset minutes
    event_names: list[str] = field(default_factory=list)
    entity_ids: list[str] = field(default_factory=list)
    target_ids: list[str] = field(default_factory=list)
    properties: list[Any] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.time_us)

    def props(self, i: int) -> dict:
        """Row i's property dict (decodes a raw-JSON sidecar lazily)."""
        p = self.properties[i]
        if p is None:
            return {}
        if isinstance(p, str):
            p = json.loads(p) if p else {}
            self.properties[i] = p
        return p

    def event_time(self, i: int) -> datetime:
        return _restore_time(self.time_us[i], self.tz_min[i])

    @staticmethod
    def empty() -> "ColumnarEvents":
        return ColumnarEvents(
            event_code=np.zeros(0, np.int32),
            entity_code=np.zeros(0, np.int32),
            target_code=np.zeros(0, np.int32),
            time_us=np.zeros(0, np.int64),
            tz_min=np.zeros(0, np.int16),
        )

    @staticmethod
    def from_events(events: Iterable[Event]) -> "ColumnarEvents":
        """One pass over Event records -> columns (the generic adapter for
        backends whose storage already holds Event objects)."""
        ev_dict: dict[str, int] = {}
        ent_dict: dict[str, int] = {}
        tgt_dict: dict[str, int] = {}
        ev_c: list[int] = []
        en_c: list[int] = []
        tg_c: list[int] = []
        t_us: list[int] = []
        tz_m: list[int] = []
        props: list[Any] = []
        for e in events:
            ev_c.append(ev_dict.setdefault(e.event, len(ev_dict)))
            en_c.append(ent_dict.setdefault(e.entity_id, len(ent_dict)))
            tid = e.target_entity_id
            tg_c.append(-1 if tid is None
                        else tgt_dict.setdefault(tid, len(tgt_dict)))
            t_us.append(_micros(e.event_time))
            tz_m.append(_tz_minutes(e.event_time))
            f = e.properties.fields
            props.append(f if f else None)
        return ColumnarEvents(
            event_code=np.asarray(ev_c, np.int32),
            entity_code=np.asarray(en_c, np.int32),
            target_code=np.asarray(tg_c, np.int32),
            time_us=np.asarray(t_us, np.int64),
            tz_min=np.asarray(tz_m, np.int16),
            event_names=list(ev_dict),
            entity_ids=list(ent_dict),
            target_ids=list(tgt_dict),
            properties=props,
        )

    @staticmethod
    def from_rows(rows: Iterable[tuple]) -> "ColumnarEvents":
        """Backend-row adapter: rows of (event, entity_id, target_id|None,
        event_time_iso, properties_json|None).  Decodes each timestamp
        once (fixed-layout ISO written by ``format_time``) and keeps the
        property JSON as a lazy raw sidecar — no Event/DataMap objects."""
        ev_dict: dict[str, int] = {}
        ent_dict: dict[str, int] = {}
        tgt_dict: dict[str, int] = {}
        ev_c: list[int] = []
        en_c: list[int] = []
        tg_c: list[int] = []
        t_us: list[int] = []
        tz_m: list[int] = []
        props: list[Any] = []
        for event, entity_id, target_id, event_time, props_json in rows:
            ev_c.append(ev_dict.setdefault(event, len(ev_dict)))
            en_c.append(ent_dict.setdefault(entity_id, len(ent_dict)))
            tg_c.append(-1 if target_id is None
                        else tgt_dict.setdefault(target_id, len(tgt_dict)))
            dt = parse_time(event_time)
            t_us.append(_micros(dt))
            tz_m.append(_tz_minutes(dt))
            props.append(props_json or None)
        return ColumnarEvents(
            event_code=np.asarray(ev_c, np.int32),
            entity_code=np.asarray(en_c, np.int32),
            target_code=np.asarray(tg_c, np.int32),
            time_us=np.asarray(t_us, np.int64),
            tz_min=np.asarray(tz_m, np.int16),
            event_names=list(ev_dict),
            entity_ids=list(ent_dict),
            target_ids=list(tgt_dict),
            properties=props,
        )


# ---------------------------------------------------------------------------
# training fold: columns -> COO interactions
# ---------------------------------------------------------------------------

def columnar_interactions(
    cols: ColumnarEvents,
    value_key: str | None = "rating",
    default_value: float = 1.0,
    dedup: str = "last",
    value_event: str | None = None,
):
    """Columns -> ``Columns`` (COO user/item/value + id tables).

    Bit-identical to ``to_interactions`` over the same event ordering:
    stable time sort, drop rows without a target entity, value semantics
    of ``make_value_fn`` (``value_key`` reads a numeric property,
    ``value_event`` restricts that read to one event name), dedup
    last/sum/none with first-occurrence key order, id tables in
    first-occurrence order over the deduped pair sequence.  The sort and
    dedup run in numpy; Python touches a row only to read its value
    property.
    """
    n = len(cols)
    order = np.argsort(cols.time_us, kind="stable") if n else np.zeros(0, np.int64)
    keep = order[cols.target_code[order] >= 0]
    m = len(keep)

    def _empty():
        return Columns(
            user_idx=np.zeros(0, np.uint32), item_idx=np.zeros(0, np.uint32),
            values=np.zeros(0, np.float32), times_us=np.zeros(0, np.int64),
            users=[], items=[],
        )

    if m == 0:
        return _empty()

    # per-row value extraction (the only per-row Python in this fold)
    if value_key is None:
        vals = np.full(m, float(default_value), np.float64)
    else:
        value_code = -1
        if value_event is not None:
            try:
                value_code = cols.event_names.index(value_event)
            except ValueError:
                value_code = -2  # name absent from this batch: never matches
        ev_code = cols.event_code
        out = np.empty(m, np.float64)
        for j, i in enumerate(keep):
            if value_code != -1 and ev_code[i] != value_code:
                out[j] = default_value
                continue
            v = cols.props(i).get(value_key)
            out[j] = default_value if v is None else float(v)
        vals = out

    ent = cols.entity_code[keep].astype(np.int64)
    tgt = cols.target_code[keep].astype(np.int64)
    pair = ent * max(len(cols.target_ids), 1) + tgt

    if dedup == "none":
        u_pairs, i_pairs, v_pairs = ent, tgt, vals
    else:
        uniq, first, inverse = np.unique(
            pair, return_index=True, return_inverse=True)
        # first-occurrence order of keys (the dict-insertion order of the
        # row fold's triples)
        key_order = np.argsort(first, kind="stable")
        if dedup == "last":
            last = np.full(len(uniq), -1, np.int64)
            np.maximum.at(last, inverse, np.arange(len(pair)))
            v_uniq = vals[last]
        elif dedup == "sum":
            # the row fold accumulates python floats (float64) and casts
            # to float32 once at the end; float64 add.at + one final cast
            # reproduces that rounding exactly
            v_uniq = np.zeros(len(uniq), np.float64)
            np.add.at(v_uniq, inverse, vals)
        else:
            raise ValueError(f"unknown dedup mode {dedup!r}")
        u_pairs = ent[first[key_order]]
        t_sorted = tgt[first[key_order]]
        v_pairs = v_uniq[key_order]
        i_pairs = t_sorted

    # id tables: first occurrence over the (deduped) pair sequence
    u_codes, u_first, u_inv = np.unique(
        u_pairs, return_index=True, return_inverse=True)
    u_order = np.argsort(u_first, kind="stable")
    u_rank = np.empty(len(u_codes), np.int64)
    u_rank[u_order] = np.arange(len(u_codes))
    i_codes, i_first, i_inv = np.unique(
        i_pairs, return_index=True, return_inverse=True)
    i_order = np.argsort(i_first, kind="stable")
    i_rank = np.empty(len(i_codes), np.int64)
    i_rank[i_order] = np.arange(len(i_codes))

    ent_ids = cols.entity_ids
    tgt_ids = cols.target_ids
    users = [ent_ids[c] for c in u_codes[u_order]]
    items = [tgt_ids[c] for c in i_codes[i_order]]
    return Columns(
        user_idx=u_rank[u_inv].astype(np.uint32),
        item_idx=i_rank[i_inv].astype(np.uint32),
        # the row fold stores python floats and casts once at the end;
        # a single float64->float32 cast here is the same rounding
        values=v_pairs.astype(np.float32),
        times_us=np.zeros(0, np.int64),
        users=users,
        items=items,
    )


# ---------------------------------------------------------------------------
# aggregate fold: columns -> entity PropertyMaps
# ---------------------------------------------------------------------------

class _Prop:
    __slots__ = ("fields", "first_us", "last_us", "first_tz", "last_tz")

    def __init__(self):
        self.fields: dict | None = None
        self.first_us: int | None = None
        self.last_us: int | None = None
        self.first_tz = 0
        self.last_tz = 0


def columnar_aggregate(
    cols: ColumnarEvents,
    required: Iterable[str] | None = None,
) -> dict[str, PropertyMap]:
    """Replay ``$set/$unset/$delete`` into per-entity PropertyMaps —
    the exact contract of ``data.aggregator.aggregate_properties`` (fold
    in event-time order; non-special events touch nothing; deleted
    entities absent) driven by one stable numpy argsort.  Property JSON
    is decoded only for special events."""
    n = len(cols)
    out: dict[str, _Prop] = {}
    if n:
        classes = [
            _SPECIAL_CLASS.get(name, _EV_OTHER) for name in cols.event_names
        ]
        ev_code = cols.event_code
        ent_code = cols.entity_code
        time_us = cols.time_us
        tz_min = cols.tz_min
        ent_ids = cols.entity_ids
        for i in np.argsort(time_us, kind="stable"):
            cls = classes[ev_code[i]]
            if cls == _EV_OTHER:
                continue
            eid = ent_ids[ent_code[i]]
            prop = out.get(eid)
            if prop is None:
                prop = out[eid] = _Prop()
            if cls == _EV_SET:
                f = cols.props(i)
                if prop.fields is None:
                    prop.fields = dict(f)
                else:
                    prop.fields.update(f)
            elif cls == _EV_UNSET:
                if prop.fields is not None:
                    for k in cols.props(i):
                        prop.fields.pop(k, None)
            else:  # $delete
                prop.fields = None
            t = time_us[i]
            if prop.first_us is None or t < prop.first_us:
                prop.first_us, prop.first_tz = t, tz_min[i]
            if prop.last_us is None or t > prop.last_us:
                prop.last_us, prop.last_tz = t, tz_min[i]
    req = list(required) if required else None
    result: dict[str, PropertyMap] = {}
    for eid, prop in out.items():
        if prop.fields is None:
            continue
        # mirror required_filter: PropertyMap.contains is key presence
        if req is not None and not all(r in prop.fields for r in req):
            continue
        result[eid] = PropertyMap(
            fields=prop.fields,
            first_updated=_restore_time(prop.first_us, prop.first_tz),
            last_updated=_restore_time(prop.last_us, prop.last_tz),
        )
    return result
