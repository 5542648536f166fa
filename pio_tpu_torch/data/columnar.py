"""Columnar event representation — the zero-copy training/ingest path.

The row path materializes one ``Event`` object (two tz-aware datetimes, a
``DataMap``, a frozen dataclass) per stored record and folds them in Python
loops.  At training-read and ingest-batch scale that per-record
deserialization dominates wall clock — the same bottleneck the MLlib
DataFrame work (arxiv 1505.06807) and the Spark-ML performance study
(arxiv 1612.01437) identify for row-at-a-time pipelines.  This module is
the struct-of-arrays alternative:

 * ``ColumnarEvents`` — contiguous numpy columns (dictionary-encoded
   strings, int64 microsecond timestamps) plus a ragged property sidecar
   that is only decoded for rows a fold actually touches;
 * ``columnar_interactions`` — the training fold (filter + value-extract +
   dedup + dict-encode) over columns, bit-identical to
   ``eventstore.to_interactions`` on the same find() ordering, with the
   sort/dedup in numpy instead of Python dict churn;
 * ``columnar_aggregate`` — the ``$set/$unset/$delete`` replay of
   ``data.aggregator`` driven by one stable numpy argsort, decoding
   properties only for special events;
 * ``decode_api_batch`` — the event server's vectorized batch decode: one
   pass over a JSON batch producing validated ``Event`` records without
   per-event ``from_api_dict`` overhead (shared receive timestamp, fast
   constructor that skips ``__post_init__`` re-coercion);
 * the **binary columnar wire format** (``application/x-pio-columnar``):
   ColumnarEvents' in-memory layout AS the wire layout — dictionary-
   encoded int32 string codes over a per-batch string table, int64 µs
   timestamps + tz-offset minutes, and the lazy raw-JSON property
   sidecar as a length-prefixed bytes column, all inside the
   utils/durable CRC32C envelope so truncation/bit-rot is rejected at
   the edge. ``encode_api_batch``/``decode_api_batch_binary`` carry
   ingest batches (SDK/loadgen -> event server) and
   ``encode_columnar_events``/``decode_columnar_events`` carry read
   batches (binary tail, the ``find_columnar`` RPC); batches deserialize
   by ``np.frombuffer`` pointer-cast views instead of per-event JSON
   decode. This module is the ONE wire codec — the ``wire-codec`` lint
   rule keeps struct/frombuffer packing from growing anywhere else.

Every ``EventsDAO`` grows a ``find_columnar`` (default: built from
``find``; SQL backends override to decode straight from rows) and a
default ``columnarize`` on top of it, so the 133x server-side columnarize
win extends to the local path, the sharded scatter-gather path, and the
train data-source stage — numpy columns go straight to the trainer
without ever materializing per-event Python objects.

Copy of ``pio_tpu.data.columnar``, imports rewritten to the port.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Iterable, Sequence

import numpy as np

from pio_tpu_torch.data.datamap import DataMap, PropertyMap
from pio_tpu_torch.data.event import (
    BUILTIN_ENTITY_TYPES, BUILTIN_PROPERTIES, Event, EventValidationError,
    SPECIAL_EVENTS, is_reserved_prefix, validate_event,
)
from pio_tpu_torch.utils.durable import (
    _HEADER as _ENVELOPE_HEAD, ModelIntegrityError, frame, is_framed,
    unframe,
)
from pio_tpu_torch.utils.time import parse_time, utcnow

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
    """Columns -> native ``Columns`` (COO user/item/value + id tables).

    Bit-identical to ``to_interactions`` over the same event ordering:
    stable time sort, drop rows without a target entity, value semantics
    of ``make_value_fn`` (``value_key`` reads a numeric property,
    ``value_event`` restricts that read to one event name), dedup
    last/sum/none with first-occurrence key order, id tables in
    first-occurrence order over the deduped pair sequence.  The sort and
    dedup run in numpy; Python touches a row only to read its value
    property.
    """
    from pio_tpu_torch.native.eventlog import Columns

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


# ---------------------------------------------------------------------------
# ingest: vectorized batch decode
# ---------------------------------------------------------------------------

def decode_api_event(d: Any, now: datetime) -> Event:
    """One API dict -> validated Event with ``now`` as the shared receive
    timestamp.  Decoding delegates to ``Event.from_api_dict`` (the ONE
    implementation of the wire rules — this wrapper only adds the
    non-dict check and validation); raises EventValidationError."""
    if not isinstance(d, dict):
        raise EventValidationError("event must be a JSON object")
    e = Event.from_api_dict(d, now=now)
    validate_event(e)
    return e


# ---------------------------------------------------------------------------
# binary columnar wire format (v1) — the ONE wire codec
# ---------------------------------------------------------------------------
#
# Frame:   utils/durable envelope  WIRE_MAGIC | crc32c(payload) | len | payload
# Payload (little-endian throughout):
#
#   u16 version | u16 flags | u32 n_rows | u32 n_strings
#   u64 strtab_bytes | u64 sidecar_bytes
#   u32[n_strings]  string byte lengths          ┐ one shared per-batch
#   utf-8 bytes     string table (concatenated)  ┘ dictionary
#   i64[n] time_us      event time (µs since epoch; INT64_MIN = absent)
#   i16[n] tz_min       original UTC-offset minutes
#   i32[n] event_code   string code (-2 = raw-JSON fallback row, ingest)
#   i32[n] entity_code  entityId string code
#   i32[n] target_code  targetEntityId code (-1 = absent)
#   -- ingest frames only (flags & _WIRE_F_INGEST) --
#   i64[n] ctime_us     creationTime µs (INT64_MIN = absent)
#   i16[n] ctz_min
#   i32[n] etype_code   entityType code
#   i32[n] ttype_code   targetEntityType code (-1 = absent)
#   i32[n] event_id_code / i32[n] pr_id_code     (-1 = absent)
#   -- sidecar --
#   u32[n] sidecar byte lengths (0 = empty properties)
#   bytes  lazy raw-JSON property sidecar (raw rows: the full event JSON)
#
# Every column decodes as one np.frombuffer view — zero per-event Python
# in the cast. Events the strict columnar shape cannot carry (non-string
# ids, tags, unparseable timestamps, non-dict bodies) ride as raw-JSON
# fallback rows decoded by ``decode_api_event`` — the SAME implementation
# the JSON route runs, so verdicts and messages cannot drift.

WIRE_MAGIC = b"PIOC\x01"
WIRE_VERSION = 1
COLUMNAR_CONTENT_TYPE = "application/x-pio-columnar"

_WIRE_F_INGEST = 1
_WIRE_TIME_ABSENT = -(2 ** 63)   # int64 sentinel: timestamp not provided
_WIRE_RAW_ROW = -2               # event_code sentinel: raw-JSON fallback

_WIRE_HEAD = struct.Struct("<HHIIQQ")
_CORE_COLS = (("time_us", "<i8"), ("tz_min", "<i2"), ("event_code", "<i4"),
              ("entity_code", "<i4"), ("target_code", "<i4"))
_INGEST_COLS = (("ctime_us", "<i8"), ("ctz_min", "<i2"),
                ("etype_code", "<i4"), ("ttype_code", "<i4"),
                ("event_id_code", "<i4"), ("pr_id_code", "<i4"))


class WireFormatError(EventValidationError):
    """A columnar wire frame is structurally unusable (bad magic, CRC or
    length mismatch, unknown version, out-of-range dictionary codes).
    EventValidationError subclass so the event server's shared 400
    mapping applies — a corrupt frame is rejected at the edge, never
    partially ingested."""


def _reject_wire_nonfinite(token: str):
    # parity with server/http.py Request.json: NaN/Infinity must never
    # flow into stored properties through the binary sidecar either
    raise EventValidationError(
        f"non-finite JSON constant {token!r} is not valid JSON")


def _pack_frame(flags: int, n: int, strings: Sequence[str],
                columns: dict, sidecar: Sequence[bytes]) -> bytes:
    """Columns + shared string table + sidecar -> framed wire bytes."""
    str_bytes = [s.encode("utf-8") for s in strings]
    strtab = b"".join(str_bytes)
    side = b"".join(sidecar)
    schema = _CORE_COLS + (_INGEST_COLS if flags & _WIRE_F_INGEST else ())
    parts = [
        _WIRE_HEAD.pack(WIRE_VERSION, flags, n, len(str_bytes),
                        len(strtab), len(side)),
        np.asarray([len(b) for b in str_bytes], "<u4").tobytes(),
        strtab,
    ]
    parts += [np.ascontiguousarray(columns[name], dtype=dt).tobytes()
              for name, dt in schema]
    parts.append(np.asarray([len(b) for b in sidecar], "<u4").tobytes())
    parts.append(side)
    return frame(b"".join(parts), magic=WIRE_MAGIC)


def _unpack_frame(blob: bytes):
    """Framed wire bytes -> (flags, n, strings, column views, sidecar
    bytes, sidecar row offsets). Raises WireFormatError on anything
    structurally wrong; the CRC32C envelope catches truncation and
    bit-rot before any column view is taken."""
    if not is_framed(blob, WIRE_MAGIC):
        raise WireFormatError(
            "not a columnar wire frame (bad or missing magic)")
    try:
        payload = unframe(blob, source="columnar wire frame",
                          magic=WIRE_MAGIC)
    except ModelIntegrityError as e:
        raise WireFormatError(str(e)) from e
    if len(payload) < _WIRE_HEAD.size:
        raise WireFormatError("columnar wire frame truncated in header")
    version, flags, n, n_str, strtab_len, side_len = \
        _WIRE_HEAD.unpack_from(payload)
    if version != WIRE_VERSION:
        raise WireFormatError(
            f"unsupported columnar wire version {version} "
            f"(this codec speaks v{WIRE_VERSION})")
    schema = _CORE_COLS + (_INGEST_COLS if flags & _WIRE_F_INGEST else ())
    row_bytes = sum(np.dtype(dt).itemsize for _, dt in schema) + 4
    expect = (_WIRE_HEAD.size + 4 * n_str + strtab_len
              + n * row_bytes + side_len)
    if len(payload) != expect:
        raise WireFormatError(
            f"columnar wire frame length mismatch: header promises "
            f"{expect} payload bytes, found {len(payload)}")
    off = _WIRE_HEAD.size
    lens = np.frombuffer(payload, "<u4", n_str, off)
    off += 4 * n_str
    if int(lens.sum()) != strtab_len:
        raise WireFormatError("columnar wire string table inconsistent")
    strtab = payload[off:off + strtab_len]
    try:
        if strtab.isascii():
            # ASCII fast path: byte offsets == char offsets, so ONE
            # decode + str slicing beats a bytes-decode per entry
            text = strtab.decode("ascii")
            ends = np.cumsum(lens).tolist()
            strings = [text[s:e] for s, e in zip([0] + ends, ends)]
        else:
            strings = []
            p = 0
            for ln in lens.tolist():
                strings.append(strtab[p:p + ln].decode("utf-8"))
                p += ln
    except UnicodeDecodeError as e:
        raise WireFormatError(
            f"columnar wire string table is not UTF-8: {e}") from e
    off += strtab_len
    cols: dict[str, np.ndarray] = {}
    for name, dt in schema:
        cols[name] = np.frombuffer(payload, dt, n, off)
        off += np.dtype(dt).itemsize * n
    side_lens = np.frombuffer(payload, "<u4", n, off)
    off += 4 * n
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(side_lens, out=starts[1:])
    if int(starts[-1]) != side_len:
        raise WireFormatError("columnar wire sidecar inconsistent")
    return (flags, n, strings, lens, cols,
            payload[off:off + side_len], starts)


# per-string validation facts, one flags byte per dictionary entry
# (decode_api_batch_binary's vectorized pre-clearance)
_SF_EMPTY, _SF_RESERVED, _SF_SPECIAL, _SF_BUILTIN, _SF_UNSET = \
    1, 2, 4, 8, 16


def _string_flags(s: str) -> int:
    flags = 0
    if not s:
        flags |= _SF_EMPTY
    elif s[0] == "$" or s.startswith("pio_"):
        flags |= _SF_RESERVED
    if s in SPECIAL_EVENTS:
        flags |= _SF_SPECIAL
        if s == "$unset":
            flags |= _SF_UNSET
    if s in BUILTIN_ENTITY_TYPES:
        flags |= _SF_BUILTIN
    return flags


def _check_codes(col: np.ndarray, n_strings: int, lo: int,
                 what: str) -> None:
    """Dictionary codes must index the shipped string table (lo = the
    smallest legal sentinel). The CRC already rules out corruption, so
    out-of-range codes mean a broken encoder — reject the whole frame."""
    if len(col) and (int(col.min()) < lo or int(col.max()) >= n_strings):
        raise WireFormatError(
            f"columnar wire frame has out-of-range {what} dictionary "
            f"codes (string table holds {n_strings} entries)")


def wire_batch_row_count(blob: bytes) -> int | None:
    """Row count read straight off a frame's fixed-offset header —
    WITHOUT CRC-verifying or decoding anything. The event server uses
    this to reject oversized batches in microseconds BEFORE paying the
    decode (the JSON route's check-size-before-decode ordering); a
    forged count still cannot make the real decode overrun, because the
    header/length/CRC checks run there regardless. None when the blob
    is too short or unframed — the full decode then produces the
    canonical error."""
    if not is_framed(blob, WIRE_MAGIC):
        return None
    off = _ENVELOPE_HEAD.size
    if len(blob) < off + _WIRE_HEAD.size:
        return None
    return _WIRE_HEAD.unpack_from(blob, off)[2]


# -- ingest direction (SDK/loadgen -> event server) --------------------------

def encode_api_batch(events: Sequence[Any]) -> bytes:
    """API-dict batch -> binary columnar ingest frame (the client half
    of the wire codec). Events the strict columnar shape cannot carry —
    non-dict slots, non-string ids, tags, unparseable timestamps,
    non-dict properties — become raw-JSON fallback rows, so the server
    produces verdicts/messages identical to the JSON route for them.
    Raises ValueError/TypeError for bodies the JSON client could not
    send either (NaN, unserializable values)."""
    n = len(events)
    strings: dict[str, int] = {}

    def code(s: str) -> int:
        return strings.setdefault(s, len(strings))

    time_us = np.full(n, _WIRE_TIME_ABSENT, "<i8")
    tz_min = np.zeros(n, "<i2")
    ctime_us = np.full(n, _WIRE_TIME_ABSENT, "<i8")
    ctz_min = np.zeros(n, "<i2")
    event_code = np.zeros(n, "<i4")
    entity_code = np.zeros(n, "<i4")
    target_code = np.full(n, -1, "<i4")
    etype_code = np.zeros(n, "<i4")
    ttype_code = np.full(n, -1, "<i4")
    event_id_code = np.full(n, -1, "<i4")
    pr_id_code = np.full(n, -1, "<i4")
    sidecar: list[bytes] = []

    for i, d in enumerate(events):
        strict = isinstance(d, dict)
        if strict:
            for k in ("event", "entityType", "entityId"):
                if not isinstance(d.get(k), str):
                    strict = False
                    break
        if strict:
            for k in ("targetEntityType", "targetEntityId", "eventId",
                      "prId"):
                v = d.get(k)
                if v is not None and not isinstance(v, str):
                    strict = False
                    break
        props = d.get("properties") if strict else None
        if strict and props is not None and not isinstance(props, dict):
            # from_api_dict treats falsy non-dicts as {} and 400s truthy
            # ones — both rules live in ONE place; ship the row raw
            strict = False
        if strict and d.get("tags"):
            strict = False  # rare; the lean hot format skips tags
        if strict:
            for key, us, tzm in (("eventTime", time_us, tz_min),
                                 ("creationTime", ctime_us, ctz_min)):
                v = d.get(key)
                if not v:
                    continue  # falsy = absent (from_api_dict contract)
                if not isinstance(v, str):
                    strict = False
                    break
                try:
                    dt = parse_time(v)
                except ValueError:
                    strict = False  # server emits the canonical 400
                    break
                us[i] = _micros(dt)
                tzm[i] = _tz_minutes(dt)
        if not strict:
            event_code[i] = _WIRE_RAW_ROW
            sidecar.append(json.dumps(d, allow_nan=False).encode("utf-8"))
            continue
        event_code[i] = code(d["event"])
        etype_code[i] = code(d["entityType"])
        entity_code[i] = code(d["entityId"])
        if d.get("targetEntityType") is not None:
            ttype_code[i] = code(d["targetEntityType"])
        if d.get("targetEntityId") is not None:
            target_code[i] = code(d["targetEntityId"])
        if d.get("eventId") is not None:
            event_id_code[i] = code(d["eventId"])
        if d.get("prId") is not None:
            pr_id_code[i] = code(d["prId"])
        sidecar.append(
            json.dumps(props, allow_nan=False).encode("utf-8")
            if props else b"")
    return _pack_frame(
        _WIRE_F_INGEST, n, list(strings),
        dict(time_us=time_us, tz_min=tz_min, event_code=event_code,
             entity_code=entity_code, target_code=target_code,
             ctime_us=ctime_us, ctz_min=ctz_min, etype_code=etype_code,
             ttype_code=ttype_code, event_id_code=event_id_code,
             pr_id_code=pr_id_code),
        sidecar)


def decode_api_batch_binary(
    blob: bytes, now: datetime | None = None,
) -> list[Event | EventValidationError]:
    """Binary ingest frame -> per-slot validated Event or the
    EventValidationError it failed with — the exact contract of
    ``decode_api_batch`` so the event server's per-event isolation and
    spill fallback apply unchanged. Raises WireFormatError (-> 400, the
    whole request) on a structurally unusable frame; per-slot semantic
    failures (validation) stay per-slot."""
    flags, n, strings, str_lens, cols, sidecar, starts = \
        _unpack_frame(blob)
    if not flags & _WIRE_F_INGEST:
        raise WireFormatError(
            "columnar wire frame lacks ingest columns (a read-side "
            "frame was POSTed to the ingest route)")
    ns = len(strings)
    ev = cols["event_code"]
    strict = ev != _WIRE_RAW_ROW
    if len(ev):
        bad = strict & ((ev < 0) | (ev >= ns))
        if bool(bad.any()):
            raise WireFormatError(
                "columnar wire frame has out-of-range event dictionary "
                f"codes (string table holds {ns} entries)")
    # raw-fallback rows carry their whole event in the sidecar — their
    # other column slots are padding, so only strict rows are checked
    # (and zeroed below before any table indexing)
    all_strict = bool(strict.all())

    def col_checked(name: str, lo: int, what: str) -> np.ndarray:
        """Range-check the STRICT positions of a code column, then
        return it with raw-row padding zeroed so later table indexing
        stays in bounds (raw rows never read the result)."""
        c = cols[name]
        _check_codes(c if all_strict else c[strict], ns, lo, what)
        return c if all_strict else np.where(strict, c, 0)

    en = col_checked("entity_code", 0, "entityId")
    et = col_checked("etype_code", 0, "entityType")
    tg = col_checked("target_code", -1, "targetEntityId")
    tt = col_checked("ttype_code", -1, "targetEntityType")
    ic = col_checked("event_id_code", -1, "eventId")
    pc = col_checked("pr_id_code", -1, "prId")
    now = now or utcnow()

    # -- vectorized validation over the DICTIONARY, not the rows: every
    # fact validate_event needs about a string is computed once per
    # unique table entry (one flags byte), then combined per row in
    # numpy. Rows this mask clears are DEFINITELY valid; anything
    # suspicious (and only that) goes through validate_event itself for
    # the canonical verdict — the fast path can skip the ONE
    # implementation, never disagree with it. (An all-raw batch ships an
    # empty table; pad with one dummy entry so the padded-zero codes of
    # raw rows index safely — raw rows never read the row mask.)
    # the EMPTY fact for every entry comes free from the wire's length
    # table; the remaining facts (reserved/special/builtin/unset) only
    # matter for strings referenced by the event/type columns — a
    # handful per batch, not the O(events) unique-id tail
    nf = max(len(strings), 1)
    f = np.zeros(nf, np.uint8)
    if len(strings):
        f[str_lens == 0] = _SF_EMPTY
    else:
        f[0] = _SF_EMPTY  # dummy entry for all-raw batches
    evs = ev if all_strict else np.where(strict, ev, 0)
    tts0 = np.maximum(tt, 0)
    for c in np.unique(np.concatenate([evs, et, tts0])).tolist():
        s = strings[c] if strings else ""
        if s:
            f[c] |= _string_flags(s)
    fe, fet, fen = f[evs], f[et], f[en]
    has_tt, has_tg = tt >= 0, tg >= 0
    ftt = f[tts0]
    ftg = f[np.maximum(tg, 0)]
    prop_len = starts[1:] - starts[:-1]
    suspicious = (
        ((fe | fet | fen) & _SF_EMPTY).astype(bool)
        | (((fe & _SF_RESERVED) != 0) & ((fe & _SF_SPECIAL) == 0))
        | (((fe & _SF_SPECIAL) != 0) & (has_tt | has_tg))
        | (((fe & _SF_UNSET) != 0) & (prop_len == 0))
        | (((fet & _SF_RESERVED) != 0) & ((fet & _SF_BUILTIN) == 0))
        | (has_tt != has_tg)
        | (has_tt & (((ftt & _SF_EMPTY) != 0)
                     | (((ftt & _SF_RESERVED) != 0)
                        & ((ftt & _SF_BUILTIN) == 0))))
        | (has_tg & ((ftg & _SF_EMPTY) != 0))
    )
    is_unset = (fe & _SF_UNSET) != 0

    # python-int column lists: one bulk tolist() per column beats n
    # numpy-scalar __index__ conversions per row in the loop below
    ev_l, en_l, et_l = ev.tolist(), en.tolist(), et.tolist()
    tg_l, tt_l = tg.tolist(), tt.tolist()
    ic_l, pc_l = ic.tolist(), pc.tolist()
    t_l, tz_l = cols["time_us"].tolist(), cols["tz_min"].tolist()
    c_l, ctz_l = cols["ctime_us"].tolist(), cols["ctz_min"].tolist()
    starts_l = starts.tolist()
    sus_l = suspicious.tolist()
    unset_l = is_unset.tolist()

    # properties memo: identical sidecar payloads (uniform workloads —
    # the loadgen's whole batch shares one props shape) parse AND get
    # their reserved-key verdict ONCE per batch; each event still gets
    # its own fields dict
    prop_memo: dict[bytes, tuple[dict, bool]] = {}
    empty_memo: tuple[dict, bool] = ({}, True)
    out: list[Event | EventValidationError] = []
    out_append = out.append
    new_event = Event.__new__
    new_datamap = DataMap.__new__
    set_dict = object.__setattr__  # the frozen guard only overrides
    absent = _WIRE_TIME_ABSENT     # type(e).__setattr__, not object's
    for i in range(n):
        ec = ev_l[i]
        s0, s1 = starts_l[i], starts_l[i + 1]
        if ec == _WIRE_RAW_ROW:
            # the fallback lane: the SAME decode the JSON route runs
            try:
                # pio: lint-ok[hot-loop-alloc] raw rows ARE the per-event
                # escape hatch by design (non-columnar shapes, rare);
                # the hot lane below never parses event JSON
                d = json.loads(sidecar[s0:s1],
                               parse_constant=_reject_wire_nonfinite)
            except ValueError as err:
                out_append(EventValidationError(
                    f"invalid raw event JSON: {err}"))
                continue
            try:
                out_append(decode_api_event(d, now))
            except EventValidationError as err:
                out_append(err)
            except ValueError as err:  # parity with decode_api_batch
                out_append(EventValidationError(str(err)))
            continue
        if s1 > s0:
            raw = sidecar[s0:s1]
            memo = prop_memo.get(raw)
            if memo is None:
                try:
                    # pio: lint-ok[hot-loop-alloc] parsed once per UNIQUE
                    # sidecar payload (the memo above), not per event —
                    # required to validate reserved property keys
                    fields = json.loads(
                        raw, parse_constant=_reject_wire_nonfinite)
                except ValueError as err:
                    out_append(EventValidationError(
                        f"invalid properties JSON: {err}"))
                    continue
                if not isinstance(fields, dict):
                    out_append(EventValidationError(
                        "properties must be a JSON object"))
                    continue
                props_ok = not fields or all(
                    not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES
                    for k in fields)
                prop_memo[raw] = memo = (fields, props_ok)
        else:
            memo = empty_memo
        fields, props_ok = memo
        t, ct = t_l[i], c_l[i]
        tc, tt_c, iid, prc = tg_l[i], tt_l[i], ic_l[i], pc_l[i]
        # one __dict__ assignment instead of 11 object.__setattr__ calls
        # — the frozen-dataclass guard only intercepts setattr, and this
        # loop is the per-event floor of the whole binary ingest path
        try:
            event_time = (now if t == absent
                          else _restore_time(t, tz_l[i]))
            creation_time = (now if ct == absent
                             else _restore_time(ct, ctz_l[i]))
        except (OverflowError, OSError, ValueError) as err:
            # a third-party encoder shipped µs/tz values no datetime can
            # hold — the binary analogue of the JSON route's per-slot
            # "invalid eventTime", never a whole-request 500
            out_append(EventValidationError(
                f"invalid eventTime/creationTime on the wire: {err}"))
            continue
        dm = new_datamap(DataMap)
        dm.__dict__["fields"] = fields.copy()
        e = new_event(Event)
        set_dict(e, "__dict__", {
            "event": strings[ec],
            "entity_type": strings[et_l[i]],
            "entity_id": strings[en_l[i]],
            "target_entity_type": strings[tt_c] if tt_c >= 0 else None,
            "target_entity_id": strings[tc] if tc >= 0 else None,
            "properties": dm,
            "event_time": event_time,
            "tags": (),
            "pr_id": strings[prc] if prc >= 0 else None,
            "event_id": strings[iid] if iid >= 0 else None,
            "creation_time": creation_time,
        })
        if sus_l[i] or not props_ok or (unset_l[i] and not fields):
            # suspicious row: the ONE validation contract decides, with
            # its canonical message order
            try:
                validate_event(e)
            except EventValidationError as err:
                out_append(err)
                continue
        out_append(e)
    return out


# -- read direction (binary tail, the find_columnar RPC) ---------------------

def encode_columnar_events(cols: ColumnarEvents) -> bytes:
    """ColumnarEvents -> binary read frame: the three per-column
    dictionaries are remapped into ONE shared string table; the property
    sidecar ships raw JSON (dict entries serialized, lazy string entries
    as-is, None as empty)."""
    n = len(cols)
    strings: dict[str, int] = {}

    def remap(table: Sequence[str]) -> np.ndarray:
        return np.asarray(
            [strings.setdefault(s, len(strings)) for s in table],
            np.int64) if table else np.zeros(0, np.int64)

    ev_map = remap(cols.event_names)
    en_map = remap(cols.entity_ids)
    tg_map = remap(cols.target_ids)
    if n:
        ev = ev_map[np.asarray(cols.event_code, np.int64)]
        en = en_map[np.asarray(cols.entity_code, np.int64)]
        tgt = np.asarray(cols.target_code, np.int64)
        if len(tg_map):
            tg = np.where(tgt >= 0, tg_map[np.maximum(tgt, 0)], -1)
        else:
            tg = np.full(n, -1, np.int64)
    else:
        ev = en = tg = np.zeros(0, np.int64)
    sidecar: list[bytes] = []
    props = cols.properties
    for i in range(n):
        p = props[i] if i < len(props) else None
        if p is None:
            sidecar.append(b"")
        elif isinstance(p, str):
            sidecar.append(p.encode("utf-8"))
        elif p:
            sidecar.append(json.dumps(p, allow_nan=False).encode("utf-8"))
        else:
            sidecar.append(b"")
    return _pack_frame(
        0, n, list(strings),
        dict(time_us=np.asarray(cols.time_us, np.int64),
             tz_min=np.asarray(cols.tz_min, np.int16),
             event_code=ev, entity_code=en, target_code=tg),
        sidecar)


def decode_columnar_events(blob: bytes) -> ColumnarEvents:
    """Binary read frame -> ColumnarEvents by pointer-cast: the columns
    ARE frombuffer views of the frame, and all three dictionary tables
    alias the one shared string table (codes already index it — every
    consumer indexes by code, so an oversized table is free)."""
    flags, n, strings, _lens, cols, sidecar, starts = _unpack_frame(blob)
    if flags & _WIRE_F_INGEST:
        raise WireFormatError(
            "columnar wire frame is an ingest batch, not a read batch")
    ns = len(strings)
    _check_codes(cols["event_code"], ns, 0, "event")
    _check_codes(cols["entity_code"], ns, 0, "entity")
    _check_codes(cols["target_code"], ns, -1, "target")
    try:
        props: list[Any] = [
            (sidecar[starts[i]:starts[i + 1]].decode("utf-8")
             if starts[i + 1] > starts[i] else None)
            for i in range(n)
        ]
    except UnicodeDecodeError as e:
        raise WireFormatError(
            f"columnar wire property sidecar is not UTF-8: {e}") from e
    # the three tables ALIAS one shared list: consumers only index by
    # code and never mutate tables, so three copies would be pure waste
    # on a large dictionary
    table = list(strings)
    return ColumnarEvents(
        event_code=np.asarray(cols["event_code"], np.int32),
        entity_code=np.asarray(cols["entity_code"], np.int32),
        target_code=np.asarray(cols["target_code"], np.int32),
        time_us=np.asarray(cols["time_us"], np.int64),
        tz_min=np.asarray(cols["tz_min"], np.int16),
        event_names=table,
        entity_ids=table,
        target_ids=table,
        properties=props,
    )


def concat_columnar(parts: Sequence[ColumnarEvents]) -> ColumnarEvents:
    """Merge per-shard columnar reads into one batch: per-part dictionary
    codes are remapped into global first-occurrence tables, columns
    concatenated, and rows stable-sorted by event time — the ordering
    the scatter ``find`` heap-merge produces, so every columnar fold
    (interactions, aggregate, tail) sees the same row sequence whether
    the read was single-host or sharded."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return ColumnarEvents.empty()
    ev_tab: dict[str, int] = {}
    en_tab: dict[str, int] = {}
    tg_tab: dict[str, int] = {}
    ev_c, en_c, tg_c, t_c, tz_c = [], [], [], [], []
    props: list[Any] = []
    for p in parts:
        ev_map = np.asarray(
            [ev_tab.setdefault(s, len(ev_tab)) for s in p.event_names],
            np.int64)
        en_map = np.asarray(
            [en_tab.setdefault(s, len(en_tab)) for s in p.entity_ids],
            np.int64)
        tg_map = np.asarray(
            [tg_tab.setdefault(s, len(tg_tab)) for s in p.target_ids],
            np.int64)
        ev_c.append(ev_map[np.asarray(p.event_code, np.int64)])
        en_c.append(en_map[np.asarray(p.entity_code, np.int64)])
        tgt = np.asarray(p.target_code, np.int64)
        if len(tg_map):
            tg_c.append(np.where(tgt >= 0, tg_map[np.maximum(tgt, 0)], -1))
        else:
            tg_c.append(np.full(len(p), -1, np.int64))
        t_c.append(np.asarray(p.time_us, np.int64))
        tz_c.append(np.asarray(p.tz_min, np.int16))
        props.extend(p.properties)
    t = np.concatenate(t_c)
    order = np.argsort(t, kind="stable")
    return ColumnarEvents(
        event_code=np.concatenate(ev_c)[order].astype(np.int32),
        entity_code=np.concatenate(en_c)[order].astype(np.int32),
        target_code=np.concatenate(tg_c)[order].astype(np.int32),
        time_us=t[order],
        tz_min=np.concatenate(tz_c)[order],
        event_names=list(ev_tab),
        entity_ids=list(en_tab),
        target_ids=list(tg_tab),
        properties=[props[i] for i in order],
    )


def decode_api_batch(
    body: Sequence[Any], now: datetime | None = None,
) -> list[Event | EventValidationError]:
    """One pass over a JSON batch -> per-slot validated Event or the
    EventValidationError it failed with.  The receive timestamp is taken
    ONCE for the whole batch (events without eventTime/creationTime share
    it), which both matches 'when the server received the batch' and
    drops two ``utcnow()`` calls per event from the hot loop."""
    now = now or utcnow()
    out: list[Event | EventValidationError] = []
    for d in body:
        try:
            out.append(decode_api_event(d, now))
        except EventValidationError as err:
            out.append(err)
        except ValueError as err:  # parity with the row loop's 400 net
            out.append(EventValidationError(str(err)))
    return out
