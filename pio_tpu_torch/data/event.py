"""Canonical event record + validation.

Behavioral contract mirrors reference data/.../storage/Event.scala:8-164:
same fields, same validation rules (empty checks, target-entity pairing,
$set/$unset/$delete special events, `pio_`/`$` reserved prefixes, built-in
entity type `pio_pr`).
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Sequence

from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.utils.time import ensure_aware, format_time, parse_time, utcnow

SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


class EventValidationError(ValueError):
    pass


@dataclass(frozen=True)
class Event:
    """One event (reference Event.scala:40-58)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=utcnow)
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    event_id: str | None = None
    creation_time: datetime = field(default_factory=utcnow)

    def __post_init__(self):
        object.__setattr__(self, "event_time", ensure_aware(self.event_time))
        object.__setattr__(self, "creation_time", ensure_aware(self.creation_time))
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(dict(self.properties)))
        if not isinstance(self.tags, tuple):
            object.__setattr__(self, "tags", tuple(self.tags))

    def with_id(self, event_id: str) -> "Event":
        # bare __dict__ copy, NOT dataclasses.replace (re-runs
        # __init__/__post_init__ tz/DataMap coercion) and NOT copy.copy
        # (routes through __reduce_ex__, ~6x slower) — this is the
        # hottest line of the ingest pipeline, one call per insert
        e = object.__new__(Event)
        e.__dict__.update(self.__dict__)
        e.__dict__["event_id"] = event_id
        return e

    # -- wire format (reference EventJson4sSupport.scala APISerializer) -----
    def to_api_dict(self, with_id: bool = True) -> dict[str, Any]:
        d: dict[str, Any] = {}
        if with_id and self.event_id is not None:
            d["eventId"] = self.event_id
        d.update(
            event=self.event,
            entityType=self.entity_type,
            entityId=self.entity_id,
        )
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        d["properties"] = dict(self.properties.fields)
        d["eventTime"] = format_time(self.event_time)
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        d["creationTime"] = format_time(self.creation_time)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_api_dict(), sort_keys=True)

    @staticmethod
    def from_api_dict(d: dict[str, Any], now: datetime | None = None) -> "Event":
        """Decode one API dict. ``now`` is the receive timestamp used when
        eventTime/creationTime are absent — batch decoders pass one shared
        value so a 50-event batch costs one utcnow(), not 100. THE single
        implementation of the wire-decode rules (the columnar batch path
        wraps this; keep it that way so the two cannot drift)."""
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e
        for k in ("event", "entityType", "entityId"):
            if not isinstance(d[k], str):
                raise EventValidationError(f"field {k} must be a string")
        for k in ("targetEntityType", "targetEntityId", "prId", "eventId"):
            v = d.get(k)
            if v is not None and not isinstance(v, str):
                raise EventValidationError(f"field {k} must be a string")
        props = d.get("properties", {}) or {}
        if not isinstance(props, dict):
            raise EventValidationError("properties must be a JSON object")
        ev_time = d.get("eventTime")
        try:
            event_time = parse_time(ev_time) if ev_time else (now or utcnow())
        except (ValueError, TypeError, AttributeError) as e:
            raise EventValidationError(f"invalid eventTime: {ev_time}") from e
        creation = d.get("creationTime")
        try:
            if creation:
                creation_time = parse_time(creation)
            elif now is not None:
                creation_time = now
            elif not ev_time:
                creation_time = event_time  # share the one utcnow() above
            else:
                creation_time = utcnow()
        except (ValueError, TypeError, AttributeError) as e:
            raise EventValidationError(f"invalid creationTime: {creation}") from e
        tags = d.get("tags", []) or []
        if not isinstance(tags, list) or not all(isinstance(t, str) for t in tags):
            raise EventValidationError("tags must be a list of strings")
        # fast construction: every field above is already coerced (aware
        # datetimes from parse_time/utcnow, DataMap, tuple), so re-running
        # __post_init__'s checks would only tax the ingest hot loop
        e = object.__new__(Event)
        s = object.__setattr__
        s(e, "event", event)
        s(e, "entity_type", entity_type)
        s(e, "entity_id", entity_id)
        s(e, "target_entity_type", d.get("targetEntityType"))
        s(e, "target_entity_id", d.get("targetEntityId"))
        s(e, "properties", DataMap(dict(props)))
        s(e, "event_time", event_time)
        s(e, "tags", tuple(tags))
        s(e, "pr_id", d.get("prId"))
        s(e, "event_id", d.get("eventId"))
        s(e, "creation_time", creation_time)
        return e

    @staticmethod
    def from_json(s: str) -> "Event":
        return Event.from_api_dict(json.loads(s))


def is_reserved_prefix(name: str) -> bool:
    """Reference Event.scala:75-76."""
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EventValidationError(msg)


def validate_event(e: Event) -> None:
    """Full validation contract of reference Event.scala:109-163."""
    _require(bool(e.event), "event must not be empty.")
    _require(bool(e.entity_type), "entityType must not be empty string.")
    _require(bool(e.entity_id), "entityId must not be empty string.")
    _require(
        e.target_entity_type is None or bool(e.target_entity_type),
        "targetEntityType must not be empty string",
    )
    _require(
        e.target_entity_id is None or bool(e.target_entity_id),
        "targetEntityId must not be empty string.",
    )
    _require(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    _require(
        not (e.event == "$unset" and e.properties.is_empty()),
        "properties cannot be empty for $unset event",
    )
    _require(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    _require(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    _require(
        not is_reserved_prefix(e.entity_type) or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    _require(
        e.target_entity_type is None
        or not is_reserved_prefix(e.target_entity_type)
        or e.target_entity_type in BUILTIN_ENTITY_TYPES,
        f"The targetEntityType {e.target_entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    for k in e.properties.key_set():
        _require(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )


def validate_events(events: Sequence[Event]) -> None:
    for e in events:
        validate_event(e)
