"""DataMap / PropertyMap — the JSON-backed property bag attached to events.

Behavioral contract mirrors reference data/.../storage/DataMap.scala:41-241 and
PropertyMap.scala:33-96: typed required/optional getters, merge (`++`),
key-removal (`--`), and PropertyMap = aggregated fields + first/lastUpdated.
Values are plain JSON-compatible Python values (None, bool, int, float, str,
list, dict).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Iterator

from pio_tpu_torch.utils.time import parse_time


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type
    (reference: DataMap.scala DataMapException)."""


@dataclass(frozen=True)
class DataMap:
    """Immutable mapping of property name -> JSON value.

    Deliberately NOT a collections.abc.Mapping: `get` here is the reference's
    required typed getter (DataMap.scala get[T]) whose signature differs from
    Mapping.get(key, default). Dict-like iteration still works via
    __getitem__/__iter__/keys.
    """

    fields: dict[str, Any] = field(default_factory=dict)

    # -- dict-like protocol -------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return self.fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def keys(self):
        return self.fields.keys()

    def items(self):
        return self.fields.items()

    def values(self):
        return self.fields.values()

    # -- reference API ------------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self.fields:
            raise DataMapError(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self.fields

    def get(self, name: str, expected: type | None = None) -> Any:
        """Required getter: raises DataMapError when absent or null
        (reference DataMap.scala get[T])."""
        self.require(name)
        v = self.fields[name]
        if v is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return _coerce(name, v, expected)

    def get_opt(self, name: str, expected: type | None = None) -> Any | None:
        """Optional getter: None when absent (reference getOpt[T])."""
        v = self.fields.get(name, None)
        if v is None:
            return None
        return _coerce(name, v, expected)

    def get_or_else(self, name: str, default: Any) -> Any:
        v = self.get_opt(name)
        return default if v is None else v

    def get_datetime(self, name: str) -> datetime:
        return parse_time(self.get(name, str))

    def get_str_list(self, name: str) -> list[str]:
        v = self.get(name, list)
        return [str(x) for x in v]

    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """`++` — right-biased union (reference DataMap.scala ++)."""
        d = dict(self.fields)
        d.update(other.fields if isinstance(other, DataMap) else other)
        return DataMap(d)

    def remove(self, keys) -> "DataMap":
        """`--` — drop the given keys (reference DataMap.scala --)."""
        ks = set(keys)
        return DataMap({k: v for k, v in self.fields.items() if k not in ks})

    def key_set(self) -> set[str]:
        return set(self.fields)

    def is_empty(self) -> bool:
        return not self.fields

    def to_json(self) -> str:
        return json.dumps(self.fields, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "DataMap":
        obj = json.loads(s) if s else {}
        if not isinstance(obj, dict):
            raise DataMapError("DataMap JSON must be an object")
        return DataMap(obj)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self.fields == other.fields
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_json())


def _coerce(name: str, v: Any, expected: type | None) -> Any:
    if expected is None:
        return v
    if expected is float and isinstance(v, int) and not isinstance(v, bool):
        return float(v)
    if expected is int and isinstance(v, float) and v.is_integer():
        return int(v)
    if expected is bool and not isinstance(v, bool):
        raise DataMapError(f"The field {name} is not a {expected.__name__}.")
    if not isinstance(v, expected) or (expected is int and isinstance(v, bool)):
        raise DataMapError(f"The field {name} is not a {expected.__name__}.")
    return v


@dataclass(frozen=True)
class PropertyMap(DataMap):
    """Aggregated entity properties plus first/last update times
    (reference PropertyMap.scala:33-96)."""

    first_updated: datetime | None = None
    last_updated: datetime | None = None

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.fields == other.fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        if isinstance(other, DataMap):
            return self.fields == other.fields
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.to_json(), self.first_updated, self.last_updated))
