"""Time helpers.

The reference uses joda-time `DateTime` with ISO-8601 wire format and a UTC
default zone (reference: data/.../storage/Event.scala:68 defaultTimeZone).
We use stdlib timezone-aware `datetime` throughout; naive datetimes are
interpreted as UTC.
"""

from __future__ import annotations

import re
from datetime import datetime, timezone

UTC = timezone.utc

# The lenient ISO-8601 grammar the native ingest parser accepts
# (native/eventlog.cpp parse_iso8601): fractional seconds of ANY length
# ('.' or ',' separator, truncated past microseconds) and compact UTC
# offsets (+HH / +HHMM, and lowercase 'z'). Python 3.10's fromisoformat
# only takes .fff/.ffffff and +HH:MM, so without normalization the two
# ingest paths would disagree on real-world timestamps like
# '...T12:00:00.5+02:00' or '...+0530' (found by the native-ingest
# differential fuzzer). 3.11+ accepts these natively; this keeps the
# verdict identical on every interpreter. '+05:' (colon, no minutes)
# stays rejected — the regex requires both digits after a colon.
_LENIENT_ISO_RE = re.compile(
    r"^(?P<prefix>\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}(?::\d{2})?)"
    r"(?:[.,](?P<frac>\d+))?"
    r"(?P<tz>[Zz]|[+-]\d{2}(?::?\d{2})?)?$"
)


def _normalize_iso(s: str) -> str | None:
    m = _LENIENT_ISO_RE.match(s)
    if m is None:
        return None
    prefix, frac, tz = m.group("prefix", "frac", "tz")
    out = prefix
    if frac is not None:
        if prefix[11:].count(":") != 2:
            return None  # fraction requires seconds ('12:00.5' is invalid)
        out += "." + frac[:6].ljust(6, "0")
    if tz is not None:
        if tz in ("Z", "z"):
            out += "+00:00"
        else:
            digits = tz[1:].replace(":", "")
            out += tz[0] + digits[:2] + ":" + (digits[2:] or "00")
    return out


def utcnow() -> datetime:
    return datetime.now(tz=UTC)


def ensure_aware(dt: datetime) -> datetime:
    """Interpret naive datetimes as UTC (joda default-zone behavior)."""
    if dt.tzinfo is None:
        return dt.replace(tzinfo=UTC)
    return dt


def parse_time(s: str) -> datetime:
    """Parse an ISO-8601 timestamp (the Event Server wire format).

    Accepts 'Z' suffix, fractional seconds of any length, and compact
    UTC offsets (+HH / +HHMM) — the exact grammar of the native ingest
    parser (see _LENIENT_ISO_RE); naive input is taken as UTC
    (reference: data/.../storage/Utils.scala stringToDateTime).
    """
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        return ensure_aware(datetime.fromisoformat(s))
    except ValueError:
        normalized = _normalize_iso(s)
        if normalized is None:
            raise
        return ensure_aware(datetime.fromisoformat(normalized))


def format_time(dt: datetime) -> str:
    """ISO-8601 with millisecond precision, matching the reference's wire
    format (e.g. 2004-12-13T21:39:45.618-08:00)."""
    dt = ensure_aware(dt)
    return dt.isoformat(timespec="milliseconds")


def millis(dt: datetime) -> int:
    return int(ensure_aware(dt).timestamp() * 1000)
