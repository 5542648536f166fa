"""MailChimp webhook connector (form data).

Behavioral parity with reference webhooks/mailchimp/MailChimpConnector.scala:
subscribe / unsubscribe / profile / upemail / cleaned / campaign form payloads
-> Event JSON. MailChimp posts flat form fields with bracketed keys
(data[merges][FNAME]); nested groups are rebuilt into property objects.
"""

from __future__ import annotations

import re
from typing import Any

from pio_tpu_torch.server.webhooks import ConnectorException, FormConnector
from pio_tpu_torch.utils.time import format_time, parse_time


def _parse_mailchimp_time(s: str) -> str:
    """MailChimp sends 'YYYY-MM-DD HH:MM:SS' (UTC); normalize to ISO
    (reference parseMailChimpDateTime, MailChimpConnector.scala:59)."""
    try:
        return format_time(parse_time(s.replace(" ", "T")))
    except ValueError as e:
        raise ConnectorException(f"Cannot parse MailChimp time {s!r}") from e


def _nested(data: dict[str, str], prefix: str) -> dict[str, Any]:
    """Collect data[merges][X]-style keys under `prefix` into a dict."""
    out: dict[str, Any] = {}
    pat = re.compile(re.escape(prefix) + r"\[([^\]]+)\](.*)")
    for k, v in data.items():
        m = pat.fullmatch(k)
        if not m:
            continue
        name, rest = m.group(1), m.group(2)
        if rest:
            out.setdefault(name, {})
            sub = _nested({f"{prefix}[{name}]{r}": data[f"{prefix}[{name}]{r}"]
                           for r in [rest]}, f"{prefix}[{name}]")
            if isinstance(out[name], dict):
                out[name].update(sub)
        else:
            out[name] = v
    return out


def _req(data: dict[str, str], key: str) -> str:
    if key not in data:
        raise ConnectorException(f"Cannot find '{key}' in MailChimp payload")
    return data[key]


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: dict[str, str]) -> dict[str, Any]:
        typ = _req(data, "type")
        handlers = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }
        if typ not in handlers:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp type {typ} to event JSON."
            )
        return handlers[typ](data)

    def _base(self, data, event, entity_type, entity_id, props):
        return {
            "event": event,
            "entityType": entity_type,
            "entityId": entity_id,
            "properties": props,
            "eventTime": _parse_mailchimp_time(_req(data, "fired_at")),
        }

    def _subscriber_props(self, data) -> dict[str, Any]:
        props = {
            "list_id": data.get("data[list_id]"),
            "email": data.get("data[email]"),
            "email_type": data.get("data[email_type]"),
            "ip_opt": data.get("data[ip_opt]"),
        }
        merges = _nested(data, "data[merges]")
        if merges:
            props["merges"] = merges
        return {k: v for k, v in props.items() if v is not None}

    def _subscribe(self, data):
        return self._base(
            data, "subscribe", "user", _req(data, "data[id]"),
            self._subscriber_props(data),
        )

    def _unsubscribe(self, data):
        props = self._subscriber_props(data)
        for k in ("action", "reason", "campaign_id"):
            v = data.get(f"data[{k}]")
            if v is not None:
                props[k] = v
        return self._base(data, "unsubscribe", "user", _req(data, "data[id]"), props)

    def _profile(self, data):
        return self._base(
            data, "profile", "user", _req(data, "data[id]"),
            self._subscriber_props(data),
        )

    def _upemail(self, data):
        props = {
            "list_id": data.get("data[list_id]"),
            "new_email": data.get("data[new_email]"),
            "old_email": data.get("data[old_email]"),
        }
        return self._base(
            data, "upemail", "user", _req(data, "data[new_id]"),
            {k: v for k, v in props.items() if v is not None},
        )

    def _cleaned(self, data):
        props = {
            "campaign_id": data.get("data[campaign_id]"),
            "reason": data.get("data[reason]"),
            "email": data.get("data[email]"),
        }
        return self._base(
            data, "cleaned", "list", _req(data, "data[list_id]"),
            {k: v for k, v in props.items() if v is not None},
        )

    def _campaign(self, data):
        props = {
            "subject": data.get("data[subject]"),
            "status": data.get("data[status]"),
            "reason": data.get("data[reason]"),
            "list_id": data.get("data[list_id]"),
        }
        return self._base(
            data, "campaign", "campaign", _req(data, "data[id]"),
            {k: v for k, v in props.items() if v is not None},
        )
