"""Webhook connectors: third-party payloads -> Event JSON.

Reference data/.../webhooks/JsonConnector.scala:21-29 (trait JsonConnector /
FormConnector + ConnectorException) and the registry in
api/WebhooksConnectors.scala:24. A JSON connector maps a JSON object; a form
connector maps urlencoded form fields. Both return an Event-API-shaped dict
consumed by Event.from_api_dict.
"""

from __future__ import annotations

import abc
from typing import Any


class ConnectorException(Exception):
    pass


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: dict[str, Any]) -> dict[str, Any]: ...


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: dict[str, str]) -> dict[str, Any]: ...


def default_connectors() -> tuple[dict[str, JsonConnector], dict[str, FormConnector]]:
    """The built-in registry (reference WebhooksConnectors.scala:24:
    segmentio + examplejson JSON; mailchimp + exampleform form)."""
    from pio_tpu_torch.server.webhooks.segmentio import SegmentIOConnector
    from pio_tpu_torch.server.webhooks.mailchimp import MailChimpConnector
    from pio_tpu_torch.server.webhooks.example import (
        ExampleFormConnector,
        ExampleJsonConnector,
    )

    json_connectors = {
        "segmentio": SegmentIOConnector(),
        "examplejson": ExampleJsonConnector(),
    }
    form_connectors = {
        "mailchimp": MailChimpConnector(),
        "exampleform": ExampleFormConnector(),
    }
    return json_connectors, form_connectors
