"""Example connectors used by tests and as templates for custom connectors
(reference webhooks/examplejson/ExampleJsonConnector.scala and
webhooks/exampleform/ExampleFormConnector.scala)."""

from __future__ import annotations

from typing import Any

from pio_tpu_torch.server.webhooks import ConnectorException, FormConnector, JsonConnector


class ExampleJsonConnector(JsonConnector):
    """userAction / userActionItem JSON payloads -> Event JSON."""

    def to_event_json(self, data: dict[str, Any]) -> dict[str, Any]:
        typ = data.get("type")
        if typ == "userAction":
            return self._user_action(data)
        if typ == "userActionItem":
            return self._user_action_item(data)
        raise ConnectorException(
            f"Cannot convert unknown type {typ!r} to event JSON"
        )

    @staticmethod
    def _req(data, key):
        if key not in data:
            raise ConnectorException(f"Cannot find '{key}' in payload")
        return data[key]

    def _user_action(self, data):
        props = {
            "context": data.get("context"),
            "anotherProperty1": self._req(data, "anotherProperty1"),
            "anotherProperty2": data.get("anotherProperty2"),
        }
        return {
            "event": self._req(data, "event"),
            "entityType": "user",
            "entityId": self._req(data, "userId"),
            "properties": {k: v for k, v in props.items() if v is not None},
            "eventTime": self._req(data, "timestamp"),
        }

    def _user_action_item(self, data):
        props = {
            "context": self._req(data, "context"),
            "anotherPropertyA": data.get("anotherPropertyA"),
            "anotherPropertyB": data.get("anotherPropertyB"),
        }
        return {
            "event": self._req(data, "event"),
            "entityType": "user",
            "entityId": self._req(data, "userId"),
            "targetEntityType": "item",
            "targetEntityId": self._req(data, "itemId"),
            "properties": {k: v for k, v in props.items() if v is not None},
            "eventTime": self._req(data, "timestamp"),
        }


class ExampleFormConnector(FormConnector):
    """userAction / userActionItem form payloads with context[...] fields."""

    def to_event_json(self, data: dict[str, str]) -> dict[str, Any]:
        typ = data.get("type")
        if typ == "userAction":
            return self._user_action(data)
        if typ == "userActionItem":
            return self._user_action_item(data)
        raise ConnectorException(
            f"Cannot convert unknown type {typ!r} to event JSON"
        )

    @staticmethod
    def _req(data, key):
        if key not in data:
            raise ConnectorException(f"Cannot find '{key}' in form data")
        return data[key]

    @staticmethod
    def _context(data) -> dict[str, str]:
        return {
            k[len("context["):-1]: v
            for k, v in data.items()
            if k.startswith("context[") and k.endswith("]")
        }

    def _user_action(self, data):
        props: dict[str, Any] = {
            "anotherProperty1": self._req(data, "anotherProperty1"),
        }
        if "anotherProperty2" in data:
            props["anotherProperty2"] = data["anotherProperty2"]
        ctx = self._context(data)
        if ctx:
            props["context"] = ctx
        return {
            "event": self._req(data, "event"),
            "entityType": "user",
            "entityId": self._req(data, "userId"),
            "properties": props,
            "eventTime": self._req(data, "timestamp"),
        }

    def _user_action_item(self, data):
        props: dict[str, Any] = {"context": self._context(data)}
        if "anotherPropertyA" in data:
            props["anotherPropertyA"] = data["anotherPropertyA"]
        if "anotherPropertyB" in data:
            props["anotherPropertyB"] = data["anotherPropertyB"]
        return {
            "event": self._req(data, "event"),
            "entityType": "user",
            "entityId": self._req(data, "userId"),
            "targetEntityType": "item",
            "targetEntityId": self._req(data, "itemId"),
            "properties": props,
            "eventTime": self._req(data, "timestamp"),
        }
