"""segment.io webhook connector.

Behavioral parity with reference webhooks/segmentio/SegmentIOConnector.scala:
maps identify/track/alias/page/screen/group payloads to Event JSON with
entityType "user", entityId = userId or anonymousId, and type-specific
properties; the optional `context` object is folded into properties.
"""

from __future__ import annotations

from typing import Any

from pio_tpu_torch.server.webhooks import ConnectorException, JsonConnector


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: dict[str, Any]) -> dict[str, Any]:
        if "version" not in data:
            raise ConnectorException("Failed to get segment.io API version.")
        typ = data.get("type")
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields."
            )
        timestamp = data.get("timestamp")
        if not timestamp:
            raise ConnectorException("missing timestamp")

        if typ == "identify":
            props: dict[str, Any] = {"traits": data.get("traits")}
        elif typ == "track":
            props = {
                "properties": data.get("properties"),
                "event": data.get("event"),
            }
        elif typ == "alias":
            props = {"previous_id": data.get("previousId")}
        elif typ == "page":
            props = {"name": data.get("name"), "properties": data.get("properties")}
        elif typ == "screen":
            props = {"name": data.get("name"), "properties": data.get("properties")}
        elif typ == "group":
            props = {"group_id": data.get("groupId"), "traits": data.get("traits")}
        else:
            raise ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON."
            )

        if data.get("context") is not None:
            props["context"] = data["context"]
        props = {k: v for k, v in props.items() if v is not None}
        return {
            "event": typ,
            "entityType": "user",
            "entityId": user_id,
            "properties": props,
            "eventTime": timestamp,
        }
