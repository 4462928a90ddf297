"""Segment.io webhook connector.

Copy of ``predictionio_tpu/data/webhooks/segmentio.py`` for the port.

Parity: ``data/.../data/webhooks/segmentio/SegmentIOConnector.scala:31-98``
(identify / track / alias / page / screen / group messages → events named
``$identify``-style ``<type>`` with userId as the entity).
"""

from __future__ import annotations

from typing import Mapping

from predictionio_tpu_torch.data.webhooks.connector import ConnectorError, JsonConnector

SUPPORTED = {"identify", "track", "alias", "page", "screen", "group"}


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: Mapping) -> dict:
        msg_type = data.get("type")
        if msg_type not in SUPPORTED:
            raise ConnectorError(
                f"segmentio message type {msg_type!r} not supported "
                f"(supported: {sorted(SUPPORTED)})"
            )
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorError("segmentio message has no userId/anonymousId")
        properties: dict = {}
        if msg_type == "identify":
            properties = dict(data.get("traits") or {})
        elif msg_type == "track":
            properties = {
                "event": data.get("event"),
                **(data.get("properties") or {}),
            }
        elif msg_type in ("page", "screen"):
            properties = {
                "name": data.get("name"),
                **(data.get("properties") or {}),
            }
        elif msg_type == "group":
            properties = {
                "groupId": data.get("groupId"),
                **(data.get("traits") or {}),
            }
        elif msg_type == "alias":
            properties = {"previousId": data.get("previousId")}
        out = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": {k: v for k, v in properties.items() if v is not None},
        }
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out
