"""Example connectors — templates for writing new webhook adapters.

Copy of ``predictionio_tpu/data/webhooks/examples.py`` for the port.

Parity: ``data/.../data/webhooks/examplejson/`` and ``exampleform/`` — the
reference ships minimal connectors demonstrating the JSON and form
interfaces; these are their equivalents (registered as ``examplejson`` /
``exampleform``).
"""

from __future__ import annotations

from typing import Mapping

from predictionio_tpu_torch.data.webhooks.connector import (
    ConnectorError,
    FormConnector,
    JsonConnector,
)


class ExampleJsonConnector(JsonConnector):
    """Expects {"time": ..., "type": ..., "user": ..., ["item": ...]}."""

    def to_event_json(self, data: Mapping) -> dict:
        try:
            out = {
                "event": str(data["type"]),
                "entityType": "user",
                "entityId": str(data["user"]),
            }
        except KeyError as e:
            raise ConnectorError(f"examplejson payload missing field {e}")
        if "item" in data:
            out["targetEntityType"] = "item"
            out["targetEntityId"] = str(data["item"])
        if "time" in data:
            out["eventTime"] = data["time"]
        return out


class ExampleFormConnector(FormConnector):
    """Expects form fields type, userId and optional itemId/timestamp."""

    def to_event_json(self, data: Mapping[str, str]) -> dict:
        if "type" not in data or "userId" not in data:
            raise ConnectorError("exampleform payload needs type and userId")
        out = {
            "event": data["type"],
            "entityType": "user",
            "entityId": data["userId"],
        }
        if data.get("itemId"):
            out["targetEntityType"] = "item"
            out["targetEntityId"] = data["itemId"]
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out
