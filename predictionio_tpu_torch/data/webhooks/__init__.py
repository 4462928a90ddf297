"""Webhook connectors: third-party payloads into events (copy of
``predictionio_tpu/data/webhooks/`` for the port)."""

from predictionio_tpu_torch.data.webhooks.connector import (
    ConnectorError,
    FormConnector,
    JsonConnector,
    get_form_connector,
    get_json_connector,
    register_form_connector,
    register_json_connector,
)

__all__ = [
    "ConnectorError",
    "FormConnector",
    "JsonConnector",
    "get_form_connector",
    "get_json_connector",
    "register_form_connector",
    "register_json_connector",
]
