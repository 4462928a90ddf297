"""Webhook connector interface: third-party payload → Event JSON.

Copy of ``predictionio_tpu/data/webhooks/connector.py`` for the port.

Parity: ``data/.../data/webhooks/{JsonConnector,FormConnector}.scala`` and
``ConnectorUtil.scala``.  Connectors are registered by name (the Python
replacement for the reference's hardwired connector map in
``api/WebhooksConnectors.scala``) and mounted by the event server at
``/webhooks/<name>.json`` / ``/webhooks/<name>.form``.
"""

from __future__ import annotations

import abc
from typing import Mapping

from predictionio_tpu_torch.data.event import Event


class ConnectorError(Exception):
    """Payload cannot be converted (reference: ConnectorException)."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping) -> dict:
        """JSON payload → Event-shaped dict (raise ConnectorError if bad)."""


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict:
        """Form fields → Event-shaped dict (raise ConnectorError if bad)."""


_JSON: dict[str, JsonConnector] = {}
_FORM: dict[str, FormConnector] = {}


def register_json_connector(name: str, connector: JsonConnector) -> None:
    _JSON[name] = connector


def register_form_connector(name: str, connector: FormConnector) -> None:
    _FORM[name] = connector


def get_json_connector(name: str) -> JsonConnector | None:
    return _JSON.get(name)


def get_form_connector(name: str) -> FormConnector | None:
    return _FORM.get(name)


def connector_to_event(connector, data) -> Event:
    """Parity: ConnectorUtil.toEvent — convert then validate."""
    return Event.from_dict(connector.to_event_json(data))
