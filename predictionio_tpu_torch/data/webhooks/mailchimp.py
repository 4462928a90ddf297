"""MailChimp webhook connector (form-encoded payloads).

Copy of ``predictionio_tpu/data/webhooks/mailchimp.py`` for the port.

Parity: ``data/.../data/webhooks/mailchimp/MailChimpConnector.scala``
(subscribe / unsubscribe / profile / upemail / cleaned / campaign events;
MailChimp posts bracket-keyed form fields like ``data[email]``).
"""

from __future__ import annotations

from typing import Mapping

from predictionio_tpu_torch.data.webhooks.connector import ConnectorError, FormConnector

SUPPORTED = {"subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign"}


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: Mapping[str, str]) -> dict:
        event_type = data.get("type")
        if event_type not in SUPPORTED:
            raise ConnectorError(
                f"mailchimp event type {event_type!r} not supported "
                f"(supported: {sorted(SUPPORTED)})"
            )
        props = {
            k[5:-1]: v for k, v in data.items() if k.startswith("data[") and k.endswith("]")
        }
        if event_type == "cleaned":
            entity_id = props.get("email")
        elif event_type == "upemail":
            entity_id = props.get("new_email") or props.get("old_email")
        elif event_type == "campaign":
            entity_id = props.get("id")
        else:
            entity_id = props.get("email") or props.get("id")
        if not entity_id:
            raise ConnectorError(f"mailchimp {event_type} payload has no entity id")
        out = {
            "event": event_type,
            "entityType": "campaign" if event_type == "campaign" else "user",
            "entityId": str(entity_id),
            "properties": props,
        }
        if data.get("fired_at"):
            out["eventTime"] = data["fired_at"].replace(" ", "T") + "+00:00"
        return out
