"""Engine-developer store API: what templates call to read events.

Counterpart of ``predictionio_tpu/data/store.py:30-177`` (parity:
``store/PEventStore.scala``, ``store/LEventStore.scala`` and the
appName→appId resolution of ``store/Common.scala``): :class:`PEventStore`
reads in bulk by app NAME, :class:`LEventStore` reads rows for
serving-time lookups (a user's recent history).

The active :class:`Storage` is process-global (:func:`set_storage`) and
defaults to the env-configured singleton, as the reference's ``object
Storage`` is ambient.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

from predictionio_tpu_torch.data.batch import EventBatch, Interactions
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage

_active_storage: Optional[Storage] = None


def set_storage(storage: Optional[Storage]) -> None:
    global _active_storage
    _active_storage = storage


def get_storage() -> Storage:
    return _active_storage if _active_storage is not None else Storage.instance()


def resolve_app(
    app_name: str, channel_name: Optional[str] = None
) -> tuple[int, Optional[int]]:
    """appName (+channelName) → (appId, channelId); parity store/Common.scala."""
    storage = get_storage()
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"Invalid app name {app_name!r}")
    channel_id = None
    if channel_name is not None:
        channels = storage.get_meta_data_channels().get_by_app_id(app.id)
        match = [c for c in channels if c.name == channel_name]
        if not match:
            raise ValueError(
                f"Invalid channel name {channel_name!r} for app {app_name!r}"
            )
        channel_id = match[0].id
    return app.id, channel_id


class PEventStore:
    """Bulk columnar reads (parity: PEventStore.find)."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
    ) -> EventBatch:
        app_id, channel_id = resolve_app(app_name, channel_name)
        return get_storage().get_p_events().find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )

    @staticmethod
    def find_interactions(
        app_name: str,
        channel_name: Optional[str] = None,
        entity_type: str = "user",
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: str = "item",
        rating_key: Optional[str] = None,
        default_rating: float = 1.0,
    ) -> Interactions:
        """Bulk (user, item, rating, t) triples for training."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return get_storage().get_p_events().find_interactions(
            app_id,
            channel_id=channel_id,
            entity_type=entity_type,
            event_names=event_names,
            target_entity_type=target_entity_type,
            rating_key=rating_key,
            default_rating=default_rating,
        )

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ):
        """entityId → :class:`~predictionio_tpu_torch.data.event.PropertyMap`
        of the entities of ``entity_type`` (parity: PEventStore.aggregateProperties;
        the fold reads the rows through the event store's ``LEvents``)."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return get_storage().get_l_events().aggregate_properties(
            app_id,
            entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )


class LEventStore:
    """Row reads for serving-time lookups (parity: LEventStore.scala:48-265).

    Rows come in ``(event_time, creation_time)`` order, newest first with
    ``latest=True``, as the storage driver's ``find`` orders them."""

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> list[Event]:
        app_id, channel_id = resolve_app(app_name, channel_name)
        return list(
            get_storage().get_l_events().find(
                app_id,
                channel_id=channel_id,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                start_time=start_time,
                until_time=until_time,
                limit=limit,
                reversed=latest,
            )
        )

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        **filters,
    ) -> list[Event]:
        app_id, channel_id = resolve_app(app_name, channel_name)
        return list(
            get_storage().get_l_events().find(app_id, channel_id=channel_id, **filters)
        )
