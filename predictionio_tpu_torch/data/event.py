"""Event model: "<entity> did <event> [on <target entity>] with <properties>
at <time>".

Counterpart of ``predictionio_tpu/data/event.py`` (parity: ``Event.scala``
and ``DataMap.scala``), cut to what the training read and the event server need: the immutable
:class:`Event`, its :class:`DataMap` of properties, the validation every
event passes at construction (``EventValidation``) and the JSON codec the
event server and the sqlite rows use, and the :class:`PropertyMap`
snapshots that ``data/aggregator.py`` folds ``$set``/``$unset``/``$delete``
streams into.
"""

from __future__ import annotations

import datetime as _dt
import json
import secrets
from dataclasses import dataclass, field, replace
from typing import Any, Iterator, Mapping, Optional

UTC = _dt.timezone.utc


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def _parse_time(v: Any) -> _dt.datetime:
    """Accept datetime, epoch seconds/millis, or ISO-8601 string."""
    if isinstance(v, _dt.datetime):
        return v if v.tzinfo else v.replace(tzinfo=UTC)
    if isinstance(v, (int, float)):
        # values beyond 2100-01-01 in seconds are millis
        if v > 4102444800:
            v = v / 1000.0
        return _dt.datetime.fromtimestamp(v, tz=UTC)
    if isinstance(v, str):
        d = _dt.datetime.fromisoformat(v.replace("Z", "+00:00"))
        return d if d.tzinfo else d.replace(tzinfo=UTC)
    raise ValueError(f"cannot parse time: {v!r}")


def parse_time_or_none(v: Any) -> Optional[_dt.datetime]:
    return None if v is None else _parse_time(v)


def format_time(d: _dt.datetime) -> str:
    return d.astimezone(UTC).isoformat(timespec="milliseconds").replace("+00:00", "Z")


class DataMap(Mapping[str, Any]):
    """Immutable JSON-object wrapper (parity: ``DataMap.scala``)."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: dict[str, Any] = dict(fields or {})

    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self):
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    # the getters templates read (parity: DataMap.scala get[T] / getOrElse)
    def require(self, key: str) -> Any:
        if key not in self._fields:
            raise KeyError(f"The field {key} is required.")
        return self._fields[key]

    def get_double(self, key: str) -> float:
        return float(self.require(key))

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields


class PropertyMap(DataMap):
    """A DataMap snapshot of an entity's properties plus its valid-time range
    (parity: ``PropertyMap.scala`` ``firstUpdated``/``lastUpdated``)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(self, fields, first_updated: _dt.datetime, last_updated: _dt.datetime):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first={self.first_updated}, "
            f"last={self.last_updated})"
        )


class EventValidation:
    """Validation rules for events (parity: ``Event.scala`` EventValidation)."""

    SPECIAL_PREFIX = "$"
    SET = "$set"
    UNSET = "$unset"
    DELETE = "$delete"
    SPECIAL_EVENTS = {SET, UNSET, DELETE}

    @classmethod
    def is_special(cls, event: str) -> bool:
        return event.startswith(cls.SPECIAL_PREFIX)

    @classmethod
    def validate(cls, e: "Event") -> None:
        if not e.event:
            raise ValueError("event must not be empty.")
        if not e.entity_type:
            raise ValueError("entityType must not be empty string.")
        if not e.entity_id:
            raise ValueError("entityId must not be empty string.")
        if e.target_entity_type is not None and not e.target_entity_type:
            raise ValueError("targetEntityType must not be empty string.")
        if e.target_entity_id is not None and not e.target_entity_id:
            raise ValueError("targetEntityId must not be empty string.")
        if (e.target_entity_type is None) != (e.target_entity_id is None):
            raise ValueError(
                "targetEntityType and targetEntityId must be specified together."
            )
        if cls.is_special(e.event) and e.event not in cls.SPECIAL_EVENTS:
            raise ValueError(
                f"{e.event} is not a supported reserved event name "
                f"(supported: {sorted(cls.SPECIAL_EVENTS)})."
            )
        # no reserved event may carry a target (parity: Event.scala:129-131)
        if e.event in cls.SPECIAL_EVENTS and e.target_entity_id is not None:
            raise ValueError(f"{e.event} must not have targetEntity.")
        if e.event == cls.UNSET and e.properties.is_empty:
            raise ValueError("$unset must have non-empty properties.")
        if e.event == cls.DELETE and not e.properties.is_empty:
            raise ValueError("$delete must not have properties.")


def new_event_id() -> str:
    return secrets.token_hex(16)


@dataclass(frozen=True)
class Event:
    """One immutable platform event (parity: ``Event.scala:42-99``)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=utcnow)
    tags: tuple[str, ...] = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=utcnow)

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        object.__setattr__(self, "event_time", _parse_time(self.event_time))
        object.__setattr__(self, "creation_time", _parse_time(self.creation_time))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        EventValidation.validate(self)

    def with_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    # JSON codec (parity: EventJson4sSupport.scala APISerializer/DBSerializer)
    def to_dict(self, include_id: bool = True) -> dict[str, Any]:
        d: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": format_time(self.event_time),
            "tags": list(self.tags),
            "prId": self.pr_id,
            "creationTime": format_time(self.creation_time),
        }
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
            d["targetEntityId"] = self.target_entity_id
        if include_id and self.event_id is not None:
            d["eventId"] = self.event_id
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Event":
        if "event" not in d or not isinstance(d["event"], str):
            raise ValueError("field event is required and must be a string")
        kwargs: dict[str, Any] = dict(
            event=d["event"],
            entity_type=d.get("entityType", ""),
            entity_id=str(d.get("entityId", "")),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=(
                None
                if d.get("targetEntityId") is None
                else str(d.get("targetEntityId"))
            ),
            properties=DataMap(d.get("properties") or {}),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
        )
        if d.get("eventTime") is not None:
            kwargs["event_time"] = _parse_time(d["eventTime"])
        if d.get("creationTime") is not None:
            kwargs["creation_time"] = _parse_time(d["creationTime"])
        if d.get("eventId") is not None:
            kwargs["event_id"] = d["eventId"]
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Event":
        return cls.from_dict(json.loads(s))
