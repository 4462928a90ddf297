"""Fold ``$set/$unset/$delete`` event streams into entity-property snapshots.

Counterpart of ``predictionio_tpu/data/aggregator.py`` (parity:
``LEventAggregator.scala:42-148``): the materialized entity state behind
``aggregate_properties``, which the similar-product, e-commerce and
classification templates read.

* ``$set``    — merge properties over the current state
* ``$unset``  — remove the named keys
* ``$delete`` — drop the entity entirely (state restarts from nothing)
* events fold in ``(event_time, creation_time)`` order; an entity whose fold
  ends deleted yields no snapshot.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Iterable, Optional

from predictionio_tpu_torch.data.event import Event, EventValidation, PropertyMap


@dataclass
class PropertyAggregate:
    """Running aggregation state for one entity (parity: LEventAggregator.Prop)."""

    fields: Optional[dict] = None  # None ⇒ entity deleted / never set
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    def update(self, e: Event) -> "PropertyAggregate":
        t = e.event_time
        if e.event == EventValidation.SET:
            base = dict(self.fields) if self.fields is not None else {}
            base.update(e.properties.to_dict())
            first = self.first_updated if self.fields is not None else t
            return PropertyAggregate(base, first or t, t)
        if e.event == EventValidation.UNSET:
            if self.fields is None:
                return self
            base = {k: v for k, v in self.fields.items() if k not in e.properties}
            return PropertyAggregate(base, self.first_updated, t)
        if e.event == EventValidation.DELETE:
            return PropertyAggregate(None, None, None)
        return self

    def to_property_map(self) -> Optional[PropertyMap]:
        if self.fields is None:
            return None
        return PropertyMap(self.fields, self.first_updated, self.last_updated)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """entityId → PropertyMap for a stream of special events of ONE entityType,
    folded in ``(event_time, creation_time)`` order."""
    per_entity: dict[str, list[Event]] = {}
    for e in events:
        if e.event in EventValidation.SPECIAL_EVENTS:
            per_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in per_entity.items():
        evs.sort(key=lambda e: (e.event_time, e.creation_time))
        agg = PropertyAggregate()
        for e in evs:
            agg = agg.update(e)
        pm = agg.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out
