"""In-memory storage driver (``PIO_STORAGE_SOURCES_*_TYPE=memory``).

Counterpart of ``predictionio_tpu/data/storage/memory.py`` (events, apps,
access keys, channels, sequences, models and engine instances), with the
same process-wide keyed singletons: separately constructed DAOs over one
source name share state, as many clients share one database.
"""

from __future__ import annotations

import copy
import datetime as _dt
import itertools
import secrets
import threading
from typing import Iterable, Optional, Sequence

from predictionio_tpu_torch.data.batch import EventBatch
from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base


class _Store:
    """Shared backing state for one named memory source."""

    def __init__(self):
        self.lock = threading.RLock()
        self.events: dict[tuple[int, int], dict[str, Event]] = {}
        self.models: dict[str, base.Model] = {}
        self.apps: dict[int, base.App] = {}
        self.access_keys: dict[str, base.AccessKey] = {}
        self.channels: dict[int, base.Channel] = {}
        self.engine_instances: dict[str, base.EngineInstance] = {}
        self.seq = itertools.count(1)
        self.sequences: dict[str, int] = {}


_STORES: dict[str, _Store] = {}
_STORES_LOCK = threading.Lock()


def get_store(name: str = "default") -> _Store:
    with _STORES_LOCK:
        if name not in _STORES:
            _STORES[name] = _Store()
        return _STORES[name]


def reset_store(name: str = "default") -> None:
    with _STORES_LOCK:
        _STORES.pop(name, None)


def _aware(d: Optional[_dt.datetime]) -> Optional[_dt.datetime]:
    """Naive filter datetimes are interpreted as UTC."""
    if d is not None and d.tzinfo is None:
        return d.replace(tzinfo=_dt.timezone.utc)
    return d


def match_event(
    e: Event,
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=None,
    target_entity_id=None,
) -> bool:
    """The event filter of ``find``: time range [start, until);
    ``target_entity_type="None"`` (the string) matches events WITHOUT a
    target (parity: LEvents.futureFind / PEvents.find)."""
    start_time, until_time = _aware(start_time), _aware(until_time)
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in set(event_names):
        return False
    if target_entity_type is not None:
        want = None if target_entity_type == "None" else target_entity_type
        if e.target_entity_type != want:
            return False
    if target_entity_id is not None:
        want = None if target_entity_id == "None" else target_entity_id
        if e.target_entity_id != want:
            return False
    return True


def _key(app_id: int, channel_id: Optional[int]) -> tuple[int, int]:
    """The default channel (None) and channel 0 are one namespace."""
    return (app_id, 0 if channel_id is None else channel_id)


class MemoryLEvents(base.LEvents):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._s.lock:
            self._s.events.setdefault(_key(app_id, channel_id), {})
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._s.lock:
            self._s.events.pop(_key(app_id, channel_id), None)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events, app_id, channel_id=None):
        # ids and rows are made before the lock: a bad event fails the
        # whole batch with nothing written
        ids = []
        rows = {}
        for event in events:
            eid = event.event_id or new_event_id()
            ids.append(eid)
            rows[eid] = event.with_id(eid)
        with self._s.lock:
            self._s.events.setdefault(_key(app_id, channel_id), {}).update(rows)
        return ids

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None):
        with self._s.lock:
            return self._s.events.get(_key(app_id, channel_id), {}).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._s.lock:
            ns = self._s.events.get(_key(app_id, channel_id), {})
            return ns.pop(event_id, None) is not None

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        with self._s.lock:
            evs = list(self._s.events.get(_key(app_id, channel_id), {}).values())
        evs = [
            e
            for e in evs
            if match_event(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        ]
        evs.sort(key=lambda e: (e.event_time, e.creation_time), reverse=reversed)
        if limit is not None and limit >= 0:
            evs = evs[:limit]
        return evs


class MemoryPEvents(base.PEvents):
    def __init__(self, source_name: str = "default", **_):
        self._l = MemoryLEvents(source_name)

    def find(self, app_id, channel_id=None, **filters) -> EventBatch:
        return EventBatch.from_events(self._l.find(app_id, channel_id, **filters))


class MemorySequences(base.Sequences):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def gen_next(self, name: str) -> int:
        with self._s.lock:
            nxt = self._s.sequences.get(name, 0) + 1
            self._s.sequences[name] = nxt
            return nxt


class MemoryApps(base.Apps):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def insert(self, app: base.App):
        with self._s.lock:
            if self.get_by_name(app.name) is not None:
                return None
            if app.id > 0:
                if app.id in self._s.apps:
                    return None
                app_id = app.id
            else:
                app_id = next(self._s.seq)
                while app_id in self._s.apps:
                    app_id = next(self._s.seq)
            self._s.apps[app_id] = base.App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int):
        with self._s.lock:
            a = self._s.apps.get(app_id)
            return copy.copy(a) if a else None

    def get_by_name(self, name: str):
        with self._s.lock:
            for a in self._s.apps.values():
                if a.name == name:
                    return copy.copy(a)
        return None

    def get_all(self):
        with self._s.lock:
            return sorted(
                (copy.copy(a) for a in self._s.apps.values()), key=lambda a: a.id
            )

    def update(self, app: base.App) -> bool:
        with self._s.lock:
            if app.id not in self._s.apps:
                return False
            self._s.apps[app.id] = base.App(app.id, app.name, app.description)
            return True

    def delete(self, app_id: int) -> bool:
        with self._s.lock:
            return self._s.apps.pop(app_id, None) is not None


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def insert(self, access_key: base.AccessKey):
        key = access_key.key or self.generate_key()
        with self._s.lock:
            if key in self._s.access_keys:
                return None
            self._s.access_keys[key] = base.AccessKey(
                key, access_key.app_id, list(access_key.events)
            )
        return key

    def get(self, key: str):
        with self._s.lock:
            k = self._s.access_keys.get(key)
            return copy.deepcopy(k) if k else None

    def get_all(self):
        with self._s.lock:
            return [copy.deepcopy(k) for k in self._s.access_keys.values()]

    def get_by_app_id(self, app_id: int):
        with self._s.lock:
            return [
                copy.deepcopy(k)
                for k in self._s.access_keys.values()
                if k.app_id == app_id
            ]

    def update(self, access_key: base.AccessKey) -> bool:
        with self._s.lock:
            if access_key.key not in self._s.access_keys:
                return False
            self._s.access_keys[access_key.key] = base.AccessKey(
                access_key.key, access_key.app_id, list(access_key.events)
            )
            return True

    def delete(self, key: str) -> bool:
        with self._s.lock:
            return self._s.access_keys.pop(key, None) is not None


class MemoryChannels(base.Channels):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def insert(self, channel: base.Channel):
        if not base.Channel.is_valid_name(channel.name):
            return None
        with self._s.lock:
            if channel.id > 0:
                if channel.id in self._s.channels:
                    return None
                cid = channel.id
            else:
                cid = next(self._s.seq)
                while cid in self._s.channels:
                    cid = next(self._s.seq)
            self._s.channels[cid] = base.Channel(cid, channel.name, channel.app_id)
            return cid

    def get(self, channel_id: int):
        with self._s.lock:
            c = self._s.channels.get(channel_id)
            return copy.copy(c) if c else None

    def get_by_app_id(self, app_id: int):
        with self._s.lock:
            return [
                copy.copy(c)
                for c in self._s.channels.values()
                if c.app_id == app_id
            ]

    def delete(self, channel_id: int) -> bool:
        with self._s.lock:
            return self._s.channels.pop(channel_id, None) is not None


class MemoryModels(base.Models):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def insert(self, model: base.Model) -> None:
        with self._s.lock:
            self._s.models[model.id] = model

    def get(self, model_id: str):
        with self._s.lock:
            return self._s.models.get(model_id)

    def delete(self, model_id: str) -> None:
        with self._s.lock:
            self._s.models.pop(model_id, None)


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self, source_name: str = "default", **_):
        self._s = get_store(source_name)

    def insert(self, instance: base.EngineInstance) -> str:
        iid = instance.id or secrets.token_hex(8)
        instance.id = iid
        with self._s.lock:
            # store a snapshot so later caller mutations require update()
            self._s.engine_instances[iid] = copy.deepcopy(instance)
        return iid

    def get(self, instance_id: str):
        with self._s.lock:
            got = self._s.engine_instances.get(instance_id)
            return copy.deepcopy(got) if got is not None else None

    def get_all(self):
        with self._s.lock:
            return [copy.deepcopy(i) for i in self._s.engine_instances.values()]

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self._s.lock:
            out = [
                copy.deepcopy(i)
                for i in self._s.engine_instances.values()
                if i.status == self.STATUS_COMPLETED
                and i.engine_id == engine_id
                and i.engine_version == engine_version
                and i.engine_variant == engine_variant
            ]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def update(self, instance: base.EngineInstance) -> bool:
        with self._s.lock:
            if instance.id not in self._s.engine_instances:
                return False
            self._s.engine_instances[instance.id] = copy.deepcopy(instance)
            return True

    def delete(self, instance_id: str) -> bool:
        with self._s.lock:
            return self._s.engine_instances.pop(instance_id, None) is not None
