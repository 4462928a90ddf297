"""In-memory storage driver (``PIO_STORAGE_SOURCES_*_TYPE=memory``).

Counterpart of ``predictionio_tpu/data/storage/memory.py`` for the
repositories of the serving slice (models and engine instances), with the
same process-wide keyed singletons: separately constructed DAOs over one
source name share state, as many clients share one database.
"""

from __future__ import annotations

import copy
import secrets
import threading

from predictionio_tpu_torch.data.storage import base


class _Store:
    """Shared backing state for one named memory source."""

    def __init__(self):
        self.lock = threading.RLock()
        self.models: dict[str, base.Model] = {}
        self.engine_instances: dict[str, base.EngineInstance] = {}


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
