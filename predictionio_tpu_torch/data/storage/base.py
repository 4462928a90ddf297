"""Storage DAO contracts for the meta-data and model repositories.

Counterpart of ``predictionio_tpu/data/storage/base.py``, cut to what the
serving slice reads: the :class:`EngineInstance` and :class:`Model` records
and their DAOs (parity: ``EngineInstances.scala``, ``Models.scala``).
Events, apps, access keys and channels come with the training slice.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EngineInstance:
    """One train run's record (parity: ``EngineInstances.scala``).

    Status lifecycle INIT → TRAINING → COMPLETED; deploy only accepts
    COMPLETED instances. ``mesh_conf`` keeps the JAX package's field name
    (the reference's ``sparkConf`` blob) so records read the same.
    """

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict = field(default_factory=dict)
    mesh_conf: dict = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass
class Model:
    """Serialized model blob (parity: ``Models.scala`` Model(id, models))."""

    id: str
    models: bytes


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class EngineInstances(abc.ABC):
    STATUS_INIT = "INIT"
    STATUS_TRAINING = "TRAINING"
    STATUS_COMPLETED = "COMPLETED"
    STATUS_ABORTED = "ABORTED"

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert, assigning id if empty; returns id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Parity: EngineInstances.getLatestCompleted — newest COMPLETED run."""
        candidates = self.get_completed(engine_id, engine_version, engine_variant)
        return candidates[0] if candidates else None

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        """COMPLETED instances, newest first."""

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...
