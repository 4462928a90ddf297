"""Storage DAO contracts for the event, meta-data and model repositories.

Counterpart of ``predictionio_tpu/data/storage/base.py``, cut to what the
serving and training slices use:

* :class:`LEvents` — row-oriented event DAO (parity: ``LEvents.scala``);
* :class:`PEvents` — bulk event DAO returning a columnar
  :class:`~predictionio_tpu_torch.data.batch.EventBatch`, with
  ``find_interactions`` for training reads (parity: ``PEvents.scala``);
* :class:`Apps`, :class:`AccessKeys`, :class:`Channels`, :class:`Sequences`,
  :class:`EngineInstances`, :class:`EvaluationInstances`, :class:`Models`
  and their records.

``LEvents.aggregate_properties`` folds ``$set``/``$unset``/``$delete`` into
entity snapshots (``data/aggregator.py``). ``PEvents.find`` and
``find_interactions`` take ``shard=(index, count)`` and ``shard_key`` for the
1/N read of a launch (``parallel/ingest.py``), with the JAX package's crc32
entity hash (:meth:`PEvents.shard_hash`). Bulk writes and deletes through
``PEvents`` (writers use ``LEvents``), free-text search and the instances'
field queries come with later slices.
"""

from __future__ import annotations

import abc
import datetime as _dt
import re
import secrets
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.batch import EventBatch
from predictionio_tpu_torch.data.event import Event, EventValidation, PropertyMap


@dataclass
class App:
    """Parity: ``Apps.scala`` case class App(id, name, description)."""

    id: int
    name: str
    description: Optional[str] = None


@dataclass
class AccessKey:
    """Parity: ``AccessKeys.scala`` (key, appid, events whitelist)."""

    key: str
    app_id: int
    events: list[str] = field(default_factory=list)


@dataclass
class Channel:
    """Parity: ``Channels.scala`` (id, name, appid) + name validation."""

    id: int
    name: str
    app_id: int

    NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")

    @classmethod
    def is_valid_name(cls, s: str) -> bool:
        return bool(cls.NAME_RE.match(s))


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
class EvaluationInstance:
    """One evaluation run's record (parity: ``EvaluationInstances.scala``).

    Status lifecycle INIT → EVALUATING → EVALCOMPLETED (or ABORTED)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict = field(default_factory=dict)
    mesh_conf: dict = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass
class Model:
    """Serialized model blob (parity: ``Models.scala`` Model(id, models))."""

    id: str
    models: bytes


class LEvents(abc.ABC):
    """Row-oriented event store: inserts, point reads, filtered scans."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize storage for an (app, channel) namespace."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of the namespace."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        """Insert one event, returning its eventId."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        """Insert many events, returning their eventIds in input order;
        pre-set ``event_id`` values are kept. The default loops
        :meth:`insert`."""
        return [self.insert(e, app_id, channel_id) for e in events]

    def batch_insert(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        """Alias of :meth:`insert_batch` (what ``PEvents.write`` calls)."""
        return self.insert_batch(events, app_id, channel_id)

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> bool: ...

    @abc.abstractmethod
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
        """Filtered scan ordered by event_time (parity: LEvents.futureFind).

        ``limit=None`` means all; ``reversed=True`` returns latest first. A
        ``target_entity_type``/``target_entity_id`` of the string "None"
        filters for events WITHOUT a target.
        """

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """Fold $set/$unset/$delete into snapshots (parity: LEvents:~430),
        keeping the entities that hold every ``required`` key."""
        snapshots = aggregate_properties(self.find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=sorted(EventValidation.SPECIAL_EVENTS),
        ))
        if not required:
            return snapshots
        return {eid: pm for eid, pm in snapshots.items() if all(k in pm for k in required)}


class PEvents(abc.ABC):
    """Bulk/columnar event store (parity: ``PEvents.scala:38-189``)."""

    @abc.abstractmethod
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
        shard: Optional[tuple] = None,
        shard_key: str = "row",
    ) -> EventBatch:
        """Filtered columnar scan of every matching row, or of shard
        ``shard = (index, count)`` of them:

        * ``"row"`` — a disjoint, covering split the backend defines
          (positional here, the rowid modulo in sqlite);
        * ``"entity"`` — ``shard_hash(entity_id) % count``: all events of
          one entity land on one shard (the user pass);
        * ``"target"`` — the same keyed by ``target_entity_id`` (the item
          pass); rows without a target go to shard 0.
        """

    @staticmethod
    def shard_hash(s: str) -> int:
        """The entity → shard hash every backend shares: crc32 of the UTF-8 bytes,
        the same on every process and run (Python's ``hash`` is salted)."""
        return zlib.crc32(s.encode("utf-8"))

    @staticmethod
    def shard_sql_predicate(shard_key: str, row_pred: str) -> str:
        """The SQL text of the shard pushdown, binding ``(count, index)``
        over a ``pio_crc32`` SQL function (:meth:`shard_hash`); ``row_pred``
        is the backend's row rule."""
        if shard_key == "row":
            return row_pred
        if shard_key == "entity":
            return "(pio_crc32(entity_id) % ?) = ?"
        if shard_key == "target":
            return (
                "((CASE WHEN target_entity_id IS NULL THEN 0 "
                "ELSE pio_crc32(target_entity_id) END) % ?) = ?"
            )
        raise ValueError(f"unknown shard_key {shard_key!r}")

    @classmethod
    def shard_select(cls, batch: EventBatch, shard: Optional[tuple], shard_key: str) -> EventBatch:
        """The row filter a backend applies after its scan when it cannot
        push the predicate down."""
        if shard is None:
            return batch
        index, count = int(shard[0]), int(shard[1])
        if count <= 1:
            return batch
        if shard_key == "row":
            keep = (np.arange(len(batch)) % count) == index
        elif shard_key in ("entity", "target"):
            col = batch.entity_id if shard_key == "entity" else batch.target_entity_id
            keep = cls._entity_shard_of(col, count) == index
        else:
            raise ValueError(f"unknown shard_key {shard_key!r}")
        return batch.select(keep)

    @classmethod
    def _entity_shard_of(cls, col, count: int) -> np.ndarray:
        """Each row's shard: the distinct ids hashed once each and spread
        through the inverse indices; rows without a target go to 0."""
        col = np.asarray(col, dtype=object)
        is_none = np.fromiter((s is None for s in col), dtype=bool, count=len(col))
        uniq, inv = np.unique(np.where(is_none, "", col).astype(object), return_inverse=True)
        ushard = np.fromiter(
            (cls.shard_hash(str(s)) % count for s in uniq), dtype=np.int64, count=len(uniq))
        out = ushard[inv]
        out[is_none] = 0
        return out

    def find_interactions(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        rating_key: Optional[str] = None,
        default_rating: float = 1.0,
        shard: Optional[tuple] = None,
        shard_key: str = "row",
    ):
        """Bulk (user, item, rating, t) triples for training reads:
        ``find`` + ``EventBatch.interactions``. A sharded read gives the
        triples of 1/count of the rows with id maps of that shard only (a
        launch merges them: ``parallel/ingest.py``)."""
        return self.find(
            app_id,
            channel_id=channel_id,
            entity_type=entity_type,
            event_names=event_names,
            target_entity_type=target_entity_type,
            shard=shard,
            shard_key=shard_key,
        ).interactions(rating_key=rating_key, default_rating=default_rating)


class Sequences(abc.ABC):
    """Named monotonic id-allocation service (parity: ``ESSequences.scala``):
    ``gen_next`` never returns one value twice for one name."""

    @abc.abstractmethod
    def gen_next(self, name: str) -> int:
        """The next value of counter ``name`` (first call returns 1)."""


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert, returning the assigned id (app.id==0 ⇒ auto-assign)."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @staticmethod
    def generate_key() -> str:
        # a key starting with '-' would parse as a CLI option flag
        while True:
            key = secrets.token_urlsafe(48)
            if key[0] not in "-_":
                return key

    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]:
        """Insert, generating the key string if empty; returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


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


class EvaluationInstances(abc.ABC):
    STATUS_INIT = "INIT"
    STATUS_EVALUATING = "EVALUATING"
    STATUS_COMPLETED = "EVALCOMPLETED"
    STATUS_ABORTED = "ABORTED"

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str:
        """Insert, assigning id if empty; returns id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]:
        """Completed evaluations, newest first."""

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...
