"""DASE controller API: the typed pipeline engine developers implement.

Copy of ``predictionio_tpu/core/controller.py``.

Capability parity with the reference controller layer
(``core/.../controller/``): DataSource → Preparator → Algorithm(s) → Serving,
plus SanityCheck.  Differences by design (SURVEY.md §7):

* The reference's three algorithm flavors (``PAlgorithm.scala:46``,
  ``P2LAlgorithm.scala:46``, ``LAlgorithm.scala:45``) distinguish where the
  model LIVES on a Spark cluster.  On one card that split collapses to
  :class:`Algorithm` (host model, auto-pickled).  The JAX package's
  ``ShardedAlgorithm`` (device-sharded pytrees) is not carried: no model
  family of this port uses it yet.
* ``Params`` are plain dataclasses; ``engine.json`` parity parsing lives in
  ``engine.py``.
* All components receive a :class:`~predictionio_tpu_torch.device.DeviceContext`
  where the reference passed ``sc: SparkContext``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Generic, Optional, Sequence, TypeVar

TD = TypeVar("TD")  # training data
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")  # model
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result


class Params:
    """Marker base for component parameter dataclasses (controller/Params.scala).

    Subclasses should be ``@dataclasses.dataclass``; they are constructed from
    the ``engine.json`` variant's ``params`` objects by ``engine.py``.
    """


@dataclasses.dataclass
class EmptyParams(Params):
    pass


class SanityCheck(abc.ABC):
    """Optional self-check on data objects (controller/SanityCheck.scala)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the data object is malformed (e.g. empty training set)."""


class DataSource(Generic[TD, Q, A], abc.ABC):
    """Reads training and evaluation data from the event store.

    Parity: ``controller/PDataSource.scala`` / ``LDataSource.scala``
    (``readTraining``, ``readEval``).
    """

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def read_training(self, ctx) -> TD: ...

    def read_eval(self, ctx) -> list[tuple[TD, Sequence[tuple[Q, A]]]]:
        """k folds of (training data, [(query, actual)]) for evaluation."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this engine."
        )


class Preparator(Generic[TD, PD], abc.ABC):
    """Parity: ``controller/PPreparator.scala`` / ``LPreparator.scala``."""

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def prepare(self, ctx, training_data: TD) -> PD: ...


class IdentityPreparator(Preparator[TD, TD]):
    """Pass-through (controller/IdentityPreparator.scala)."""

    def prepare(self, ctx, training_data: TD) -> TD:
        return training_data


class Algorithm(Generic[PD, M, Q, P], abc.ABC):
    """Host-model algorithm: train on the mesh, model lives as a host object.

    Parity: ``P2LAlgorithm.scala:46``/``LAlgorithm.scala:45`` (model is a
    plain object, auto-serialized into the MODELDATA repo like the reference's
    Kryo blobs, ``CoreWorkflow.scala:76-81``).
    """

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def train(self, ctx, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Bulk predict for evaluation (parity: batchPredictBase,
        ``BaseAlgorithm.scala:81``).  Override to vectorize on device."""
        return [(i, self.predict(model, q)) for i, q in queries]

    # -- persistence hooks (parity: BaseAlgorithm.makePersistentModel:111) --
    def make_serializable_model(self, model: M) -> Any:
        """Return the picklable form of the model (identity by default).

        Returning :data:`predictionio_tpu_torch.core.persistence.RETRAIN` opts into
        retrain-on-deploy (the reference's Unit-model mode,
        ``Engine.scala:210-232``).  A model implementing
        :class:`~predictionio_tpu_torch.core.persistence.PersistentModel` is saved
        through its own ``save`` with a manifest instead.
        """
        return model

    def load_serializable_model(self, ctx, blob: Any) -> M:
        """Rebuild the in-memory model at deploy time (identity by default)."""
        return blob


class Serving(Generic[Q, P], abc.ABC):
    """Merges per-algorithm predictions (controller/LServing.scala)."""

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    def supplement(self, query: Q) -> Q:
        """Pre-process the query (parity: LServing.supplement)."""
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...


class FirstServing(Serving[Q, P]):
    """Serve the first algorithm's prediction (LFirstServing.scala)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """Average numeric predictions (LAverageServing.scala)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)
