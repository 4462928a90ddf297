"""pypio-compatible Python API.

Counterpart of ``predictionio_tpu/pypio.py`` (parity:
``python/pypio/pypio.py:31-117``): a notebook calls :func:`init`,
:func:`find_events`, trains whatever it likes, and :func:`save_model`
publishes an EngineInstance plus model blob that ``pio deploy`` serves
through :class:`PythonEngine`. Host code: nothing here touches a card.

The blob is the JAX package's: one ``("pickle", {"model", "columns"})``
slot. A model saved by the JAX package's pypio names
``predictionio_tpu.pypio.PythonEngine``, which the port's persistence maps
to :class:`PythonEngine` here, so either package deploys the other's.
"""

from __future__ import annotations

import datetime as _dt
import pickle
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
)
from predictionio_tpu_torch.data.batch import EventBatch
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.registry import Storage

_storage: Optional[Storage] = None


def init(storage: Optional[Storage] = None) -> None:
    """Parity: pypio.init — bind the ambient storage (env-configured)."""
    global _storage
    _storage = storage or Storage.instance()
    from predictionio_tpu_torch.data import store as store_mod

    store_mod.set_storage(_storage)


def _require_init() -> Storage:
    if _storage is None:
        raise RuntimeError("call pypio.init() first")
    return _storage


def find_events(app_name: str, channel_name: Optional[str] = None) -> EventBatch:
    """Parity: pypio.find_events → DataFrame; here a columnar EventBatch."""
    _require_init()
    from predictionio_tpu_torch.data.store import PEventStore

    return PEventStore.find(app_name, channel_name=channel_name)


def save_model(
    model: Any,
    predict_columns: Sequence[str] = (),
    engine_factory: str = "predictionio_tpu_torch.pypio.PythonEngine",
) -> str:
    """Persist a model as a deployable EngineInstance (parity: save_model).

    Returns the engine instance id; ``pio deploy`` with a variant whose
    engineFactory matches will serve it.
    """
    storage = _require_init()
    instances = storage.get_meta_data_engine_instances()
    now = _dt.datetime.now(tz=_dt.timezone.utc)
    instance = EngineInstance(
        id="",
        status=instances.STATUS_COMPLETED,
        start_time=now,
        end_time=now,
        engine_id=engine_factory,
        engine_version="default",
        engine_variant="default",
        engine_factory=engine_factory,
        algorithms_params='[{"name": "python", "params": {}}]',
    )
    instance_id = instances.insert(instance)
    blob = pickle.dumps(
        [("pickle", {"model": model, "columns": list(predict_columns)})],
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    storage.get_model_data_models().insert(Model(id=instance_id, models=blob))
    return instance_id


# -- canned engine serving pypio-saved models (parity: e2 PythonEngine) ------


class _NullDataSource(DataSource):
    def read_training(self, ctx):
        raise RuntimeError(
            "PythonEngine models are trained externally; use pypio.save_model"
        )


class _PythonAlgorithm(Algorithm):
    """Serves a pypio-saved model: predict calls model.predict(query) if
    available, else projects ``columns`` from the query dict."""

    def train(self, ctx, pd):
        raise RuntimeError("PythonEngine does not train in-workflow")

    def predict(self, payload, query):
        model = payload["model"]
        if hasattr(model, "predict"):
            return {"prediction": model.predict(query)}
        columns = payload["columns"]
        return {c: query.get(c) for c in columns}


class PythonEngine(EngineFactory):
    """Parity: e2/.../engine/PythonEngine.scala:31-96."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=_NullDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={"python": _PythonAlgorithm},
            serving_cls=FirstServing,
            query_cls=None,  # raw dict queries
        )
