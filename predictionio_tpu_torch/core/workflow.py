"""Workflow entry points: train and persist, and load for serving.

Counterpart of ``predictionio_tpu/core/workflow.py`` (parity:
``workflow/CoreWorkflow.scala:45-164`` and ``Engine.prepareDeploy``):
:func:`run_train` (context → read → prepare → train → sealed MODELDATA blob
→ EngineInstance COMPLETED), :func:`prepare_deploy` and
:func:`get_latest_completed_instance`. One process trains on one card and
always writes the rows; generation quarantine comes with the canary slice.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
from typing import Optional

from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext

logger = logging.getLogger(__name__)

UTC = _dt.timezone.utc


class CleanupFunctions:
    """End-of-workflow hooks (parity: workflow/CleanupFunctions.scala):
    callables run when a train workflow finishes, success or failure."""

    _fns: list = []

    @classmethod
    def add(cls, fn) -> None:
        cls._fns.append(fn)

    @classmethod
    def run(cls) -> None:
        for fn in cls._fns:
            try:
                fn()
            except Exception:
                # one failing hook must not keep the others from running
                logger.exception("cleanup function %r failed", fn)

    @classmethod
    def clear(cls) -> None:
        cls._fns = []


@dataclasses.dataclass
class WorkflowParams:
    """Knobs of a workflow run (parity: workflow/WorkflowParams.scala)."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


def resolve_engine(engine_factory: str) -> Engine:
    """Dotted path → Engine (parity: CreateWorkflow's reflective factory
    load, ``CreateWorkflow.scala:196-204``)."""
    obj = persistence.resolve_class(engine_factory)
    if isinstance(obj, Engine):
        return obj
    if isinstance(obj, type):
        candidate = obj.apply() if hasattr(obj, "apply") else obj()
    elif callable(obj):
        candidate = obj()
    else:
        candidate = obj
    if not isinstance(candidate, Engine):
        raise TypeError(
            f"{engine_factory} resolved to {type(candidate).__name__}, not an Engine"
        )
    return candidate


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    engine_factory: str,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    env: Optional[dict] = None,
) -> str:
    """Train and persist; returns the COMPLETED EngineInstance id.

    Parity with CoreWorkflow.runTrain (CoreWorkflow.scala:45-101): insert
    the instance → TRAINING → train → seal the models into MODELDATA →
    COMPLETED. Any failure, a kernel's build or launch included, marks the
    instance ABORTED and propagates. The engine reads its events through
    :mod:`predictionio_tpu_torch.data.store` (``set_storage``); ``storage``
    holds the instance and model rows.
    """
    storage = storage or Storage.instance()
    ctx = ctx or DeviceContext.create()
    wp = workflow_params or WorkflowParams()

    instances = storage.get_meta_data_engine_instances()
    now = _dt.datetime.now(tz=UTC)
    instance = EngineInstance(
        id="",
        status=instances.STATUS_INIT,
        start_time=now,
        end_time=now,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=wp.batch,
        env=dict(env or {}),
        mesh_conf=dict(ctx.conf),
        **engine_params.to_json_strings(),
    )
    instance_id = instances.insert(instance)
    logger.info("engine instance %s: training started", instance_id)
    instance.status = instances.STATUS_TRAINING
    instances.update(instance)

    try:
        algorithms = engine.make_algorithms(engine_params)
        models = engine.train(
            ctx,
            engine_params,
            skip_sanity_check=wp.skip_sanity_check,
            stop_after_read=wp.stop_after_read,
            stop_after_prepare=wp.stop_after_prepare,
            algorithms=algorithms,
        )
        algo_params = [p for _, p in engine_params.algorithm_params_list]
        blob = persistence.serialize_models(instance_id, algorithms, models, algo_params)
        # checksum envelope: deploy verifies the content before unpickling
        storage.get_model_data_models().insert(
            Model(id=instance_id, models=persistence.seal_model_blob(blob))
        )
    except BaseException:
        # no zombie TRAINING rows: mark the run aborted, then propagate
        instance.status = instances.STATUS_ABORTED
        instance.end_time = _dt.datetime.now(tz=UTC)
        instances.update(instance)
        raise
    finally:
        CleanupFunctions.run()

    instance.status = instances.STATUS_COMPLETED
    instance.end_time = _dt.datetime.now(tz=UTC)
    instances.update(instance)
    logger.info("engine instance %s: training completed", instance_id)
    return instance_id


def prepare_deploy(
    engine: Engine,
    instance: EngineInstance,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
):
    """Load a COMPLETED instance's models for serving.

    Returns (engine_params, algorithms, serving, models): the EngineParams
    rebuilt from the instance row, the model blob verified and inverted,
    and retrain-on-deploy slots retrained.
    """
    storage = storage or Storage.instance()
    ctx = ctx or DeviceContext.create(conf=instance.mesh_conf)

    engine_params = engine.params_from_instance_strings(
        {
            "data_source_params": instance.data_source_params,
            "preparator_params": instance.preparator_params,
            "algorithms_params": instance.algorithms_params,
            "serving_params": instance.serving_params,
        }
    )
    algorithms = engine.make_algorithms(engine_params)
    algo_params = [p for _, p in engine_params.algorithm_params_list]

    model_row = storage.get_model_data_models().get(instance.id)
    if model_row is None:
        raise RuntimeError(f"no model blob for engine instance {instance.id}")
    # raises ModelIntegrityError on a torn/corrupt blob
    blob = persistence.open_model_blob(model_row.models)
    models, retrain_idx = persistence.deserialize_models(
        blob, instance.id, algorithms, algo_params, ctx
    )
    if retrain_idx:
        # Unit-model mode: retrain ONLY those slots (Engine.scala:210-232)
        logger.info("retrain-on-deploy for algorithm slots %s", retrain_idx)
        pd = engine.prepare_data(ctx, engine_params, skip_sanity_check=True)
        for i in retrain_idx:
            models[i] = algorithms[i].train(ctx, pd)
    serving = engine.make_serving(engine_params)
    return engine_params, algorithms, serving, models


def get_latest_completed_instance(
    storage: Storage,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> EngineInstance:
    """Deploy-time lookup (parity: commands/Engine.scala:234-241)."""
    inst = storage.get_meta_data_engine_instances().get_latest_completed(
        engine_id, engine_version, engine_variant
    )
    if inst is None:
        raise RuntimeError(
            f"No completed engine instance for {engine_id}/{engine_version}/"
            f"{engine_variant}. Run train first."
        )
    return inst
