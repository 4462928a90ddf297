"""Deploy-preparation workflow: load a COMPLETED instance for serving.

Counterpart of ``predictionio_tpu/core/workflow.py:180-266``
(``prepare_deploy``, ``get_latest_completed_instance``; parity:
``CreateServer.scala:193-206`` + ``Engine.prepareDeploy``). ``run_train``
comes with the training slice; generation quarantine with the canary slice.
"""

from __future__ import annotations

import logging
from typing import Optional

from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext

logger = logging.getLogger(__name__)


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
