from predictionio_tpu_torch.core.controller import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Params,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory, EngineParams
from predictionio_tpu_torch.core.persistence import PersistentModel

__all__ = [
    "Algorithm",
    "AverageServing",
    "DataSource",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "Params",
    "PersistentModel",
    "Preparator",
    "Serving",
]
