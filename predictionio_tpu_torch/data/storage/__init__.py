from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EngineInstances,
    Model,
    Models,
)
from predictionio_tpu_torch.data.storage.registry import Storage

__all__ = [
    "EngineInstance",
    "EngineInstances",
    "Model",
    "Models",
    "Storage",
]
