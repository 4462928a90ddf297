"""The event model: the JAX package's ``predictionio_tpu.data`` names,
bound to the port's classes."""

from predictionio_tpu_torch.data.event import Event, DataMap, PropertyMap, EventValidation
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.aggregator import aggregate_properties, PropertyAggregate

__all__ = [
    "Event",
    "DataMap",
    "PropertyMap",
    "EventValidation",
    "BiMap",
    "aggregate_properties",
    "PropertyAggregate",
]
