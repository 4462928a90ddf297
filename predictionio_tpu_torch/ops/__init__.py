"""Compute primitives: the JAX package's ``predictionio_tpu.ops`` names,
bound to the port's torch functions."""

from predictionio_tpu_torch.ops.segment import segment_sum, segment_count
from predictionio_tpu_torch.ops.topk import top_k_with_mask

__all__ = ["segment_sum", "segment_count", "top_k_with_mask"]
