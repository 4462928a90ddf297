"""Segment reductions: sum rows into buckets by a precomputed bucket id.

Counterpart of ``predictionio_tpu/ops/segment.py:15-25``. The JAX package
sums with ``jax.ops.segment_sum``, outside any Pallas kernel; here the sum
is ``index_add_`` into zeros, a plain torch op. On the CPU ``index_add_``
adds the rows in order and equals the JAX sum bit for bit; on a CUDA card
it adds with float atomics, in no fixed order, so two runs may differ in
the last bits. The segment solver's path on the card no longer sums here:
it takes ``csrc/segment_normal_eq.cu``, which adds in order
(``ops/train_kernel.fused_segment_normal_eq``). That kernel's plain version,
which the CPU runs, still sums with ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets:
    ``out[s] = Σ data[i]`` over ``segment_ids[i] == s``."""
    out = torch.zeros(
        (num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor, num_segments: int, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-bucket count of ``segment_ids`` (float32), or the sum of
    ``weights`` when given."""
    w = (
        torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
        if weights is None else weights
    )
    return segment_sum(w, segment_ids, num_segments)
