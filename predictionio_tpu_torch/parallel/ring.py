"""Dense attention on one device.

Counterpart of ``predictionio_tpu/parallel/ring.py``, holding only
``full_attention`` (``:357-367``): the path the JAX package takes for
blocks too short for its flash kernel. Ring attention across devices comes
with the multi-GPU slice (ROADMAP §1 item 10).

There is one dense implementation in the port: :func:`full_attention` is
the output of the flash kernel's plain version
(:func:`~predictionio_tpu_torch.ops.flash_attention.flash_attention_reference`),
which scales q before the product as the kernel does; the JAX function
scales the product, a difference of float32 rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from predictionio_tpu_torch.ops.flash_attention import flash_attention_reference


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense softmax attention, q/k/v (..., T, D) → (..., T_q, D), any
    length, on any device."""
    return flash_attention_reference(q, k, v, causal, scale)[0]
