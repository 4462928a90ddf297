"""Ulysses sequence parallelism: heads exchanged for sequence, once each way.

Counterpart of ``predictionio_tpu/parallel/ulysses.py``. Where the ring
(``parallel/ring.py``) sends key/value blocks round the axis, Ulysses
redistributes once with :func:`~predictionio_tpu_torch.parallel.mesh.
all_to_all`: the sequence-split (..., H, T/n, D) blocks become head-split
(..., H/n, T, D) ones, every placement runs whole-sequence attention for its
heads, and a second all-to-all restores the sequence split. It needs
``n_heads % n == 0`` and holds the whole sequence's k/v for its heads on
every placement; the ring has no head constraint and holds O(T/n).

The local attention is dense (:func:`~predictionio_tpu_torch.parallel.ring.
full_attention`) or, with ``use_flash``, the flash kernels
(:func:`~predictionio_tpu_torch.ops.flash_attention.flash_attention`: kernel
4 forward, kernels 5 and 6 backward). The whole is differentiable through
the all-to-alls (tensor ops), with no hand-written backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops.flash_attention import flash_attention, use_flash_default
from predictionio_tpu_torch.parallel.mesh import MeshContext, all_to_all
from predictionio_tpu_torch.parallel.ring import _blocks, axis_devices, full_attention


def ulysses_attention(
    ctx: MeshContext,
    q,
    k,
    v,
    axis: str = "data",
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Exact attention with the sequence split over mesh axis ``axis``.

    q/k/v (..., H, T, D): an explicit head dimension, T and H both divisible
    by the axis size. ``use_flash`` picks the flash kernels for the local
    attention (default: the shared gate, on the card at a flash length of
    the whole sequence). Returns (..., H, T, D) on the first placement.
    """
    devices = axis_devices(ctx, axis)
    n = len(devices)
    if q.ndim < 3:
        raise ValueError(f"ulysses_attention needs (..., H, T, D) inputs, got {tuple(q.shape)}")
    h, t = q.shape[-3], q.shape[-2]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by {n} shards")
    if h % n:
        raise ValueError(
            f"n_heads {h} not divisible by axis size {n}: Ulysses shards heads — use ring "
            "attention for head counts below the mesh size"
        )
    if use_flash is None:
        # the local attention sees the WHOLE sequence after the all-to-all
        use_flash = use_flash_default(t, devices[0])
    h_dim, t_dim = q.ndim - 3, q.ndim - 2
    q, k, v = (torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
               for x in (q, k, v))
    # (..., H, T/n, D) → (..., H/n, T, D)
    qs, ks, vs = (all_to_all(_blocks(x, devices), h_dim, t_dim, devices) for x in (q, k, v))
    if use_flash:
        out = [flash_attention(a, b, c, causal=causal, scale=scale) for a, b, c in zip(qs, ks, vs)]
    else:
        out = [full_attention(a, b, c, causal=causal, scale=scale) for a, b, c in zip(qs, ks, vs)]
    # (..., H/n, T, D) → (..., H, T/n, D), then the whole sequence
    out = all_to_all(out, t_dim, h_dim, devices)
    return torch.cat([o.to(devices[0]) for o in out], dim=t_dim)
