"""Quantized factor storage: bf16 and int8 (per-row scale) variants.

Counterpart of ``predictionio_tpu/ops/quantize.py``: the same symmetric
per-row int8 (``row ≈ q * scale``, round-half-even, ``:37-58``) and bf16
downcast. Quantization happens once at publish; serving holds the narrow
arrays on the card and the score kernel upcasts them after the load.

numpy has no bfloat16 and the port does not depend on ``ml_dtypes`` (the
JAX package takes it from jax's wheel). A bf16 matrix is therefore held in
numpy as its ``uint16`` bit pattern and in torch as ``torch.bfloat16``;
:func:`f32_to_bf16_bits` rounds to nearest-even exactly as ``ml_dtypes``
and ``torch`` do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# serving factor dtypes, narrowest last; "f32" means no quantization
FACTOR_DTYPES = ("f32", "bf16", "int8")

# bytes per factor element, used by the analytic byte counts
FACTOR_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def f32_to_bf16_bits(f: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit pattern (uint16), round-to-nearest-even."""
    bits = np.ascontiguousarray(f, np.float32).view(np.uint32)
    out = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    # NaN stays a (quiet) NaN instead of rounding into the infinity pattern
    nan = np.isnan(f)
    if nan.any():
        out[nan] = ((bits[nan] >> 16) | 0x40).astype(np.uint16)
    return out


def bf16_bits_to_f32(b: np.ndarray) -> np.ndarray:
    """bfloat16 bit pattern (uint16) → float32, exact."""
    return (np.asarray(b, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_factors(
    factors: np.ndarray, dtype: str
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Quantize a (n, rank) float32 factor matrix to ``dtype``.

    Returns ``(quantized, scale)``: ``scale`` is a (n, 1) float32 per-row
    scale for int8 and None for f32/bf16. bf16 comes back as its uint16 bit
    pattern (see the module docstring).
    """
    f = np.asarray(factors, np.float32)
    if dtype == "f32":
        return f, None
    if dtype == "bf16":
        return f32_to_bf16_bits(f), None
    if dtype == "int8":
        amax = np.max(np.abs(f), axis=1, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(f / scale), -127, 127).astype(np.int8)
        return q, scale
    raise ValueError(
        f"factor dtype must be one of {FACTOR_DTYPES}, got {dtype!r}"
    )


def quantize_factors_torch(
    factors: torch.Tensor, dtype: str
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tensor counterpart of :func:`quantize_factors` (same math)."""
    if dtype == "f32":
        return factors, None
    if dtype == "bf16":
        return factors.to(torch.bfloat16), None
    if dtype == "int8":
        amax = factors.abs().amax(dim=1, keepdim=True)
        scale = torch.where(
            amax > 0, amax / 127.0, torch.ones_like(amax)
        ).to(torch.float32)
        q = torch.round(factors / scale).clamp(-127, 127).to(torch.int8)
        return q, scale
    raise ValueError(
        f"factor dtype must be one of {FACTOR_DTYPES}, got {dtype!r}"
    )


def dequantize_factors(
    quantized: np.ndarray, scale: Optional[np.ndarray] = None
) -> np.ndarray:
    """Reconstruct float32 factors — the reference math the kernel fuses."""
    q = np.asarray(quantized)
    f = bf16_bits_to_f32(q) if q.dtype == np.uint16 else q.astype(np.float32)
    if scale is not None:
        f = f * np.asarray(scale, np.float32)
    return f


def factors_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host factor matrix → tensor on ``device``; a uint16 array is a bf16
    bit pattern and becomes ``torch.bfloat16``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
