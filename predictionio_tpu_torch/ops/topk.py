"""Top-k selection with masking — the serving-side ranking primitive.

Counterpart of ``predictionio_tpu/ops/topk.py``. :func:`gather_score_topk`
is the ONE entry point of the serving score path: the fast path, the
per-query scorer and the tests all call through it, and it calls the
hand-written kernel's wrapper (``ops/score_kernel.py``). That wrapper
launches the CUDA kernel for tensors on the card and takes the plain
PyTorch version for tensors on the CPU. There is no backend switch and no
environment variable that swaps the two on the card.

Tie order: ``torch.topk`` documents none, and the JAX package's contract
is ``lax.top_k``'s (value descending, then smaller index). The helpers
here write that two-key order out with stable sorts.

Only slots whose value is above ``-1e29`` carry meaning. Excluded and
padded items score ``-1e30`` (:data:`NEG_INF`); when fewer than ``k`` items
remain, the tail holds excluded items in index order, as ``lax.top_k``
returns them. Callers filter those slots (``templates/recommendation.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sort_two_key(
    values: torch.Tensor, indices: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by (value descending, index ascending).

    ``indices`` defaults to the column position. A stable sort by index
    followed by a stable sort by value gives the two-key order for any
    candidate layout.
    """
    if indices is None:
        order = torch.argsort(-values, dim=1, stable=True)
        return values.gather(1, order), order.to(torch.int32)
    first = torch.argsort(indices, dim=1, stable=True)
    v = values.gather(1, first)
    i = indices.gather(1, first)
    second = torch.argsort(-v, dim=1, stable=True)
    return v.gather(1, second), i.gather(1, second).to(torch.int32)


def top_k_with_mask(
    scores: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k best scores; masked slots never win.

    ``mask`` is True for EXCLUDED entries (seen items, blacklist, padding)
    and broadcasts over the batch.
    """
    if mask is not None:
        scores = torch.where(mask, torch.full_like(scores, NEG_INF), scores)
    v, i = sort_two_key(scores)
    return v[:, :k], i[:, :k]


def merge_topk(
    values: torch.Tensor, indices: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge (B, M) candidate rows carrying global indices into a (B, k)
    top-k in the two-key order — bit-identical to one top-k over the full
    score row, ties across candidate lists included."""
    v, i = sort_two_key(values, indices)
    return v[:, :k], i[:, :k]


def gather_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    u_idx: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    *,
    u_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    timing: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather → score → masked top-k: ``(values (B, k), indices (B, k))``.

    ``U[u_idx] @ V.T`` then a masked top-k, with U dequantized BEFORE the
    dot and the item scale applied AFTER it (the reference op order).
    ``item_mask`` is True for slots that must never win. ``timing``: a
    pair of CUDA events recorded around the kernel's launch.
    """
    from predictionio_tpu_torch.ops import score_kernel

    return score_kernel.fused_gather_score_topk(
        U, V, u_idx, k, item_mask, u_scale=u_scale, v_scale=v_scale, timing=timing
    )
