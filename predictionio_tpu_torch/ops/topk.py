"""Top-k selection with masking — the serving-side ranking primitive.

Counterpart of ``predictionio_tpu/ops/topk.py``. :func:`gather_score_topk`
is the ONE entry point of the exact serving score path: the fast path, the
per-query scorer and the tests all call through it (IVF retrieval calls the
kernel's probe-table mode, ``ops/score_kernel.ivf_score_topk``), and it calls
the hand-written kernel's wrapper (``ops/score_kernel.py``). That wrapper
launches the CUDA kernel for tensors on the card and takes the plain
PyTorch version for tensors on the CPU. There is no backend switch and no
environment variable that swaps the two on the card.

:func:`two_tier_merge_topk` is the pod layout's two-tier merge of per-shard
leaderboards (``predictionio_tpu/ops/topk.py:94-184``).

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


def topk_two_key(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row of a float32 ``values`` in the two-key order
    (value descending, then smaller index), without sorting whole rows.

    Each entry becomes one distinct 64-bit key, its value's bits in an
    order-preserving int32 above its complemented column index, so
    ``torch.topk`` over the keys has no ties to order: it returns
    ``lax.top_k``'s selection and order. ``-0.0`` counts as ``0.0``, as a
    float comparison has it.
    """
    bits = (values + 0.0).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(values.shape[1], device=values.device, dtype=torch.int64)
    keys = (ordered << 32) + (0xFFFFFFFF - col)
    del bits, ordered
    top = torch.topk(keys, k, dim=1).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return values.gather(1, idx), idx.to(torch.int32)


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


def gather_merge_topk(values, indices, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat merge of per-shard leaderboards: the n placements' (B, m)
    leaderboards gathered onto ``device`` as (B, n·m) candidate rows, then
    :func:`merge_topk` to ``min(k, n·m)``."""
    from predictionio_tpu_torch.parallel.mesh import all_gather

    gv, gg = all_gather(values, device), all_gather(indices, device)  # (n, B, m)
    n, b, m = gv.shape
    return merge_topk(gv.transpose(0, 1).reshape(b, n * m), gg.transpose(0, 1).reshape(b, n * m),
                      min(k, n * m))


def two_tier_merge_topk(
    values: list[torch.Tensor],
    indices: list[torch.Tensor],
    k: int,
    *,
    host_groups: int,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pod layout's leaderboard merge, on per-shard lists.

    ``values``/``indices`` are the S shards' ``(B, local_k)`` leaderboards in
    global ids, host-major (shard s in host row ``s // G``, G = S /
    ``host_groups``). Tier 1 gathers each row's G leaderboards onto the
    row's first placement and merges them to one ``(B, min(k, G·local_k))``
    per-host leaderboard; tier 2 gathers the H per-host leaderboards onto
    ``device`` (default: shard 0's) and merges them to ``(B, k)``. Both
    tiers use :func:`merge_topk`'s two-key order, so the answer equals one
    top-k over the whole row, as the JAX ``two_tier_merge_topk`` promises.
    """
    s = len(values)
    if host_groups < 1 or s % host_groups:
        raise ValueError(f"host_groups={host_groups} must divide {s} shards")
    g = s // host_groups
    dev = values[0].device if device is None else device
    host_v, host_g = [], []
    for h in range(host_groups):
        row = slice(h * g, (h + 1) * g)
        v, i = gather_merge_topk(values[row], indices[row], k, values[h * g].device)
        host_v.append(v)
        host_g.append(i)
    return gather_merge_topk(host_v, host_g, k, dev)


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
