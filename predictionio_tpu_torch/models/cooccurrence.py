"""Item co-occurrence / CCO: top-N similar items from interaction overlap.

Counterpart of ``predictionio_tpu/models/cooccurrence.py`` (parity:
``examples/scala-parallel-similarproduct/multi-events-multi-algos/src/main/
scala/CooccurrenceAlgorithm.scala:45-140``, and the log-likelihood-ratio
scoring at the heart of CCO / the Universal Recommender).

The user × item incidence is built densely on the card, one block of
``_USER_BLOCK`` users at a time, and (co/cross-)occurrence accumulates as
``C = Σ_blocks A_pᵀ A_s``. The host blocking (:func:`block_incidence`,
:func:`distinct_item_counts`) is numpy, bit for bit the JAX package's. The
scatter, product, LLR and top-k are torch ops on the context's device; the
JAX package computes them outside Pallas too, so no hand kernel is involved.

* **Exact counts.** The JAX package multiplies 0/1 bf16 operands with f32
  accumulation. A bf16 product in torch returns bf16, which rounds any count
  past 256, so here the operands are int8 and ``torch._int_mm`` returns
  int32 counts, exact on every device; the float32 ``C`` holds them exactly
  (counts stay below 2²⁴).
* **The scatter writes only real slots.** The JAX scatter is a max, a no-op
  for padded slots (mask 0 at local user 0, item 0). Here a padded slot is
  sent to one spare element past the operand, so no store of a padded slot
  can land on a real (0, 0).
* **User blocks per product.** :func:`cross_occurrence_block` scatters as
  many user blocks as fit in ``_OPERAND_BYTES`` into one operand pair and
  runs one product for them, adding the int32 products in block order. Both
  operands are laid out items × users, so the product takes the int8
  tensor cores' A-row-major, B-column-major form.
* **Tie order.** ``lax.top_k`` puts ties by smaller index; the top-k here is
  ``ops/topk.topk_two_key``, which has that order.

Multi-host reduction (``host_reduce``), the ``model``-axis column split and
the sharded trainer come with ROADMAP §1 item 10 and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import _pad_to_multiple as pad_to_multiple
from predictionio_tpu_torch.ops.topk import topk_two_key

_USER_BLOCK = 4096  # users per incidence block (A_b is USER_BLOCK × n_items)
# bytes of the larger int8 operand of one product: user blocks are grouped
# up to this (8 blocks at the ML-25M catalog of 59,136 padded items)
_OPERAND_BYTES = 2 << 30


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to predictionio_tpu_torch yet (ROADMAP §1 item 10)"
    )


@dataclasses.dataclass
class CooccurrenceModel:
    top_items: np.ndarray  # (n_items, N) int32 similar-item indices
    top_scores: np.ndarray  # (n_items, N) float32
    item_map: BiMap

    def similar(self, item_idx: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.top_items[item_idx][:n]
        sc = self.top_scores[item_idx][:n]
        keep = sc > 0
        return idx[keep], sc[keep]


@dataclasses.dataclass
class BlockedIncidence:
    """Host-blocked (user, item) pairs ready for the per-block scatter.

    Build once with :func:`block_incidence` and reuse across products (the
    Universal Recommender re-uses the primary side for every indicator).
    """

    local_user: np.ndarray  # (n_blocks, width) int32
    item: np.ndarray  # (n_blocks, width) int32
    mask: np.ndarray  # (n_blocks, width) float32
    n_blocks: int


def incidence_width(user: np.ndarray, n_users_pad: int) -> int:
    """Per-user-block row width block_incidence would use, without building
    the incidence arrays."""
    counts = np.bincount(
        user.astype(np.int64) // _USER_BLOCK,
        minlength=n_users_pad // _USER_BLOCK,
    )
    return pad_to_multiple(int(counts.max()) if len(counts) else 1, 8)


def block_incidence(
    inter: Interactions, n_users_pad: int, width: Optional[int] = None
) -> BlockedIncidence:
    n_blocks = n_users_pad // _USER_BLOCK
    order = np.argsort(inter.user, kind="stable")
    u = inter.user[order].astype(np.int64)
    i = inter.item[order].astype(np.int64)
    block_of = u // _USER_BLOCK
    counts = np.bincount(block_of, minlength=n_blocks)
    if width is None:
        width = incidence_width(inter.user, n_users_pad)
    lu = np.zeros((n_blocks, width), np.int32)
    li = np.zeros((n_blocks, width), np.int32)
    lm = np.zeros((n_blocks, width), np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for b in range(n_blocks):
        s, e = offsets[b], offsets[b + 1]
        lu[b, : e - s] = (u[s:e] - b * _USER_BLOCK).astype(np.int32)
        li[b, : e - s] = i[s:e].astype(np.int32)
        lm[b, : e - s] = 1.0
    return BlockedIncidence(local_user=lu, item=li, mask=lm, n_blocks=n_blocks)


def distinct_item_counts(inter: Interactions, n_items: int) -> np.ndarray:
    """Per-item count of DISTINCT users (LLR marginals must match the
    binarized incidence, not raw event counts). The distinct pairs are the
    JAX package's ``np.unique`` of them, taken from one sort: numpy 2.3's
    ``np.unique`` took 64 s on the 25,000,095 pairs of the ML-25M draw on
    the H100's host, against 0.5 s for ``np.sort``."""
    pairs = np.sort(inter.user.astype(np.int64) * n_items + inter.item.astype(np.int64))
    first = np.ones(len(pairs), bool)
    first[1:] = pairs[1:] != pairs[:-1]
    uniq_items = (pairs[first] % n_items).astype(np.int64)
    return np.bincount(uniq_items, minlength=n_items).astype(np.float32)


def _on_device(b: BlockedIncidence, device) -> tuple[torch.Tensor, ...]:
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (b.local_user, b.item, b.mask)
    )


def _incidence(lu, li, lm, n_items_pad: int) -> torch.Tensor:
    """The transposed 0/1 int8 incidence of a group of user blocks:
    (n_items_pad, G·USER_BLOCK), row-major, the users along a row. Only
    slots whose mask is 1 are written; the padded ones go to a spare element
    past the matrix."""
    g = lu.shape[0]
    users = g * _USER_BLOCK
    user = (
        torch.arange(g, device=lu.device, dtype=torch.int64)[:, None] * _USER_BLOCK
        + lu.to(torch.int64)
    )
    spare = users * n_items_pad
    flat = torch.where(lm > 0, li.to(torch.int64) * users + user, spare).reshape(-1)
    buf = torch.zeros(spare + 1, dtype=torch.int8, device=lu.device)
    buf.index_fill_(0, flat, 1)
    return buf[:spare].view(n_items_pad, users)


def cross_occurrence_block(
    pu: torch.Tensor, pi: torch.Tensor, pm: torch.Tensor,
    su: torch.Tensor, si: torch.Tensor, sm: torch.Tensor,
    p_pad: int, s_pad: int,
) -> torch.Tensor:
    """One column block's ``C = Σ_b A_p,bᵀ A_s,b`` (float32, exact counts).

    ``pu, pi, pm`` and ``su, si, sm`` are the two sides' blocked incidences
    (:class:`BlockedIncidence` arrays, ``(n_blocks, width)``) on the device
    that computes; ``p_pad``/``s_pad`` the padded item counts of the two
    sides (the secondary's local to its column block). The counterpart of
    the JAX package's ``accumulate_block`` (``cooccurrence.py:262-279``).
    """
    C = torch.zeros((p_pad, s_pad), dtype=torch.int32, device=pu.device)
    for g0, g1 in product_groups(pu.shape[0], p_pad, s_pad):
        a_pt = _incidence(pu[g0:g1], pi[g0:g1], pm[g0:g1], p_pad)
        a_st = _incidence(su[g0:g1], si[g0:g1], sm[g0:g1], s_pad)
        # both operands users-inner: the int8 tensor-core layout (A row-major,
        # B column-major); a row-major B took 7% of the int8 peak on an H100
        C += torch._int_mm(a_pt, a_st.T)
        del a_pt, a_st
    return C.to(torch.float32)


def product_groups(n_blocks: int, p_pad: int, s_pad: int) -> list[tuple[int, int]]:
    """The user-block ranges of :func:`cross_occurrence_block`'s products:
    as many blocks a product as keep the larger operand within
    ``_OPERAND_BYTES``."""
    group = max(1, min(n_blocks, _OPERAND_BYTES // (max(p_pad, s_pad) * _USER_BLOCK)))
    return [(g0, min(n_blocks, g0 + group)) for g0 in range(0, n_blocks, group)]


def cross_occurrence_matrix(
    ctx: DeviceContext,
    primary: "Interactions | BlockedIncidence",
    secondary: "Interactions | BlockedIncidence",
    n_items_primary: int,
    n_items_secondary: int,
    n_users_pad: Optional[int] = None,
    host_reduce=None,
) -> torch.Tensor:
    """Dense (primary_items, secondary_items) CROSS-occurrence counts on
    ``ctx.device``: #distinct users who did the PRIMARY event on item i AND
    the SECONDARY event on item j (``C = A_pᵀ A_s``). Either side may come
    pre-blocked (:func:`block_incidence`); then ``n_users_pad`` used for
    blocking must match."""
    if host_reduce is not None:
        raise _not_ported("the multi-host cross-occurrence reduction")
    if n_users_pad is None:
        n_users = max(
            x.n_users for x in (primary, secondary) if isinstance(x, Interactions)
        )
        n_users_pad = pad_to_multiple(n_users, _USER_BLOCK)
    p_pad = pad_to_multiple(n_items_primary, 128)
    s_pad = pad_to_multiple(n_items_secondary, 128)
    if isinstance(primary, Interactions):
        primary = block_incidence(primary, n_users_pad)
    if isinstance(secondary, Interactions):
        secondary = block_incidence(secondary, n_users_pad)
    C = cross_occurrence_block(
        *_on_device(primary, ctx.device), *_on_device(secondary, ctx.device),
        p_pad, s_pad,
    )
    return C[:n_items_primary, :n_items_secondary]


def cooccurrence_matrix(ctx: DeviceContext, interactions: Interactions) -> torch.Tensor:
    """Dense (n_items, n_items) co-occurrence counts (diagonal = item counts);
    the self-case of :func:`cross_occurrence_matrix`."""
    n_items = interactions.n_items
    n_users_pad = pad_to_multiple(interactions.n_users, _USER_BLOCK)
    blocked = block_incidence(interactions, n_users_pad)
    return cross_occurrence_matrix(
        ctx, blocked, blocked, n_items, n_items, n_users_pad=n_users_pad
    )


def llr_cross_scores(
    C: torch.Tensor,
    primary_counts: torch.Tensor,
    secondary_counts: torch.Tensor,
    n_users,
) -> torch.Tensor:
    """Dunning G² over a (cross-)occurrence table, float32, in the JAX
    package's operation order (``cooccurrence.py:185-217``).

    Marginals MUST be distinct-user counts (:func:`distinct_item_counts`) so
    the contingency table is consistent with the binarized incidence. Each
    entropy holds ``T·ln T``, so the result carries that term's rounding:
    a last-bit difference of ``log`` between devices moves an LLR value by
    up to a few ulp of ``T·ln T``.
    """
    zero = C.new_zeros(())
    k11 = C
    k12 = torch.maximum(primary_counts[:, None] - C, zero)
    k21 = torch.maximum(secondary_counts[None, :] - C, zero)
    total = torch.as_tensor(n_users, dtype=torch.float32, device=C.device)
    k22 = torch.maximum(
        total - primary_counts[:, None] - secondary_counts[None, :] + C, zero
    )

    def xlogx(x):
        return torch.where(x > 0, x * torch.log(x), zero)

    def entropy(*ks):
        s = sum(ks)
        return xlogx(s) - sum(xlogx(k) for k in ks)

    h_matrix = entropy(k11, k12, k21, k22)
    h_rows = entropy(k11 + k12, k21 + k22)
    h_cols = entropy(k11 + k21, k12 + k22)
    # Dunning's G²: 2·(rowEntropy + colEntropy − matrixEntropy), floored at 0
    llr = 2.0 * torch.maximum(h_rows + h_cols - h_matrix, zero)
    return torch.where(C > 0, llr, zero)


def score_block(
    C: torch.Tensor,
    p_counts: torch.Tensor,
    s_counts: torch.Tensor,
    col_start: int,
    n_items_primary: int,
    k: int,
    use_llr: bool,
    total: float,
    exclude_diagonal: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score one (globally complete) column block and take each indicator
    column's top-k: ``(values (width, k), indices (width, k))``. Padded
    primary rows, and the diagonal with ``exclude_diagonal``, score -1 and
    never win over a real row."""
    scores = llr_cross_scores(C, p_counts, s_counts, total) if use_llr else C
    p_pad, width = C.shape
    rows = torch.arange(p_pad, device=C.device)
    neg = scores.new_full((), -1.0)
    scores = torch.where((rows < n_items_primary)[:, None], scores, neg)
    if exclude_diagonal:
        cols = col_start + torch.arange(width, device=C.device)
        scores = torch.where(rows[:, None] == cols[None, :], neg, scores)
    return topk_two_key(scores.T, k)


def cross_occurrence_topn(
    ctx: DeviceContext,
    primary: "Interactions | BlockedIncidence",
    secondary: Interactions,
    n_items_primary: int,
    n_items_secondary: int,
    n_users: int,
    k: int,
    use_llr: bool = True,
    primary_counts: Optional[np.ndarray] = None,
    col_block: int = 4096,
    exclude_diagonal: bool = False,
    secondary_counts: Optional[np.ndarray] = None,
    host_reduce=None,
    llr_total: Optional[float] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k correlated PRIMARY items per INDICATOR item, never holding C.

    The dense (p_items × s_items) matrix is ~14 GB at the MovieLens-25M
    catalog; this computes it in COLUMN blocks of ``col_block`` indicator
    items (:func:`cross_occurrence_block`), scores each block (LLR
    optional) and takes the per-column top-k at once, so the card holds
    O(p_items × col_block). Exact: every column sees all its rows.

    Returns (top_items (s_items, k) int32, top_scores (s_items, k) f32),
    rows indexed by INDICATOR item.
    """
    if host_reduce is not None:
        raise _not_ported("the multi-host cross_occurrence_topn (host_reduce)")
    device = ctx.device
    n_users_pad = pad_to_multiple(n_users, _USER_BLOCK)
    if isinstance(primary, Interactions):
        primary = block_incidence(primary, n_users_pad)
    p_pad = pad_to_multiple(n_items_primary, 128)
    if primary_counts is None:
        raise ValueError("primary_counts (distinct users per item) required")
    pc_primary = torch.from_numpy(
        np.pad(primary_counts.astype(np.float32), (0, p_pad - n_items_primary))
    ).to(device)
    sec_counts_full = (
        secondary_counts.astype(np.float32)
        if secondary_counts is not None
        else distinct_item_counts(secondary, n_items_secondary)
    )

    k = min(k, n_items_primary)
    out_items = np.zeros((n_items_secondary, k), np.int32)
    out_scores = np.zeros((n_items_secondary, k), np.float32)

    s_user = secondary.user.astype(np.int64)
    s_item = secondary.item.astype(np.int64)
    width_pad = pad_to_multiple(min(col_block, n_items_secondary), 128)
    total = float(llr_total if llr_total is not None else n_users)

    # sort secondary ONCE by item so each column block is a contiguous slice
    s_order = np.argsort(s_item, kind="stable")
    s_user_sorted = s_user[s_order]
    s_item_sorted = s_item[s_order]
    s_bounds = np.searchsorted(
        s_item_sorted, np.arange(0, n_items_secondary + col_block, col_block)
    )

    # each column block's incidence takes its own width: the products have
    # no static shapes to share, so no block is padded to the widest
    starts = list(range(0, n_items_secondary, col_block))

    def build_block(bi: int):
        start = starts[bi]
        width = min(col_block, n_items_secondary - start)
        lo, hi = s_bounds[bi], s_bounds[bi + 1]
        blk_inter = Interactions(
            user=s_user_sorted[lo:hi].astype(np.int32),
            item=(s_item_sorted[lo:hi] - start).astype(np.int32),
            rating=np.ones(hi - lo, np.float32),
            t=np.zeros(hi - lo),
            user_map=None,
            item_map=None,
        )
        blocked_s = block_incidence(blk_inter, n_users_pad)
        s_counts = np.pad(
            sec_counts_full[start : start + width].astype(np.float32),
            (0, width_pad - width),
        )
        return blocked_s, s_counts, start, width

    p_dev = _on_device(primary, device)
    for bi in range(len(starts)):
        blocked_s, s_counts, start, width = build_block(bi)
        C = cross_occurrence_block(
            *p_dev, *_on_device(blocked_s, device), p_pad, width_pad
        )
        vals, idx = score_block(
            C, pc_primary, torch.from_numpy(s_counts).to(device), start,
            n_items_primary, k, use_llr, total, exclude_diagonal,
        )
        del C
        out_scores[start : start + width] = vals.cpu().numpy()[:width]
        out_items[start : start + width] = idx.cpu().numpy()[:width]
    # zero out non-positive scores like the dense path's s > 0 filter
    out_scores = np.maximum(out_scores, 0.0)
    return out_items, out_scores


def llr_scores(C: torch.Tensor, n_users: Optional[int] = None) -> torch.Tensor:
    """LLR rescoring of a SELF co-occurrence matrix: marginals come from the
    diagonal (= distinct users per item). Pass ``n_users``; without it the
    interaction total is a (biased) stand-in."""
    diag = torch.diagonal(C)
    total = (
        torch.tensor(float(n_users), dtype=torch.float32, device=C.device)
        if n_users is not None
        else diag.sum()
    )
    return llr_cross_scores(C, diag, diag, torch.clamp(total, min=1.0))


# above this catalog size train_cooccurrence uses the column-blocked top-N
# path (the dense items x items matrix would not fit on the card)
DENSE_ITEM_LIMIT = 16_384


def train_cooccurrence(
    ctx: DeviceContext,
    interactions,
    n: int = 20,
    use_llr: bool = False,
) -> CooccurrenceModel:
    """Top-``n`` co-occurring items per item (LLR-scored with ``use_llr``),
    computed on ``ctx.device``. The JAX package's sharded interactions (one
    host's users' rows) come with ROADMAP §1 item 10."""
    if not isinstance(interactions, Interactions):
        return _train_cooccurrence_sharded(ctx, interactions, n, use_llr)
    n_items_total = interactions.n_items
    if n_items_total > DENSE_ITEM_LIMIT:
        # self-case C is symmetric: per-column top-k == per-row top-k
        pc = distinct_item_counts(interactions, n_items_total)
        idx, vals = cross_occurrence_topn(
            ctx,
            interactions,
            interactions,
            n_items_total,
            n_items_total,
            n_users=interactions.n_users,
            k=min(n, n_items_total),
            use_llr=use_llr,
            primary_counts=pc,
            exclude_diagonal=True,
        )
        return CooccurrenceModel(
            top_items=idx, top_scores=vals, item_map=interactions.item_map
        )
    C = cooccurrence_matrix(ctx, interactions)
    scores = llr_scores(C, n_users=interactions.n_users) if use_llr else C
    n_items = scores.shape[0]
    scores = scores - torch.diag(torch.diagonal(scores))  # exclude self-pairs
    vals, idx = topk_two_key(scores, min(n, n_items))
    return CooccurrenceModel(
        top_items=idx.cpu().numpy().astype(np.int32),
        top_scores=vals.cpu().numpy().astype(np.float32),
        item_map=interactions.item_map,
    )


def _train_cooccurrence_sharded(ctx, sh, n: int, use_llr: bool):
    """Multi-host self-co-occurrence (per-host Grams reduced across hosts)."""
    raise _not_ported("the sharded co-occurrence trainer (ShardedInteractions)")


# ---------------------------------------------------------------------------
# Streaming micro-generation increments (core/delta.py)
# ---------------------------------------------------------------------------


def cooccurrence_increments(items_by_user: dict,
                            prior_by_user: Optional[dict] = None
                            ) -> np.ndarray:
    """Pair-count increments from freshly committed interactions.

    ``items_by_user`` maps a user index to the item indices of that
    user's NEW events only.  ``prior_by_user`` (optional) maps the same
    user to the items the base generation and earlier deltas already
    counted for them.  The increment for each user is
    ``pairs(prior ∪ new) − pairs(prior)``: every unordered pair among
    the genuinely new items, plus every cross pair new×prior, each as a
    ``(item_a, item_b, +count)`` row (``item_a < item_b``).  That is the
    exact delta the full-retrain co-occurrence Gram would gain from
    those events — historical pairs are never re-counted, so a replica
    accumulator fed these increments converges to the next full rebuild
    instead of inflating past it.

    Returns an (m, 3) int64 array, deduplicated and sorted.
    """
    counts: dict = {}
    prior_by_user = prior_by_user or {}
    for user, items in items_by_user.items():
        prior = set(int(i) for i in prior_by_user.get(user, ()))
        new = sorted(set(int(i) for i in items) - prior)
        for i, a in enumerate(new):
            for b in new[i + 1:]:
                counts[(a, b)] = counts.get((a, b), 0) + 1
            for p in prior:
                key = (a, p) if a < p else (p, a)
                counts[key] = counts.get(key, 0) + 1
    if not counts:
        return np.zeros((0, 3), np.int64)
    return np.array(
        [(a, b, c) for (a, b), c in sorted(counts.items())], dtype=np.int64)


def fold_increments(updates: np.ndarray, into: dict) -> dict:
    """Apply delta pair increments to a replica's streaming accumulator.

    ``into`` maps ``(item_a, item_b)`` to the accumulated pending count;
    the replica exposes its size through stats so operators can see how
    much co-occurrence signal is waiting on the next full rebuild."""
    for a, b, c in np.asarray(updates, dtype=np.int64):
        key = (int(a), int(b))
        into[key] = into.get(key, 0) + int(c)
    return into
