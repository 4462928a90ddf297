"""Kernel 2's work partition and summation order, emulated in numpy.

``csrc/train_normal_eq.cu`` cannot run here, so this file replays how it
deals out one degree bucket (``train_kernel.dense_plan``, the function the
wrapper launches with): rows of at most ``NARROW_MAX`` slots to one warp
each, slot batches in order; wider rows to a block each, cut into
``split_plan`` parts, each part's batches dealt to the block's 8 warps in
turn, the warps' sums folded in warp order and the parts' in part order. A
batch holds up to 32 slots, fewer where 32 staged records would not fit
(the C source's ``batch_rows``). Every bucket of ``_make_dense_blocks``
must be covered slot for slot exactly once, for every rank and mode.

Then the order itself: the normal equations summed in float32 in exactly
that order (one rounding a product-and-add, as ``fmaf``) stay within the
card's kernel-vs-float64 rule (``testing.KERNEL_VS_FLOAT64_RTOL`` of the
summed magnitudes, against ``train_normal_eq_reference(...,
accumulate=torch.float64)``), and give an explicit A that is exactly
symmetric when all k² entries are summed on their own, which is why the
kernel sums only i ≤ j and stores each twice. The same buckets go through
the JAX package's reference math at f32 as a cross-check of the operands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.testing import (
    KERNEL_VS_FLOAT64_RTOL,
    normal_eq_magnitudes,
    normal_eq_mismatches,
)

WARPS = 8
STAGE_FLOATS = 1152  # the C source's staged record floats a warp
ALPHA = 2.0


def batch_rows(k: int, implicit: bool) -> int:
    """Slots of one batch (the C source's ``batch_rows``)."""
    record = (2 * k if implicit else k) + 3
    return min(32, STAGE_FLOATS // record)


def slot_streams(n_b: int, D: int, k: int, implicit: bool, n_sm: int):
    """``(narrow, splits, streams)``: ``streams[part][warp]`` is the slot
    order one warp of one (row, part) sums, the same for every row."""
    narrow, splits, seg = train_kernel.dense_plan(n_b, D, n_sm)
    rows = batch_rows(k, implicit)
    if narrow:
        return narrow, splits, [[list(range(D))]]
    streams = []
    for part in range(splits):
        d0, d1 = part * seg, min(D, (part + 1) * seg)
        streams.append([[d for b in range(d0 + w * rows, d1, rows * WARPS)
                         for d in range(b, min(b + rows, d1))] for w in range(WARPS)])
    return narrow, splits, streams


def _draw(seed=0, n_users=400, n_items=300, n=60_000):
    """A small Zipf draw: a few hot items wide enough to be cut into parts."""
    rng = np.random.default_rng(seed)
    pu = (np.arange(1, n_users + 1) + 5.0) ** -0.7
    pi = (np.arange(1, n_items + 1) + 2.0) ** -1.1
    user = rng.choice(n_users, n, p=pu / pu.sum())
    item = rng.choice(n_items, n, p=pi / pi.sum())
    rating = rng.uniform(1, 5, n).astype(np.float32)
    return user, item, rating, n_users, n_items


def _buckets(seed=0):
    user, item, rating, n_users, n_items = _draw(seed)
    out = []
    for ent, oth, n_ent in ((user, item, n_users), (item, user, n_items)):
        perm = als._degree_sort_permutation(ent, n_ent)
        blocks = als._make_dense_blocks(perm[ent], oth, rating, n_ent)
        out += list(zip(blocks.idx, blocks.rat, blocks.msk))
    return out


@pytest.mark.parametrize("n_sm", (1, 132))
@pytest.mark.parametrize("k, implicit", [(1, False), (10, False), (10, True), (63, True), (64, False)])
def test_partition_covers_every_slot_once(k, implicit, n_sm):
    buckets = _buckets()
    assert max(i.shape[1] for i, _, _ in buckets) > 2048  # some rows are cut into parts
    kinds = set()
    for idx, _, _ in buckets:
        n_b, D = idx.shape
        narrow, splits, streams = slot_streams(n_b, D, k, implicit, n_sm)
        kinds.add((narrow, splits > 1))
        seen = np.zeros(D, np.int64)
        for part in streams:
            for s in part:
                np.add.at(seen, s, 1)
                assert s == sorted(s)  # a warp sums its slots in slot order
        assert (seen == 1).all(), (n_b, D, narrow, splits)
        assert narrow == (D <= train_kernel.NARROW_MAX)
    if n_sm == 132:
        assert kinds == {(True, False), (False, False), (False, True)}


def _fma32(x, y, acc):
    """float32 product-and-add with one rounding: the product of two
    float32 values is exact in float64."""
    return (x.astype(np.float64) * y.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def emulate(idx, rat, msk, V, implicit, n_sm, alpha=ALPHA):
    """A (all k² entries, each summed on its own), b and cnt of one bucket,
    summed in float32 in the kernel's order (f32 factors)."""
    n_b, D = idx.shape
    k = V.shape[1]
    _, splits, streams = slot_streams(n_b, D, k, implicit, n_sm)
    a = np.float32(alpha)
    g = V[np.clip(idx, 0, V.shape[0] - 1)]                      # (n_b, D, k)
    live = msk != 0
    if implicit:
        cw = (a * rat) * msk
        X = g * cw[:, :, None]
        Y = g
        bw = (np.float32(1) + a * rat) * msk
        bx = g
    else:
        X = Y = g * msk[:, :, None]
        bw = rat
        bx = X
    part_sums = []
    for part in streams:
        warp_sums = []
        for s in part:
            A = np.zeros((n_b, k, k), np.float32)
            b = np.zeros((n_b, k), np.float32)
            c = np.zeros(n_b, np.float32)
            for d in s:
                on = live[:, d]
                A = np.where(on[:, None, None], _fma32(X[:, d, :, None], Y[:, d, None, :], A), A)
                b = np.where(on[:, None], _fma32(bx[:, d], bw[:, d, None], b), b)
                c = np.where(on, _fma32(msk[:, d], np.float32(1), c), c)
            warp_sums.append((A, b, c))
        # warps folded in warp order from +0 (a narrow row has one warp)
        fold = [np.zeros_like(t) for t in warp_sums[0]]
        for ws in warp_sums:
            fold = [f + w for f, w in zip(fold, ws)]
        part_sums.append(fold if len(part) > 1 else list(warp_sums[0]))
    if splits > 1:
        out = [np.zeros_like(t) for t in part_sums[0]]
        for ps in part_sums:
            out = [o + p for o, p in zip(out, ps)]
    else:
        out = part_sums[0]
    A, b, c = out
    if implicit:
        c = np.zeros(n_b, np.float32)
    return A, b, c


@pytest.mark.parametrize("implicit", (False, True))
@pytest.mark.parametrize("n_sm", (1, 132))
def test_emulated_order_holds_the_float64_rule(implicit, n_sm):
    rng = np.random.default_rng(5)
    user, item, rating, n_users, n_items = _draw(1)
    V = rng.normal(size=(n_users, 10)).astype(np.float32)
    perm = als._degree_sort_permutation(item, n_items)
    blocks = als._make_dense_blocks(perm[item], user, rating, n_items)
    seen = set()
    for idx, rat, msk in zip(blocks.idx, blocks.rat, blocks.msk):
        seen.add(train_kernel.dense_plan(*idx.shape, n_sm)[0])
        got = emulate(idx, rat, msk, V, implicit, n_sm)
        t = [torch.from_numpy(x) for x in (idx, rat, msk, V)]
        kw = dict(implicit=implicit, alpha=ALPHA)
        exact = train_kernel.train_normal_eq_reference(*t, accumulate=torch.float64, **kw)
        mag = normal_eq_magnitudes(*t, **kw)
        tg = tuple(torch.from_numpy(x) for x in got)
        assert not normal_eq_mismatches(tg, exact, mag, rtol=KERNEL_VS_FLOAT64_RTOL), idx.shape
        if not implicit:
            A = got[0]
            assert np.array_equal(A.view(np.uint32), A.transpose(0, 2, 1).view(np.uint32))
        # the JAX package's reference math on the same bucket, at f32
        Vg = jnp.asarray(V)[jnp.asarray(idx)]
        w = jnp.asarray(msk)
        if implicit:
            ja = jnp.einsum("edk,edl->ekl", Vg * (ALPHA * jnp.asarray(rat) * w)[:, :, None], Vg)
        else:
            ja = jnp.einsum("edk,edl->ekl", Vg * w[:, :, None], Vg * w[:, :, None])
        np.testing.assert_allclose(got[0], np.asarray(ja), rtol=1e-4, atol=1e-3)
    assert seen == {True, False}
