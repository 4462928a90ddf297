"""The score kernel's selection, emulated in numpy, against the plain version.

``csrc/score_topk.cu`` cannot run here, so this file replays what it does
with the scores the plain version computes: the grid of
``score_kernel.slice_plan`` (the function the wrapper launches with), each
(row, slice) offering its items 32 a round (256 a round when a block shares
one buffer, past ``WARP_MAX_K``) to a selection that keeps only the 64-bit
keys above its running k-th key (``Selection`` says how, with
``buffer_cap(k)``); then the merge: each lane offers the first entry of each
of its share of the slice lists, then walks the lists whose first entry was
kept until an entry is not kept.

Tolerance: none. Selection does no arithmetic on the scores, so the
emulation must give the plain version's values bit for bit and its indices
exactly, tie order included: ascending scores (every item beats the running
threshold), all-equal scores (indices 0..k-1), random scores, masks that
leave fewer than k items, k ∈ {1, 100, n_items}, ragged catalogs and
B ∈ {1, 13, 64}. Integer-valued cases are also held against the JAX
package's reference top-k.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import score_kernel

# the C source's per-call constants that shape the rounds
TILE_BYTES, MAX_TILE_ITEMS = 40960, 1024


def tile_items(rank: int, elem: int, slice_items: int) -> int:
    ti = min(TILE_BYTES // (rank * elem), MAX_TILE_ITEMS, -(-slice_items // 32) * 32) // 32 * 32
    return max(32, ti)


def keys_of(values: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit keys: order-preserving score bits (-0 as +0)
    above the complemented index; a larger key comes first."""
    b = (values.astype(np.float32) + np.float32(0)).view(np.uint32).astype(np.uint64)
    b = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (b << np.uint64(32)) | (~indices.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)


def decode(keys: np.ndarray):
    o = (keys >> np.uint64(32)).astype(np.uint32)
    bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(np.uint32)
    idx = (~(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int32)
    return bits.view(np.float32), idx


class Selection:
    """One selection, as the kernel keeps it: ``offer`` appends the keys
    above ``t`` in lane order. Up to ``WARP_MAX_K`` (a warp) the best
    ``cap`` keys so far sit in a sorted queue beside a buffer of ``cap``;
    a round that could overflow the buffer first merges it into the queue,
    and ``t`` is the queue's k-th key. Past it (a block) one buffer of
    ``cap`` is sorted and cut back to its best k instead."""

    def __init__(self, k: int):
        self.k, self.cap = k, score_kernel.buffer_cap(k)
        self.warp = k <= score_kernel.WARP_MAX_K
        self.queue = [0] * self.cap if self.warp else []
        self.buf: list[int] = []
        self.t = 0
        self.cuts = 0

    def _cut(self):
        if self.warp:
            self.queue = sorted(self.queue + self.buf, reverse=True)[: self.cap]
            self.buf = []
            self.t = self.queue[self.k - 1]
        else:
            assert len(self.buf) > self.k
            self.buf = sorted(self.buf, reverse=True)[: self.k]
            self.t = self.buf[-1]
        self.cuts += 1

    def offer(self, keys) -> list[bool]:
        kept = [key > self.t for key in keys]
        total = sum(kept)
        if total and len(self.buf) + total > self.cap:
            self._cut()
        if total:
            self.buf += [key for key, p in zip(keys, kept) if p]
            assert len(self.buf) <= self.cap
        return kept

    def best(self) -> list[int]:
        out = sorted(self.queue + self.buf, reverse=True)[: self.k]
        return out + [0] * (self.k - len(out))


def emulate(scores: np.ndarray, k: int, n_sm: int, rank: int = 10, elem: int = 4):
    """The kernel's answer for a (B, n_items) float32 score matrix."""
    batch, n_items = scores.shape
    rows, slices, per = score_kernel.slice_plan(batch, n_items, k, n_sm)
    width = 32 if k <= score_kernel.WARP_MAX_K else 256  # keys a round
    ti = tile_items(rank, elem, per)
    out_v = np.empty((batch, k), np.float32)
    out_i = np.empty((batch, k), np.int32)
    stats = {"rows": rows, "slices": slices, "cuts": 0}
    for row in range(batch):
        row_keys = [int(x) for x in keys_of(scores[row], np.arange(n_items))]
        lists = []
        for s in range(slices):
            i0, i1 = s * per, min(n_items, (s + 1) * per)
            sel = Selection(k)
            for t0 in range(i0, i1, ti):
                t1 = min(i1, t0 + ti)
                for r0 in range(t0, t1, width):
                    sel.offer(row_keys[r0: min(t1, r0 + width)])
            stats["cuts"] += sel.cuts
            lists.append(sel.best())
        # the merge: lane l offers the first entry of lists l, l + width, ...,
        # then walks the lists whose first entry was kept, from their second
        # entry on, until an entry is not kept
        sel = Selection(k)
        mine = [list(range(ln, slices, width)) for ln in range(width)]
        alive = [[] for _ in range(width)]
        for m in range(-(-slices // width)):
            keys = [lists[ls[m]][0] if m < len(ls) else 0 for ls in mine]
            for ln, kept in enumerate(sel.offer(keys)):
                if kept:
                    alive[ln].append(mine[ln][m])
        pos = [1] * width
        while any(a and p < k for a, p in zip(alive, pos)):
            live = [bool(a) and p < k for a, p in zip(alive, pos)]
            keys = [lists[a[0]][p] if ok else 0 for a, p, ok in zip(alive, pos, live)]
            kept = sel.offer(keys)
            for ln in range(width):
                if not live[ln]:
                    continue
                pos[ln] += 1
                if not kept[ln] or pos[ln] == k:
                    alive[ln].pop(0)
                    pos[ln] = 1
        stats["cuts"] += sel.cuts
        best = np.array(sel.best(), np.uint64)
        assert (best > 0).all(), "the lists hold at least k items"
        out_v[row], out_i[row] = decode(best)
    return out_v, out_i, stats


def _scores(U, V, u_idx, mask):
    """The plain version's score matrix, step for step."""
    s = torch.from_numpy(U)[torch.from_numpy(u_idx).long()] @ torch.from_numpy(V).T
    if mask is not None:
        s = torch.where(torch.from_numpy(mask)[None, :], torch.full_like(s, -1e30), s)
    return s.numpy()


def _case(kind, n_items, batch, seed=0, rank=10):
    rng = np.random.default_rng(seed)
    n_users = max(batch, 20)
    if kind == "random":
        U = rng.standard_normal((n_users, rank)).astype(np.float32)
        V = rng.standard_normal((n_items, rank)).astype(np.float32)
    elif kind == "ascending":  # score = (user + 1) · item: rises with the index
        U = np.zeros((n_users, rank), np.float32)
        U[:, 0] = np.arange(1, n_users + 1)
        V = np.zeros((n_items, rank), np.float32)
        V[:, 0] = np.arange(n_items)
    else:  # tied: every item scores alike
        U = rng.integers(-3, 4, (n_users, rank)).astype(np.float32)
        V = np.tile(rng.integers(-3, 4, (1, rank)), (n_items, 1)).astype(np.float32)
    u_idx = rng.integers(0, n_users, batch).astype(np.int32)
    return U, V, u_idx


def _check(U, V, u_idx, k, mask=None, n_sm=132, jax_too=False):
    got_v, got_i, stats = emulate(_scores(U, V, u_idx, mask), k, n_sm)
    ref_v, ref_i = score_kernel.gather_score_topk_reference(
        torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(u_idx), k,
        None if mask is None else torch.from_numpy(mask),
    )
    # bit for bit, -0 taken as +0 as the kernel's keys take it
    assert np.array_equal(got_v.view(np.uint32), (ref_v.numpy() + np.float32(0)).view(np.uint32))
    assert np.array_equal(got_i, ref_i.numpy())
    if jax_too:
        jv, ji = jax_topk.gather_score_topk(U, V, u_idx, k, item_mask=mask, backend="reference")
        assert np.array_equal(got_i, np.asarray(ji))
        assert np.array_equal(got_v, np.asarray(jv))
    return got_i, stats


N_ITEMS = 1100


@pytest.mark.parametrize("batch", (1, 13, 64))
@pytest.mark.parametrize("k", (1, 100, N_ITEMS))
@pytest.mark.parametrize("kind", ("ascending", "tied", "random"))
def test_emulated_selection_equals_plain_version(kind, k, batch):
    U, V, u_idx = _case(kind, N_ITEMS, batch, seed=k + batch)
    got_i, stats = _check(U, V, u_idx, k, jax_too=kind != "random")
    if kind == "tied":
        assert (got_i == np.arange(k)).all()
    if kind == "ascending":
        assert (got_i == np.arange(N_ITEMS - 1, N_ITEMS - 1 - k, -1)).all()


@pytest.mark.parametrize("batch", (1, 13))
@pytest.mark.parametrize("n_sm", (1, 132))
def test_mask_leaving_fewer_than_k_items(batch, n_sm):
    """5 unmasked items, k = 100: the 5, then masked items in index order."""
    U, V, u_idx = _case("random", 3000, batch, seed=3)
    mask = np.ones(3000, bool)
    mask[[7, 600, 1500, 2222, 2999]] = False
    got_i, _ = _check(U, V, u_idx, 100, mask=mask, n_sm=n_sm)
    assert sorted(got_i[0, :5]) == [7, 600, 1500, 2222, 2999]
    assert (got_i[:, 5:] == [i for i in range(100) if i not in (7,)][:95]).all()


@pytest.mark.parametrize("n_items", (1, 7, 37, 513, 1025, 3001))
@pytest.mark.parametrize("k_kind", ("one", "few", "all"))
def test_ragged_catalogs(n_items, k_kind):
    k = {"one": 1, "few": min(5, n_items), "all": n_items}[k_kind]
    U, V, u_idx = _case("random", n_items, 8, seed=n_items)
    _check(U, V, u_idx, k)


def test_ascending_scores_cut_the_buffer():
    """Ascending scores keep every item, so the warp's buffer fills and is
    merged into its queue again and again; the answer is still exact."""
    U, V, u_idx = _case("ascending", 5000, 4)
    _, stats = _check(U, V, u_idx, 100, n_sm=1)
    assert stats["cuts"] > 4 * 10


@pytest.mark.parametrize("batch", (1, 8, 13, 16, 32, 64, 100))
@pytest.mark.parametrize("k", (1, 100, 512, 513, 8192))
def test_slice_plan_covers_the_catalog(batch, k):
    """Slices cover the catalog once; the grid reaches two blocks per SM
    where the catalog has room; the scratch is batch × slices × k keys."""
    n_items, n_sm = 59_392, 132
    rows, slices, per = score_kernel.slice_plan(batch, n_items, k, n_sm)
    assert per % score_kernel.SLICE_ALIGN == 0 and (slices - 1) * per < n_items <= slices * per
    assert slices <= score_kernel.MAX_SLICES
    groups = -(-batch // rows)
    assert rows == (min(8, batch) if k <= score_kernel.WARP_MAX_K else 1)
    if k <= score_kernel.WARP_MAX_K:
        assert slices * groups >= 2 * n_sm or per == score_kernel.SLICE_ALIGN
    else:
        assert per >= k or slices == 1
