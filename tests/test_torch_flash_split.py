"""The forward kernel's key splits, held on the CPU.

``split_plan`` picks the kernel's grid: query tiles of ``q_rows`` rows, each
cut into splits of ``ks`` keys when the tiles alone cannot fill the card;
``plan_blocks`` lists the blocks in the kernel's launch order. Here:

* every visible (query tile, key) pair is covered by exactly one block, the
  block count is the plan's, and every row of a tile sees the first key of
  each of its splits; at the SASRec serving shape (1, 256, 256) causal the
  plan gives at least 64 blocks of at most 64 keys, at the training shape
  (128, 256, 256) one split a tile; T_q != T_kv both ways;
* a numpy float32 emulation of what the blocks compute (each split's online
  (m, l, acc) over 64-key tiles, written as a partial) and of the merge (in
  split order: M = max m_s, w_s = exp(m_s - M), l = sum l_s w_s,
  o = sum acc_s w_s / max(l, 1e-30), lse = M + log(max(l, 1e-30))) against
  the port's plain version and the JAX ``full_attention`` at rtol = atol =
  2e-5 (o) and 1e-5 (lse), the kernel's tolerances; B·H 1 and 8, causal and
  not, and a plan whose splits leave rows with no key, which carry
  m = -1e30 and must weigh exactly 0.

The dq kernel's plan, ``dq_plan`` (query tiles of 64, 32 or 16 rows, each
warp a row group and a key group, ``dq_warp_keys``): every visible (query,
key) pair is summed by exactly one warp, each warp's key runs in increasing
order and, under a causal mask, none past its last row; 64-row tiles at the
SASRec training shape, 32 at (8, 1024, 1024, 64), 64 for heads wider than
128; T_q != T_kv both ways.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel.ring import full_attention as jax_full_attention
from predictionio_tpu_torch.ops import flash_attention as fa

N_SM = 132  # the H100 SXM's SMs
NEG_INF = np.float32(-1e30)


def _visible(t_q, t_kv, causal, q0, nq):
    return min(t_kv, q0 + nq) if causal else t_kv


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("n_bh, t_q, t_kv, n_sm", [
    (1, 256, 256, N_SM), (128, 256, 256, N_SM), (1, 256, 1024, N_SM), (4, 1024, 256, N_SM),
    (8, 1024, 1024, N_SM), (2, 100, 100, N_SM), (1, 8, 8, N_SM), (3, 384, 128, 16),
    (1, 16, 4096, N_SM), (2, 512, 512, 1000),
])
def test_plan_covers_every_visible_pair_once(causal, n_bh, t_q, t_kv, n_sm):
    q_rows, ks, blocks = fa.split_plan(n_bh, t_q, t_kv, causal, n_sm)
    grid = fa.plan_blocks(n_bh, t_q, t_kv, causal, q_rows, ks)
    assert len(grid) == blocks
    n_qt = -(-t_q // q_rows)
    covered = np.zeros((n_bh, n_qt, t_kv), np.int32)
    splits = np.zeros((n_bh, n_qt), np.int32)
    for bh, qt, split, k_begin, k_end in grid:
        assert k_begin < k_end and k_end - k_begin <= ks
        assert k_begin <= qt * q_rows or not causal  # every row sees the split's first key
        covered[bh, qt, k_begin:k_end] += 1
        splits[bh, qt] += 1
    for qt in range(n_qt):
        q0 = qt * q_rows
        vis = _visible(t_q, t_kv, causal, q0, min(q_rows, t_q - q0))
        assert (covered[:, qt, :vis] == 1).all() and (covered[:, qt, vis:] == 0).all()
    assert splits.max() <= fa.MAX_SPLITS
    # heaviest first: query tiles in descending order along the grid
    qts = [b[1] for b in grid]
    assert qts == sorted(qts, reverse=True)


def test_serving_shape_fills_the_card():
    q_rows, ks, blocks = fa.split_plan(1, 256, 256, True, N_SM)
    assert blocks >= 64 and ks <= 64 and q_rows == fa.MIN_Q_ROWS
    assert max(e - b for *_, b, e in fa.plan_blocks(1, 256, 256, True, q_rows, ks)) <= 64


def test_training_shape_takes_one_split_a_tile():
    q_rows, ks, blocks = fa.split_plan(128, 256, 256, True, N_SM)
    assert (q_rows, blocks) == (fa.TILE, 128 * 4) and ks >= 256


@pytest.mark.parametrize("t_q, t_kv", [(256, 1024), (1024, 256)])
def test_plan_with_unequal_lengths(t_q, t_kv):
    for causal in (False, True):
        q_rows, ks, blocks = fa.split_plan(4, t_q, t_kv, causal, N_SM)
        assert blocks == len(fa.plan_blocks(4, t_q, t_kv, causal, q_rows, ks))
        assert blocks >= N_SM // 2


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("n_bh, t_q, t_kv, d, n_sm", [
    (128, 256, 256, 50, N_SM), (8, 1024, 1024, 64, N_SM), (1, 256, 1024, 50, N_SM),
    (4, 1024, 256, 64, N_SM), (2, 100, 100, 16, N_SM), (1, 8, 8, 16, N_SM),
    (4, 2048, 2048, 128, N_SM), (2, 128, 128, 192, N_SM), (3, 200, 136, 33, 1000),
])
def test_dq_plan_covers_every_visible_pair_once(causal, n_bh, t_q, t_kv, d, n_sm):
    q_rows, blocks = fa.dq_plan(n_bh, t_q, d, n_sm)
    n_qt = -(-t_q // q_rows)
    assert q_rows in (16, 32, 64) and blocks == n_bh * n_qt * -(-d // fa.DQ_SLICE)
    covered = np.zeros((t_q, t_kv), np.int32)
    for qt in range(n_qt):
        for warp in range(4):
            (r0, r1), runs = fa.dq_warp_keys(t_q, t_kv, causal, q_rows, qt, warp)
            assert qt * q_rows <= r0 <= r1 <= min((qt + 1) * q_rows, t_q)
            assert runs == sorted(runs)  # one fixed order, keys increasing
            for k0, k1 in runs:
                assert 0 <= k0 < k1 <= t_kv and k1 - k0 <= fa.DQ_KT
                assert not causal or k0 <= r1 - 1  # no run past the warp's last row
                covered[r0:r1, k0:k1] += 1
    visible = np.ones((t_q, t_kv), bool)
    if causal:
        visible = np.arange(t_q)[:, None] >= np.arange(t_kv)[None, :]
    assert (covered[visible] == 1).all() and covered.max() <= 1


def test_dq_plan_shapes():
    assert fa.dq_plan(128, 256, 50, N_SM) == (64, 512)  # the SASRec training shape
    assert fa.dq_plan(8, 1024, 64, N_SM) == (32, 256)  # 64-row tiles: 128 blocks, fewer than SMs
    assert fa.dq_plan(1, 256, 50, N_SM) == (16, 16)
    assert fa.dq_plan(1, 256, 256, N_SM) == (64, 16)  # a head past 128 keeps 64 rows
    assert fa.dq_plan(2, 512, 128, N_SM)[0] == 16


def _split_partial(q, k, v, rows, k_begin, k_end, causal, scale):
    """One block's (m, l, acc) for query rows ``rows`` over keys [k_begin,
    k_end), float32, with the kernel's online update over 64-key tiles."""
    qs = (q[rows] * scale).astype(np.float32)
    m = np.full(len(rows), NEG_INF, np.float32)
    l = np.zeros(len(rows), np.float32)
    acc = np.zeros((len(rows), q.shape[-1]), np.float32)
    for k0 in range(k_begin, k_end, 64):
        cols = np.arange(k0, min(k0 + 64, k_end))
        s = (qs @ k[cols].T).astype(np.float32)
        if causal:
            s = np.where(rows[:, None] < cols[None, :], NEG_INF, s)
        mb = np.maximum(m, s.max(-1))
        alpha = np.exp(m - mb)
        p = np.exp(s - mb[:, None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + p @ v[cols]
        m = mb
    return m, l, acc


def emulate_split_forward(q, k, v, causal, q_rows, ks):
    """(o, lse) of one batch·head as the kernel's blocks and merges compute
    them under the plan (q_rows, ks)."""
    t_q, d = q.shape
    t_kv = k.shape[0]
    scale = np.float32(fa._f32(1.0 / d**0.5))
    o = np.zeros_like(q)
    lse = np.zeros(t_q, np.float32)
    parts = {}
    for _, qt, split, k_begin, k_end in fa.plan_blocks(1, t_q, t_kv, causal, q_rows, ks):
        rows = np.arange(qt * q_rows, min((qt + 1) * q_rows, t_q))
        parts.setdefault(qt, {})[split] = _split_partial(q, k, v, rows, k_begin, k_end, causal, scale)
    for qt, by_split in parts.items():
        rows = np.arange(qt * q_rows, min((qt + 1) * q_rows, t_q))
        ms = [by_split[s][0] for s in sorted(by_split)]
        M = np.max(ms, axis=0)
        lsum = np.zeros(len(rows), np.float32)
        osum = np.zeros((len(rows), d), np.float32)
        for s in sorted(by_split):  # split order
            m_s, l_s, acc_s = by_split[s]
            w = np.exp(m_s - M)
            lsum = lsum + l_s * w
            osum = osum + acc_s * w[:, None]
        lf = np.maximum(lsum, np.float32(1e-30))
        o[rows] = osum / lf[:, None]
        lse[rows] = M + np.log(lf)
    return o, lse


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("n_bh, t_q, t_kv, d", [
    (1, 256, 256, 50), (8, 128, 128, 16), (1, 128, 512, 50), (8, 256, 128, 8),
])
def test_split_merge_matches_plain_version_and_jax(causal, n_bh, t_q, t_kv, d):
    rng = np.random.default_rng(n_bh + t_q + d)
    q, k, v = (rng.standard_normal((n_bh, t, d)).astype(np.float32) for t in (t_q, t_kv, t_kv))
    q_rows, ks, _ = fa.split_plan(n_bh, t_q, t_kv, causal, N_SM)
    if n_bh == 1:
        assert ks < t_kv  # the serving-like shapes do split
    got = [emulate_split_forward(q[b], k[b], v[b], causal, q_rows, ks) for b in range(n_bh)]
    o = np.stack([g[0] for g in got])
    lse = np.stack([g[1] for g in got])
    ro, rlse = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o, ro.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse, rlse.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, np.asarray(jax_full_attention(q, k, v, causal=causal)),
                               rtol=2e-5, atol=2e-5)


def test_rows_whose_split_sees_no_key_weigh_zero():
    """Splits of 8 keys over 16-row tiles: rows 16..23 see none of keys
    24..31, so that split carries m = -1e30 for them (l counts its masked
    keys) and must weigh exactly 0 in the merge."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((64, 50)).astype(np.float32) for _ in range(3))
    rows = np.arange(16, 32)
    m, l, _ = _split_partial(q, k, v, rows, 24, 32, True, np.float32(0.1))
    assert (m[:8] == NEG_INF).all() and (l[:8] > 0).all()
    assert (np.exp(m[:8] - np.float32(-3.0)) == 0).all()
    o, lse = emulate_split_forward(q, k, v, True, 16, 8)
    ro, rlse = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), True)
    np.testing.assert_allclose(o, ro.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse, rlse.numpy(), rtol=1e-5, atol=1e-5)
