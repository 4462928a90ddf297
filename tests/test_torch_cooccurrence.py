"""The port's co-occurrence / CCO models against the JAX package's, on the
same seeded inputs (``models/cooccurrence.py``).

* Counts and marginals are bitwise equal: to brute force (sets of users per
  item), and to the JAX package's ``cross_occurrence_matrix`` /
  ``distinct_item_counts``, with several user blocks and several products
  (``_USER_BLOCK`` and ``_OPERAND_BYTES`` monkeypatched small).
* The host blocking (``block_incidence``) is the JAX package's array for
  array.
* LLR values follow ROADMAP §3's LLR rule (``testing.llr_topk_mismatches``):
  within ``8·ulp_f32(T·ln T) + 1e-5·|v|`` of the float64 LLR of the same
  exact counts, indices equal except between items whose float64 values lie
  within twice that of each other. Count scores are integers: values and
  indices, tie order included, equal the JAX package's exactly.
* Dense and column-blocked training agree (``DENSE_ITEM_LIMIT`` and
  ``col_block`` monkeypatched small); no item lists itself with a positive
  score; padded slots never count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.data.batch import Interactions as JaxInteractions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import cooccurrence as jco
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import cooccurrence as co
from predictionio_tpu_torch.ops.topk import sort_two_key, topk_two_key
from predictionio_tpu_torch.testing import (
    llr_atol,
    llr_reference64,
    llr_topk_mismatches,
)

CPU = DeviceContext.create(device="cpu")


@pytest.fixture(scope="module")
def jctx():
    return MeshContext.create(devices=jax.devices()[:1])


def draw(seed, n_users, n_items, per_user=(1, 9), dup=True):
    """(port Interactions, JAX Interactions) of random user → item rows,
    repeated pairs included (the incidence is binarized)."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        items = rng.choice(n_items, int(rng.integers(*per_user)), replace=False)
        rows += [(u, int(i)) for i in items]
        if dup and len(items):
            rows.append((u, int(items[0])))
    u, i = (np.array(c) for c in zip(*rows))
    port = interactions_from_arrays(
        u, i, np.ones(len(u)), np.zeros(len(u)),
        (f"u{k}" for k in range(n_users)), (f"i{k}" for k in range(n_items)))
    ref = JaxInteractions(
        user=u.astype(np.int32), item=i.astype(np.int32),
        rating=np.ones(len(u), np.float32), t=np.zeros(len(u)),
        user_map=JaxBiMap.string_int(f"u{k}" for k in range(n_users)),
        item_map=JaxBiMap.string_int(f"i{k}" for k in range(n_items)))
    return port, ref


def brute_counts(p, s, n_p, n_s):
    users_p = [set() for _ in range(n_p)]
    users_s = [set() for _ in range(n_s)]
    for u, i in zip(p.user, p.item):
        users_p[i].add(u)
    for u, i in zip(s.user, s.item):
        users_s[i].add(u)
    return np.array([[len(a & b) for b in users_s] for a in users_p], np.float32)


@pytest.fixture()
def small_blocks(monkeypatch):
    """16 users a block in both packages; the port groups 2 blocks a product."""
    monkeypatch.setattr(co, "_USER_BLOCK", 16)
    monkeypatch.setattr(jco, "_USER_BLOCK", 16)
    monkeypatch.setattr(co, "_OPERAND_BYTES", 2 * 16 * 128)


class TestCounts:
    @pytest.mark.parametrize("seed", range(3))
    def test_self_counts_equal_brute_force_and_jax(self, jctx, small_blocks, seed):
        port, ref = draw(seed, 90, 37)
        C = co.cooccurrence_matrix(CPU, port).numpy()
        np.testing.assert_array_equal(C, brute_counts(port, port, 37, 37))
        np.testing.assert_array_equal(C, np.asarray(jco.cooccurrence_matrix(jctx, ref)))

    @pytest.mark.parametrize("seed", range(3))
    def test_cross_counts_and_marginals_equal_jax(self, jctx, small_blocks, seed):
        pp, pr = draw(seed, 70, 23)
        sp, sr = draw(seed + 100, 70, 41, per_user=(0, 12))
        C = co.cross_occurrence_matrix(CPU, pp, sp, 23, 41).numpy()
        np.testing.assert_array_equal(C, brute_counts(pp, sp, 23, 41))
        np.testing.assert_array_equal(
            C, np.asarray(jco.cross_occurrence_matrix(jctx, pr, sr, 23, 41)))
        np.testing.assert_array_equal(
            co.distinct_item_counts(sp, 41), jco.distinct_item_counts(sr, 41))

    def test_block_incidence_is_the_jax_packages(self, small_blocks):
        port, ref = draw(5, 75, 30)
        for width in (None, co.incidence_width(port.user, 80) + 16):
            a = co.block_incidence(port, 80, width)
            b = jco.block_incidence(ref, 80, width)
            for name in ("local_user", "item", "mask"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert a.n_blocks == b.n_blocks == 5
        assert co.incidence_width(port.user, 80) == jco.incidence_width(ref.user, 80)

    def test_padded_slots_never_count_at_zero_zero(self):
        """Local user 0 of a block never touches item 0, and the padded
        slots (mask 0) point at (0, 0): the incidence must stay 0 there."""
        lu = torch.tensor([[1, 2, 0, 0, 0]], dtype=torch.int32)
        li = torch.tensor([[0, 3, 0, 0, 0]], dtype=torch.int32)
        lm = torch.tensor([[1, 1, 0, 0, 0]], dtype=torch.float32)
        a = co._incidence(lu, li, lm, 8)
        assert a.dtype == torch.int8 and a.shape == (8, co._USER_BLOCK) and a.is_contiguous()
        want = torch.zeros_like(a)
        want[0, 1] = want[3, 2] = 1
        assert torch.equal(a, want)
        C = co.cross_occurrence_block(lu, li, lm, lu, li, lm, 128, 128)
        assert C[0, 0] == 1 and C[3, 3] == 1 and C.sum() == 2

    def test_counts_are_exact_past_bf16(self, monkeypatch):
        """300 users sharing two items: a bf16 product would round the count."""
        monkeypatch.setattr(co, "_USER_BLOCK", 512)
        u = np.repeat(np.arange(300), 2)
        i = np.tile([0, 1], 300)
        inter = interactions_from_arrays(u, i, np.ones(600), np.zeros(600),
                                         (f"u{k}" for k in range(301)), ["a", "b", "c"])
        C = co.cooccurrence_matrix(CPU, inter).numpy()
        assert C[0, 1] == 300 and C[0, 0] == 300 and C[2, 2] == 0


class TestScores:
    @pytest.mark.parametrize("seed", range(3))
    def test_llr_follows_the_rule_against_float64_and_jax(self, jctx, seed):
        pp, pr = draw(seed, 300, 30)
        sp, sr = draw(seed + 7, 300, 45, per_user=(0, 15))
        C = co.cross_occurrence_matrix(CPU, pp, sp, 30, 45)
        pc, sc = co.distinct_item_counts(pp, 30), co.distinct_item_counts(sp, 45)
        got = co.llr_cross_scores(C, torch.from_numpy(pc), torch.from_numpy(sc), 300).numpy()
        ref = np.asarray(jco.llr_cross_scores(
            jnp.asarray(C.numpy()), jnp.asarray(pc), jnp.asarray(sc), 300))
        ref64 = llr_reference64(C.numpy(), pc, sc, 300)
        tol = llr_atol(300) + 1e-5 * np.abs(ref64)
        assert np.all(np.abs(got - ref64) <= tol)
        assert np.all(np.abs(ref - ref64) <= tol)  # the JAX package's, too
        assert np.all(got >= 0) and np.all(got[C.numpy() == 0] == 0)

    def test_self_llr_matches_jax(self, jctx):
        C = np.array([[50.0, 10.0, 2.0], [10.0, 60.0, 1.0], [2.0, 1.0, 4.0]], np.float32)
        got = co.llr_scores(torch.from_numpy(C)).numpy()
        ref = np.asarray(jco.llr_scores(jnp.asarray(C)))
        assert got.shape == C.shape and np.all(got >= 0) and np.all(got[C == 0] == 0)
        total = float(np.diag(C).sum())
        ref64 = llr_reference64(C, np.diag(C), np.diag(C), total)
        assert np.all(np.abs(got - ref64) <= llr_atol(total) + 1e-5 * np.abs(ref64))
        assert np.all(np.abs(ref - ref64) <= llr_atol(total) + 1e-5 * np.abs(ref64))

    def test_two_key_topk_is_lax_order(self):
        rng = np.random.default_rng(0)
        for _ in range(10):
            v = (rng.integers(-3, 4, (6, 40)) * 0.5).astype(np.float32)
            v[0, :5] = -0.0
            got_v, got_i = topk_two_key(torch.from_numpy(v), 12)
            ref_v, ref_i = jax.lax.top_k(jnp.asarray(v), 12)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
            sv, si = sort_two_key(torch.from_numpy(v))
            np.testing.assert_array_equal(got_i.numpy(), si[:, :12].numpy())


def rule_mismatches(model_items, model_scores, C, pc, sc, total, diagonal=None):
    """Every indicator row of (items, scores) against the float64 LLR of
    the exact counts ``C`` (primary × indicator); ``diagonal`` is what the
    path puts there: -1 where the blocked path masks it, 0 where the dense
    path zeroes it (an item may then list itself among the zero ties)."""
    ref = llr_reference64(C, pc, sc, total)
    if diagonal is not None:
        np.fill_diagonal(ref, diagonal)
    atol = llr_atol(total)
    out = []
    for j in range(model_items.shape[0]):
        out += [f"indicator {j}: {m}" for m in llr_topk_mismatches(
            model_items[j], model_scores[j], ref[:, j], atol)]
    return out


class TestTraining:
    @pytest.mark.parametrize("use_llr", [False, True])
    @pytest.mark.parametrize("blocked", [False, True])
    def test_train_matches_jax(self, jctx, monkeypatch, small_blocks, use_llr, blocked):
        port, ref = draw(3, 120, 40, per_user=(2, 8))
        if blocked:
            monkeypatch.setattr(co, "DENSE_ITEM_LIMIT", 1)
            monkeypatch.setattr(jco, "DENSE_ITEM_LIMIT", 1)
        got = co.train_cooccurrence(CPU, port, n=6, use_llr=use_llr)
        want = jco.train_cooccurrence(jctx, ref, n=6, use_llr=use_llr)
        if not use_llr:
            # integer scores: exact, tie order included
            np.testing.assert_array_equal(got.top_items, want.top_items)
            np.testing.assert_array_equal(got.top_scores, want.top_scores)
            return
        C = brute_counts(port, port, 40, 40)
        pc = co.distinct_item_counts(port, 40)
        diag = -1.0 if blocked else 0.0
        assert rule_mismatches(got.top_items, got.top_scores, C, pc, pc, 120, diag) == []
        assert rule_mismatches(want.top_items, want.top_scores, C, pc, pc, 120, diag) == []
        pos = want.top_scores > 1e-3
        np.testing.assert_allclose(got.top_scores[pos], want.top_scores[pos],
                                   rtol=1e-5, atol=llr_atol(120))

    @pytest.mark.parametrize("use_llr", [False, True])
    def test_blocked_mode_matches_dense(self, monkeypatch, use_llr):
        port, _ = draw(3, 40, 25, per_user=(4, 5), dup=False)
        dense = co.train_cooccurrence(CPU, port, n=5, use_llr=use_llr)
        monkeypatch.setattr(co, "DENSE_ITEM_LIMIT", 1)  # force blocked
        blocked = co.train_cooccurrence(CPU, port, n=5, use_llr=use_llr)
        np.testing.assert_allclose(blocked.top_scores, dense.top_scores, rtol=1e-5,
                                   atol=llr_atol(40) if use_llr else 0)
        pos = dense.top_scores > 1e-3
        np.testing.assert_array_equal(blocked.top_items[pos], dense.top_items[pos])

    @pytest.mark.parametrize("col_block", [16, 4096])
    @pytest.mark.parametrize("exclude", [False, True])
    def test_blocked_topn_equals_jax(self, jctx, small_blocks, col_block, exclude):
        pp, pr = draw(9, 150, 50, per_user=(1, 7))
        sp, sr = draw(10, 150, 50, per_user=(2, 12))
        pc = co.distinct_item_counts(pp, 50)
        kw = dict(n_users=150, k=7, primary_counts=pc, col_block=col_block,
                  exclude_diagonal=exclude)
        got_i, got_v = co.cross_occurrence_topn(CPU, pp, sp, 50, 50, **kw)
        ref_i, ref_v = jco.cross_occurrence_topn(jctx, pr, sr, 50, 50, **kw)
        C = brute_counts(pp, sp, 50, 50)
        sc = co.distinct_item_counts(sp, 50)
        diag = -1.0 if exclude else None
        assert rule_mismatches(got_i, got_v, C, pc, sc, 150, diag) == []
        assert rule_mismatches(ref_i, ref_v, C, pc, sc, 150, diag) == []
        # count mode: exact, ties included
        got_i, got_v = co.cross_occurrence_topn(CPU, pp, sp, 50, 50, use_llr=False, **kw)
        ref_i, ref_v = jco.cross_occurrence_topn(jctx, pr, sr, 50, 50, use_llr=False, **kw)
        np.testing.assert_array_equal(got_i, ref_i)
        np.testing.assert_array_equal(got_v, ref_v)

    @pytest.mark.parametrize("use_llr", [False, True])
    @pytest.mark.parametrize("blocked", [False, True])
    def test_no_item_lists_itself(self, monkeypatch, use_llr, blocked):
        rows = [(u, i) for u in range(10) for i in (0, 1)] + [(0, 2)]
        u, i = (np.array(c) for c in zip(*rows))
        inter = interactions_from_arrays(u, i, np.ones(len(u)), np.zeros(len(u)),
                                         (f"u{k}" for k in range(10)), ("a", "b", "c"))
        if blocked:
            monkeypatch.setattr(co, "DENSE_ITEM_LIMIT", 1)
        model = co.train_cooccurrence(CPU, inter, n=3, use_llr=use_llr)
        for j in range(3):
            items, scores = model.similar(j, 3)
            assert j not in items.tolist()
        if not use_llr:
            idx, scores = model.similar(0, 2)
            assert idx[0] == 1 and scores[0] == 10

    def test_sharded_paths_raise_naming_item_10(self):
        port, _ = draw(0, 10, 5, per_user=(1, 4))
        with pytest.raises(NotImplementedError, match="item 10"):
            co.train_cooccurrence(CPU, object(), n=3)
        with pytest.raises(NotImplementedError, match="item 10"):
            co.cross_occurrence_matrix(CPU, port, port, 5, 5, host_reduce=sum)
        with pytest.raises(NotImplementedError, match="item 10"):
            co.cross_occurrence_topn(CPU, port, port, 5, 5, n_users=10, k=2,
                                     primary_counts=np.ones(5), host_reduce=sum)
