"""The port's score path against the JAX package's, on the CPU.

Mirrors ``tests/test_score_kernel.py`` case for case: the same inputs, made
with numpy from a seed, go through the JAX ``gather_score_topk`` (its XLA
``reference`` backend) and the port's ``gather_score_topk`` on CPU tensors,
which is the CUDA kernel's plain PyTorch version.

Tolerance: values within rtol = atol = 1e-5 (XLA and PyTorch sum the dot
products in different orders); indices equal, except where two reference
values lie within that tolerance of each other (``topk_mismatches``). With
integer-valued factors every dot product is exact in any order, so indices
— tie order included — must be identical. The CUDA kernel itself cannot
run here; ``chip_smoke.py`` holds it against this plain version on the card,
and so does ``tests/test_torch_cuda.py`` where a card is present.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.ops import score_kernel as jax_score_kernel
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import quantize, score_kernel
from predictionio_tpu_torch.ops.topk import gather_score_topk, merge_topk
from predictionio_tpu_torch.testing import topk_mismatches

RUNGS = (1, 8, 16, 32, 64)
DTYPES = ("f32", "bf16", "int8")
TOL = 1e-5


def _factors(n_users=50, n_items=40, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    return U, V


def _integer_factors(n_users, n_items, rank=8, seed=0):
    """Nonzero small integers: every dot product is exact, no -0.0."""
    rng = np.random.default_rng(seed)
    U = rng.integers(1, 4, (n_users, rank)) * rng.choice([-1, 1], (n_users, rank))
    V = rng.integers(1, 4, (n_items, rank)) * rng.choice([-1, 1], (n_items, rank))
    return U.astype(np.float32), V.astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _both(U, V, u_idx, k, dtype="f32", item_mask=None):
    """(port result, JAX reference result) on identical quantized inputs."""
    Uq, us = jax_quantize.quantize_factors(U, dtype)
    Vq, vs = jax_quantize.quantize_factors(V, dtype)
    ref = jax_topk.gather_score_topk(
        Uq, Vq, u_idx, k, item_mask=item_mask, u_scale=us, v_scale=vs,
        backend="reference",
    )
    Up, _ = quantize.quantize_factors(U, dtype)
    Vp, _ = quantize.quantize_factors(V, dtype)
    port = gather_score_topk(
        quantize.factors_to_tensor(Up, "cpu"), quantize.factors_to_tensor(Vp, "cpu"),
        _t(np.asarray(u_idx, np.int32)), k, _t(item_mask),
        u_scale=_t(us), v_scale=_t(vs),
    )
    return [np.asarray(x) for x in port], [np.asarray(x) for x in ref]


def _assert_ranking_equal(port, ref, what, tol=TOL):
    (pv, pi), (rv, ri) = port, ref
    bad = topk_mismatches(pv, pi, rv, ri, tol)
    assert not bad, f"[{what}] port differs from the JAX reference: {bad[:3]}"
    np.testing.assert_allclose(pv, rv, rtol=TOL, atol=TOL)
    assert pv.dtype == np.float32 and pi.dtype == np.int32


class TestEquivalence:
    @pytest.mark.parametrize("batch", RUNGS)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_rungs_match_reference(self, batch, dtype):
        U, V = _factors(seed=batch)
        rng = np.random.default_rng(batch + 1)
        u_idx = rng.integers(0, U.shape[0], batch).astype(np.int32)
        _assert_ranking_equal(*_both(U, V, u_idx, 10, dtype=dtype), dtype)

    @pytest.mark.parametrize("n_items", (1, 7, 29, 37))
    def test_ragged_item_tail(self, n_items):
        U, V = _factors(n_items=n_items, seed=n_items)
        k = min(5, n_items)
        u_idx = np.arange(8, dtype=np.int32)
        port, ref = _both(U, V, u_idx, k)
        _assert_ranking_equal(port, ref, "ragged")
        assert port[1].max() < n_items

    def test_duplicate_score_ties_exact(self):
        # identical item rows ⇒ exactly tied scores; both break ties by
        # ascending item index (lax.top_k semantics)
        U, base = _integer_factors(50, 5, seed=3)
        V = np.repeat(base, 6, axis=0)  # 30 items in 5 groups of 6 clones
        port, ref = _both(U, V, np.arange(8, dtype=np.int32), 12)
        np.testing.assert_array_equal(port[1], ref[1])
        np.testing.assert_array_equal(port[0], ref[0])

    def test_exclusion_mask_never_wins(self):
        U, V = _factors()
        mask = np.zeros(V.shape[0], dtype=bool)
        mask[::2] = True  # exclude every even item
        port, ref = _both(U, V, np.arange(16, dtype=np.int32), 8, item_mask=mask)
        _assert_ranking_equal(port, ref, "mask")
        assert not np.any(port[1] % 2 == 0)

    def test_mask_leaves_fewer_than_k_items(self):
        # k beyond the unmasked items: the tail holds excluded items at
        # -1e30 in index order, as lax.top_k returns them
        U, V = _integer_factors(10, 12)
        mask = np.arange(12) >= 3
        port, ref = _both(U, V, np.arange(4, dtype=np.int32), 6, item_mask=mask)
        np.testing.assert_array_equal(port[1], ref[1])
        assert np.all(port[0][:, 3:] == np.float32(-1e30))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_multi_chunk_grid(self, dtype):
        # a catalog over several kernel chunks (BLOCK_I = 512), with a
        # cross-chunk tie (item 3 cloned into the last chunk)
        U, V = _factors(n_items=1100, seed=9)
        V[1090] = V[3]
        port, ref = _both(U, V, np.arange(8, dtype=np.int32), 100, dtype=dtype)
        _assert_ranking_equal(port, ref, dtype)

    def test_k_equals_items(self):
        U, V = _factors(n_items=12)
        port, ref = _both(U, V, np.arange(4, dtype=np.int32), 12)
        _assert_ranking_equal(port, ref, "fullk")

    @pytest.mark.parametrize("dtype", ("f32", "bf16"))
    def test_integer_factors_identical(self, dtype):
        # exact dot products: indices and values must be identical, with
        # in-chunk and cross-chunk clones
        U, V = _integer_factors(64, 1100, seed=5)
        V[600], V[10], V[1090] = V[601], V[3], V[3]
        port, ref = _both(U, V, np.arange(64, dtype=np.int32), 100, dtype=dtype)
        np.testing.assert_array_equal(port[1], ref[1])
        np.testing.assert_array_equal(port[0], ref[0])


class TestMergeTopk:
    def test_cross_list_ties_match_jax(self):
        # candidate lists with equal values in different lists, unsorted
        # indices: the merge orders (value desc, index asc) like lax.top_k
        vals = np.array([[3.0, 1.0, 3.0, 2.0, 3.0, 1.0]], np.float32)
        idx = np.array([[40, 7, 5, 9, 12, 2]], np.int32)
        pv, pi = merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), 5)
        rv, ri = jax_topk.merge_topk(vals, idx, 5)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        assert pi.numpy().tolist() == [[5, 12, 40, 9, 2]]

    def test_random_candidates_match_jax(self):
        rng = np.random.default_rng(7)
        vals = rng.integers(0, 5, (8, 64)).astype(np.float32)
        idx = np.stack([rng.permutation(1000)[:64] for _ in range(8)]).astype(np.int32)
        pv, pi = merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), 20)
        rv, ri = jax_topk.merge_topk(vals, idx, 20)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


class TestQuantize:
    def test_int8_identical_to_jax(self):
        U, _ = _factors()
        q, s = quantize.quantize_factors(U, "int8")
        jq, js = jax_quantize.quantize_factors(U, "int8")
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)

    def test_bf16_bits_identical_to_jax(self):
        # round-half-even on ties, huge and tiny values, signed zeros
        U, _ = _factors(seed=4)
        extra = np.array([[1 + 2**-8, 1 + 3 * 2**-8, -0.0, 3.4e38, 1e-40, -2.5, 0, 7]],
                         np.float32)
        U = np.concatenate([U, extra])
        q, s = quantize.quantize_factors(U, "bf16")
        jq, _ = jax_quantize.quantize_factors(U, "bf16")
        assert s is None and q.dtype == np.uint16
        np.testing.assert_array_equal(q, np.asarray(jq).view(np.uint16))
        t = quantize.factors_to_tensor(q, "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(jq).astype(np.float32))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_torch_twin_matches_numpy(self, dtype):
        U, _ = _factors(seed=6)
        q, s = quantize.quantize_factors(U, dtype)
        tq, ts = quantize.quantize_factors_torch(torch.from_numpy(U), dtype)
        np.testing.assert_array_equal(
            tq.float().numpy(), quantize.dequantize_factors(q, None)
        )
        if s is not None:
            np.testing.assert_array_equal(ts.numpy(), s)

    def test_int8_round_trip_error_bounded(self):
        U, _ = _factors()
        q, scale = quantize.quantize_factors(U, "int8")
        back = quantize.dequantize_factors(q, scale)
        step = np.abs(U).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(back - U) <= step / 2 + 1e-7)

    def test_zero_row_is_stable(self):
        q, scale = quantize.quantize_factors(np.zeros((3, 8), np.float32), "int8")
        assert np.all(q == 0) and np.all(np.isfinite(scale))

    def test_f32_passthrough(self):
        U, _ = _factors()
        q, scale = quantize.quantize_factors(U, "f32")
        assert q is U and scale is None


class TestWrapper:
    def test_cpu_tensor_takes_plain_version(self):
        U, V = _factors()
        before = score_kernel.launches.count
        v, i = score_kernel.fused_gather_score_topk(
            torch.from_numpy(U), torch.from_numpy(V), torch.arange(4, dtype=torch.int32), 5
        )
        rv, ri = score_kernel.gather_score_topk_reference(
            torch.from_numpy(U), torch.from_numpy(V), torch.arange(4, dtype=torch.int32), 5
        )
        assert torch.equal(v, rv) and torch.equal(i, ri)
        assert score_kernel.launches.count == before  # the kernel never ran

    def test_other_device_raises(self):
        U = torch.empty((4, 8), device="meta")
        with pytest.raises(ValueError, match="no score kernel"):
            score_kernel.fused_gather_score_topk(U, U, torch.empty(2, device="meta"), 2)

    def test_k_out_of_range_raises(self):
        U, V = _factors(n_items=5)
        with pytest.raises(ValueError):
            gather_score_topk(
                torch.from_numpy(U), torch.from_numpy(V), torch.arange(2, dtype=torch.int32), 6
            )

    @pytest.mark.parametrize("n", (1, 7, 8, 9, 512, 513, 1025, 59047))
    def test_pad_block_items_matches_jax(self, n):
        assert score_kernel.pad_block_items(n) == jax_score_kernel.pad_block_items(n)
        assert score_kernel.BLOCK_I == jax_score_kernel.BLOCK_I
