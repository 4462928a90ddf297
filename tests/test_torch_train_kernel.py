"""The training kernel's plain version against the JAX package's reference math.

``predictionio_tpu_torch.ops.train_kernel.fused_train_normal_eq`` on CPU
tensors runs ``train_normal_eq_reference``; it must compute what the JAX
dense half-step computes per bucket (``models/als.py:644-665``, quoted
verbatim below as ``_jax_normal_eq``, the same math as
``tests/test_train_kernel.py``) on the same numpy inputs, for every compute
dtype, explicit and implicit, ragged bucket shapes, masked slots pointing
anywhere and a fully masked bucket. A rank above the kernel's limit raises.

Tolerances: f32 and int8 rtol = atol = 1e-5 (the same products, summed in
another order); bf16 explicit the same (products of bf16 values are exact
in f32); bf16 implicit ``A`` rtol = 2e-2, atol = 0.5, as the JAX suite holds
its own kernel (``tests/test_train_kernel.py:84-90``: the weighted row is
rounded to bf16, and XLA may keep it in f32 across a fusion).

``tests/test_torch_cuda.py`` holds the CUDA kernel against this plain
version on a card, by the summation-order rule tested here
(``predictionio_tpu_torch/testing.py`` ``normal_eq_mismatches``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops.quantize import quantize_factors_jax
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.ops.quantize import quantize_factors_torch
from predictionio_tpu_torch.testing import (
    KERNEL_VS_FLOAT64_RTOL,
    normal_eq_magnitudes,
    normal_eq_mismatches,
)

DTYPES = ("f32", "bf16", "int8")
ALPHA = 2.0


def _bucket(n_b, D, n_opp, k, seed=0, mask_p=0.7):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_opp, (n_b, D)).astype(np.int32)
    rat = rng.uniform(1, 5, (n_b, D)).astype(np.float32)
    msk = (rng.uniform(size=(n_b, D)) < mask_p).astype(np.float32)
    V = rng.normal(size=(n_opp, k)).astype(np.float32)
    return idx, rat, msk, V


def _jax_normal_eq(idx, rat, msk, opp, implicit, alpha):
    f32 = jnp.float32
    Vg = opp[idx]
    w = msk.astype(Vg.dtype)
    if implicit:
        cw = (alpha * rat).astype(Vg.dtype) * w
        A = jnp.einsum(
            "edk,edl->ekl", Vg * cw[:, :, None], Vg, preferred_element_type=f32
        )
        b = jnp.einsum(
            "edk,ed->ek", Vg, (1.0 + alpha * rat).astype(Vg.dtype) * w,
            preferred_element_type=f32,
        )
        cnt = jnp.zeros(idx.shape[0], f32)
    else:
        W = Vg * w[:, :, None]
        A = jnp.einsum("edk,edl->ekl", W, W, preferred_element_type=f32)
        b = jnp.einsum(
            "edk,ed->ek", W, rat.astype(Vg.dtype), preferred_element_type=f32
        )
        cnt = msk.sum(-1)
    return A, b, cnt


def _port(idx, rat, msk, V, dtype, implicit, alpha=ALPHA):
    q, scale = quantize_factors_torch(torch.from_numpy(V), dtype)
    return train_kernel.fused_train_normal_eq(
        torch.from_numpy(idx), torch.from_numpy(rat), torch.from_numpy(msk),
        q, scale, implicit=implicit, alpha=alpha,
    )


def _jax(idx, rat, msk, V, dtype, implicit, alpha=ALPHA):
    q, scale = quantize_factors_jax(jnp.asarray(V), dtype)
    opp = q if scale is None else q.astype(jnp.float32) * scale
    return _jax_normal_eq(
        jnp.asarray(idx), jnp.asarray(rat), jnp.asarray(msk), opp, implicit, alpha
    )


def _assert_close(got, ref, dtype, implicit):
    for name, g, r in zip(("A", "b", "cnt"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == np.float32 and g.shape == r.shape, name
        if dtype == "bf16" and implicit and name == "A":
            np.testing.assert_allclose(g, r, rtol=2e-2, atol=0.5, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_matches_jax_reference(dtype, implicit):
    args = _bucket(13, 24, 37, 5, seed=1)
    _assert_close(_port(*args, dtype, implicit), _jax(*args, dtype, implicit), dtype, implicit)


@pytest.mark.parametrize("n_b,D", [(1, 4), (5, 8), (8, 16), (17, 33), (32, 7)])
@pytest.mark.parametrize("implicit", (False, True))
def test_ragged_shapes(n_b, D, implicit):
    args = _bucket(n_b, D, 29, 6, seed=n_b * 31 + D)
    _assert_close(_port(*args, "f32", implicit), _jax(*args, "f32", implicit), "f32", implicit)


def test_int8_quantization_matches_jax():
    V = _bucket(1, 1, 41, 7, seed=9)[3]
    q, s = quantize_factors_torch(torch.from_numpy(V), "int8")
    jq, js = quantize_factors_jax(jnp.asarray(V), "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_masked_slots_contribute_exactly_zero(dtype, implicit):
    """A masked slot's idx is irrelevant: pointing dead slots at another
    row, or past the end of V, changes no output bit."""
    idx, rat, msk, V = _bucket(9, 12, 21, 4, seed=3, mask_p=0.5)
    live = msk.astype(bool)
    for dead in ((idx + 7) % 21, np.full_like(idx, 10_000), np.full_like(idx, -3)):
        moved = np.where(live, idx, dead).astype(np.int32)
        for x, y in zip(
            _port(idx, rat, msk, V, dtype, implicit),
            _port(moved, rat, msk, V, dtype, implicit),
        ):
            assert torch.equal(x, y)


@pytest.mark.parametrize("implicit", (False, True))
def test_fully_masked_bucket_is_all_zero(implicit):
    idx, rat, _, V = _bucket(6, 10, 15, 4, seed=4)
    zero = np.zeros_like(rat)
    for t in _port(idx, rat, zero, V, "f32", implicit):
        assert not torch.any(t)


def test_rank_above_limit_raises():
    idx, rat, msk, _ = _bucket(2, 3, 5, 1)
    V = np.zeros((5, train_kernel.MAX_RANK + 1), np.float32)
    with pytest.raises(ValueError, match=f"1..{train_kernel.MAX_RANK}"):
        _port(idx, rat, msk, V, "f32", False)


@pytest.mark.parametrize(
    "n_b,D,n_sm,want",
    [(43, 96_168, 132, (25, 3904)), (1000, 48, 132, (1, 64)), (3, 20_000, 132, (10, 2048)),
     (1, 4, 132, (1, 64)), (100_000, 14_360, 132, (1, 14_400))],
)
def test_split_plan(n_b, D, n_sm, want):
    """Wide rows of short buckets are cut into TILE-multiple parts that cover
    D exactly once; long buckets are never cut."""
    splits, seg = train_kernel.split_plan(n_b, D, n_sm)
    assert (splits, seg) == want
    assert seg % train_kernel.TILE == 0 and (splits - 1) * seg < D <= splits * seg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_float64_accumulation_keeps_the_cast_points(dtype, implicit):
    """``accumulate=torch.float64`` sums the plain version's operands, bf16
    roundings included, in float64: it agrees with the float32 sums within
    the card's kernel-vs-float64 rule (a skipped bf16 rounding would part
    them by ~2e-3), and on integer-valued operands, where every sum is
    exact, bit for bit."""
    idx, rat, msk, V = (torch.from_numpy(a) for a in _bucket(11, 40, 23, 6, seed=7))
    q, s = quantize_factors_torch(V, dtype)
    kw = dict(implicit=implicit, alpha=ALPHA)
    f32 = train_kernel.train_normal_eq_reference(idx, rat, msk, q, s, **kw)
    f64 = train_kernel.train_normal_eq_reference(idx, rat, msk, q, s, accumulate=torch.float64, **kw)
    assert f64[0].dtype == f64[1].dtype == torch.float64 and f64[2].dtype == torch.float32
    mag = normal_eq_magnitudes(idx, rat, msk, q, s, **kw)
    assert normal_eq_mismatches(f32, f64, mag, rtol=KERNEL_VS_FLOAT64_RTOL) == []
    Vi, ri = V.round(), rat.round()
    qi, si = quantize_factors_torch(Vi, "f32")
    exact = train_kernel.train_normal_eq_reference(idx, ri, msk, qi, si, **kw)
    wide = train_kernel.train_normal_eq_reference(idx, ri, msk, qi, si, accumulate=torch.float64, **kw)
    for x, y in zip(exact[:2], wide[:2]):
        assert torch.equal(x.double(), y)


def test_mismatch_rule():
    """The rule flags a difference beyond rtol of the magnitudes, and a
    count that differs, and nothing within them."""
    idx, rat, msk, V = (torch.from_numpy(a) for a in _bucket(7, 9, 11, 3, seed=5))
    ref = train_kernel.train_normal_eq_reference(idx, rat, msk, V, implicit=False)
    mag = normal_eq_magnitudes(idx, rat, msk, V, implicit=False, alpha=1.0)
    near = (ref[0] + 0.5e-4 * mag[0], ref[1] - 0.5e-4 * mag[1], ref[2])
    assert normal_eq_mismatches(near, ref, mag) == []
    far = (ref[0] + 3e-4 * mag[0] + 1e-5, ref[1], ref[2])
    assert normal_eq_mismatches(far, ref, mag)[0].startswith("A:")
    assert normal_eq_mismatches((ref[0], ref[1], ref[2] + 1), ref, mag) == [
        "cnt differs at 7 rows"
    ]
