"""The 3xTF32 products of the flash kernels, emulated in numpy.

Kernels 4 (forward), 5 (dq) and 6 (dk, dv) run their products on the tensor
cores as ``mma.sync.m16n8k8`` with TF32 operands (``csrc/mma_tf32.cuh``):
each float32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x -
hi) (round to 10 mantissa bits, ties away from zero, as
``cvt.rna.tf32.f32``), and a product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
each 8-deep step's three products summed from zero and then added to the
float32 sum (the per-step fold). Here that arithmetic is emulated and held
against float64 at the kernels' tolerances (o rtol = atol = 2e-5; dq, dk,
dv rtol 2e-4, atol 2e-5), at head widths 16, 50, 64 and 128, while a single
TF32 product (a_hi·b_hi alone) is shown to exceed them: the reason the
kernels take three. Kernel 5 is emulated as it runs: ds formed in float32
from the score and dp fragments, and a row's dq summed by key group
(``dq_plan``'s ``64 // q_rows`` groups of 32 keys out of every
``32 · (64 // q_rows)``), the groups' sums added in group order.
"""

import numpy as np
import pytest

from predictionio_tpu_torch.ops import flash_attention as fa

O_TOL = 2e-5
BWD_RTOL, BWD_ATOL = 2e-4, 2e-5


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32's 10 mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = rna_tf32(x)
    return hi, rna_tf32((x - hi).astype(np.float32))


def mma_product(a: np.ndarray, b: np.ndarray, passes: int, steps=None) -> np.ndarray:
    """a (m, k) @ b (k, n) as the kernels form it (``mma3``): ``passes`` 3 is
    3xTF32, 1 a single TF32 product; each 8-deep step's products (the small
    ones first; each exact, as TF32 products fit float32's mantissa) are
    summed from zero in float32, then added to the float32 sum. ``steps``
    lists the steps' first indices, in order (all of them by default)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]
    c = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8) if steps is None else steps:
        t = np.zeros_like(c)
        for x, y in terms:
            t = (t + (x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64))).astype(np.float32)
        c = (c + t).astype(np.float32)
    return c


def _excess(got, want, rtol, atol):
    return float((np.abs(got - want) - (atol + rtol * np.abs(want))).max())


def _inputs(d, t=256, seed=0):
    rng = np.random.default_rng(seed + d)
    return (rng.standard_normal((t, d)).astype(np.float32) for _ in range(4))


def _causal_mask(t):
    return np.arange(t)[:, None] < np.arange(t)[None, :]


def forward(q, k, v, passes):
    scale = np.float32(fa._f32(1.0 / q.shape[1] ** 0.5))
    s = mma_product((q * scale).astype(np.float32), k.T.copy(), passes)
    s = np.where(_causal_mask(len(q)), np.float32(-1e30), s)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(np.float32)
    l = p.sum(-1, keepdims=True)
    return mma_product(p, v, passes) / l


def forward64(q, k, v):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = (q / np.sqrt(q.shape[1])) @ k.T
    s = np.where(_causal_mask(len(q)), -1e30, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p @ v) / p.sum(-1, keepdims=True)


def _lse_delta(q, k, v, do, scale):
    """The forward's lse and the wrapper's delta (float32), from float64,
    with the scores in float64."""
    o64 = forward64(q, k, v)
    s64 = (q.astype(np.float64) * float(scale)) @ k.T.astype(np.float64)
    s64 = np.where(_causal_mask(len(q)), -1e30, s64)
    lse = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + s64.max(-1)
    return s64, lse.astype(np.float32), (do.astype(np.float64) * o64).sum(-1).astype(np.float32)


def backward_kv(q, k, v, do, passes):
    """dk, dv in the recomputation form, every product as the kernel forms it."""
    scale = np.float32(fa._f32(1.0 / q.shape[1] ** 0.5))
    s64, lse, delta = _lse_delta(q, k, v, do, scale)
    if passes == 0:  # float64 throughout
        p = np.exp(s64 - lse[:, None].astype(np.float64))
        ds = p * (do.astype(np.float64) @ v.T.astype(np.float64) - delta[:, None])
        return (ds.T @ q.astype(np.float64)) * float(scale), p.T @ do.astype(np.float64)
    sT = mma_product(k, (q * scale).astype(np.float32).T.copy(), passes)  # keys x queries
    sT = np.where(_causal_mask(len(q)).T, np.float32(-1e30), sT)
    pT = np.exp(sT - lse[None, :]).astype(np.float32)
    dpT = mma_product(v, do.T.copy(), passes)
    dsT = (pT * (dpT - delta[None, :])).astype(np.float32)
    return mma_product(dsT, q, passes) * scale, mma_product(pT, do, passes)


def backward_q(q, k, v, do, passes, q_rows=fa.TILE):
    """dq as kernel 5 forms it for query tiles of ``q_rows`` rows; ``passes``
    0 gives float64 throughout."""
    scale = np.float32(fa._f32(1.0 / q.shape[1] ** 0.5))
    s64, lse, delta = _lse_delta(q, k, v, do, scale)
    if passes == 0:
        p = np.exp(s64 - lse[:, None].astype(np.float64))
        ds = p * (do.astype(np.float64) @ v.T.astype(np.float64) - delta[:, None])
        return (ds @ k.astype(np.float64)) * float(scale)
    s = mma_product((q * scale).astype(np.float32), k.T.copy(), passes)
    s = np.where(_causal_mask(len(q)), np.float32(-1e30), s)
    p = np.exp(s - lse[:, None]).astype(np.float32)
    ds = (p * (mma_product(do, v.T.copy(), passes) - delta[:, None])).astype(np.float32)
    # a key group's sum folds its own 8-key steps in order; a step no row
    # sees adds exactly 0, so the causal skips change nothing
    n_kg = fa.TILE // q_rows
    steps = range(0, k.shape[0], 8)
    parts = [mma_product(ds, k, passes, [k0 for k0 in steps if (k0 // fa.DQ_KT) % n_kg == g])
             for g in range(n_kg)]
    dq = parts[0]
    for part in parts[1:]:
        dq = (dq + part).astype(np.float32)
    return (dq * scale).astype(np.float32)


@pytest.mark.parametrize("d", (16, 50, 64, 128))
def test_forward_3xtf32_within_tolerance_single_tf32_not(d):
    q, k, v, _ = _inputs(d)
    want = forward64(q, k, v)
    assert _excess(forward(q, k, v, 3), want, O_TOL, O_TOL) <= 0
    assert _excess(forward(q, k, v, 1), want, O_TOL, O_TOL) > 0


@pytest.mark.parametrize("d", (16, 50, 64, 128))
def test_dkdv_3xtf32_within_tolerance_single_tf32_not(d):
    q, k, v, do = _inputs(d, seed=1)
    dk64, dv64 = backward_kv(q, k, v, do, 0)
    dk3, dv3 = backward_kv(q, k, v, do, 3)
    dk1, dv1 = backward_kv(q, k, v, do, 1)
    assert max(_excess(dk3, dk64, BWD_RTOL, BWD_ATOL), _excess(dv3, dv64, BWD_RTOL, BWD_ATOL)) <= 0
    assert max(_excess(dk1, dk64, BWD_RTOL, BWD_ATOL), _excess(dv1, dv64, BWD_RTOL, BWD_ATOL)) > 0


@pytest.mark.parametrize("d", (16, 50, 64, 128))
def test_dq_3xtf32_folded_within_tolerance_single_tf32_not(d):
    q, k, v, do = _inputs(d, seed=2)
    dq64 = backward_q(q, k, v, do, 0)
    assert _excess(backward_q(q, k, v, do, 3), dq64, BWD_RTOL, BWD_ATOL) <= 0
    assert _excess(backward_q(q, k, v, do, 1), dq64, BWD_RTOL, BWD_ATOL) > 0


@pytest.mark.parametrize("q_rows", (32, 16))
def test_dq_key_groups_within_tolerance(q_rows):
    """The smaller tiles of ``dq_plan`` sum a row by key group and add the
    groups in order: as close to float64 as one sum over every key."""
    q, k, v, do = _inputs(50, seed=3)
    dq64 = backward_q(q, k, v, do, 0)
    grouped = backward_q(q, k, v, do, 3, q_rows)
    assert _excess(grouped, dq64, BWD_RTOL, BWD_ATOL) <= 0
    assert not np.array_equal(grouped, backward_q(q, k, v, do, 3))  # the order is another


def test_rna_rounds_to_ten_bits_ties_away():
    one_ulp = np.float32(2.0**-10)
    x = np.array([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0], np.float32)
    np.testing.assert_array_equal(rna_tf32(x), [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0])
    hi, lo = (x[0] for x in split(np.float32([np.pi])))
    assert hi + lo != hi and abs(float(hi + lo) - np.pi) < 2**-20
