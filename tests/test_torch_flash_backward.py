"""The flash-attention backward of the port against the JAX package.

The same numpy q, k, v and cotangents (drawn from a seed) go through the
port on CPU tensors, where ``flash_block_bwd`` and the autograd Function's
backward run the kernels' plain version (``flash_attention_bwd_reference``),
and through:

* ``jax.grad`` of the JAX ``full_attention`` (``parallel/ring.py``), at the
  shapes and tolerances of the JAX package's own gradient tests
  (``tests/test_flash_attention.py``: rtol 2e-4, atol 2e-5);
* the JAX ``flash_block_bwd`` with the Pallas kernels in interpret mode, as
  the JAX package's own tests run them on the CPU, fed the global ``o`` and
  ``lse`` (whole k/v, and one half of it as a ring block).

Besides: ``torch.autograd.gradcheck`` on the Function in float64, the
global-lse split summing to the whole backward, a non-contiguous cotangent,
and the refusals. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.ops import flash_attention as jax_flash
from predictionio_tpu.parallel.ring import full_attention as jax_full_attention
from predictionio_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 2e-4, 2e-5


def _draw(seed, q_shape, kv_len=None):
    rng = np.random.default_rng(seed)
    kv_shape = (*q_shape[:-2], kv_len or q_shape[-2], q_shape[-1])
    return tuple(rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape, q_shape))


def _t(*arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


def _close(got, want):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", (False, True))
def test_function_grads_match_jax_dense_grads(causal):
    """``tests/test_flash_attention.py::test_grads_match_dense``: (256, 32)
    and a non-uniform cotangent."""
    q, k, v, _ = _draw(4, (256, 32))
    w = np.cos(np.arange(32)).astype(np.float32)
    want = jax.grad(lambda q, k, v: (jax_full_attention(q, k, v, causal=causal) * w).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    (fa.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want)


def test_function_grads_match_jax_batched_square_loss():
    """``test_grads_multiblock_batched``: (2, 2, 128, 16), loss Σ o²."""
    q, k, v, _ = _draw(5, (2, 2, 128, 16))
    want = jax.grad(lambda q, k, v: (jax_full_attention(q, k, v, causal=True) ** 2).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    (fa.flash_attention(tq, tk, tv, causal=True) ** 2).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want)


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("shape, kv_len", [((256, 32), None), ((2, 3, 128, 16), None),
                                           ((128, 16), 256), ((1, 1, 256, 50), None)])
def test_plain_backward_matches_jax_flash_block_bwd_interpret(causal, shape, kv_len):
    q, k, v, do = _draw(6, shape, kv_len)
    t_q, t_kv = q.shape[-2], k.shape[-2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = jax_flash.flash_block_fwd(q, k, v, causal, scale, min(128, t_q), min(128, t_kv), True)
    want = jax_flash.flash_block_bwd(q, k, v, o, lse, do, causal, scale,
                                     min(128, t_q), min(128, t_kv), True)
    got = fa.flash_block_bwd(*_t(q, k, v, np.asarray(o), np.asarray(lse), do), causal, scale)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    _close(got, want)


@pytest.mark.parametrize("causal", (False, True))
def test_ring_block_with_global_lse_matches_jax_interpret(causal):
    """One half of k/v as a ring block, with the whole forward's o and lse."""
    q, k, v, do = _draw(7, (256, 32))
    scale = 1.0 / np.sqrt(32)
    o, lse = jax_flash.flash_block_fwd(q, k, v, causal, scale, 128, 128, True)
    k2, v2 = k[128:], v[128:]
    want = jax_flash.flash_block_bwd(q, k2, v2, o, lse, do, causal, scale, 128, 128, True)
    got = fa.flash_block_bwd(*_t(q, k2, v2, np.asarray(o), np.asarray(lse), do), causal, scale)
    _close(got, want)


def _ring_sum(q, k, v, o, lse, do, causal, n_blocks=2):
    """The ring backward's composition on one device: q and k/v cut into
    ``n_blocks`` blocks along T; block pair (i, j) is causal on the diagonal,
    full below it and skipped above it under a causal mask, and every pair
    is fed the GLOBAL o and lse of its query block."""
    cut = q.shape[-2] // n_blocks
    blk = [slice(b * cut, (b + 1) * cut) for b in range(n_blocks)]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for i, si in enumerate(blk):
        for j, sj in enumerate(blk):
            if causal and j > i:
                continue
            gq, gk, gv = fa.flash_block_bwd(
                q[:, si].contiguous(), k[:, sj].contiguous(), v[:, sj].contiguous(),
                o[:, si].contiguous(), lse[:, si].contiguous(), do[:, si].contiguous(),
                causal and i == j)
            dq[:, si] += gq
            dk[:, sj] += gk
            dv[:, sj] += gv
    return dq, dk, dv


@pytest.mark.parametrize("causal", (False, True))
def test_global_lse_split_sums_to_the_whole_backward(causal):
    q, k, v, do = _t(*_draw(8, (2, 256, 50)))
    o, lse = fa.flash_block_fwd(q, k, v, causal)
    whole = fa.flash_block_bwd(q, k, v, o, lse, do, causal)
    for got, want in zip(_ring_sum(q, k, v, o, lse, do, causal), whole):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("q_len, kv_len, d", [(16, 16, 4), (8, 16, 3), (32, 16, 2)])
def test_gradcheck_in_float64(causal, q_len, kv_len, d):
    rng = np.random.default_rng(q_len + kv_len + d)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, t, d)), requires_grad=True)
               for t in (q_len, kv_len, kv_len))
    assert torch.autograd.gradcheck(lambda q, k, v: fa.flash_attention(q, k, v, causal), (q, k, v))


def test_non_contiguous_cotangent_is_taken():
    """As from ``_block_stack``'s ``a.transpose(-3, -2).reshape(...)`` with
    two heads: the backward makes ``do`` contiguous itself."""
    q, k, v, _ = _draw(9, (2, 2, 128, 16))
    w = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 128, 2, 16)).astype(np.float32))
    do = w.transpose(1, 2)
    assert not do.is_contiguous()
    tq, tk, tv = _t(q, k, v)
    o, lse = fa.flash_block_fwd(tq, tk, tv, True)
    got = fa.flash_block_bwd(tq, tk, tv, o, lse, do, True)
    want = fa.flash_block_bwd(tq, tk, tv, o, lse, do.contiguous(), True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tq, tk, tv = _t(q, k, v, grad=True)
    (fa.flash_attention(tq, tk, tv, causal=True).transpose(1, 2) * w).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_backward():
    q, k, v, do = _t(*_draw(11, (2, 256, 50)))
    o, lse = fa.flash_block_fwd(q, k, v, True)
    before = (fa.bwd_dq_launches.count, fa.bwd_dkv_launches.count)
    got = fa.flash_block_bwd(q, k, v, o, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    assert (fa.bwd_dq_launches.count, fa.bwd_dkv_launches.count) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_plain_backward_in_float64_is_near_float32():
    q, k, v, do = _t(*_draw(12, (3, 128, 50)))
    o, lse = fa.flash_attention_reference(q, k, v, True)
    g32 = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    g64 = fa.flash_attention_bwd_reference(*(x.double() for x in (q, k, v, o, lse, do)), True)
    for a, b in zip(g32, g64):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_shapes_are_checked():
    q, k, v, do = _t(*_draw(13, (2, 128, 16)))
    o, lse = fa.flash_block_fwd(q, k, v, False)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_block_bwd(q, k, v, o, lse[:, :64], do, False)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_block_bwd(q, k, v, o[:1], lse, do, False)
    q, k, v, do = _t(*_draw(13, (2, 200, 16)))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_block_bwd(q, k, v, torch.zeros_like(q), torch.zeros(2, 200), do, False)
