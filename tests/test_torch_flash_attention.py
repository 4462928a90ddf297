"""The flash-attention forward of the port against the JAX package.

The same numpy q, k, v (drawn from a seed) go through the port's
``flash_attention`` / ``flash_block_fwd`` on CPU tensors, which run the
kernel's plain version (``flash_attention_reference``), and through:

* the JAX ``full_attention`` (``parallel/ring.py``), the dense path;
* the JAX ``flash_attention`` / ``flash_block_fwd`` with the Pallas kernel
  in interpret mode, as the JAX package's own tests run it on the CPU:
  ``o`` and ``lse``.

Causal and not, batched, ``T_q != T_kv``, and the lengths both refuse.
Tolerance: rtol = atol = 2e-5, the JAX package's own flash test
(``tests/test_flash_attention.py``). The kernel itself runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import flash_attention as jax_flash
from predictionio_tpu.parallel.ring import full_attention as jax_full_attention
from predictionio_tpu_torch.ops import flash_attention as fa
from predictionio_tpu_torch.parallel.ring import full_attention

TOL = 2e-5


def _qkv(seed, q_shape, kv_len=None):
    rng = np.random.default_rng(seed)
    kv_shape = (*q_shape[:-2], kv_len or q_shape[-2], q_shape[-1])
    return (rng.normal(size=q_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("shape, kv_len", [
    ((8, 16), None),
    ((2, 3, 128, 16), None),
    ((64, 50), 128),
    ((256, 8), 128),
])
def test_plain_version_matches_jax_full_attention(causal, shape, kv_len):
    q, k, v = _qkv(0, shape, kv_len)
    want = np.asarray(jax_full_attention(q, k, v, causal=causal))
    got = fa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        full_attention(*_t(q, k, v), causal=causal).numpy(), want, rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("shape, kv_len", [
    ((256, 32), None),
    ((2, 3, 128, 16), None),
    ((128, 16), 256),
    ((1, 1, 256, 50), None),
])
def test_matches_jax_flash_kernel_in_interpret_mode(causal, shape, kv_len):
    q, k, v = _qkv(1, shape, kv_len)
    t_q, t_kv = q.shape[-2], k.shape[-2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    o_ref, lse_ref = jax_flash.flash_block_fwd(
        q, k, v, causal, scale, min(128, t_q), min(128, t_kv), True
    )
    o, lse = fa.flash_block_fwd(*_t(q, k, v), causal, scale)
    assert o.shape == q.shape and lse.shape == q.shape[:-1] and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL, atol=TOL)
    o_jax = np.asarray(jax_flash.flash_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(
        fa.flash_attention(*_t(q, k, v), causal=causal).numpy(), o_jax, rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("q_len, kv_len", [(200, 200), (256, 300), (384, 130)])
def test_lengths_the_jax_blocks_refuse_raise_alike(q_len, kv_len):
    q, k, v = _qkv(2, (q_len, 16), kv_len)
    with pytest.raises(ValueError, match="divide"):
        jax_flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(*_t(q, k, v))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_block_fwd(*_t(q, k, v), False)


def test_head_width_and_shapes_are_checked():
    q, k, v = _t(*_qkv(3, (128, 257)))
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(3, (2, 128, 16)))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:1], v[:1])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[..., :8])


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _t(*_qkv(4, (2, 256, 50)))
    before = fa.launches.count
    o, lse = fa.flash_block_fwd(q, k, v, True)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, True)
    assert fa.launches.count == before
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)


def test_plain_version_in_float64_is_near_float32():
    q, k, v = _t(*_qkv(5, (3, 128, 50)))
    o32, lse32 = fa.flash_attention_reference(q, k, v, causal=True)
    o64, lse64 = fa.flash_attention_reference(q.double(), k.double(), v.double(), causal=True)
    assert o64.dtype == lse64.dtype == torch.float64
    np.testing.assert_allclose(o32.numpy(), o64.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse32.numpy(), lse64.numpy(), rtol=TOL, atol=TOL)


def test_causal_first_row_sees_only_the_first_key():
    q, k, v = _t(*_qkv(6, (128, 16)))
    o, lse = fa.flash_block_fwd(q, k, v, True, 0.25)
    np.testing.assert_allclose(o[0].numpy(), v[0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(lse[0]), float((q[0] * np.float32(0.25)) @ k[0]), rtol=1e-6)


@pytest.mark.parametrize("t, device, want", [
    (256, "cuda", True), (384, "cuda", True), (1024, "cuda", True),
    (128, "cuda", False), (320, "cuda", False), (255, "cuda", False),
    (256, "cpu", False),
])
def test_gate_is_the_jax_shape_policy(t, device, want):
    assert fa.use_flash_default(t, torch.device(device)) is want
