"""Kernel 3's plain version against the JAX package's gather, bit for bit.

``predictionio_tpu_torch.ops.train_kernel.fused_gather_rows`` on CPU
tensors runs ``gather_rows_reference``: ``V`` dequantized (int8 times its
per-row scale), its rows gathered by ``idx`` (clamped into range), widened
to float32. On the same numpy inputs it must EQUAL, bit for bit:

* the JAX package's Pallas kernel ``fused_gather_rows``, run in interpret
  mode as ``tests/test_train_kernel.py::TestGatherRows`` runs it;
* the XLA gather the JAX reference backend uses, ``opp[idx]`` in float32
  (``predictionio_tpu/models/als.py:480-488,497``).

Gathering and widening are exact and one f32 multiply rounds the same on
either side, so no tolerance applies. The shapes: n not a multiple of the
TPU kernel's 512-row block, n = 1, ranks 4, 10, 65 and 128. Then
``quantize_factors_torch`` followed by the port's gather must equal
``quantize_factors_jax`` followed by JAX's gather, the routing on CPU
tensors counts no launch, and the wrapper refuses what the kernel does
not take. ``tests/test_torch_cuda.py`` holds the CUDA kernel against this
plain version on a card, bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import train_kernel as jax_train_kernel
from predictionio_tpu.ops.quantize import quantize_factors_jax
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.ops.quantize import factors_to_tensor, quantize_factors_torch

DTYPES = ("f32", "bf16", "int8")


def _inputs(n, n_opp, k, seed):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_opp, k)).astype(np.float32)
    idx = rng.integers(0, n_opp, (n,)).astype(np.int32)
    return V, idx


def _jax_quantized(V, dtype):
    """JAX's quantized V and scale, and the same values as torch tensors."""
    q, scale = quantize_factors_jax(jnp.asarray(V), dtype)
    qn = np.asarray(q)
    if dtype == "bf16":
        qn = qn.view(np.uint16)  # the bit pattern, as the port holds bf16 in numpy
    qt = factors_to_tensor(qn, "cpu")
    st = None if scale is None else torch.from_numpy(np.asarray(scale))
    return q, scale, qt, st


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, n_opp, k", [
    (1, 9, 4), (77, 33, 10), (513, 200, 4), (1000, 257, 65), (130, 40, 128),
])
def test_plain_version_equals_jax_gather_bitwise(dtype, n, n_opp, k):
    V, idx = _inputs(n, n_opp, k, seed=n + k)
    q, scale, qt, st = _jax_quantized(V, dtype)
    before = train_kernel.gather_launches.count
    got = train_kernel.fused_gather_rows(qt, torch.from_numpy(idx), st).numpy()
    assert train_kernel.gather_launches.count == before  # CPU: no launch
    assert got.dtype == np.float32 and got.shape == (n, k)
    opp = q if scale is None else q.astype(jnp.float32) * scale
    xla = np.asarray(opp[jnp.asarray(idx)].astype(jnp.float32))
    pallas = np.asarray(jax_train_kernel.fused_gather_rows(q, jnp.asarray(idx), scale))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_quantize_then_gather_equals_jax(dtype):
    V, idx = _inputs(300, 120, 10, seed=3)
    qt, st = quantize_factors_torch(torch.from_numpy(V), dtype)
    got = train_kernel.fused_gather_rows(qt, torch.from_numpy(idx), st).numpy()
    q, scale = quantize_factors_jax(jnp.asarray(V), dtype)
    want = np.asarray(jax_train_kernel.fused_gather_rows(q, jnp.asarray(idx), scale))
    np.testing.assert_array_equal(got, want)


def test_out_of_range_indices_are_clamped():
    """Both ways out of range, clamped as XLA's gather clamps (``lax.gather``
    in CLIP mode). ``jnp`` indexing would first wrap a negative index
    numpy-style; the solver's streams hold no negative index."""
    import jax

    V, _ = _inputs(1, 6, 3, seed=4)
    idx = torch.tensor([-5, -1, 0, 5, 6, 1000], dtype=torch.int32)
    got = train_kernel.fused_gather_rows(torch.from_numpy(V), idx)
    want = V[[0, 0, 0, 5, 5, 5]]
    np.testing.assert_array_equal(got.numpy(), want)
    dims = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,))
    xla = jax.lax.gather(jnp.asarray(V), jnp.asarray(idx.numpy())[:, None], dims, (1, 3),
                         mode=jax.lax.GatherScatterMode.CLIP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_index_gives_an_empty_result(dtype):
    V, _ = _inputs(1, 5, 7, seed=5)
    q, s = quantize_factors_torch(torch.from_numpy(V), dtype)
    before = train_kernel.gather_launches.count
    out = train_kernel.fused_gather_rows(q, torch.zeros(0, dtype=torch.int32), s)
    assert out.shape == (0, 7) and out.dtype == torch.float32
    assert train_kernel.gather_launches.count == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    V, idx = _inputs(10, 8, 4, seed=6)
    Vt, it = torch.from_numpy(V), torch.from_numpy(idx)
    q, s = quantize_factors_torch(Vt, "int8")
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_gather_rows(q, it)  # int8 without a scale
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_gather_rows(Vt, it, s)  # a scale with f32
    with pytest.raises(ValueError, match="int32"):
        train_kernel.fused_gather_rows(Vt, it.long())
    with pytest.raises(ValueError, match="int32"):
        train_kernel.fused_gather_rows(Vt, it.reshape(2, 5))
    with pytest.raises(ValueError, match="dtype"):
        train_kernel.fused_gather_rows(Vt.double(), it)
    with pytest.raises(ValueError, match="non-empty"):
        train_kernel.fused_gather_rows(torch.zeros((0, 4)), it)
    with pytest.raises(ValueError, match="exceed"):
        train_kernel.fused_gather_rows(  # n·k of 2,049 × 2^20 > 2^31 - 1
            torch.zeros((1, 2**20)).expand(8, -1), torch.zeros(2049, dtype=torch.int32)
        )
    with pytest.raises(ValueError, match="device"):
        train_kernel.fused_gather_rows(Vt.to("meta"), it.to("meta"))
