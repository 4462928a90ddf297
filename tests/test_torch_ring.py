"""Ring attention and Ulysses on the port, held against the JAX package.

Mirrors ``tests/test_ring_attention.py`` and ``tests/test_ulysses.py``: the
port runs on a mesh of eight repeated CPU placements (the JAX tests' eight
host devices) and is held against the JAX ``ring_attention``,
``full_attention`` and ``ulysses_attention`` (XLA) at the JAX tests'
tolerances: rtol = atol = 2e-5 forward, rtol 2e-4 / atol 2e-5 for
gradients. ``ring_flash_attention`` is held against the JAX dense
functions, not against the JAX ``ring_flash_attention`` (Pallas interpret
mode). On the CPU the flash blocks run the kernels' plain versions; the
launch counts on the card are ``tests/test_torch_cuda.py``'s. bf16 runs on
the CPU only: the flash kernels take float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.parallel.mesh import MeshContext as JaxMeshContext
from predictionio_tpu.parallel import ring as jax_ring
from predictionio_tpu.parallel import ulysses as jax_ulysses
from predictionio_tpu_torch.parallel import ring, ulysses
from predictionio_tpu_torch.parallel.mesh import MeshContext, all_gather, all_to_all, ppermute, psum
from predictionio_tpu_torch.testing import warm_cpu_math

warm_cpu_math()  # the first exp/log of a process can be off: testing.warm_cpu_math

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def ctx():
    return MeshContext.create(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_ctx():
    return JaxMeshContext.create(devices=jax.devices()[:8])


def rand_qkv(rng, shape):
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _dense(q, k, v, causal):
    return np.asarray(jax_ring.full_attention(*map(jnp.asarray, (q, k, v)), causal=causal))


def _dense_grads(q, k, v, w, causal=True):
    def loss(a, b, c):
        return (jax_ring.full_attention(a, b, c, causal=causal) * jnp.asarray(w)).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _port_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (fn(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


class TestCollectives:
    def test_the_four_collectives_on_lists(self):
        blocks = [torch.full((2, 4), float(i)) for i in range(4)]
        assert all_gather(blocks, "cpu").shape == (4, 2, 4)
        assert [int(b[0, 0]) for b in ppermute(blocks)] == [3, 0, 1, 2]
        assert [int(b[0, 0]) for b in ppermute(blocks, shift=2)] == [2, 3, 0, 1]
        out = all_to_all(blocks, split_dim=1, concat_dim=0)
        assert out[1].shape == (8, 1) and out[1][:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
        sums = psum(blocks)
        assert len(sums) == 4 and torch.equal(sums[2], torch.full((2, 4), 6.0))
        with pytest.raises(ValueError, match="split"):
            all_to_all(blocks, split_dim=0, concat_dim=1)

    def test_place_cuts_blocks_along_the_spec(self):
        mesh = MeshContext.create(axes={"data": 2, "model": 2}, devices=["cpu"] * 4)
        x = torch.arange(16.0).reshape(4, 4)
        blocks = mesh.place(x, "data", "model")
        assert [b.tolist() for b in blocks][1] == [[2.0, 3.0], [6.0, 7.0]]
        rows = mesh.place(x, "data")
        assert rows[0] is rows[1] and torch.equal(rows[2], x[2:])
        assert len({id(t) for t in mesh.place(x)}) == 1
        with pytest.raises(ValueError, match="split"):
            mesh.place(torch.zeros(3, 4), "data")


class TestRingAttention:
    def test_matches_full_attention(self, ctx, jax_ctx):
        q, k, v = rand_qkv(np.random.default_rng(0), (64, 16))
        out = ring.ring_attention(ctx, q, k, v).numpy()
        np.testing.assert_allclose(out, _dense(q, k, v, False), **FWD)
        np.testing.assert_allclose(out, np.asarray(jax_ring.ring_attention(jax_ctx, q, k, v)), **FWD)

    def test_causal_matches(self, ctx, jax_ctx):
        q, k, v = rand_qkv(np.random.default_rng(1), (32, 8))
        out = ring.ring_attention(ctx, q, k, v, causal=True).numpy()
        np.testing.assert_allclose(out, _dense(q, k, v, True), **FWD)
        np.testing.assert_allclose(
            out, np.asarray(jax_ring.ring_attention(jax_ctx, q, k, v, causal=True)), **FWD)

    def test_batched_heads(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(2), (2, 4, 16, 8))
        out = ring.ring_attention(ctx, q, k, v, causal=True).numpy()
        assert out.shape == (2, 4, 16, 8)
        np.testing.assert_allclose(out, _dense(q, k, v, True), **FWD)

    def test_indivisible_length_rejected(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(3), (30, 8))
        with pytest.raises(ValueError, match="divisible"):
            ring.ring_attention(ctx, q, k, v)

    def test_gradients_flow_through_the_dense_ring(self, ctx):
        rng = np.random.default_rng(10)
        q, k, v = rand_qkv(rng, (2, 32, 8))
        w = rng.normal(size=(2, 32, 8)).astype(np.float32)
        got = _port_grads(lambda a, b, c: ring.ring_attention(ctx, a, b, c, causal=True), q, k, v, w)
        for g, r in zip(got, _dense_grads(q, k, v, w)):
            np.testing.assert_allclose(g, r, **GRAD)

    def test_other_axes_replicate(self):
        """On a (data, model) mesh the ring runs along the named axis."""
        mesh = MeshContext.create(axes={"data": 2, "model": 4}, devices=["cpu"] * 8)
        assert len(ring.axis_devices(mesh, "model")) == 4
        q, k, v = rand_qkv(np.random.default_rng(11), (2, 32, 8))
        out = ring.ring_attention(mesh, q, k, v, axis="model", causal=True).numpy()
        np.testing.assert_allclose(out, _dense(q, k, v, True), **FWD)

    def test_full_attention_matches_jax(self):
        q, k, v = rand_qkv(np.random.default_rng(12), (3, 40, 8))
        for causal in (False, True):
            got = ring.full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
            np.testing.assert_allclose(got, _dense(q, k, v, causal), **FWD)


class TestRingFlashAttention:
    def test_matches_full_attention_both_modes(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(5), (2, 64, 16))
        for causal in (False, True):
            out = ring.ring_flash_attention(ctx, q, k, v, causal=causal).numpy()
            np.testing.assert_allclose(out, _dense(q, k, v, causal), **FWD)

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_gradients_match_dense(self, n):
        mesh = MeshContext.create(devices=["cpu"] * n)
        rng = np.random.default_rng(6)
        q, k, v = rand_qkv(rng, (2, 32, 8))
        w = rng.normal(size=(2, 32, 8)).astype(np.float32)
        got = _port_grads(lambda a, b, c: ring.ring_flash_attention(mesh, a, b, c, causal=True),
                          q, k, v, w)
        for g, r in zip(got, _dense_grads(q, k, v, w)):
            np.testing.assert_allclose(g, r, **GRAD)

    def test_full_mask_gradients_match_dense(self, ctx):
        rng = np.random.default_rng(13)
        q, k, v = rand_qkv(rng, (2, 64, 8))
        w = rng.normal(size=(2, 64, 8)).astype(np.float32)
        got = _port_grads(lambda a, b, c: ring.ring_flash_attention(ctx, a, b, c), q, k, v, w)
        for g, r in zip(got, _dense_grads(q, k, v, w, causal=False)):
            np.testing.assert_allclose(g, r, **GRAD)

    def test_bf16_gradients_accumulate_in_f32(self, ctx):
        """bf16 on the CPU only (the flash kernels take float32): the ring's
        f32 carries keep the gradients within bf16 resolution of the f32
        reference, returned in bf16."""
        rng = np.random.default_rng(9)
        q, k, v = rand_qkv(rng, (2, 64, 8))
        qt, kt, vt = (torch.tensor(x, dtype=torch.bfloat16, requires_grad=True) for x in (q, k, v))
        ring.ring_flash_attention(ctx, qt, kt, vt, causal=True).sum().backward()
        want = _dense_grads(q, k, v, np.ones((2, 64, 8), np.float32))
        for g, r in zip((qt.grad, kt.grad, vt.grad), want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(), r, rtol=0.1, atol=0.05)

    def test_matches_dense_ring(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(7), (4, 32, 8))
        a = ring.ring_attention(ctx, q, k, v, causal=True).numpy()
        b = ring.ring_flash_attention(ctx, q, k, v, causal=True).numpy()
        np.testing.assert_allclose(a, b, **FWD)

    def test_forward_lse_is_the_whole_sequence_lse(self):
        """The merged (o, lse) of the ring's blocks is the whole-sequence
        (o, lse) of the flash kernel's plain version."""
        from predictionio_tpu_torch.ops.flash_attention import flash_attention_reference

        mesh = MeshContext.create(devices=["cpu"] * 4)
        q, k, v = (torch.from_numpy(x) for x in rand_qkv(np.random.default_rng(14), (3, 64, 16)))
        devs = ring.axis_devices(mesh, "data")
        o, lse = ring._ring_flash_fwd_impl(*(ring._blocks(x, devs) for x in (q, k, v)), True,
                                           0.25, devs)
        want_o, want_lse = flash_attention_reference(q, k, v, True, 0.25)
        np.testing.assert_allclose(torch.cat(o, -2).numpy(), want_o.numpy(), **FWD)
        np.testing.assert_allclose(torch.cat(lse, -1).numpy(), want_lse.numpy(), **FWD)

    def test_indivisible_flash_blocks_rejected(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(8), (24, 8))
        with pytest.raises(ValueError, match="divide|divisible"):
            ring.ring_flash_attention(ctx, q, k, v, block_q=2)
        with pytest.raises(ValueError, match="divisible"):
            ring.ring_flash_attention(ctx, *rand_qkv(np.random.default_rng(8), (30, 8)))


class TestUlyssesAttention:
    def test_matches_full_attention_both_modes(self, ctx, jax_ctx):
        q, k, v = rand_qkv(np.random.default_rng(0), (8, 64, 16))
        for causal in (False, True):
            out = ulysses.ulysses_attention(ctx, q, k, v, causal=causal).numpy()
            np.testing.assert_allclose(out, _dense(q, k, v, causal), **FWD)
            jout = np.asarray(jax_ulysses.ulysses_attention(jax_ctx, q, k, v, causal=causal))
            np.testing.assert_allclose(out, jout, **FWD)

    def test_batched_multi_head(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(1), (3, 16, 32, 8))
        out = ulysses.ulysses_attention(ctx, q, k, v, causal=True).numpy()
        np.testing.assert_allclose(out, _dense(q, k, v, True), **FWD)

    def test_matches_ring(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(2), (8, 32, 8))
        a = ulysses.ulysses_attention(ctx, q, k, v, causal=True).numpy()
        b = ring.ring_attention(ctx, q, k, v, causal=True).numpy()
        np.testing.assert_allclose(a, b, **FWD)

    @pytest.mark.parametrize("use_flash", [False, True])
    def test_gradients_match_dense(self, ctx, use_flash):
        rng = np.random.default_rng(3)
        q, k, v = rand_qkv(rng, (8, 128, 8))
        w = rng.normal(size=(8, 128, 8)).astype(np.float32)
        got = _port_grads(lambda a, b, c: ulysses.ulysses_attention(
            ctx, a, b, c, causal=True, use_flash=use_flash), q, k, v, w)
        for g, r in zip(got, _dense_grads(q, k, v, w)):
            np.testing.assert_allclose(g, r, **GRAD)

    def test_flash_local_path_matches(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(4), (8, 64, 8))
        dense = ulysses.ulysses_attention(ctx, q, k, v, causal=True, use_flash=False).numpy()
        flash = ulysses.ulysses_attention(ctx, q, k, v, causal=True, use_flash=True).numpy()
        np.testing.assert_allclose(dense, flash, **FWD)

    def test_head_divisibility_required(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(5), (6, 32, 8))
        with pytest.raises(ValueError, match="heads"):
            ulysses.ulysses_attention(ctx, q, k, v)

    def test_needs_head_dim(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(6), (32, 8))
        with pytest.raises(ValueError, match="H, T, D"):
            ulysses.ulysses_attention(ctx, q, k, v)

    def test_sequence_divisibility_required(self, ctx):
        q, k, v = rand_qkv(np.random.default_rng(7), (8, 30, 8))
        with pytest.raises(ValueError, match="divisible"):
            ulysses.ulysses_attention(ctx, q, k, v)
