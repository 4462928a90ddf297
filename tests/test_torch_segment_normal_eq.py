"""The segment solver's normal equations: the layout, the kernel's order and
the plain version, on the CPU.

``csrc/segment_normal_eq.cu`` sums one half-step's A, b and cnt over the
stream sorted by entity (``ops/train_kernel.segment_layout``, built by
``models/als._segment_layout``): per entity, each run of slots of one chunk
summed in stream order from zero, the run sums folded into the carry in
chunk order. This file holds, with chunks of 256 forced in both packages
(1,200 ratings in five chunks):

* (a) the layout keeps stream order inside every (entity, chunk) run,
  covers every real slot once, drops the padding, splits the entities into
  heavy (a block each) and light (a warp each, most slots first), and
  raises past its limits;
* (b) a numpy float32 emulation of the kernel's order on the layout equals
  the plain version (the JAX package's chunk loop on the stream in its own
  order, ``index_add_`` into zeros) bit for bit, f32/bf16/int8 × explicit/
  implicit, on a stream with an entity spanning every chunk, an entity with
  no slot and padding at the end. Every product and sum is one float32
  rounding in both, and a chunk without a slot of the entity, or a padding
  slot, adds only ±0, which changes no sum that started from +0; so no
  tolerance applies. The card-only tests in ``tests/test_torch_cuda.py``
  hold the kernel against the same plain version bit for bit;
* (c) the port's segment half-step (the wrapper on CPU tensors, so the
  plain version, then the solve) against the JAX package's
  ``_half_step_local(backend="reference")`` from the same opposite factors,
  at rtol = atol = 1e-4, the rule of ``tests/test_torch_als_segment.py``
  (the two packages' Cholesky solves round differently in the last bits);
* the wrapper on CPU tensors counts no launch and refuses what neither
  version takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.models import als as jax_als
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.ops.quantize import quantize_factors_torch

DTYPES = ("f32", "bf16", "int8")
TOL = 1e-4
N_ENTITY, N_OPP, N_SLOTS, RANK = 40, 30, 1200, 6
HOT, EMPTY = 3, N_ENTITY - 1  # an entity in every chunk, and one with no slot


@pytest.fixture()
def small_chunk(monkeypatch):
    """A 256-rating chunk in both packages: 1,200 ratings pad to 1,280 and
    run in five chunks."""
    monkeypatch.setattr(als, "_CHUNK", 256)
    monkeypatch.setattr(jax_als, "_CHUNK", 256)


def _stream(seed=0):
    """(entity, other, rating): a third of the slots on HOT, none on EMPTY."""
    rng = np.random.default_rng(seed)
    entity = rng.integers(0, EMPTY, N_SLOTS)
    entity[rng.random(N_SLOTS) < 0.35] = HOT
    other = rng.integers(0, N_OPP, N_SLOTS)
    rating = rng.uniform(1.0, 5.0, N_SLOTS).astype(np.float32)
    return entity, other, rating


def _blocks(seed=0):
    entity, other, rating = _stream(seed)
    return als._make_blocks(entity, other, rating, N_ENTITY)


def _factors(seed, dtype):
    rng = np.random.default_rng(seed)
    V = torch.from_numpy(rng.standard_normal((N_OPP, RANK)).astype(np.float32))
    return quantize_factors_torch(V, dtype)


def _dequantized(q, scale):
    """The rows the kernel reads, widened to float32 (int8 times its scale)."""
    v = q.float().numpy()
    return v if scale is None else v * scale.numpy()


# -- (a) the layout ------------------------------------------------------------


def test_layout_keeps_stream_order_in_every_run(small_chunk):
    blk = _blocks()
    assert blk.length == 1280 and not blk.mask[N_SLOTS:].any()  # padding at the end
    lay = als._segment_layout(blk, "cpu")
    chunk = 256
    assert lay.chunk == chunk and lay.n_entity == N_ENTITY
    run_off, ent_runs = lay.run_offsets.numpy(), lay.entity_runs.numpy()
    for t in (lay.other, lay.run_offsets, lay.entity_runs, lay.heavy, lay.light):
        assert t.dtype == torch.int32
    assert lay.rating.dtype == torch.float32
    assert run_off[0] == 0 and run_off[-1] == N_SLOTS == lay.other.shape[0]
    assert ent_runs[0] == 0 and ent_runs[-1] == len(run_off) - 1
    assert (np.diff(run_off) > 0).all() and (np.diff(ent_runs) >= 0).all()
    real = np.flatnonzero(blk.mask)
    for e in range(N_ENTITY):
        # e's real slots in stream order, and the chunk of each
        mine = real[blk.local[real] == e]
        s0, s1 = run_off[ent_runs[e]], run_off[ent_runs[e + 1]]
        np.testing.assert_array_equal(lay.other.numpy()[s0:s1], blk.other[mine])
        np.testing.assert_array_equal(lay.rating.numpy()[s0:s1], blk.rating[mine])
        # one run for each chunk that holds a slot of e, in chunk order
        chunks, sizes = np.unique(mine // chunk, return_counts=True)
        runs = run_off[ent_runs[e]: ent_runs[e + 1] + 1]
        np.testing.assert_array_equal(np.diff(runs), sizes)
        assert len(runs) - 1 == len(chunks)
    assert ent_runs[EMPTY + 1] == ent_runs[EMPTY]
    assert ent_runs[HOT + 1] - ent_runs[HOT] == 5  # every chunk


def test_layout_splits_heavy_and_light_entities(small_chunk, monkeypatch):
    monkeypatch.setattr(train_kernel, "HEAVY_SLOTS", 60)
    blk = _blocks()
    lay = als._segment_layout(blk, "cpu")
    slots = np.bincount(blk.local[blk.mask > 0], minlength=N_ENTITY)
    heavy, light = lay.heavy.numpy(), lay.light.numpy()
    np.testing.assert_array_equal(np.sort(np.concatenate([heavy, light])), np.arange(N_ENTITY))
    assert HOT in heavy and (slots[heavy] >= 60).all() and (np.diff(heavy) > 0).all()
    assert (slots[light] < 60).all() and (np.diff(slots[light]) <= 0).all()
    # one chunk: no entity has two runs, so none is heavy however many slots
    monkeypatch.setattr(als, "_CHUNK", 65536)
    lay = als._segment_layout(als._make_blocks(*_stream(), N_ENTITY), "cpu")
    assert lay.heavy.numel() == 0 and lay.light.numel() == N_ENTITY


def test_layout_raises_past_its_limits(monkeypatch):
    blk = _blocks()
    stream = [torch.from_numpy(a) for a in (blk.local, blk.other, blk.rating, blk.mask)]
    monkeypatch.setattr(train_kernel, "MAX_SLOTS", blk.length - 1)
    with pytest.raises(ValueError, match=f"{blk.length} slots exceed .*{blk.length - 1}"):
        als._segment_layout(blk, "cpu")
    monkeypatch.setattr(train_kernel, "MAX_SLOTS", blk.length)
    train_kernel.segment_layout(*stream, N_ENTITY, chunk=256)
    half = stream[:3] + [stream[3] * 0.5]
    with pytest.raises(ValueError, match="0/1 mask"):
        train_kernel.segment_layout(*half, N_ENTITY, chunk=256)
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        train_kernel.segment_layout(*stream, 10, chunk=256)


# -- (b) the kernel's order, emulated, against the plain version ---------------


def _emulate(lay, V, implicit, alpha):
    """The kernel's order in numpy float32 on the layout: per entity and run,
    S = ((0 + o_1) + o_2) + ... in slot order, then A = A + S, run by run."""
    other, rating = lay.other.numpy(), lay.rating.numpy()
    run_off, ent_runs = lay.run_offsets.numpy(), lay.entity_runs.numpy()
    n, k = lay.n_entity, V.shape[1]
    a, one = np.float32(alpha), np.float32(1.0)
    A = np.zeros((n, k, k), np.float32)
    b = np.zeros((n, k), np.float32)
    cnt = np.zeros(n, np.float32)
    for e in range(n):
        for r in range(ent_runs[e], ent_runs[e + 1]):
            SA, Sb, Sc = np.zeros((k, k), np.float32), np.zeros(k, np.float32), np.float32(0)
            for s in range(run_off[r], run_off[r + 1]):
                v, rt = V[other[s]], rating[s]
                if implicit:
                    cw = a * rt
                    SA = SA + v[:, None] * (v * cw)[None, :]
                    Sb = Sb + v * (one + cw)
                else:
                    SA = SA + v[:, None] * v[None, :]
                    Sb = Sb + v * rt
                    Sc = Sc + one
            A[e], b[e], cnt[e] = A[e] + SA, b[e] + Sb, cnt[e] + Sc
    return A, b, cnt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_kernel_order_equals_plain_version_bitwise(small_chunk, dtype, implicit):
    blk = _blocks(seed=1)
    lay = als._segment_layout(blk, "cpu")
    q, scale = _factors(2, dtype)
    before = train_kernel.segment_launches.count
    A, b, cnt = train_kernel.fused_segment_normal_eq(lay, q, scale, implicit=implicit, alpha=2.0)
    assert train_kernel.segment_launches.count == before  # CPU: the plain version
    assert A.shape == (N_ENTITY, RANK, RANK) and b.shape == (N_ENTITY, RANK)
    assert cnt.shape == (N_ENTITY,) and A.dtype == b.dtype == cnt.dtype == torch.float32
    eA, eb, ecnt = _emulate(lay, _dequantized(q, scale), implicit, 2.0)
    np.testing.assert_array_equal(A.numpy(), eA)
    np.testing.assert_array_equal(b.numpy(), eb)
    np.testing.assert_array_equal(cnt.numpy(), ecnt)
    assert not A[EMPTY].any() and not b[EMPTY].any() and cnt[EMPTY] == 0
    if not implicit:
        np.testing.assert_array_equal(cnt.numpy(), np.bincount(blk.local[:N_SLOTS], minlength=N_ENTITY))


def test_plain_version_is_the_chunk_loop_over_the_stream(small_chunk):
    """The wrapper on CPU tensors runs ``segment_normal_eq_reference`` on the
    stream the layout kept, with the layout's chunk."""
    blk = _blocks(seed=3)
    lay = als._segment_layout(blk, "cpu")
    q, _ = _factors(4, "f32")
    got = train_kernel.fused_segment_normal_eq(lay, q)
    want = train_kernel.segment_normal_eq_reference(
        *(torch.from_numpy(a) for a in (blk.local, blk.other, blk.rating, blk.mask)),
        N_ENTITY, q, chunk=256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- (c) the plain version against the JAX package's half-step -----------------


def _jax_half_step(entity, other, rating, opp, cfg):
    """The JAX package's segment half-step (reference backend) from ``opp``."""
    blk = jax_als._make_blocks(entity, other, rating, N_ENTITY, 1)
    gram = opp.T @ opp if cfg.implicit else jnp.zeros((cfg.rank, cfg.rank), jnp.float32)
    step = jax.jit(lambda *a: jax_als._half_step_local(
        *a, per_shard=blk.per_shard, rank=cfg.rank, reg=cfg.reg, implicit=cfg.implicit,
        alpha=cfg.alpha, compute_dtype=cfg.compute_dtype, backend="reference"))
    return np.asarray(step(*(jnp.asarray(a) for a in (
        blk.local, blk.other, blk.rating, blk.mask)), jnp.asarray(opp), gram))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_half_step_matches_jax_half_step(small_chunk, dtype, implicit):
    entity, other, rating = _stream(seed=5)
    opp = (np.random.default_rng(6).standard_normal((N_OPP, RANK)) / np.sqrt(RANK)).astype(np.float32)
    cfg = als.ALSConfig(rank=RANK, implicit=implicit, alpha=2.0, reg=0.05, compute_dtype=dtype,
                        solver="segment")
    lay = als._segment_layout(als._make_blocks(entity, other, rating, N_ENTITY), "cpu")
    o = torch.from_numpy(opp)
    got = als._half_step(lay, o, als._gram(o) if implicit else None, cfg).numpy()
    want = _jax_half_step(entity, other, rating, opp, cfg)
    print(f"max_abs_gap={float(np.abs(got - want).max()):.3e}")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- the wrapper's refusals --------------------------------------------------


def test_wrapper_refuses_what_it_does_not_take():
    lay = als._segment_layout(_blocks(), "cpu")
    V = torch.zeros((N_OPP, RANK))
    with pytest.raises(ValueError, match="non-empty"):
        train_kernel.fused_segment_normal_eq(lay, V[:, :0])
    with pytest.raises(ValueError, match="dtype"):
        train_kernel.fused_segment_normal_eq(lay, V.double())
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_segment_normal_eq(lay, V.to(torch.int8))
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_segment_normal_eq(lay, V, torch.ones((N_OPP, 1)))
    with pytest.raises(ValueError, match=f"1..{train_kernel.MAX_SEGMENT_RANK}"):
        train_kernel.fused_segment_normal_eq(
            lay, torch.zeros((2, train_kernel.MAX_SEGMENT_RANK + 1)))
    lay.stream = None  # as a layout built on a card holds it
    with pytest.raises(ValueError, match="another device"):
        train_kernel.fused_segment_normal_eq(lay, V)
