"""The segment solver in the port against the JAX package's, on the CPU.

The same numpy triples (the fixture of ``tests/test_torch_als_train.py``)
go through both packages:

* ``segment_sum`` / ``segment_count`` (``index_add_`` into zeros) equal
  ``jax.ops.segment_sum`` bit for bit: on the CPU both add the rows in
  order;
* ``_make_blocks`` equals the JAX package's ``_make_blocks(…, n_shards=1)``
  array for array, ``length`` and its padding included, at the default
  chunk and at a chunk forced to 256 in both modules (the stream then
  pads to a multiple of 256 and runs in several chunks);
* ``train_als(solver="segment")`` from the JAX trainer's initial factors
  against JAX ``train_als(solver="segment", train_kernel="reference")`` (a
  one-device mesh) at rtol = atol = 1e-4, explicit and implicit, 1 and 3
  iterations, in one chunk and in chunks of 256. Every operation after the
  gather is float32 in both packages and the chunk sums are the same sums
  in the same order, so the factors part only where the two packages'
  batched Cholesky solves round differently (torch's LAPACK against
  jaxlib's). f32 is held free-running; largest gap 8.9e-6 (explicit, rank
  4, 3 iterations, one chunk). bf16 and int8 quantize the opposite factors
  at every half-step, which can turn such a last-bit difference into a
  whole bf16 or int8 step: free-running they part by up to 1.6e-2 (bf16
  explicit, 3 iterations, chunks of 256; ROADMAP §3). They are held half-step
  by half-step instead, each JAX half-step fed the port's previous factors,
  at the same 1e-4; largest gap 8.2e-6 (int8 explicit, chunks of 256).
  Each case prints its gaps (``pytest -rP`` shows them);
* the two trained models serve the same top-k (``topk_mismatches``, tol
  1e-4, the factors' own tolerance);
* the port's segment and dense solvers agree at the JAX package's own
  prediction tolerance for the pair (rtol 5e-2, atol 5e-3,
  ``tests/test_als.py:339-353``): the same normal equations summed in
  another order;
* rank 65 trains on the segment path (the gather takes any rank) while the
  dense path still refuses ranks past the training kernel's 64;
* on the CPU neither kernel counts a launch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.models import als as jax_als
from predictionio_tpu.ops import segment as jax_segment
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.als import ALSScorer, als_model_from_arrays
from predictionio_tpu_torch.ops import segment, train_kernel
from predictionio_tpu_torch.testing import topk_mismatches

from test_torch_als_train import CPU, N_ITEMS, N_USERS, _jax_init, triples  # noqa: F401

TOL = 1e-4


def _jax_config(**kw):
    return jax_als.ALSConfig(solver="segment", train_kernel="reference", **kw)


def _mesh():
    return MeshContext.create(devices=jax.devices()[:1])


@pytest.fixture()
def small_chunk(monkeypatch):
    """A 256-rating chunk in both packages: 1,200 ratings pad to 1,280 and
    run in five chunks."""
    monkeypatch.setattr(als, "_CHUNK", 256)
    monkeypatch.setattr(jax_als, "_CHUNK", 256)


@pytest.mark.parametrize("shape", [(5000, 10, 10), (5000,), (700, 3)])
def test_segment_sum_equals_jax_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, 300, shape[0]).astype(np.int32)
    got = segment.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 300)
    want = jax.jit(jax_segment.segment_sum, static_argnums=2)(
        jnp.asarray(data), jnp.asarray(ids), 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got.shape == (300, *shape[1:])


def test_segment_count_equals_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 50, 999).astype(np.int32)
    w = rng.uniform(size=999).astype(np.float32)
    for weights in (None, w):
        got = segment.segment_count(
            torch.from_numpy(ids), 50, None if weights is None else torch.from_numpy(weights))
        want = jax_segment.segment_count(
            jnp.asarray(ids), 50, None if weights is None else jnp.asarray(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_blocks_equal(port_inter):
    user = port_inter.user.astype(np.int64)
    item = port_inter.item.astype(np.int64)
    rating = port_inter.rating.astype(np.float32)
    for ent, oth, n in ((user, item, N_USERS), (item, user, N_ITEMS)):
        p = als._make_blocks(ent, oth, rating, n)
        j = jax_als._make_blocks(ent, oth, rating, n, 1)
        assert (p.length, p.n_entity) == (j.length, j.per_shard)
        for name in ("local", "other", "rating", "mask"):
            a, b = getattr(p, name), getattr(j, name)
            assert a.dtype == b.dtype and a.shape == b.shape == (p.length,)
            np.testing.assert_array_equal(a, b)
        assert p.mask.sum() == len(ent) and not p.mask[len(ent):].any()
    return p


def test_make_blocks_equal_jax_one_chunk(triples):
    p = _assert_blocks_equal(triples[1])
    assert p.length == 1200  # a multiple of 8 already: one chunk, no padding


def test_make_blocks_equal_jax_small_chunk(triples, small_chunk):
    p = _assert_blocks_equal(triples[1])
    assert p.length == 1280 and p.length % 256 == 0


def _train_both(triples, **kw):
    jax_inter, port_inter = triples
    ref = jax_als.train_als(_mesh(), jax_inter, _jax_config(**kw))
    got = als.train_als(CPU, port_inter, als.ALSConfig(solver="segment", **kw),
                        init_factors=_jax_init(kw["seed"], kw["rank"]))
    return got, ref


CHUNKING = pytest.mark.parametrize(
    "chunked", (False, True), ids=("one-chunk", "chunks-of-256"))


def _gap(a, b):
    """Largest |Δ| between two models' factors."""
    return float(max(np.abs(a.user_factors - b.user_factors).max(),
                     np.abs(a.item_factors - b.item_factors).max()))


def _no_launches_on_cpu(fn):
    """Run ``fn``; on the CPU neither kernel may count a launch."""
    before = train_kernel.launches.count, train_kernel.gather_launches.count
    out = fn()
    assert (train_kernel.launches.count, train_kernel.gather_launches.count) == before
    return out


@CHUNKING
@pytest.mark.parametrize("implicit,rank,iterations",
                         [(False, 4, 3), (False, 5, 1), (True, 6, 1), (True, 5, 3)])
def test_segment_train_als_matches_jax(triples, request, chunked, implicit,
                                       rank, iterations):
    """f32, free-running from the JAX trainer's initial factors."""
    if chunked:
        request.getfixturevalue("small_chunk")
    got, ref = _no_launches_on_cpu(lambda: _train_both(
        triples, rank=rank, iterations=iterations, implicit=implicit, alpha=2.0, seed=11,
        reg=0.05))
    print(f"max_abs_gap={_gap(got, ref):.3e}")
    np.testing.assert_allclose(got.user_factors, ref.user_factors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, rtol=TOL, atol=TOL)
    assert got.config.solver == "segment" and got.config.compute_dtype == "f32"
    _, port_inter = triples
    assert got.user_map == port_inter.user_map and got.item_map == port_inter.item_map


def _jax_half_step(blocks, opp, cfg):
    """The JAX package's segment half-step (reference backend) from ``opp``."""
    gram = opp.T @ opp if cfg.implicit else jnp.zeros((cfg.rank, cfg.rank), jnp.float32)
    step = jax.jit(lambda *a: jax_als._half_step_local(
        *a, per_shard=blocks.per_shard, rank=cfg.rank, reg=cfg.reg, implicit=cfg.implicit,
        alpha=cfg.alpha, compute_dtype=cfg.compute_dtype, backend="reference"))
    return np.asarray(step(*(jnp.asarray(a) for a in (
        blocks.local, blocks.other, blocks.rating, blocks.mask)), jnp.asarray(opp), gram))


@CHUNKING
@pytest.mark.parametrize("dtype", ("bf16", "int8"))
@pytest.mark.parametrize("implicit,rank,iterations", [(False, 5, 3), (True, 6, 1)])
def test_segment_quantized_training_matches_jax_half_step_by_half_step(
        triples, request, chunked, dtype, implicit, rank, iterations):
    """bf16 and int8 quantize the opposite factors at every half-step, so
    one last-bit difference of a solve can become a whole bf16 or int8 step
    at the next (ROADMAP §3). Each half-step of the port's ``train_als`` is
    held at 1e-4 against the JAX half-step fed the port's previous factors:
    one iteration at a time, each from the last one's factors, which gives
    the free run's factors exactly (checked). The first iteration starts
    from the JAX trainer's initial factors, and its user half-step equals
    JAX ``train_als``'s at 1e-4 too. The free run's gap to JAX's free run
    is printed (``free_run_gap``), not held."""
    if chunked:
        request.getfixturevalue("small_chunk")
    jax_inter, port_inter = triples
    kw = dict(rank=rank, implicit=implicit, alpha=2.0, seed=11, reg=0.05, compute_dtype=dtype)
    jcfg = _jax_config(iterations=1, **kw)
    user, item = (a.astype(np.int64) for a in (port_inter.user, port_inter.item))
    ub = jax_als._make_blocks(user, item, port_inter.rating, N_USERS, 1)
    ib = jax_als._make_blocks(item, user, port_inter.rating, N_ITEMS, 1)
    factors = _jax_init(11, rank)
    gap = 0.0
    for it in range(iterations):
        m = _no_launches_on_cpu(lambda: als.train_als(
            CPU, port_inter, als.ALSConfig(solver="segment", iterations=1, **kw),
            init_factors=factors))
        U_ref = _jax_half_step(ub, factors[1], jcfg)
        V_ref = _jax_half_step(ib, m.user_factors, jcfg)
        gap = max(gap, float(np.abs(m.user_factors - U_ref).max()),
                  float(np.abs(m.item_factors - V_ref).max()))
        np.testing.assert_allclose(m.user_factors, U_ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(m.item_factors, V_ref, rtol=TOL, atol=TOL)
        if it == 0:
            first = jax_als.train_als(_mesh(), jax_inter, jcfg)
            np.testing.assert_allclose(m.user_factors, first.user_factors, rtol=TOL, atol=TOL)
        factors = (m.user_factors, m.item_factors)
    free = als.train_als(CPU, port_inter, als.ALSConfig(
        solver="segment", iterations=iterations, **kw), init_factors=_jax_init(11, rank))
    np.testing.assert_array_equal(free.user_factors, factors[0])
    np.testing.assert_array_equal(free.item_factors, factors[1])
    assert free.config.compute_dtype == dtype
    jax_free = jax_als.train_als(_mesh(), jax_inter, _jax_config(iterations=iterations, **kw))
    print(f"max_abs_gap={gap:.3e} free_run_gap={_gap(free, jax_free):.3e}")


@pytest.mark.parametrize("implicit", (False, True))
def test_segment_models_serve_the_same_topk(triples, implicit):
    got, ref = _train_both(triples, rank=5, iterations=3, implicit=implicit, seed=4)
    ref_port = als_model_from_arrays(
        ref.user_factors, ref.item_factors,
        [ref.user_map.inverse[k] for k in range(N_USERS)],
        [ref.item_map.inverse[k] for k in range(N_ITEMS)],
    )
    users = np.arange(N_USERS)
    gi, gv = ALSScorer(CPU, got, on_device=False).recommend_batch(users, 10)
    ri, rv = ALSScorer(CPU, ref_port, on_device=False).recommend_batch(users, 10)
    assert not topk_mismatches(gv, gi, rv, ri, tol=TOL)


@pytest.mark.parametrize("implicit", (False, True))
def test_segment_and_dense_agree_on_predictions(triples, implicit):
    """One seed starts both solvers from the same factors (entity e from
    row e of the draw), so without ``init_factors`` they train alike."""
    _, port_inter = triples
    kw = dict(rank=4, iterations=3, seed=7, implicit=implicit)
    ms = als.train_als(CPU, port_inter, als.ALSConfig(solver="segment", **kw))
    md = als.train_als(CPU, port_inter, als.ALSConfig(solver="dense", **kw))
    np.testing.assert_allclose(
        ms.user_factors @ ms.item_factors.T, md.user_factors @ md.item_factors.T,
        rtol=5e-2, atol=5e-3,
    )


def test_segment_trains_past_the_dense_rank_limit(triples):
    _, port_inter = triples
    m = als.train_als(CPU, port_inter, als.ALSConfig(solver="segment", rank=65, iterations=1))
    assert m.user_factors.shape == (N_USERS, 65) and np.isfinite(m.user_factors).all()
    assert np.isfinite(m.item_factors).all()
    with pytest.raises(ValueError, match="1..64"):
        als.train_als(CPU, port_inter, als.ALSConfig(solver="dense", rank=65, iterations=1))
