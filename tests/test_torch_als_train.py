"""ALS training in the port against the JAX package's dense solver.

The same numpy triples go through both packages:

* the host-side degree bucketing (``_dense_blocks_for``,
  ``_make_dense_blocks``, ``_bucket_boundaries``) must give EQUAL arrays,
  widths and permutations (the JAX side at one shard, whose arrays carry a
  leading shard dimension of 1);
* ``train_als`` from the same initial factors must give factors allclose to
  the JAX package's ``train_als`` (dense solver, ``reference`` backend, a
  one-device mesh). The JAX trainer draws its initial factors with jax's
  threefry generator (``models/als.py:902-918``); the test makes that draw
  and hands it to the port as ``init_factors``;
* the two trained models serve the same top-k (``topk_mismatches``).

Tolerances, factors: f32 rtol = atol = 1e-4; bf16 and int8 1e-3 (the
summation order of A and b differs and the solve amplifies it by the
condition number of A). bf16 implicit 3e-2: the JAX trainer runs under
``jit``, where XLA on the CPU keeps the bf16 product α·r·v in float32
across its fusion into the contraction, while the port (like the TPU kernel
and the JAX reference run eagerly, ``models/als.py:648-652``) rounds it to
bf16 first; A then differs at bf16 precision (ROADMAP §3).
Top-k: ``topk_mismatches`` with tol 1e-4, the factors' own tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from predictionio_tpu.data.batch import Interactions as JaxInteractions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.als import ALSScorer, als_model_from_arrays
from predictionio_tpu_torch.ops import train_kernel
from predictionio_tpu_torch.testing import topk_mismatches

N_USERS, N_ITEMS, N_RATINGS = 70, 45, 1200
CPU = DeviceContext.create(device="cpu")


def _zipf(rng, n, size, s):
    p = (np.arange(1, n + 1) + 5.0) ** -s
    return rng.choice(n, size=size, p=p / p.sum())


@pytest.fixture(scope="module")
def triples():
    rng = np.random.default_rng(0)
    u = _zipf(rng, N_USERS, N_RATINGS, 0.7).astype(np.int32)
    i = _zipf(rng, N_ITEMS, N_RATINGS, 1.1).astype(np.int32)
    r = rng.uniform(1, 5, N_RATINGS).astype(np.float32)
    uids = [f"u{k}" for k in range(N_USERS)]
    iids = [f"i{k}" for k in range(N_ITEMS)]
    jax_inter = JaxInteractions(
        user=u, item=i, rating=r, t=np.zeros(N_RATINGS),
        user_map=JaxBiMap({x: k for k, x in enumerate(uids)}),
        item_map=JaxBiMap({x: k for k, x in enumerate(iids)}),
    )
    port_inter = interactions_from_arrays(u, i, r, np.zeros(N_RATINGS), uids, iids)
    return jax_inter, port_inter


def _jax_config(**kw):
    return jax_als.ALSConfig(solver="dense", train_kernel="reference", **kw)


def test_dense_blocks_equal_jax(triples):
    jax_inter, port_inter = triples
    jub, jib, jup, jip = jax_als._dense_blocks_for(jax_inter, _jax_config(), 1)
    pub, pib, pup, pip = als._dense_blocks_for(port_inter, als.ALSConfig())
    np.testing.assert_array_equal(pup, jup)
    np.testing.assert_array_equal(pip, jip)
    for j, p in ((jub, pub), (jib, pib)):
        assert p.widths == j.widths and len(p.widths) > 2
        assert p.padded_ratings == j.padded_ratings
        for name in ("idx", "rat", "msk"):
            for a, b in zip(getattr(p, name), getattr(j, name)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b[0])


@pytest.mark.parametrize("budget", (64, 200, 4_194_304))
def test_make_dense_blocks_with_chunk_budget_equal_jax(triples, budget):
    """A small chunk budget caps rows per bucket: the cut points match."""
    _, port_inter = triples
    perm = als._degree_sort_permutation(port_inter.user.astype(np.int64), N_USERS)
    np.testing.assert_array_equal(
        perm, jax_als._degree_sort_permutation(port_inter.user.astype(np.int64), N_USERS, 1)
    )
    ent, oth = perm[port_inter.user], port_inter.item.astype(np.int64)
    p = als._make_dense_blocks(ent, oth, port_inter.rating, N_USERS, chunk_budget=budget)
    j = jax_als._make_dense_blocks(ent, oth, port_inter.rating, N_USERS, 1, chunk_budget=budget)
    assert p.widths == j.widths
    for name in ("idx", "rat", "msk"):
        for a, b in zip(getattr(p, name), getattr(j, name)):
            np.testing.assert_array_equal(a, b[0])
    deg = np.bincount(ent, minlength=N_USERS)
    assert als._bucket_boundaries(deg, budget) == jax_als._bucket_boundaries(deg, budget)


def _jax_init(seed, rank):
    """The initial factors ``jax_als.train_als`` draws (original order)."""
    ku, kv = jax.random.split(jax.random.PRNGKey(seed))
    scale = 1.0 / np.sqrt(rank)
    U0 = jax.random.normal(ku, (N_USERS, rank), jnp.float32) * scale
    V0 = jax.random.normal(kv, (N_ITEMS, rank), jnp.float32) * scale
    return np.asarray(U0), np.asarray(V0)


def _tolerance(dtype, implicit):
    if dtype == "bf16" and implicit:
        return 3e-2  # see the module docstring
    return 1e-4 if dtype == "f32" else 1e-3


@pytest.mark.parametrize(
    "implicit,dtype,rank,iterations",
    [(False, "f32", 4, 3), (False, "bf16", 5, 2), (False, "int8", 6, 4),
     (True, "f32", 6, 2), (True, "bf16", 4, 3), (True, "int8", 5, 3)],
)
def test_train_als_matches_jax(triples, implicit, dtype, rank, iterations):
    jax_inter, port_inter = triples
    kw = dict(rank=rank, iterations=iterations, implicit=implicit, alpha=2.0,
              seed=11, reg=0.05, compute_dtype=dtype)
    ctx = MeshContext.create(devices=jax.devices()[:1])
    ref = jax_als.train_als(ctx, jax_inter, _jax_config(**kw))
    got = als.train_als(CPU, port_inter, als.ALSConfig(**kw), init_factors=_jax_init(11, rank))
    tol = _tolerance(dtype, implicit)
    np.testing.assert_allclose(got.user_factors, ref.user_factors, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, rtol=tol, atol=tol)
    assert got.user_map == port_inter.user_map and got.item_map == port_inter.item_map
    assert got.config.compute_dtype == dtype


@pytest.mark.parametrize("implicit", (False, True))
def test_trained_models_serve_the_same_topk(triples, implicit):
    jax_inter, port_inter = triples
    kw = dict(rank=5, iterations=3, implicit=implicit, seed=4)
    ctx = MeshContext.create(devices=jax.devices()[:1])
    ref = jax_als.train_als(ctx, jax_inter, _jax_config(**kw))
    got = als.train_als(CPU, port_inter, als.ALSConfig(**kw), init_factors=_jax_init(4, 5))
    ref_port = als_model_from_arrays(
        ref.user_factors, ref.item_factors,
        [ref.user_map.inverse[k] for k in range(N_USERS)],
        [ref.item_map.inverse[k] for k in range(N_ITEMS)],
    )
    users = np.arange(N_USERS)
    gi, gv = ALSScorer(CPU, got, on_device=False).recommend_batch(users, 10)
    ri, rv = ALSScorer(CPU, ref_port, on_device=False).recommend_batch(users, 10)
    assert not topk_mismatches(gv, gi, rv, ri, tol=1e-4)


def test_default_init_is_seeded_and_launch_count_matches_buckets(triples):
    """Without init_factors the draw comes from cfg.seed: the same seed
    trains the same model, another seed another one. On the CPU the wrapper
    runs the plain version and counts no launch."""
    _, port_inter = triples
    before = train_kernel.launches.count
    a = als.train_als(CPU, port_inter, als.ALSConfig(rank=4, iterations=2, seed=1))
    b = als.train_als(CPU, port_inter, als.ALSConfig(rank=4, iterations=2, seed=1))
    c = als.train_als(CPU, port_inter, als.ALSConfig(rank=4, iterations=2, seed=2))
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    assert not np.allclose(a.user_factors, c.user_factors)
    assert np.isfinite(a.item_factors).all() and a.item_factors.shape == (N_ITEMS, 4)
    assert train_kernel.launches.count == before


def test_config_validation():
    with pytest.raises(ValueError, match="compute_dtype"):
        als.ALSConfig(compute_dtype="fp8")
    # the segment solver is ported: it builds
    assert als.ALSConfig(solver="segment").solver == "segment"
    with pytest.raises(ValueError, match="solver"):
        als.ALSConfig(solver="sparse")
    with pytest.raises(NotImplementedError, match="item 7"):
        als.ALSConfig(checkpoint_dir="/tmp/ckpt")


def test_init_factors_shape_is_checked(triples):
    _, port_inter = triples
    with pytest.raises(ValueError, match="init_factors"):
        als.train_als(
            CPU, port_inter, als.ALSConfig(rank=3, iterations=1),
            init_factors=(np.zeros((N_USERS, 4)), np.zeros((N_ITEMS, 4))),
        )


def test_rank_above_kernel_limit_raises(triples):
    _, port_inter = triples
    with pytest.raises(ValueError, match="1..64"):
        als.train_als(CPU, port_inter, als.ALSConfig(rank=65, iterations=1))
