"""Mid-training checkpoints in the port against the JAX package.

* ``dataset_digest`` equals the JAX package's, value for value;
  ``save_due``/``validate_interval`` answer the same;
* the sealed numpy-dict state store round-trips dicts, lists, numpy and
  torch leaves exactly, and a torn file is a ``ModelIntegrityError``;
* ``CheckpointManager``: ``step_<n>`` layout, the fingerprint sidecar, keep=2;
  ``resume_from`` takes the largest matching step ≤ max, skips a foreign, a
  torn and a too-high step;
* ALS resume (dense and segment): 10 iterations with checkpoint_interval 5,
  then 20 from the same directory, equal BIT FOR BIT to an uninterrupted
  20-iteration run, and only 2 × 10 half-steps run after the resume; the
  fingerprint sidecar equals the one the JAX package writes for the same
  data; from the JAX package's initial factors the resumed factors are
  within rtol = atol = 1e-4 of the JAX package's own resumed run (f32, the
  tolerance of ``tests/test_torch_als_train.py`` and of the JAX package's
  ``tests/test_checkpoint.py:72-74``); a permuted dataset starts fresh;
* SASRec resume: 4 epochs (interval 2), then 6 from the directory; each of
  the 2 resumed steps' losses within rtol 1e-5 of the uninterrupted run's
  and the params within rtol = atol = 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.core import checkpoint as jax_ckpt
from predictionio_tpu.data.batch import Interactions as JaxInteractions
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu_torch.core import checkpoint as ckpt
from predictionio_tpu_torch.core.persistence import ModelIntegrityError
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als, sequential

CPU = DeviceContext.create(device="cpu")
N_USERS, N_ITEMS, N_RATINGS = 60, 40, 900


@pytest.fixture(scope="module")
def triples():
    rng = np.random.default_rng(3)
    u = rng.integers(0, N_USERS, N_RATINGS).astype(np.int32)
    i = (rng.zipf(1.3, N_RATINGS) % N_ITEMS).astype(np.int32)
    r = rng.uniform(1, 5, N_RATINGS).astype(np.float32)
    return u, i, r


def _port(u, i, r):
    return interactions_from_arrays(
        u, i, r, np.zeros(len(u)), [f"u{k}" for k in range(N_USERS)],
        [f"i{k}" for k in range(N_ITEMS)])


def _jax(u, i, r):
    return JaxInteractions(
        user=u, item=i, rating=r, t=np.zeros(len(u)),
        user_map=JaxBiMap({f"u{k}": k for k in range(N_USERS)}),
        item_map=JaxBiMap({f"i{k}": k for k in range(N_ITEMS)}))


@pytest.mark.parametrize("arrays", [
    lambda rng: (rng.integers(0, 9, 100).astype(np.int64),),
    lambda rng: (rng.integers(0, 9, 100).astype(np.int64), rng.random(100).astype(np.float32)),
    lambda rng: (rng.integers(0, 5, (7, 33)).astype(np.int32),),
    lambda rng: (np.zeros(0, np.int64),),
])
def test_dataset_digest_equals_jax(arrays):
    a = arrays(np.random.default_rng(0))
    assert ckpt.dataset_digest(*a) == jax_ckpt.dataset_digest(*a)
    if a[0].size > 1:
        assert ckpt.dataset_digest(a[0][::-1].copy(), *a[1:]) != ckpt.dataset_digest(*a)


@pytest.mark.parametrize("step,interval,total", [(5, 5, 20), (6, 5, 20), (20, 7, 20), (1, 1, 3)])
def test_save_due_equals_jax(step, interval, total):
    assert ckpt.save_due(step, interval, total) == jax_ckpt.save_due(step, interval, total)


def test_validate_interval():
    ckpt.validate_interval(1)
    with pytest.raises(ValueError, match=">= 1"):
        ckpt.validate_interval(0)


def test_state_round_trip_and_torn_file(tmp_path):
    tree = {"U": torch.arange(6, dtype=torch.float32).reshape(3, 2),
            "layers": [{"w": np.eye(2, dtype=np.float32)}, {"w": np.ones(3, np.int8)}],
            "none": None, "fingerprint": np.array([1.5, 2.0])}
    path = str(tmp_path / "state.blob")
    ckpt.save_state(path, tree)
    got = ckpt.restore_state(path)
    np.testing.assert_array_equal(got["U"], tree["U"].numpy())
    assert got["layers"][1]["w"].dtype == np.int8 and got["none"] is None
    np.testing.assert_array_equal(got["layers"][0]["w"], np.eye(2))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-7])
    with pytest.raises(ModelIntegrityError):
        ckpt.restore_state(path)


def test_manager_layout_retention_and_resume_policy(tmp_path, caplog):
    m = ckpt.CheckpointManager(str(tmp_path))
    fp = np.array([1.0, 2.0])
    for step in (2, 4, 6):
        m.save(step, {"x": np.full(3, step), "fingerprint": fp})
    assert m.steps() == [4, 6] and m.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_4.fp.npy", "step_6", "step_6.fp.npy"]
    assert set(os.listdir(tmp_path / "step_6")) == {ckpt.STATE_FILE}
    np.testing.assert_array_equal(m.saved_fingerprint(6), fp)
    assert ckpt.resume_from(m, fp, 10)[0] == 6
    assert ckpt.resume_from(m, fp, 5)[0] == 4  # a too-high step does not disable resume
    assert ckpt.resume_from(m, np.array([1.0, 3.0]), 10) == (0, None)  # foreign
    blob = tmp_path / "step_6" / ckpt.STATE_FILE
    blob.write_bytes(blob.read_bytes()[:-3])  # torn: skipped, the older step resumes
    step, state = ckpt.resume_from(m, fp, 10)
    assert step == 4 and int(state["x"][0]) == 4
    assert "unreadable" in caplog.text


def _count_half_steps(monkeypatch):
    calls = []
    for name in ("_dense_half_step", "_half_step"):
        fn = getattr(als, name)

        def counted(*a, _fn=fn, **kw):
            calls.append(1)
            return _fn(*a, **kw)

        monkeypatch.setattr(als, name, counted)
    return calls


@pytest.mark.parametrize("solver", ["dense", "segment"])
def test_als_resume_equals_uninterrupted_run(tmp_path, monkeypatch, triples, solver):
    inter = _port(*triples)
    kw = dict(rank=4, reg=0.05, seed=7, solver=solver, compute_dtype="f32")
    full = als.train_als(CPU, inter, als.ALSConfig(iterations=20, **kw))
    d = str(tmp_path / "ckpt")
    als.train_als(CPU, inter, als.ALSConfig(iterations=10, checkpoint_dir=d,
                                            checkpoint_interval=5, **kw))
    assert ckpt.CheckpointManager(d).steps() == [5, 10]
    calls = _count_half_steps(monkeypatch)
    resumed = als.train_als(CPU, inter, als.ALSConfig(iterations=20, checkpoint_dir=d,
                                                      checkpoint_interval=5, **kw))
    assert len(calls) == 2 * 10
    assert ckpt.CheckpointManager(d).steps() == [15, 20]
    np.testing.assert_array_equal(resumed.user_factors, full.user_factors)
    np.testing.assert_array_equal(resumed.item_factors, full.item_factors)

    # a permuted copy of the data (same element sums) starts fresh
    perm = np.random.default_rng(1).permutation(N_RATINGS)
    permuted = _port(*(a[perm] for a in triples))
    calls.clear()
    fresh = als.train_als(CPU, permuted, als.ALSConfig(iterations=20, checkpoint_dir=d,
                                                       checkpoint_interval=5, **kw))
    assert len(calls) == 2 * 20
    ref = als.train_als(CPU, permuted, als.ALSConfig(iterations=20, **kw))
    np.testing.assert_array_equal(fresh.user_factors, ref.user_factors)


def _jax_init(seed, rank):
    ku, kv = jax.random.split(jax.random.PRNGKey(seed))
    scale = 1.0 / np.sqrt(rank)
    return (np.asarray(jax.random.normal(ku, (N_USERS, rank), jnp.float32) * scale),
            np.asarray(jax.random.normal(kv, (N_ITEMS, rank), jnp.float32) * scale))


@pytest.mark.parametrize("solver", ["dense", "segment"])
def test_als_resume_matches_jax_resume(tmp_path, triples, solver):
    kw = dict(rank=4, reg=0.05, seed=7, solver=solver, compute_dtype="f32",
              checkpoint_interval=5)
    mesh = MeshContext.create(devices=jax.devices()[:1])
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_inter, inter = _jax(*triples), _port(*triples)
    for iters in (10, 20):
        ref = jax_als.train_als(mesh, jax_inter, jax_als.ALSConfig(
            iterations=iters, checkpoint_dir=jd, train_kernel="reference", **kw))
        got = als.train_als(CPU, inter, als.ALSConfig(iterations=iters, checkpoint_dir=pd, **kw),
                            init_factors=_jax_init(7, 4))
        # the same fingerprint fields: the sidecars are equal
        for step in (iters - 5, iters):
            np.testing.assert_array_equal(
                np.load(os.path.join(pd, f"step_{step}.fp.npy")),
                np.load(os.path.join(jd, f"step_{step}.fp.npy")))
    np.testing.assert_allclose(got.user_factors, ref.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, rtol=1e-4, atol=1e-4)


def test_jax_checkpoint_steps_are_skipped_not_loaded(tmp_path, triples, caplog):
    """A directory the JAX package wrote (orbax steps, the same sidecar
    fingerprint) is unreadable to the port: it starts fresh."""
    kw = dict(rank=4, reg=0.05, seed=7, solver="dense", compute_dtype="f32",
              checkpoint_interval=5)
    d = str(tmp_path)
    jax_als.train_als(MeshContext.create(devices=jax.devices()[:1]), _jax(*triples),
                      jax_als.ALSConfig(iterations=5, checkpoint_dir=d,
                                        train_kernel="reference", **kw))
    inter = _port(*triples)
    got = als.train_als(CPU, inter, als.ALSConfig(iterations=5, checkpoint_dir=d, **kw))
    ref = als.train_als(CPU, inter, als.ALSConfig(iterations=5, **kw))
    np.testing.assert_array_equal(got.user_factors, ref.user_factors)
    assert "unreadable" in caplog.text


def test_sasrec_resume_per_step(tmp_path):
    rng = np.random.default_rng(5)
    n_users, n_items, per = 30, 50, 12
    u = np.repeat(np.arange(n_users), per)
    i = rng.integers(0, n_items, len(u))
    t = np.tile(np.arange(per, dtype=np.float64), n_users)
    inter = interactions_from_arrays(u, i, np.ones(len(u)), t,
                                     [f"u{k}" for k in range(n_users)],
                                     [f"i{k}" for k in range(n_items)])
    base = dict(d_model=16, n_layers=1, n_heads=2, max_len=8, batch_size=8, lr=1e-2, seed=3)
    full = sequential.train_sasrec(CPU, inter, sequential.SASRecConfig(epochs=6, **base))
    d = str(tmp_path)
    first = sequential.train_sasrec(CPU, inter, sequential.SASRecConfig(
        epochs=4, checkpoint_dir=d, checkpoint_interval=2, **base))
    assert ckpt.CheckpointManager(d).steps() == [2, 4]
    np.testing.assert_allclose(first.losses, full.losses[:4], rtol=1e-5)
    resumed = sequential.train_sasrec(CPU, inter, sequential.SASRecConfig(
        epochs=6, checkpoint_dir=d, checkpoint_interval=2, **base))
    assert len(resumed.losses) == 2
    np.testing.assert_allclose(resumed.losses, full.losses[4:], rtol=1e-5)
    np.testing.assert_allclose(resumed.params["emb"], full.params["emb"], rtol=1e-5, atol=1e-5)
    for a, b in zip(resumed.params["layers"], full.params["layers"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)
