"""SASRec sequence parallelism on the port, held against the JAX package.

Mirrors ``tests/test_sequential.py::TestSeqParallel``: the port's
``_build_sp_loss`` on a mesh of repeated CPU placements against the JAX
``_build_sp_loss`` (jitted over a CPU device mesh) and against the port's
data-parallel ``_loss_fn``, loss at rtol 1e-5 and gradients at rtol 5e-4 /
atol 1e-6 (the JAX test's tolerances); ``train_sasrec(seq_parallel=True)``
learning the cycle; its refusals; and SP training step by step against
data-parallel training from the same params.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.models import sequential as jax_seq
from predictionio_tpu.parallel.mesh import MeshContext as JaxMeshContext
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.models import sequential as seq
from predictionio_tpu_torch.parallel.mesh import MeshContext
from predictionio_tpu_torch.testing import warm_cpu_math

warm_cpu_math()  # the first exp/log of a process can be off: testing.warm_cpu_math

CPU = MeshContext.create(device="cpu")


def cyclic_interactions(n_users=64, n_items=10, length=12, seed=0):
    """Every user walks the cycle 0 → 1 → … → 9 → 0 from a random start."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_items, n_users)
    user = np.repeat(np.arange(n_users), length)
    item = (np.repeat(starts, length) + np.tile(np.arange(length), n_users)) % n_items
    t = np.tile(np.arange(length), n_users).astype(np.float64)
    return interactions_from_arrays(user, item, np.ones(len(user)), t,
                                    [f"u{k}" for k in range(n_users)],
                                    [f"i{k}" for k in range(n_items)])


def _mesh(data, model):
    return MeshContext.create(axes={"data": data, "model": model}, devices=["cpu"] * (data * model))


def _case(seed=0, n_layers=2, d_model=16, max_len=8, batch=4):
    cfg = seq.SASRecConfig(d_model=d_model, n_heads=2, n_layers=n_layers, max_len=max_len)
    jcfg = jax_seq.SASRecConfig(d_model=d_model, n_heads=2, n_layers=n_layers, max_len=max_len)
    jp = jax_seq._init_params(jax.random.PRNGKey(seed), jcfg, n_items=20)
    rng = np.random.default_rng(seed)
    s = np.zeros((batch, max_len + 1), np.int32)
    s[:, 3:] = rng.integers(1, 21, size=(batch, max_len - 2))  # right-aligned pads
    return cfg, jcfg, jp, s


def _port_loss_and_grads(loss_fn, host_params, cfg):
    net = seq.SASRecNet(seq.sasrec_params_from_jax(host_params), cfg, "cpu", trainable=True)
    loss = loss_fn(net.tree())
    loss.backward()
    grads = {"emb": net.emb.grad, "pos": net.pos.grad,
             "layers": [{k: p.grad for k, p in layer.items()} for layer in net.layers]}
    return float(loss.detach()), grads


def _flat(tree):
    out = [tree["emb"], tree["pos"]]
    for layer in tree["layers"]:
        out += [layer[k] for k in sorted(layer)]
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x) for x in out]


@pytest.mark.parametrize("data,model", [(2, 4), (1, 2), (4, 2), (1, 8)])
def test_sp_loss_matches_jax_and_the_dense_loss(data, model):
    cfg, jcfg, jp, s = _case(seed=data * 10 + model)
    host = jax.tree.map(np.asarray, jp)
    st = torch.from_numpy(s.astype(np.int64))
    sp_loss = seq._build_sp_loss(_mesh(data, model), model, cfg)
    got, got_g = _port_loss_and_grads(lambda p: sp_loss(p, st[:, :-1], st[:, 1:]), host, cfg)
    dense, dense_g = _port_loss_and_grads(lambda p: seq._loss_fn(p, st, cfg), host, cfg)

    jctx = JaxMeshContext.create(axes={"data": data, "model": model},
                                 devices=jax.devices()[:data * model])
    jfn = jax_seq._build_sp_loss(jctx.mesh, model, jcfg)
    bt = jctx.sharding("data", "model")
    inp = jax.device_put(jnp.asarray(s[:, :-1]), bt)
    tgt = jax.device_put(jnp.asarray(s[:, 1:]), bt)
    want = float(jax.jit(jfn)(jp, inp, tgt))
    want_g = jax.jit(jax.grad(jfn))(jp, inp, tgt)

    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, dense, rtol=1e-5)
    jflat = [np.asarray(want_g["emb"]), np.asarray(want_g["pos"])]
    for layer in want_g["layers"]:
        jflat += [np.asarray(layer[k]) for k in sorted(layer)]
    for g, d, j in zip(_flat(got_g), _flat(dense_g), jflat):
        np.testing.assert_allclose(g, d, rtol=5e-4, atol=1e-6)
        np.testing.assert_allclose(g, j, rtol=5e-4, atol=1e-6)


def test_sp_training_step_by_step_equals_data_parallel():
    """Five Adam steps of SP training and of data-parallel training from the
    same params and batches: every step's loss at rtol 1e-5."""
    inter = cyclic_interactions()
    cfg = seq.SASRecConfig(d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=5, batch_size=32)
    start = seq.init_params(3, cfg, inter.n_items)
    dp = seq.train_sasrec(CPU, inter, cfg, init_params=start)
    sp = seq.train_sasrec(_mesh(1, 2), inter, seq.SASRecConfig(
        **{**cfg.__dict__, "seq_parallel": True}), init_params=start)
    np.testing.assert_allclose(sp.losses, dp.losses, rtol=1e-5)
    for a, b in zip(_flat(dp.params), _flat(sp.params)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_train_seq_parallel_learns():
    model = seq.train_sasrec(_mesh(2, 4), cyclic_interactions(), seq.SASRecConfig(
        d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=40, batch_size=32,
        seq_parallel=True))
    model.bind("cpu")
    items, _ = model.recommend(["i2", "i3", "i4"], num=1)
    assert items == ["i5"]
    assert model.losses[-1] < model.losses[0]


def test_batch_is_a_multiple_of_the_data_axis():
    """The JAX rule: min(batch_size, n) rounded up to the data axis."""
    inter = cyclic_interactions(n_users=7)
    cfg = seq.SASRecConfig(d_model=8, n_heads=2, n_layers=1, max_len=8, epochs=1, batch_size=32,
                           seq_parallel=True)
    seq.train_sasrec(_mesh(2, 2), inter, cfg)  # 7 users → a batch of 8 over 2 data blocks
    with pytest.raises(ValueError, match="model.*axis"):
        seq.train_sasrec(_mesh(2, 1), inter, cfg)


def test_sp_rejects_expert_combo_and_bad_length():
    inter = cyclic_interactions()
    ctx = _mesh(2, 4)
    with pytest.raises(ValueError, match="model"):
        seq.train_sasrec(ctx, inter, seq.SASRecConfig(max_len=8, seq_parallel=True, n_experts=2))
    with pytest.raises(ValueError, match="divisible"):
        seq.train_sasrec(ctx, inter, seq.SASRecConfig(max_len=6, seq_parallel=True))


def test_sp_rejects_mesh_without_model_axis():
    with pytest.raises(ValueError, match="model.*axis"):
        seq.train_sasrec(CPU, cyclic_interactions(), seq.SASRecConfig(max_len=8, seq_parallel=True))
