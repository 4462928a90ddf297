"""Each reference against the program's plain CPU path at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench.adapters import als as als_adapter
from portbench.adapters import sasrec as sasrec_adapter
from portbench.reference import als as ref_als
from portbench.reference import compare
from portbench.reference import sasrec as ref_sasrec
from portbench.reference import topk as ref_topk
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als, sequential

ALS_CFG = {"n_users": 200, "n_items": 80, "n_ratings": 4000, "rank": 6, "iterations": 5,
           "lambda": 0.01, "user_zipf_s": 0.7, "item_zipf_s": 1.1, "zipf_q": 50.0,
           "rating_low": 1.0, "rating_high": 5.0}


def _inter(user, item, rating, n_users, n_items, t=None):
    return interactions_from_arrays(
        user, item, rating, np.zeros(len(user)) if t is None else t,
        (f"u{i}" for i in range(n_users)), (f"i{j}" for j in range(n_items)))


def test_degree_order_is_the_programs_layout():
    user, item, _ = als_adapter.draw_ratings(ALS_CFG, 5, "cpu")
    assert np.array_equal(ref_als.degree_order(user, 200),
                          als._degree_sort_permutation(user.astype(np.int64), 200))


def test_als_reference_against_train_als_on_the_cpu():
    user, item, rating = als_adapter.draw_ratings(ALS_CFG, 7, "cpu")
    U0, V0 = als_adapter.draw_factors(ALS_CFG, 7, "cpu")
    cfg = als.ALSConfig(rank=6, iterations=5, reg=0.01, compute_dtype="f32", solver="dense")
    model = als.train_als(DeviceContext.create(device="cpu"), _inter(user, item, rating, 200, 80),
                          cfg, init_factors=(U0, V0))
    U, V = ref_als.train(*(torch.from_numpy(a.astype(np.int64)) for a in (user, item)),
                         torch.from_numpy(rating), torch.from_numpy(U0), torch.from_numpy(V0),
                         0.01, 5, "f64")
    assert compare.factor_gap(torch.from_numpy(model.user_factors), U) < 1e-4
    assert compare.factor_gap(torch.from_numpy(model.item_factors), V) < 1e-4


def test_topk_reference_against_recommend_batch_on_the_cpu():
    rng = np.random.default_rng(3)
    U = rng.integers(-4, 5, (50, 8)).astype(np.float32)  # every score exact
    V = rng.integers(-4, 5, (300, 8)).astype(np.float32)
    model = als.als_model_from_arrays(U, V, range(50), range(300))
    scorer = als.ALSScorer(DeviceContext.create(device="cpu"), model, max_k=20)
    idx, val = scorer.recommend_batch(np.arange(50), 20)
    users = torch.arange(50)
    ref = ref_topk.scores(torch.from_numpy(U), torch.from_numpy(V), users, "f64")
    rank, value = compare.topk_gaps(torch.from_numpy(idx), torch.from_numpy(val), ref)
    assert rank == 0.0 and value == 0.0
    ref_idx, ref_val = ref_topk.top_k(ref, 20)
    assert np.array_equal(np.sort(ref_val.numpy(), axis=1), np.sort(val.astype(np.float64), axis=1))


SAS_CFG = {"d_model": 8, "n_layers": 2, "n_heads": 2, "lr": 0.001, "n_users": 30,
           "n_items": 25, "n_events": 900, "min_events": 5}


def _sasrec_program(max_len):
    user, item, t, _ = sasrec_adapter.draw_events(SAS_CFG, 4)
    inter = _inter(user, item, np.ones(len(user)), 30, 25, t)
    cfg = sequential.SASRecConfig(d_model=8, n_layers=2, n_heads=2, max_len=max_len,
                                  batch_size=6, lr=0.001)
    return (user, item, t), sequential.training_sequences(inter, cfg), cfg


@pytest.mark.parametrize("max_len", [6, 40])
def test_sasrec_sequences_are_the_programs(max_len):
    (user, item, t), seqs, _ = _sasrec_program(max_len)
    assert np.array_equal(ref_sasrec.sequences(user, item, t, 30, max_len + 1), seqs)


def test_sasrec_reference_steps_against_train_step_on_the_cpu():
    _, seqs, cfg = _sasrec_program(10)
    init = sasrec_adapter.draw_params(SAS_CFG, 10, 4, "cpu")
    net = sequential.SASRecNet(init, cfg, "cpu", trainable=True)
    opt = sequential.adam(net, cfg)
    picks = sasrec_adapter.check_rows(len(seqs), 6, 3, 4)
    named = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    losses = []
    for i, p in enumerate(picks):
        batch = torch.from_numpy(seqs[p].astype(np.int64))
        losses.append(float(sequential.train_step(net, opt, batch, cfg)))
        if i == 0:
            grads = {k: float(opt.state[q]["exp_avg"].double().norm()) / 0.1
                     for k, q in named.items()}
    program = {"losses": losses, "grad_norms": grads,
               "change_norms": {k: float((q.detach().double() - start[k].double()).norm())
                                for k, q in named.items()}}
    batches = [torch.from_numpy(seqs[p].astype(np.int64)) for p in picks]
    reference = ref_sasrec.train_steps(init, batches, 2, 0.001, "f64", "cpu")
    numbers = compare.train_numbers(program, reference)
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-4
