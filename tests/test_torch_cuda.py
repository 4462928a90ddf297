"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and the CUDA toolkit (``nvcc`` builds the
kernels at first use) and skips without a card. The file imports neither
jax nor the JAX package, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports jax to set up its CPU mesh).
``chip_smoke.py`` runs the same comparisons at full width; these are the
small, fast cases.

Tolerances: the score kernel by ``topk_mismatches`` at 1e-5; the training
kernel by ``normal_eq_mismatches`` (each entry of A and b within 3e-4 of
the summed absolute products behind it against the plain version, and
within 1e-5 against the same operands summed in float64, plus 1e-6; cnt
equal; ``predictionio_tpu_torch/testing.py`` says how the two were set);
the gather kernel and the segment normal equations bit for bit against
their plain versions (the segment kernel against the plain version on the
CPU, which sums in the same order); training on the card against training
on the CPU from the same initial factors (dense and segment solvers), rtol
= atol = 1e-4 at f32; the flash-attention kernel against its
plain version, o within rtol = atol = 2e-5 (the JAX package's own flash
test) and lse within 1e-5; the backward kernels against the plain backward,
rtol 2e-4, atol 2e-5 (the JAX package's own gradient test); SASRec logits
through the kernel against the plain attention, rtol = atol = 1e-4; a SASRec
trained on the card against the same steps on the CPU, rtol = atol = 1e-4.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models import sequential
from predictionio_tpu_torch.ops import flash_attention, score_kernel, train_kernel
from predictionio_tpu_torch.ops.quantize import quantize_factors_torch
from predictionio_tpu_torch.testing import (
    KERNEL_VS_FLOAT64_RTOL,
    KERNEL_VS_PLAIN_RTOL,
    normal_eq_magnitudes,
    normal_eq_mismatches,
    topk_mismatches,
)

DTYPES = ("f32", "bf16", "int8")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks there)")
    return torch.device("cuda", 0)


def _score_case(name, seed=11):
    """(U, V, u_idx, k, mask, tol) of one score-kernel case: integer-valued
    cases (every dot product exact) are held with tol 0."""
    rng = np.random.default_rng(seed)
    n, batch, k, mask, tol = 3000, 64, 100, None, 1e-5
    if name == "random":
        n = 1100
    elif name == "k=8192":
        n, batch, k = 10_000, 5, 8192
    elif name == "k=n_items":
        n, k = 1100, 1100
    U = rng.standard_normal((300, 10)).astype(np.float32)
    V = rng.standard_normal((n, 10)).astype(np.float32)
    if name == "random":
        V[1090] = V[3]
    elif name == "ascending":  # every item beats the running threshold
        U = np.zeros((300, 10), np.float32)
        U[:, 0] = np.arange(1, 301)
        V = np.zeros((n, 10), np.float32)
        V[:, 0] = np.arange(n)
        tol = 0.0
    elif name == "tied":  # all scores equal: indices 0..k-1
        U = rng.integers(-3, 4, (300, 10)).astype(np.float32)
        V = np.tile(rng.integers(1, 4, (1, 10)), (n, 1)).astype(np.float32)
        tol = 0.0
    elif name == "mask-leaves-5":
        mask = np.ones(n, bool)
        mask[[7, 600, 1500, 2222, 2999]] = False
    elif name == "B=13":
        batch = 13
    elif name == "k=1":
        k = 1
    u = rng.integers(0, 300, batch).astype(np.int32)
    return U, V, u, k, mask, tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ("random", "ascending", "tied", "mask-leaves-5", "B=13",
                                  "k=1", "k=8192", "k=n_items"))
def test_score_kernel_matches_plain_version_on_card(card, case, dtype):
    U, V, u, k, mask, tol = _score_case(case)
    if dtype == "int8" and tol == 0.0:
        tol = 1e-5  # int8 rescales the rows: the dot products are no longer exact
    Uq, us = quantize_factors_torch(torch.from_numpy(U).to(card), dtype)
    Vq, vs = quantize_factors_torch(torch.from_numpy(V).to(card), dtype)
    u = torch.from_numpy(u).to(card)
    m = None if mask is None else torch.from_numpy(mask).to(card)
    before = score_kernel.launches.count
    kv, ki = score_kernel.fused_gather_score_topk(Uq, Vq, u, k, m, u_scale=us, v_scale=vs)
    rv, ri = score_kernel.gather_score_topk_reference(Uq, Vq, u, k, m, u_scale=us, v_scale=vs)
    torch.cuda.synchronize()
    assert score_kernel.launches.count == before + 1
    bad = topk_mismatches(kv.cpu().numpy(), ki.cpu().numpy(),
                          rv.cpu().numpy(), ri.cpu().numpy(), tol)
    assert not bad, bad[:3]
    if case == "tied" and dtype != "int8":
        assert (ki.cpu().numpy() == np.arange(k)).all()
    # a second call on the same stream: the kernel left its tickets at zero
    kv2, ki2 = score_kernel.fused_gather_score_topk(Uq, Vq, u, k, m, u_scale=us, v_scale=vs)
    assert torch.equal(kv, kv2) and torch.equal(ki, ki2)


# (n_b, D, n_opp, rank): narrow rows (a warp each, widths 1, 24, 31, 33, 65,
# 300), wide rows (a block each, cut into parts at 20,000), ranks 1, 10, 63, 64
TRAIN_CASES = ((13, 24, 37, 10), (3, 20_000, 1000, 10), (5, 300, 50, 64), (40, 1, 9, 10),
               (17, 31, 30, 1), (17, 33, 30, 63), (9, 65, 40, 10), (6, 700, 80, 63))


def _bucket_on(card, rng, n_b, D, n_opp, k):
    idx = torch.from_numpy(rng.integers(0, n_opp, (n_b, D)).astype(np.int32)).to(card)
    rat = torch.from_numpy(rng.uniform(1, 5, (n_b, D)).astype(np.float32)).to(card)
    msk = (rng.uniform(size=(n_b, D)) < 0.7).astype(np.float32)
    msk[n_b // 2] = 0.0  # a fully masked row: A = 0, b = 0, cnt = 0
    msk = torch.from_numpy(msk).to(card)
    V = torch.from_numpy(rng.normal(size=(n_opp, k)).astype(np.float32)).to(card)
    return idx, rat, msk, V


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
def test_train_kernel_matches_plain_version_on_card(card, dtype, implicit):
    rng = np.random.default_rng(1)
    for n_b, D, n_opp, k in TRAIN_CASES:
        idx, rat, msk, V = _bucket_on(card, rng, n_b, D, n_opp, k)
        q, s = quantize_factors_torch(V, dtype)
        before = train_kernel.launches.count
        got = train_kernel.fused_train_normal_eq(idx, rat, msk, q, s, implicit=implicit, alpha=2.0)
        ref = train_kernel.train_normal_eq_reference(idx, rat, msk, q, s, implicit=implicit, alpha=2.0)
        exact = train_kernel.train_normal_eq_reference(
            idx, rat, msk, q, s, implicit=implicit, alpha=2.0, accumulate=torch.float64
        )
        mag = normal_eq_magnitudes(idx, rat, msk, q, s, implicit=implicit, alpha=2.0)
        torch.cuda.synchronize()
        assert train_kernel.launches.count == before + 1
        assert not normal_eq_mismatches(got, ref, mag, rtol=KERNEL_VS_PLAIN_RTOL), (n_b, D, k)
        assert not normal_eq_mismatches(got, exact, mag, rtol=KERNEL_VS_FLOAT64_RTOL), (n_b, D, k)
        empty = n_b // 2
        assert not any(bool(t[empty].any()) for t in got), (n_b, D, k)
        if not implicit:  # explicit A is summed for i <= j and mirrored: exactly symmetric
            assert torch.equal(got[0], got[0].transpose(1, 2)), (n_b, D, k)


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", (False, True))
def test_train_kernel_is_deterministic_on_card(card, implicit):
    """Two launches on the same inputs give the same bytes: every sum has one
    order, narrow rows and wide rows cut into parts alike."""
    rng = np.random.default_rng(3)
    for n_b, D, n_opp, k in TRAIN_CASES:
        idx, rat, msk, V = _bucket_on(card, rng, n_b, D, n_opp, k)
        first = train_kernel.fused_train_normal_eq(idx, rat, msk, V, implicit=implicit, alpha=2.0)
        again = train_kernel.fused_train_normal_eq(idx, rat, msk, V, implicit=implicit, alpha=2.0)
        torch.cuda.synchronize()
        for x, y in zip(first, again):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), (n_b, D, k)


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", (False, True))
def test_train_on_card_matches_cpu(card, implicit):
    rng = np.random.default_rng(2)
    n_users, n_items, n = 70, 45, 1200
    inter = interactions_from_arrays(
        rng.integers(0, n_users, n), rng.integers(0, n_items, n),
        rng.uniform(1, 5, n), np.zeros(n),
        [f"u{i}" for i in range(n_users)], [f"i{j}" for j in range(n_items)],
    )
    cfg = als.ALSConfig(rank=5, iterations=3, implicit=implicit, seed=2)
    init = (rng.standard_normal((n_users, 5)).astype(np.float32),
            rng.standard_normal((n_items, 5)).astype(np.float32))
    ub, ib, _, _ = als._dense_blocks_for(inter, cfg)
    before = train_kernel.launches.count
    on_card = als.train_als(DeviceContext.create(device=card), inter, cfg, init_factors=init)
    assert train_kernel.launches.count - before == (len(ub.widths) + len(ib.widths)) * 3
    on_cpu = als.train_als(DeviceContext.create(device="cpu"), inter, cfg, init_factors=init)
    np.testing.assert_allclose(on_card.user_factors, on_cpu.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(on_card.item_factors, on_cpu.item_factors, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, n_opp, k", [(1, 9, 1), (513, 200, 10), (65_539, 3000, 65),
                                         (70, 40, 256)])
def test_gather_kernel_matches_plain_version_bitwise_on_card(card, dtype, n, n_opp, k):
    rng = np.random.default_rng(n + k)
    V = torch.from_numpy(rng.normal(size=(n_opp, k)).astype(np.float32)).to(card)
    idx = rng.integers(0, n_opp, n).astype(np.int32)
    idx[:2] = (0, n_opp - 1)[: min(2, n)]
    if n > 4:
        idx[2:4] = (-3, n_opp + 5)  # clamped
    idx = torch.from_numpy(idx).to(card)
    q, s = quantize_factors_torch(V, dtype)
    before = train_kernel.gather_launches.count
    got = train_kernel.fused_gather_rows(q, idx, s)
    ref = train_kernel.gather_rows_reference(q, idx, s)
    torch.cuda.synchronize()
    assert train_kernel.gather_launches.count == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    empty = train_kernel.fused_gather_rows(q, idx[:0], s)
    assert empty.shape == (0, k) and train_kernel.gather_launches.count == before + 1


@pytest.mark.cuda
def test_gather_kernel_refuses_what_it_does_not_take(card):
    V = torch.zeros((8, 4), device=card)
    idx = torch.zeros(5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="idx is on cpu"):
        train_kernel.fused_gather_rows(V, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        train_kernel.fused_gather_rows(V.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_gather_rows(V.to(torch.int8), idx)


def _segment_case(seed, n_entity, n_opp, n, hot):
    """A skewed stream: ``hot`` of the slots on entity 1, none on the last."""
    rng = np.random.default_rng(seed)
    entity = rng.integers(0, n_entity - 1, n)
    entity[rng.random(n) < hot] = 1
    return als._make_blocks(entity, rng.integers(0, n_opp, n),
                            rng.uniform(1, 5, n).astype(np.float32), n_entity)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("implicit", (False, True))
@pytest.mark.parametrize("k, heavy_slots", [(1, 4096), (10, 4096), (10, 64), (65, 64), (130, 4096)])
def test_segment_kernel_matches_plain_version_bitwise_on_card(card, dtype, implicit, k,
                                                              heavy_slots, monkeypatch):
    """The kernel on the card against the plain version on the CPU, A, b and
    cnt bit for bit: chunks of 256, a third of the slots on one entity (a
    block of warps takes it where ``HEAVY_SLOTS`` is 64), an entity with no
    slot, ranks from 1 past the dense kernel's 64 (65 and 130: 18 to 134
    tiles of accumulators). Two launches give the same bytes."""
    monkeypatch.setattr(als, "_CHUNK", 256)
    monkeypatch.setattr(train_kernel, "HEAVY_SLOTS", heavy_slots)
    blk = _segment_case(k, 60, 500, 3000, 1 / 3)
    rng = np.random.default_rng(k + 1)
    V = torch.from_numpy(rng.normal(size=(500, k)).astype(np.float32))
    q, s = quantize_factors_torch(V, dtype)
    lay_card, lay_cpu = als._segment_layout(blk, card), als._segment_layout(blk, "cpu")
    assert (lay_card.heavy.numel() > 0) == (heavy_slots == 64)
    qc, sc = q.to(card), None if s is None else s.to(card)
    before = train_kernel.segment_launches.count
    got = train_kernel.fused_segment_normal_eq(lay_card, qc, sc, implicit=implicit, alpha=2.0)
    again = train_kernel.fused_segment_normal_eq(lay_card, qc, sc, implicit=implicit, alpha=2.0)
    torch.cuda.synchronize()
    assert train_kernel.segment_launches.count == before + 2
    ref = train_kernel.fused_segment_normal_eq(lay_cpu, q, s, implicit=implicit, alpha=2.0)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == torch.float32 and torch.equal(g.cpu(), r), (float((g.cpu() - r).abs().max()))
        assert torch.equal(g, a)
    assert train_kernel.segment_launches.count == before + 2


@pytest.mark.cuda
def test_segment_kernel_refuses_what_it_does_not_take(card):
    lay = als._segment_layout(_segment_case(0, 20, 30, 100, 0.0), card)
    V = torch.zeros((30, 4), device=card)
    with pytest.raises(ValueError, match="V is on the CPU"):
        train_kernel.fused_segment_normal_eq(lay, V.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        train_kernel.fused_segment_normal_eq(lay, V.t().contiguous().t())
    with pytest.raises(ValueError, match="v_scale"):
        train_kernel.fused_segment_normal_eq(lay, V.to(torch.int8))
    with pytest.raises(ValueError, match="other is on cpu"):
        train_kernel.fused_segment_normal_eq(dataclasses.replace(lay, other=lay.other.cpu()), V)
    with pytest.raises(ValueError, match="entity_runs has shape"):
        train_kernel.fused_segment_normal_eq(dataclasses.replace(lay, n_entity=19), V)


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", (False, True))
def test_segment_train_on_card_matches_cpu(card, implicit, monkeypatch):
    """Several chunks a half-step (chunks of 256), one segment kernel launch
    a half-step and no gather; the card sums A, b and cnt in the CPU's
    order, and the factors part only where the two devices' solves round
    differently, within rtol = atol = 1e-4."""
    monkeypatch.setattr(als, "_CHUNK", 256)
    rng = np.random.default_rng(3)
    n_users, n_items, n = 70, 45, 1200
    inter = interactions_from_arrays(
        rng.integers(0, n_users, n), rng.integers(0, n_items, n),
        rng.uniform(1, 5, n), np.zeros(n),
        [f"u{i}" for i in range(n_users)], [f"i{j}" for j in range(n_items)],
    )
    cfg = als.ALSConfig(rank=5, iterations=3, implicit=implicit, seed=2, solver="segment")
    init = (rng.standard_normal((n_users, 5)).astype(np.float32),
            rng.standard_normal((n_items, 5)).astype(np.float32))
    counters = (train_kernel.launches, train_kernel.gather_launches, train_kernel.segment_launches)
    before = [c.count for c in counters]
    on_card = als.train_als(DeviceContext.create(device=card), inter, cfg, init_factors=init)
    # two half-steps an iteration, 3 iterations
    assert [c.count - b for c, b in zip(counters, before)] == [0, 0, 2 * 3]
    on_cpu = als.train_als(DeviceContext.create(device="cpu"), inter, cfg, init_factors=init)
    np.testing.assert_allclose(on_card.user_factors, on_cpu.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(on_card.item_factors, on_cpu.item_factors, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("bh, t_q, t_kv, h", [
    (1, 256, 256, 50), (3, 128, 128, 64), (2, 8, 8, 16), (2, 384, 384, 128),
    (1, 256, 512, 50), (2, 512, 256, 32), (1, 256, 256, 256), (2, 100, 100, 1),
    (70, 64, 64, 256),  # 64-row tiles at the widest head: a one-stage ring
])
def test_flash_kernel_matches_plain_version_on_card(card, causal, bh, t_q, t_kv, h):
    rng = np.random.default_rng(bh * 1000 + t_q + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, t, h)).astype(np.float32)).to(card)
               for t in (t_q, t_kv, t_kv))
    before = flash_attention.launches.count
    o, lse = flash_attention.flash_block_fwd(q, k, v, causal)
    ro, rlse = flash_attention.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches.count == before + 1
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("bh, t_q, t_kv, h", [
    (1, 256, 256, 50), (1, 256, 256, 64), (4, 256, 1024, 50), (4, 1024, 256, 64),
    (1, 100, 100, 7), (1, 128, 128, 256), (2, 16, 4096, 50),
])
def test_flash_kernel_with_key_splits_matches_plain_version_on_card(card, causal, bh, t_q, t_kv, h):
    """Shapes whose split plan takes 16-row query tiles, most of them cut
    into key splits: the merged partials against the plain version, a second
    launch byte for byte, and the tickets back at zero."""
    rng = np.random.default_rng(bh * 7 + t_q + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, t, h)).astype(np.float32)).to(card)
               for t in (t_q, t_kv, t_kv))
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert flash_attention.split_plan(bh, t_q, t_kv, causal, n_sm)[0] == flash_attention.MIN_Q_ROWS
    o, lse = flash_attention.flash_block_fwd(q, k, v, causal)
    o2, lse2 = flash_attention.flash_block_fwd(q, k, v, causal)
    ro, rlse = flash_attention.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    stream = torch.cuda.current_stream(card).cuda_stream
    tickets = flash_attention._tickets.get((card.index, stream))
    assert tickets is None or int(tickets.abs().sum()) == 0


@pytest.mark.cuda
def test_flash_serving_shape_plan_fills_the_card(card):
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    q_rows, ks, blocks = flash_attention.split_plan(1, 256, 256, True, n_sm)
    assert blocks >= 64 and ks <= 64, (q_rows, ks, blocks)
    assert flash_attention.split_plan(128, 256, 256, True, n_sm)[1] == 256


@pytest.mark.cuda
@pytest.mark.parametrize("bh, t_q, t_kv, h", [(128, 256, 256, 50), (8, 1024, 1024, 64), (2, 128, 128, 192)])
def test_flash_kernels_give_the_same_bytes_twice_on_card(card, bh, t_q, t_kv, h):
    q, k, v, o, lse, do = _bwd_inputs(card, 21, bh, t_q, t_kv, h, True)
    fwd = [flash_attention.flash_block_fwd(q, k, v, True) for _ in range(2)]
    bwd = [flash_attention.flash_block_bwd(q, k, v, o, lse, do, True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    for a, b in zip(*bwd):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 256, 50), device=card)
    for bad in (q.double(), q.bfloat16(), torch.zeros((1, 50, 256), device=card).transpose(1, 2)):
        with pytest.raises(ValueError):
            flash_attention.flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="divide"):
        flash_attention.flash_attention(*(torch.zeros((1, 200, 8), device=card),) * 3)
    with pytest.raises(ValueError, match="head width"):
        flash_attention.flash_attention(*(torch.zeros((1, 128, 257), device=card),) * 3)


@pytest.mark.cuda
def test_sasrec_logits_through_the_kernel_on_card(card, monkeypatch):
    cfg = sequential.SASRecConfig(d_model=50, n_heads=1, n_layers=2, max_len=256)
    net = sequential.SASRecNet(sequential.init_params(0, cfg, 500), cfg, card)
    seqs = torch.from_numpy(np.random.default_rng(3).integers(0, 501, (4, 256))).to(card)
    seqs[:, :50] = 0
    before = flash_attention.launches.count
    got = net(seqs)
    torch.cuda.synchronize()
    assert flash_attention.launches.count == before + cfg.n_layers
    monkeypatch.setattr(sequential, "_use_flash", lambda t, device: False)
    want = net(seqs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _bwd_inputs(card, seed, bh, t_q, t_kv, h, causal):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, t, h)).astype(np.float32)).to(card)
               for t in (t_q, t_kv, t_kv))
    o, lse = flash_attention.flash_attention_reference(q, k, v, causal)
    do = torch.from_numpy(rng.normal(size=(bh, t_q, h)).astype(np.float32)).to(card)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("bh, t_q, t_kv, h", [
    (1, 256, 256, 50), (3, 128, 128, 64), (2, 8, 8, 16), (2, 384, 384, 128),
    (1, 256, 512, 50), (2, 512, 256, 32), (1, 256, 256, 256), (2, 100, 100, 1),
    (2, 128, 128, 192),
])
def test_flash_backward_kernels_match_plain_version_on_card(card, causal, bh, t_q, t_kv, h):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, o, lse, do = _bwd_inputs(card, bh * 1000 + t_q + h, bh, t_q, t_kv, h, causal)
    before = (flash_attention.bwd_dq_launches.count, flash_attention.bwd_dkv_launches.count)
    got = flash_attention.flash_block_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention.bwd_dq_launches.count, flash_attention.bwd_dkv_launches.count) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("bh, t_q, t_kv, h", [
    (4, 256, 256, 50), (8, 1024, 1024, 64), (2, 384, 384, 128), (1, 256, 256, 256),
    (2, 128, 256, 50),  # a ring block pair: T_q != T_kv
])
def test_flash_dq_kernel_matches_plain_and_float64_and_relaunches_on_card(card, causal, bh, t_q, t_kv, h):
    """Kernel 5 alone: dq against the plain backward and against float64 at
    the gradient tolerance, through every ``dq_plan`` tile height the shapes
    give, and the same bytes when launched again."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, o, lse, do = _bwd_inputs(card, bh + t_q + t_kv + h, bh, t_q, t_kv, h, causal)
    delta = (do * o).sum(-1)
    scale = flash_attention._f32(1.0 / h ** 0.5)
    before = flash_attention.bwd_dq_launches.count
    got = flash_attention._launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    again = flash_attention._launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    want = flash_attention.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)[0]
    exact = flash_attention.flash_attention_bwd_reference(
        *(x.double() for x in (q, k, v, o, lse, do)), causal)[0]
    torch.cuda.synchronize()
    assert flash_attention.bwd_dq_launches.count == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.double(), exact, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
def test_flash_backward_with_a_global_lse_splits_over_blocks_on_card(card, causal):
    """Block pairs of 128 (the ring's composition: causal on the diagonal,
    full below it, skipped above it), each fed the global o and lse, sum to
    the whole backward."""
    q, k, v, o, lse, do = _bwd_inputs(card, 9, 4, 256, 256, 50, causal)
    whole = flash_attention.flash_block_bwd(q, k, v, o, lse, do, causal)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    blocks = (slice(0, 128), slice(128, 256))
    for i, si in enumerate(blocks):
        for j, sj in enumerate(blocks):
            if causal and j > i:
                continue
            part = flash_attention.flash_block_bwd(
                *(x[:, s].contiguous() for x, s in ((q, si), (k, sj), (v, sj), (o, si), (lse, si), (do, si))),
                causal and i == j)
            dq[:, si] += part[0]
            dk[:, sj] += part[1]
            dv[:, sj] += part[2]
    for a, b in zip((dq, dk, dv), whole):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_function_grads_through_the_kernels_on_card(card):
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 256, 16)).astype(np.float32)).to(card)
               .requires_grad_() for _ in range(3))
    w = torch.from_numpy(rng.normal(size=(2, 256, 3, 16)).astype(np.float32)).to(card)

    def loss(attn):  # the cotangent arrives non-contiguous, as from _block_stack
        a = attn(q, k, v)
        return (a.transpose(-3, -2) * w).sum()

    before = flash_attention.bwd_dq_launches.count
    got = torch.autograd.grad(loss(lambda *a: flash_attention.flash_attention(*a, causal=True)), (q, k, v))
    assert flash_attention.bwd_dq_launches.count == before + 1
    want = torch.autograd.grad(loss(lambda *a: flash_attention.flash_attention_reference(*a, True)[0]),
                               (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(card):
    q, k, v, o, lse, do = _bwd_inputs(card, 11, 1, 256, 256, 50, True)
    with pytest.raises(ValueError):
        flash_attention.flash_block_bwd(q.double(), k, v, o, lse, do, True)
    with pytest.raises(ValueError):
        flash_attention.flash_block_bwd(q, k, v, o, lse[:, :128], do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts", (0, 4))
def test_sasrec_training_on_card_matches_cpu(card, n_experts):
    rng = np.random.default_rng(12)
    n_users, n_items = 24, 60
    lengths = rng.integers(2, 300, n_users)
    user = np.repeat(np.arange(n_users), lengths)
    item = rng.integers(0, n_items, len(user))
    t = np.concatenate([np.arange(n) for n in lengths]).astype(np.float64)
    inter = interactions_from_arrays(user, item, np.ones(len(user)), t,
                                     [f"u{i}" for i in range(n_users)],
                                     [f"i{j}" for j in range(n_items)])
    cfg = sequential.SASRecConfig(d_model=16, n_heads=2, n_layers=2, max_len=256, epochs=3,
                                  batch_size=8, lr=1e-3, seed=3, n_experts=n_experts)
    init = sequential.init_params(4, cfg, n_items)
    before = flash_attention.bwd_dkv_launches.count
    on_card = sequential.train_sasrec(DeviceContext.create(device=card), inter, cfg, init_params=init)
    assert flash_attention.bwd_dkv_launches.count - before == cfg.n_layers * cfg.epochs
    on_cpu = sequential.train_sasrec(DeviceContext.create(device="cpu"), inter, cfg, init_params=init)
    np.testing.assert_allclose(on_card.losses, on_cpu.losses, rtol=1e-5)
    for a, b in zip(_leaves(on_card.params), _leaves(on_cpu.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _leaves(params):
    out = [params["emb"], params["pos"]]
    for layer in params["layers"]:
        out += [layer[key] for key in sorted(layer)]
    return out


def _cli_quickstart_store(tmp_path, monkeypatch):
    """A zero-config sqlite store under ``tmp_path`` holding app ``CardQS``
    with 3,000 rate/buy events, and an engine directory for it."""
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.tools import cli

    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.delenv("PIO_ALS_SOLVER", raising=False)
    monkeypatch.delenv("PIO_ALS_COMPUTE_DTYPE", raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    Storage.reset_instance()
    store.set_storage(None)
    storage = Storage.instance()
    app_id = storage.get_meta_data_apps().insert(App(0, "CardQS"))
    rng = np.random.default_rng(21)
    storage.get_l_events().insert_batch([
        Event(event="buy" if k % 5 == 0 else "rate", entity_type="user",
              entity_id=f"u{int(rng.integers(120))}", target_entity_type="item",
              target_entity_id=f"i{int(rng.integers(90))}",
              properties=None if k % 5 == 0 else {"rating": int(rng.integers(1, 6))},
              event_time=1_767_225_600 + k) for k in range(3000)], app_id)
    eng = tmp_path / "engine"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps({
        "engineFactory": cli.BUILTIN_TEMPLATES["recommendation"],
        "datasource": {"params": {"appName": "CardQS"}},
        "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 5, "seed": 2}}]}))
    return storage, eng


@pytest.fixture()
def cli_store(card, tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage

    yield _cli_quickstart_store(tmp_path, monkeypatch)
    Storage.reset_instance()
    sqlite.close_all_dbs()


@pytest.mark.cuda
def test_cli_train_on_card_gives_train_als_factors(card, cli_store, capsys):
    """``pio train --device cuda`` from a sqlite store: the stored factors
    equal ``train_als`` on the card on the same read, bit for bit."""
    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
    from predictionio_tpu_torch.tools import cli

    storage, eng = cli_store
    before = train_kernel.launches.count
    assert cli.main(["train", "--engine-dir", str(eng), "--device", "cuda"]) == 0
    launches = train_kernel.launches.count - before
    iid = capsys.readouterr().out.split("Engine instance ID: ")[1].strip()
    engine = RecommendationEngine.apply()
    ctx = DeviceContext.create(device=card)
    inst = storage.get_meta_data_engine_instances().get(iid)
    model = workflow.prepare_deploy(engine, inst, storage=storage, ctx=ctx)[3][0]
    params = engine.params_from_variant(json.loads((eng / "engine.json").read_text()))
    pd = engine.prepare_data(ctx, params)
    cfg = engine.make_algorithms(params)[0]._config()
    ub, ib, _, _ = als._dense_blocks_for(pd.interactions, cfg)
    assert launches == (len(ub.widths) + len(ib.widths)) * cfg.iterations
    ref = als.train_als(ctx, pd.interactions, cfg)
    assert np.array_equal(model.user_factors, ref.user_factors)
    assert np.array_equal(model.item_factors, ref.item_factors)


@pytest.mark.cuda
def test_cli_deploy_batching_on_card_answers_the_plain_version(card, cli_store, capsys):
    """``pio deploy --batching --device cuda``: concurrent answers through
    the score kernel equal ``torch.topk(U[u] @ V.T)`` on the CPU."""
    import socket
    import threading
    import time
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
    from predictionio_tpu_torch.tools import cli

    storage, eng = cli_store
    assert cli.main(["train", "--engine-dir", str(eng), "--device", "cuda"]) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = threading.Thread(target=cli.main, daemon=True, args=([
        "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
        "--batching", "--device", "cuda"],))
    server.start()
    base = f"http://127.0.0.1:{port}"

    def get(path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        with urllib.request.urlopen(urllib.request.Request(
                base + path, data=data, headers={"Content-Type": "application/json"}),
                timeout=60) as r:
            return json.loads(r.read())

    for _ in range(600):
        try:
            ready = get("/readyz")
            break
        except OSError:
            time.sleep(0.1)
    launched_at_ready = get("/")["scoreKernelLaunches"]  # after the warm-up
    inst = storage.get_meta_data_engine_instances().get(ready["engineInstanceId"])
    model = workflow.prepare_deploy(RecommendationEngine.apply(), inst, storage=storage,
                                    ctx=DeviceContext.create(device="cpu"))[3][0]
    rng = np.random.default_rng(3)
    queries = [{"user": model.user_map.inverse[int(u)], "num": int(n)}
               for u, n in zip(rng.integers(0, len(model.user_map), 96), rng.integers(1, 40, 96))]
    with ThreadPoolExecutor(32) as pool:
        answers = list(pool.map(lambda q: get("/queries.json", q), queries))
    info = get("/")
    calls = info["fastpath"][0]["calls"]
    assert info["scoreKernelLaunches"] - launched_at_ready == calls
    assert cli.main(["undeploy", "--port", str(port)]) == 0
    server.join(30)
    U, V = torch.from_numpy(model.user_factors), torch.from_numpy(model.item_factors)
    bad = []
    for q, a in zip(queries, answers):
        rv, ri = torch.topk(U[model.user_map[q["user"]]] @ V.T, q["num"])
        got_i = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
        got_v = np.array([[x["score"] for x in a["itemScores"]]])
        bad += topk_mismatches(got_v, got_i, rv.numpy()[None], ri.numpy()[None], 1e-5)
    assert not bad, bad[:3]
    assert 0 < calls <= len(queries) and not server.is_alive()


STICKY_PROBE = """
import json
import numpy as np
import torch
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.serving.fastpath import BucketedScorer

rng = np.random.default_rng(0)
scorer = BucketedScorer(DeviceContext.create(device="cuda"),
                        rng.standard_normal((50, 4)).astype(np.float32),
                        rng.standard_normal((300, 4)).astype(np.float32), max_k=10)
out = {}
x = torch.zeros(4, device="cuda")
try:  # an index past the end: a device-side assert, sticky for the process
    x[torch.tensor([7], device="cuda")].sum().item()
except Exception as e:
    out["first"] = [c.__name__ for c in type(e).__mro__]
try:
    scorer.score_topk(np.array([1, 2], np.int32), 5)
except Exception as e:
    out["dispatch"] = {"type": type(e).__name__, "kernel_error": isinstance(e, KernelError),
                       "cause": [c.__name__ for c in type(e.__cause__).__mro__]
                       if e.__cause__ is not None else None}
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_a_sticky_card_error_reaches_the_fast_path_as_kernel_error(card):
    """After the card reports an error (sticky for the process), the fast
    path's next dispatch raises ``KernelError``, which the query server
    answers 500 and never serves a degraded answer for. Run in a process
    of its own: the error poisons the CUDA context."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-c", STICKY_PROBE], capture_output=True, text=True,
                       timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    print(out)
    assert "RuntimeError" in out["first"], out
    assert out["dispatch"]["kernel_error"], out


@pytest.mark.cuda
def test_score_kernel_refusals_are_kernel_errors(card):
    from predictionio_tpu_torch.ops._build import KernelError

    U = torch.zeros((10, 4), device=card)
    V = torch.zeros((64, 4), device=card)
    u = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(KernelError, match="out of range"):
        score_kernel.fused_gather_score_topk(U, V, u, 65)
    with pytest.raises(KernelError, match="dtype"):
        score_kernel.fused_gather_score_topk(U.double(), V.double(), u, 5)


# -- publish, resume and evaluate on the card ---------------------------------


def _small_als_model(n_users=300, n_items=700, rank=10, seed=5):
    rng = np.random.default_rng(seed)
    return als.als_model_from_arrays(
        rng.standard_normal((n_users, rank)).astype(np.float32),
        rng.standard_normal((n_items, rank)).astype(np.float32),
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)])


@pytest.mark.cuda
def test_batch_recommend_on_card_runs_the_kernel_in_top_rung_chunks(card):
    """On the card a batch builds the fast path on first use (whatever
    HOST_THRESHOLD says), warms its top rung only, and launches the score
    kernel once a chunk of 64."""
    m = _small_als_model()
    scorer = als.ALSScorer(DeviceContext.create(device=card), m)
    assert not scorer.on_device  # the catalog is below HOST_THRESHOLD
    score_kernel.launches.reset()
    users = np.arange(150)
    idx, vals = scorer.recommend_batch(users, 10)
    assert score_kernel.launches.count == 1 + 3  # the top rung's warm-up + ⌈150 / 64⌉
    s = torch.from_numpy(m.user_factors[users]) @ torch.from_numpy(m.item_factors).T
    rv, ri = torch.topk(s, 10, dim=1)
    assert not topk_mismatches(vals, idx, rv.numpy(), ri.numpy(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("num", [150, 700, 900])
def test_batch_recommend_on_card_past_the_serving_width(card, num):
    """A ``num`` past the fast path's width (100) scores on the card through
    a scorer of its own at that width, not on the host; the serving fast
    path keeps its width. ``num`` past the catalog serves the whole catalog."""
    m = _small_als_model()
    scorer = als.ALSScorer(DeviceContext.create(device=card), m)
    serving = scorer.enable_fastpath()
    k = min(num, m.item_factors.shape[0])
    score_kernel.launches.reset()
    users = np.arange(150)
    idx, vals = scorer.recommend_batch(users, num)
    assert score_kernel.launches.count == 1 + 3  # the wide scorer's warm-up + ⌈150 / 64⌉
    assert idx.shape == (150, k) and serving.k == 100 and scorer._wide_fastpath.k == k
    s = torch.from_numpy(m.user_factors[users]) @ torch.from_numpy(m.item_factors).T
    rv, ri = torch.topk(s, k, dim=1)
    assert not topk_mismatches(vals, idx, rv.numpy(), ri.numpy(), 1e-5)


@pytest.mark.cuda
def test_batch_recommend_on_card_past_the_kernel_limit_raises(card):
    from predictionio_tpu_torch.ops._build import KernelError

    rng = np.random.default_rng(2)
    n_items = score_kernel.MAX_K + 10
    m = als.als_model_from_arrays(
        rng.standard_normal((20, 4)).astype(np.float32),
        rng.standard_normal((n_items, 4)).astype(np.float32),
        [f"u{i}" for i in range(20)], [f"i{i}" for i in range(n_items)])
    scorer = als.ALSScorer(DeviceContext.create(device=card), m)
    with pytest.raises(KernelError, match=f"top-k limit {score_kernel.MAX_K}"):
        scorer.recommend_batch(np.arange(5), score_kernel.MAX_K + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "segment"])
def test_als_resume_on_card_equals_the_uninterrupted_run(card, tmp_path, solver):
    rng = np.random.default_rng(1)
    n = 20_000
    inter = interactions_from_arrays(
        rng.integers(0, 900, n), rng.zipf(1.3, n) % 400, rng.integers(1, 6, n).astype(np.float32),
        np.zeros(n), [f"u{i}" for i in range(900)], [f"i{i}" for i in range(400)])
    ctx = DeviceContext.create(device=card)
    kw = dict(rank=10, solver=solver, compute_dtype="f32", checkpoint_interval=5)
    full = als.train_als(ctx, inter, als.ALSConfig(iterations=20, **kw))
    d = str(tmp_path)
    als.train_als(ctx, inter, als.ALSConfig(iterations=10, checkpoint_dir=d, **kw))
    counter = train_kernel.launches if solver == "dense" else train_kernel.segment_launches
    counter.reset()
    resumed = als.train_als(ctx, inter, als.ALSConfig(iterations=20, checkpoint_dir=d, **kw))
    if solver == "segment":
        assert counter.count == 2 * 10
    np.testing.assert_array_equal(resumed.user_factors, full.user_factors)
    np.testing.assert_array_equal(resumed.item_factors, full.item_factors)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_checkpoint_publish_serves_the_quantized_variant_on_card(card, tmp_path, monkeypatch,
                                                                  dtype):
    from predictionio_tpu_torch.ops.quantize import factors_to_tensor, quantize_factors

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PIO_QUANT_DTYPE", dtype)
    m = _small_als_model()
    ck = als.CheckpointedALSModel(m.user_factors, m.item_factors, m.user_map, m.item_map, m.config)
    assert ck.save("inst", None)
    monkeypatch.delenv("PIO_QUANT_DTYPE")
    loaded = als.CheckpointedALSModel.load("inst", None, None)
    assert loaded.factor_dtype == dtype
    fp = als.ALSScorer(DeviceContext.create(device=card), loaded).enable_fastpath()
    assert fp.stats()["kernel"]["factor_dtype"] == dtype and fp.backend == "fused"
    users = np.arange(64)
    idx, vals = fp.score_topk(users, 20)
    uq, us = quantize_factors(m.user_factors, dtype)
    vq, vs = quantize_factors(m.item_factors, dtype)
    s = factors_to_tensor(uq, "cpu").float()[users] * (1.0 if us is None else torch.from_numpy(us[users]))
    s = s @ factors_to_tensor(vq, "cpu").float().T
    if vs is not None:
        s = s * torch.from_numpy(vs).reshape(1, -1)
    rv, ri = torch.topk(s, 20, dim=1)
    assert not topk_mismatches(vals, idx, rv.numpy(), ri.numpy(), 1e-5)


def _patch_pair(dtype, seed=23):
    """Base factors, the rows a delta writes over users 0..1999, and the
    scorers that serve each version alone (each answer is the kernel's own,
    so the live scorer's answers are compared bit for bit)."""
    from predictionio_tpu_torch.ops.quantize import quantize_factors

    rng = np.random.default_rng(seed)
    U = rng.standard_normal((5000, 10)).astype(np.float32)
    V = rng.standard_normal((3000, 10)).astype(np.float32)
    users = np.arange(2000)
    rows = rng.standard_normal((2000, 10)).astype(np.float32) * 2
    U2 = U.copy()
    U2[users] = rows
    return U, V, U2, users, rows, quantize_factors


def _scorer(card, U, V, dtype, quantize_factors):
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    uq, us = quantize_factors(U, dtype)
    vq, vs = quantize_factors(V, dtype)
    return BucketedScorer(DeviceContext.create(device=card), uq, vq, max_k=50,
                          factor_dtype=dtype, user_scale=us, item_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_a_delta_patch_never_reaches_a_launch_half_done(card, dtype):
    """Launches from eight threads while another patches 2,000 user rows
    back and forth: every batch's answer is the base scorer's or the
    patched scorer's, whole; never a mix of rows (or of int8 rows and
    their scales) from the two."""
    import threading

    U, V, U2, users, rows, qf = _patch_pair(dtype)
    live = _scorer(card, U, V, dtype, qf)
    want = {}
    for name, F in (("base", U), ("patched", U2)):
        s = _scorer(card, F, V, dtype, qf)
        want[name] = {b: s.score_topk(users[b * 64:(b + 1) * 64], 50) for b in range(31)}
    base_rows = U[users]
    stop, errors, seen = threading.Event(), [], {"base": 0, "patched": 0}

    def reader(t):
        rng = np.random.default_rng(t)
        while not stop.is_set():
            b = int(rng.integers(31))
            idx, vals = live.score_topk(users[b * 64:(b + 1) * 64], 50)
            for name in ("base", "patched"):
                wi, wv = want[name][b]
                if np.array_equal(idx, wi) and np.array_equal(vals, wv):
                    seen[name] += 1
                    break
            else:
                errors.append(b)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    try:
        for n in range(40):
            live.apply_delta_rows(users, rows if n % 2 == 0 else base_rows)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not errors, f"{len(errors)} answers matched neither version"
    assert seen["base"] and seen["patched"], seen


@pytest.mark.cuda
def test_int8_rows_and_scales_patch_together_on_card(card):
    """An int8 patch writes each row's codes and its scale as
    ``quantize_factors`` gives them, builds and warms nothing, and serves
    what a scorer built on the patched factors serves."""
    from predictionio_tpu_torch.ops import _build

    U, V, U2, users, rows, qf = _patch_pair("int8", seed=29)
    live = _scorer(card, U, V, "int8", qf)
    warm, builds = live.warmup_executions, len(_build.build_log)
    before = score_kernel.launches.count
    rc = live.apply_delta_rows(users, rows)
    assert rc["users"] == len(users) and rc["device_ms"] > 0
    assert (rc["warmup_executions"], rc["kernel_builds"]) == (warm, builds)
    assert score_kernel.launches.count == before  # a patch launches no kernel
    q, s = qf(rows, "int8")
    assert torch.equal(live._U[:2000].cpu(), torch.from_numpy(q))
    assert torch.equal(live._Uscale[:2000].cpu(), torch.from_numpy(s))
    fresh = _scorer(card, U2, V, "int8", qf)
    for b in range(0, 5000, 64):
        gi, gv = live.score_topk(np.arange(b, min(b + 64, 5000)), 50)
        ri, rv = fresh.score_topk(np.arange(b, min(b + 64, 5000)), 50)
        assert np.array_equal(gi, ri) and np.array_equal(gv, rv)


# -- kernel 1's probe-table mode (IVF retrieval) ----------------------------------------


def _probed_case(card, dtype, case, seed=31):
    """(U, V laid out, u, k, probes, gid, cap, mask, us, vs, tol, nlist) on the
    card: a catalog's k-means layout (``ops/ivf.py``) and a probe table."""
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.serving import sharding

    rng = np.random.default_rng(seed)
    n, nlist, batch, k, tol = 6000, 24, 64, 100, 1e-5
    U = rng.standard_normal((400, 10)).astype(np.float32)
    V = rng.standard_normal((n, 10)).astype(np.float32)
    if case == "tied":
        U = rng.integers(-2, 3, (400, 10)).astype(np.float32)
        V = rng.integers(-2, 3, (n, 10)).astype(np.float32)
        tol = 0.0 if dtype != "int8" else 1e-5
    elif case == "small-clusters":  # clusters of ~25 rows, k past one block
        n, nlist = 1500, 60
        V = V[:n]
    elif case == "k=600":  # the block route (k past WARP_MAX_K)
        k = 600
    elif case == "B=13":
        batch = 13
    index = ivf.build_index(V, nlist)
    layout = sharding.build_layout(index.plan, score_kernel.pad_block_items)
    Uq, us = quantize_factors_torch(torch.from_numpy(U).to(card), dtype)
    Vq, vs = quantize_factors_torch(torch.from_numpy(layout.take_rows(V)).to(card), dtype)
    if vs is not None:
        vs[torch.from_numpy(layout.pad_mask).to(card)] = 1.0
    sizes = index.plan.shard_sizes()
    order = rng.permutation(index.nlist)
    n_probes = int(np.searchsorted(np.cumsum(sizes[order]), k) + 1) + 3
    probes = torch.from_numpy(order[:n_probes].astype(np.int32)).to(card)
    u = torch.from_numpy(rng.integers(0, 400, batch).astype(np.int32)).to(card)
    return (Uq, Vq, u, k, probes, torch.from_numpy(layout.gid).to(card), layout.cap_pad,
            torch.from_numpy(layout.pad_mask).to(card), us, vs, tol, index)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ("random", "tied", "small-clusters", "k=600", "B=13"))
def test_probe_mode_matches_plain_version_in_one_launch_on_card(card, dtype, case):
    Uq, Vq, u, k, probes, gid, cap, mask, us, vs, tol, _ = _probed_case(card, dtype, case)
    before, ivf_before = score_kernel.launches.count, score_kernel.ivf_launches.count
    kv, ki = score_kernel.fused_probed_score_topk(Uq, Vq, u, k, probes, gid, cap, mask,
                                                  u_scale=us, v_scale=vs)
    rv, ri = score_kernel.probed_score_topk_reference(Uq, Vq, u, k, probes, gid, cap, mask,
                                                      u_scale=us, v_scale=vs)
    torch.cuda.synchronize()
    assert score_kernel.launches.count == before + 1
    assert score_kernel.ivf_launches.count == ivf_before + 1
    bad = topk_mismatches(kv.cpu().numpy(), ki.cpu().numpy(), rv.cpu().numpy(),
                          ri.cpu().numpy(), tol)
    assert not bad, bad[:3]
    assert int(ki.max()) < 2**31 - 1  # padding never wins
    kv2, ki2 = score_kernel.fused_probed_score_topk(Uq, Vq, u, k, probes, gid, cap, mask,
                                                    u_scale=us, v_scale=vs)
    assert torch.equal(kv, kv2) and torch.equal(ki, ki2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_full_probe_equals_the_exact_mode_bit_for_bit_on_card(card, dtype):
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    rng = np.random.default_rng(37)
    U = rng.standard_normal((500, 10)).astype(np.float32)
    V = rng.standard_normal((5000, 10)).astype(np.float32)
    Uq, us = quantize_factors(U, dtype)
    Vq, vs = quantize_factors(V, dtype)
    ctx = DeviceContext.create(device=str(card))
    kw = dict(max_k=100, factor_dtype=dtype, user_scale=us, item_scale=vs)
    exact = BucketedScorer(ctx, Uq, Vq, **kw)
    index = ivf.build_index(V, 32, nprobe=32)
    full = BucketedScorer(ctx, Uq, Vq, ivf_index=index, retrieval="ivf", **kw)
    for b in (1, 8, 16, 32, 64):
        users = rng.integers(0, 500, b)
        before = score_kernel.ivf_launches.count
        ei, ev = exact.score_topk(users, 100)
        fi, fv = full.score_topk(users, 100)
        assert score_kernel.ivf_launches.count == before + 1
        assert np.array_equal(ei, fi) and ev.tobytes() == fv.tobytes(), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("f32", "int8"))
def test_ivf_scorer_serves_the_plain_version_and_a_delta_on_card(card, dtype):
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    rng = np.random.default_rng(41)
    U = rng.standard_normal((500, 10)).astype(np.float32)
    V = rng.standard_normal((5000, 10)).astype(np.float32)
    index = ivf.build_index(V, 40)
    cpu, ctx = DeviceContext.create(device="cpu"), DeviceContext.create(device=str(card))

    def scorers(U, V):
        Uq, us = quantize_factors(U, dtype)
        Vq, vs = quantize_factors(V, dtype)
        kw = dict(max_k=100, factor_dtype=dtype, user_scale=us, item_scale=vs,
                  ivf_index=index, retrieval="ivf")
        return BucketedScorer(ctx, Uq, Vq, **kw), BucketedScorer(cpu, Uq, Vq, **kw)

    live, _ = scorers(U, V)
    users, items = np.arange(0, 500, 7), np.arange(0, 5000, 13)
    U2, V2 = U.copy(), V.copy()
    U2[users] = rng.standard_normal((len(users), 10)) * 2
    V2[items] = rng.standard_normal((len(items), 10)) * 2
    rc = live.apply_delta_rows(users, U2[users], items, V2[items])
    assert rc["users"] == len(users) and rc["items"] == len(items)
    _, plain = scorers(U2, V2)
    for b in (1, 8, 64):
        who = rng.integers(0, 500, b)
        (gi, gv), (ri, rv) = live.score_topk(who, 100), plain.score_topk(who, 100)
        assert not topk_mismatches(gv, gi, rv, ri, 1e-5), b


@pytest.mark.cuda
def test_probe_mode_refuses_what_it_does_not_take_on_card(card, monkeypatch):
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.ops._build import KernelError
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    Uq, Vq, u, k, probes, gid, cap, mask, us, vs, _, index = _probed_case(card, "f32", "random")
    with pytest.raises(KernelError, match="probes"):
        score_kernel.fused_probed_score_topk(Uq, Vq, u, k, probes.long(), gid, cap, mask)
    with pytest.raises(KernelError, match="blocks of"):
        score_kernel.fused_probed_score_topk(Uq, Vq, u, k, probes, gid, cap + 1, mask)
    monkeypatch.setattr(score_kernel, "MAX_PROBED_SLOTS", 100)
    rng = np.random.default_rng(2)
    with pytest.raises(KernelError, match="probe mode"):
        BucketedScorer(DeviceContext.create(device=str(card)),
                       rng.standard_normal((40, 10)).astype(np.float32),
                       rng.standard_normal((600, 10)).astype(np.float32), max_k=10,
                       ivf_index=ivf.build_index(rng.standard_normal((600, 10)).astype(
                           np.float32), 6), retrieval="ivf")


def _co_draw(seed, n_users, n_items, n_ratings):
    rng = np.random.default_rng(seed)
    p = (np.arange(1, n_items + 1) + 5.0) ** -1.1
    user = rng.integers(0, n_users, n_ratings)
    item = rng.choice(n_items, n_ratings, p=p / p.sum())
    return interactions_from_arrays(user, item, np.ones(n_ratings), np.zeros(n_ratings),
                                    (f"u{k}" for k in range(n_users)),
                                    (f"i{k}" for k in range(n_items)))


@pytest.mark.cuda
@pytest.mark.parametrize("operand_bytes", (None, 1 << 20))
def test_cross_occurrence_block_counts_are_exact_on_card(card, monkeypatch, operand_bytes):
    """int8 products on the card give the exact distinct-user counts (float64
    products of the dense 0/1 incidence on the host: exact integers), past
    bf16's 256 and over several user blocks and products."""
    from predictionio_tpu_torch.models import cooccurrence as co

    if operand_bytes is not None:
        monkeypatch.setattr(co, "_OPERAND_BYTES", operand_bytes)
    primary = _co_draw(1, 10_000, 700, 60_000)
    secondary = _co_draw(2, 10_000, 900, 150_000)
    ctx = DeviceContext.create(device=card)
    C = co.cross_occurrence_matrix(ctx, primary, secondary, 700, 900).cpu().numpy()
    a_p = np.zeros((10_000, 700))
    a_p[primary.user, primary.item] = 1.0
    a_s = np.zeros((10_000, 900))
    a_s[secondary.user, secondary.item] = 1.0
    want = a_p.T @ a_s
    assert want.max() > 256
    np.testing.assert_array_equal(C, want.astype(np.float32))


@pytest.mark.cuda
def test_scatter_padded_slot_at_origin_on_card(card):
    from predictionio_tpu_torch.models import cooccurrence as co

    lu = torch.tensor([[1, 2, 0, 0, 0]], dtype=torch.int32, device=card)
    li = torch.tensor([[0, 3, 0, 0, 0]], dtype=torch.int32, device=card)
    lm = torch.tensor([[1, 1, 0, 0, 0]], dtype=torch.float32, device=card)
    a = co._incidence(lu, li, lm, 8).cpu()
    want = torch.zeros_like(a)
    want[0, 1] = want[3, 2] = 1
    assert torch.equal(a, want)
    C = co.cross_occurrence_block(lu, li, lm, lu, li, lm, 128, 128).cpu()
    assert C[0, 0] == 1 and C[3, 3] == 1 and C.sum() == 2


@pytest.mark.cuda
def test_cross_occurrence_topn_on_card_follows_the_llr_rule(card):
    """The column-blocked LLR top-k on the card against float64 LLR of the
    exact counts (ROADMAP §3's LLR rule), with the diagonal excluded."""
    from predictionio_tpu_torch.models import cooccurrence as co
    from predictionio_tpu_torch.testing import (
        llr_atol,
        llr_reference64,
        llr_topk_mismatches,
    )

    inter = _co_draw(3, 6_000, 500, 40_000)
    pc = co.distinct_item_counts(inter, 500)
    idx, vals = co.cross_occurrence_topn(
        DeviceContext.create(device=card), inter, inter, 500, 500, n_users=6_000, k=20,
        primary_counts=pc, col_block=128, exclude_diagonal=True)
    a = np.zeros((6_000, 500))
    a[inter.user, inter.item] = 1.0
    ref = llr_reference64(a.T @ a, pc, pc, 6_000)
    np.fill_diagonal(ref, -1.0)
    bad = [m for j in range(500)
           for m in llr_topk_mismatches(idx[j], vals[j], ref[:, j], llr_atol(6_000))]
    assert not bad, bad[:5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("f32", "int8"))
@pytest.mark.parametrize("retrieval", ("exact", "ivf"))
def test_candidate_masked_rung1_launch_matches_plain_version_on_card(card, dtype, retrieval):
    """The pipeline's ranking stage: one launch at rung 1 under a candidate
    mask (and an exclusion) gives the plain version's answer, and
    ``ALSScorer.recommend(prefer_card=True)`` takes that launch below
    ``HOST_THRESHOLD``, up to ``MAX_FILTER`` candidates."""
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    rng = np.random.default_rng(41)
    U = rng.standard_normal((400, 10)).astype(np.float32)
    V = rng.standard_normal((6000, 10)).astype(np.float32)
    Uq, us = quantize_factors(U, dtype)
    Vq, vs = quantize_factors(V, dtype)
    kw = dict(max_k=100, factor_dtype=dtype, user_scale=us, item_scale=vs)
    if retrieval == "ivf":
        kw.update(ivf_index=ivf.build_index(V, 16, nprobe=4), retrieval="ivf")
    on_card = BucketedScorer(DeviceContext.create(device=str(card)), Uq, Vq, **kw)
    plain = BucketedScorer(DeviceContext.create(device="cpu"), Uq, Vq, **kw)
    for n_cand, k in ((1, 1), (37, 10), (2000, 100), (als.ALSScorer.MAX_FILTER // 8, 100)):
        cand = rng.choice(6000, size=min(n_cand, 6000), replace=False)
        excl = cand[: len(cand) // 10]
        u = int(rng.integers(0, 400))
        before = score_kernel.launches.count
        gi, gv = on_card.score_topk_filtered(u, k, excl, cand)
        assert score_kernel.launches.count == before + 1
        ri, rv = plain.score_topk_filtered(u, k, excl, cand)
        assert not topk_mismatches(gv[None], gi[None], rv[None], ri[None], 1e-5)
        keep = np.asarray(gv) > -1e29
        assert set(np.asarray(gi)[keep]) <= set(cand) - set(excl)
    model = als.als_model_from_arrays(U, V, [f"u{i}" for i in range(400)],
                                      [f"i{i}" for i in range(6000)])
    scorer = als.ALSScorer(DeviceContext.create(device=str(card)), model)
    assert not scorer.on_device  # below HOST_THRESHOLD
    scorer.enable_fastpath()
    cand = rng.choice(6000, size=500, replace=False)
    before = score_kernel.launches.count
    gi, gv = scorer.recommend(3, 20, candidate_items=cand, prefer_card=True)
    assert score_kernel.launches.count == before + 1
    hi, hv = scorer.recommend(3, 20, candidate_items=cand)  # the host's answer
    assert score_kernel.launches.count == before + 1
    assert not topk_mismatches(gv[None], gi[None], hv[None], hi[None], 1e-5)


FLEET_REPLICA_PROBE = """
import json, sys
sys.modules["jax"] = None
import numpy as np
import torch
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import _build, score_kernel
from predictionio_tpu_torch.serving.fastpath import BucketedScorer

rng = np.random.default_rng(5)
U = rng.standard_normal((300, 10)).astype(np.float32)
V = rng.standard_normal((4000, 10)).astype(np.float32)
scorer = BucketedScorer(DeviceContext.create(device="cuda"), U, V, max_k=50)
idx, vals = scorer.score_topk(np.arange(64), 50)
print(json.dumps({"build": _build.build_log["score_topk"][2] == "cached",
                  "launches": score_kernel.launches.count,
                  "idx": np.asarray(idx).tolist(), "vals": np.asarray(vals).tolist()}))
"""


@pytest.mark.cuda
def test_two_processes_launch_kernel_1_from_one_build_cache(card):
    """Two replica processes, each with its own CUDA context on one card,
    load kernel 1 from the one build cache at the same time (neither runs
    nvcc) and give the plain version's answer."""
    import subprocess
    import sys

    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    _build.build_all(("score_topk",))  # the cache the replicas find
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", FLEET_REPLICA_PROBE], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    rng = np.random.default_rng(5)
    U = rng.standard_normal((300, 10)).astype(np.float32)
    V = rng.standard_normal((4000, 10)).astype(np.float32)
    ri, rv = BucketedScorer(DeviceContext.create(device="cpu"), U, V, max_k=50).score_topk(
        np.arange(64), 50)
    for o in outs:
        assert o["build"] is True and o["launches"] >= 1
        assert not topk_mismatches(np.array(o["vals"]), np.array(o["idx"]), rv, ri, 1e-5)
    assert outs[0]["idx"] == outs[1]["idx"] and outs[0]["vals"] == outs[1]["vals"]


# -- the mesh on one card: sharded serving and the ring (repeated placements) ----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("host_groups", (1, 2))
def test_sharded_rungs_equal_replicated_with_a_launch_a_shard_on_card(card, dtype, host_groups):
    """A plan of 4 shards on ``[cuda:0] * 4``: every rung equals the
    replicated exact kernel path bit for bit, and a dispatch launches kernel
    1 once a shard (4 × dispatches), flat or two-tier merged."""
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving import sharding
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    rng = np.random.default_rng(53)
    U = rng.standard_normal((500, 10)).astype(np.float32)
    V = rng.standard_normal((5003, 10)).astype(np.float32)
    Uq, us = quantize_factors(U, dtype)
    Vq, vs = quantize_factors(V, dtype)
    kw = dict(max_k=100, factor_dtype=dtype, user_scale=us, item_scale=vs)
    plan = sharding.build_plan(5003, 4, weights=np.linalg.norm(V, axis=1), host_groups=host_groups)
    repl = BucketedScorer(DeviceContext.create(device=str(card)), Uq, Vq, **kw)
    shrd = BucketedScorer(DeviceContext.create(devices=[card] * 4), Uq, Vq, plan=plan, **kw)
    assert shrd.sharding == "sharded" and shrd._pod == (host_groups > 1)
    for b in (1, 8, 16, 32, 64):
        users = rng.integers(0, 500, b)
        ri, rv = repl.score_topk(users, 100)
        before = score_kernel.launches.count
        si, sv = shrd.score_topk(users, 100)
        assert score_kernel.launches.count == before + 4, b
        assert np.array_equal(ri, si) and rv.tobytes() == sv.tobytes(), b
    excl = np.arange(0, 5003, 3)
    before = score_kernel.launches.count
    got = shrd.score_topk_filtered(7, 100, excl, None)
    assert score_kernel.launches.count == before + 4
    want = repl.score_topk_filtered(7, 100, excl, None)
    assert np.array_equal(got[0], want[0]) and got[1].tobytes() == want[1].tobytes()


@pytest.mark.cuda
def test_sharded_delta_rows_on_card(card):
    from predictionio_tpu_torch.serving import sharding
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    rng = np.random.default_rng(59)
    U = rng.standard_normal((300, 10)).astype(np.float32)
    V = rng.standard_normal((3000, 10)).astype(np.float32)
    plan = sharding.build_plan(3000, 4, strategy="round_robin")
    shrd = BucketedScorer(DeviceContext.create(devices=[card] * 4), U, V, max_k=50, plan=plan)
    users, items = np.arange(0, 300, 7), np.arange(0, 3000, 11)
    U2, V2 = U.copy(), V.copy()
    U2[users] = rng.standard_normal((len(users), 10)) * 2
    V2[items] = rng.standard_normal((len(items), 10)) * 2
    shrd.apply_delta_rows(users, U2[users], items, V2[items])
    plain = BucketedScorer(DeviceContext.create(device="cpu"), U2, V2, max_k=50)
    for b in (1, 8, 64):
        who = rng.integers(0, 300, b)
        (gi, gv), (ri, rv) = shrd.score_topk(who, 50), plain.score_topk(who, 50)
        assert not topk_mismatches(gv, gi, rv, ri, 1e-5), b


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (True, False))
def test_ring_flash_launches_once_a_live_pair_and_matches_the_whole_kernel_on_card(card, causal):
    """``ring_flash_attention`` over ``[cuda:0] * 4``: kernels 4, 5 and 6
    launch once per live block pair (10 each causal, 16 full), and o and
    the gradients match the whole-sequence flash kernel (2e-5; 2e-4 /
    2e-5)."""
    from predictionio_tpu_torch.parallel import ring
    from predictionio_tpu_torch.parallel.mesh import MeshContext

    mesh = MeshContext.create(devices=[card] * 4)
    g = torch.Generator(device="cpu").manual_seed(61)
    q, k, v, w = (torch.randn(2, 4, 512, 32, generator=g).to(card) for _ in range(4))
    pairs = 10 if causal else 16
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    counts = [c.count for c in (flash_attention.launches, flash_attention.bwd_dq_launches,
                                flash_attention.bwd_dkv_launches)]
    out = ring.ring_flash_attention(mesh, qs, ks, vs, causal=causal)
    (out * w).sum().backward()
    torch.cuda.synchronize(card)
    got = [c.count - n for c, n in zip((flash_attention.launches, flash_attention.bwd_dq_launches,
                                        flash_attention.bwd_dkv_launches), counts)]
    assert got == [pairs, pairs, pairs]
    qw, kw, vw = (x.clone().requires_grad_(True) for x in (q, k, v))
    whole = flash_attention.flash_attention(qw, kw, vw, causal=causal)
    (whole * w).sum().backward()
    torch.testing.assert_close(out, whole, rtol=2e-5, atol=2e-5)
    for a, b in ((qs, qw), (ks, kw), (vs, vw)):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_ulysses_flash_and_sasrec_sp_on_card(card):
    """Ulysses with the flash local attention (kernel 4 once a placement)
    matches the dense attention, and a SASRec SP step's loss on a {data 1,
    model 2} mesh of the card equals the data-parallel loss (rtol 1e-5)."""
    from predictionio_tpu_torch.parallel import ring, ulysses
    from predictionio_tpu_torch.parallel.mesh import MeshContext

    mesh = MeshContext.create(devices=[card] * 4)
    g = torch.Generator(device="cpu").manual_seed(67)
    q, k, v = (torch.randn(8, 1024, 64, generator=g).to(card) for _ in range(3))
    before = flash_attention.launches.count
    out = ulysses.ulysses_attention(mesh, q, k, v, causal=True, use_flash=True)
    assert flash_attention.launches.count == before + 4
    torch.testing.assert_close(out, ring.full_attention(q, k, v, causal=True), rtol=2e-5, atol=2e-5)

    cfg = sequential.SASRecConfig(d_model=16, n_heads=2, n_layers=1, max_len=16)
    params = sequential.init_params(0, cfg, 30)
    rng = np.random.default_rng(1)
    s = np.zeros((8, 17), np.int64)
    s[:, 4:] = rng.integers(1, 31, size=(8, 13))
    st = torch.from_numpy(s).to(card)
    net = sequential.SASRecNet(params, cfg, card, trainable=True)
    sp2 = MeshContext.create(axes={"data": 1, "model": 2}, devices=[card] * 2)
    sp = sequential._build_sp_loss(sp2, 2, cfg)(net.tree(), st[:, :-1], st[:, 1:])
    dense = sequential._loss_fn(net.tree(), st, cfg)
    np.testing.assert_allclose(float(sp), float(dense), rtol=1e-5)
