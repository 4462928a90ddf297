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
