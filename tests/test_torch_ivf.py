"""IVF retrieval in the port, held against the JAX package on the CPU.

* k-means (``train_kmeans``) and ``build_index`` give the JAX package's
  centroids, assignment and fingerprint bit for bit; ``IVFIndex`` and
  ``ShardingPlan`` payloads (and sealed ``ivf.blob`` files) cross both ways;
  ``measure_recall``, ``recall_at_k`` and ``resolve_retrieval`` answer as
  the JAX package's do;
* the port's ``BucketedScorer(retrieval="ivf")`` (CPU tensors, so the
  probe-table mode's plain version) against the JAX scorer's XLA
  ``reference`` backend at f32, bf16 and int8 and rungs 1, 8 and 64: values
  within rtol = atol = 1e-5, indices by ``topk_mismatches`` (exactly equal
  on integer-valued factors), the ``retrieval`` stats block equal;
* with every cluster probed the IVF scorer equals the port's exact scorer
  bit for bit at every rung and dtype; a numpy replay of the kernel's
  probe-mode selection (one top-k over the probed slots by value, then
  global id) equals the plain version (per-probe top-k, then merge);
* ``min_probes`` keeps padding out of the answers, ``PIO_IVF_NPROBE`` is
  clamped, an index the probe mode cannot take raises ``KernelError``
  when the scorer is built;
* the publish lifecycle of ``CheckpointedALSModel`` against the JAX
  package's: seal, load, refusal receipt, torn or missing blob, fingerprint
  mismatch, ``PIO_RETRIEVAL=exact``; a JAX auto-mode blob carrying an index
  loads and answers as the JAX scorer does; ``bridge_ivf``; an IVF delta;
* ``pio train`` under ``PIO_IVF_NLIST``, ``pio deploy --batching``, ``pio
  ivf show`` and ``pio ivf rebuild`` with ``POST /reload`` through the CLI.
"""

import dataclasses
import json
import os
import pickle
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core import evaluation as jax_evaluation
from predictionio_tpu.core import persistence as jax_persistence
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.obs import bridges as jax_bridges
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.ops import ivf as jax_ivf
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving import sharding as jax_sharding
from predictionio_tpu.serving.fastpath import BucketedScorer as JaxBucketedScorer
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import evaluation, persistence
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.obs import bridges
from predictionio_tpu_torch.obs import metrics as port_metrics
from predictionio_tpu_torch.ops import ivf, quantize, score_kernel
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.serving import sharding
from predictionio_tpu_torch.serving.fastpath import BucketedScorer
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli

TOL = 1e-5
DTYPES = ("f32", "bf16", "int8")
RUNGS = (1, 8, 64)
CPU = DeviceContext.create(device="cpu")
ENV = ("PIO_RETRIEVAL", "PIO_IVF_NLIST", "PIO_IVF_NPROBE", "PIO_IVF_MIN_RECALL",
       "PIO_IVF_EVAL_USERS", "PIO_QUANT_DTYPE", "PIO_QUANT_MIN_OVERLAP", "PIO_SHARD_COUNT",
       "PIO_SHARD_HBM_BUDGET")


@pytest.fixture(scope="module")
def jax_ctx():
    return MeshContext.create()


@pytest.fixture()
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _clustered(n_items=96, rank=8, nlist=6, seed=7, n_users=64):
    """A well-separated Gaussian mixture (the JAX tests' catalog)."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(nlist, rank)) * 4.0).astype(np.float32)
    V = (centers[rng.integers(0, nlist, size=n_items)]
         + rng.normal(size=(n_items, rank)) * 0.25).astype(np.float32)
    U = (centers[rng.integers(0, nlist, size=n_users)]
         + rng.normal(size=(n_users, rank)) * 0.25).astype(np.float32)
    return U, V


def _random(n_users=60, n_items=40, rank=8, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, rank)).astype(np.float32),
            rng.standard_normal((n_items, rank)).astype(np.float32))


# -- k-means, index, payloads ------------------------------------------------------


def _kmeans_inputs():
    rng = np.random.default_rng(0)
    return {
        "clustered": (_clustered()[1], 6),
        "wide": (_clustered(n_items=400, nlist=8)[1], 8),
        "blob": ((rng.normal(size=(64, 4)) * 0.01 + 5.0).astype(np.float32), 4),
        "duplicates": (np.repeat(np.eye(3, dtype=np.float32), 5, axis=0), 8),
        "random": (_random(n_items=300)[1], 17),
    }


@pytest.mark.parametrize("case", sorted(_kmeans_inputs()))
def test_kmeans_and_index_equal_jax_bit_for_bit(case):
    V, nlist = _kmeans_inputs()[case]
    pc, pa = ivf.train_kmeans(V, nlist, seed=3)
    jc, ja = jax_ivf.train_kmeans(V, nlist, seed=3)
    assert pc.tobytes() == jc.tobytes() and pa.tobytes() == ja.tobytes()
    pi, ji = ivf.build_index(V, nlist), jax_ivf.build_index(V, nlist)
    assert pi.fingerprint == ji.fingerprint
    assert pi.plan.fingerprint == ji.plan.fingerprint
    assert pi.describe() == ji.describe()
    assert pi.to_payload() == ji.to_payload()


def test_nlist_bounds_raise_as_jax():
    V = _clustered()[1]
    for nlist in (0, len(V) + 1):
        with pytest.raises(ValueError):
            jax_ivf.train_kmeans(V, nlist)
        with pytest.raises(ValueError):
            ivf.train_kmeans(V, nlist)


def test_payloads_cross_both_ways(tmp_path):
    V = _clustered()[1]
    pi = dataclasses.replace(ivf.build_index(V, 6, nprobe=2), recall_at_publish=0.97,
                             recall_threshold=0.95, recall_k=10)
    ji = dataclasses.replace(jax_ivf.build_index(V, 6, nprobe=2), recall_at_publish=0.97,
                             recall_threshold=0.95, recall_k=10)
    assert pi.to_payload() == ji.to_payload()
    assert pi.plan.to_payload() == ji.plan.to_payload()
    back = ivf.IVFIndex.from_payload(ji.to_payload())
    assert back.fingerprint == ji.fingerprint and back.describe() == ji.describe()
    assert jax_ivf.IVFIndex.from_payload(pi.to_payload()).describe() == pi.describe()
    plan = sharding.ShardingPlan.from_payload(ji.plan.to_payload())
    assert plan.describe() == ji.plan.describe()
    jplan = jax_sharding.ShardingPlan.from_payload(pi.plan.to_payload())
    assert jplan.describe() == pi.plan.describe()
    # sealed blobs: each package opens the other's ivf.blob
    jax_ivf.save_index(str(tmp_path / "j.blob"), ji)
    ivf.save_index(str(tmp_path / "p.blob"), pi)
    assert ivf.load_index(str(tmp_path / "j.blob")).fingerprint == ji.fingerprint
    assert jax_ivf.load_index(str(tmp_path / "p.blob")).fingerprint == pi.fingerprint
    assert (tmp_path / "j.blob").read_bytes() == (tmp_path / "p.blob").read_bytes()


def test_torn_blob_raises_integrity(tmp_path):
    path = str(tmp_path / "ivf.blob")
    ivf.save_index(path, ivf.build_index(_clustered()[1], 6))
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-7] + b"XXXXXXX")
    with pytest.raises(persistence.ModelIntegrityError):
        ivf.load_index(path)


def test_layout_equals_jax():
    V = _clustered(n_items=200)[1]
    plan = ivf.build_index(V, 9).plan
    jplan = jax_ivf.build_index(V, 9).plan
    got = sharding.build_layout(plan, score_kernel.pad_block_items)
    want = jax_sharding.build_layout(jplan, score_kernel.pad_block_items)
    assert got.cap_pad == want.cap_pad
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.gid, want.gid)
    np.testing.assert_array_equal(got.pad_mask, want.pad_mask)
    np.testing.assert_array_equal(got.take_rows(V, fill=7.0), want.take_rows(V, fill=7.0))
    assert sharding.PAD_SENTINEL == jax_sharding.PAD_SENTINEL


@pytest.mark.parametrize("nprobe", [1, 2, 6])
def test_measure_recall_equals_jax(nprobe):
    U, V = _random(n_users=90, n_items=150)
    index, jindex = ivf.build_index(V, 6), jax_ivf.build_index(V, 6)
    for k, sample in ((10, 256), (5, 17)):
        got = ivf.measure_recall(U, V, index, k=k, sample=sample, nprobe=nprobe)
        want = jax_ivf.measure_recall(U, V, jindex, k=k, sample=sample, nprobe=nprobe)
        assert got == want
    assert ivf.measure_recall(U, V, index, k=10, nprobe=index.nlist) == 1.0


def test_recall_at_k_equals_jax():
    rng = np.random.default_rng(2)
    exact = rng.integers(0, 50, (20, 12))
    approx = rng.integers(0, 50, (20, 12))
    approx[3, :5] = -1
    approx[4, 2:] = int(sharding.PAD_SENTINEL)
    exact[5] = -1  # nothing retrievable: 1.0
    for k in (1, 5, 10, 12):
        assert evaluation.recall_at_k(exact, approx, k) == jax_evaluation.recall_at_k(
            exact, approx, k)
    with pytest.raises(ValueError, match="row mismatch"):
        evaluation.recall_at_k(exact, approx[:3], 5)


@pytest.mark.parametrize("requested,has_index,env", [
    (None, True, None), (None, False, None), ("exact", True, None), ("ivf", True, None),
    ("auto", True, None), ("auto", False, None), (None, True, "exact"), (None, True, "IVF "),
    ("ivf", False, None), ("bogus", True, None), (None, True, "bogus"),
])
def test_resolve_retrieval_answers_as_jax(clean_env, requested, has_index, env):
    if env is not None:
        clean_env.setenv("PIO_RETRIEVAL", env)
    index = object() if has_index else None

    def outcome(fn):
        try:
            return fn(requested, index=index)
        except ValueError as e:
            return ("ValueError", re.sub(r"\S+$", "", str(e)))

    assert outcome(ivf.resolve_retrieval) == outcome(jax_ivf.resolve_retrieval)


def test_index_from_env(clean_env):
    V = _clustered()[1]
    assert ivf.index_from_env(V) is None
    clean_env.setenv("PIO_IVF_NLIST", "6")
    clean_env.setenv("PIO_IVF_NPROBE", "3")
    index = ivf.index_from_env(V)
    assert index.nlist == 6 and index.nprobe == 3
    assert index.fingerprint == jax_ivf.index_from_env(V).fingerprint


# -- serving: the port's scorer against the JAX scorer ---------------------------------


def _pair(jax_ctx, U, V, dtype, nlist, nprobe, max_k=10, **kw):
    """(port IVF scorer, JAX reference IVF scorer) over the same factors."""
    jU, jus = jax_quantize.quantize_factors(U, dtype)
    jV, jvs = jax_quantize.quantize_factors(V, dtype)
    pU, _ = quantize.quantize_factors(U, dtype)
    pV, _ = quantize.quantize_factors(V, dtype)
    port = BucketedScorer(CPU, pU, pV, max_k=max_k, factor_dtype=dtype, user_scale=jus,
                          item_scale=jvs, ivf_index=ivf.build_index(V, nlist, nprobe=nprobe),
                          retrieval="ivf", **kw)
    ref = JaxBucketedScorer(jax_ctx, jU, jV, max_k=max_k, factor_dtype=dtype, user_scale=jus,
                            item_scale=jvs, backend="reference",
                            ivf_index=jax_ivf.build_index(V, nlist, nprobe=nprobe),
                            retrieval="ivf", **kw)
    return port, ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_scorer_matches_jax_at_every_rung(jax_ctx, clean_env, dtype):
    U, V = _clustered(n_items=300, nlist=12, n_users=80)
    port, ref = _pair(jax_ctx, U, V, dtype, nlist=12, nprobe=2)
    rng = np.random.default_rng(11)
    for b in RUNGS:
        users = rng.integers(0, len(U), b)
        (gi, gv), (ri, rv) = port.score_topk(users, 10), ref.score_topk(users, 10)
        bad = topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), TOL)
        assert not bad, (b, bad[:3])
    ps, rs = port.stats()["retrieval"], ref.stats()["retrieval"]
    assert ps == rs
    assert port.stats()["retrieval_backend"] == "ivf"


def test_integer_valued_ivf_indices_equal_jax_exactly(jax_ctx, clean_env):
    # every dot product is exact: ties abound and their order must be lax.top_k's
    rng = np.random.default_rng(4)
    U = rng.integers(-2, 3, (40, 4)).astype(np.float32)
    V = rng.integers(-2, 3, (120, 4)).astype(np.float32)
    port, ref = _pair(jax_ctx, U, V, "f32", nlist=7, nprobe=2, max_k=20)
    for b in RUNGS:
        users = rng.integers(0, len(U), b)
        (gi, gv), (ri, rv) = port.score_topk(users, 20), ref.score_topk(users, 20)
        assert not topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_probe_equals_the_exact_scorer_bit_for_bit(clean_env, dtype):
    U, V = _clustered()
    Uq, us = quantize.quantize_factors(U, dtype)
    Vq, vs = quantize.quantize_factors(V, dtype)
    kw = dict(max_k=10, factor_dtype=dtype, user_scale=us, item_scale=vs)
    exact = BucketedScorer(CPU, Uq, Vq, **kw)
    pruned = BucketedScorer(CPU, Uq, Vq, ivf_index=ivf.build_index(V, 6, nprobe=6),
                            retrieval="ivf", **kw)
    assert pruned.retrieval == "ivf" and exact.retrieval == "exact"
    for b in (1, 8, 16, 32, 64):
        users = np.arange(b) % len(U)
        ei, ev = exact.score_topk(users, 10)
        pi, pv = pruned.score_topk(users, 10)
        assert np.array_equal(ei, pi) and ev.tobytes() == pv.tobytes(), b


def _replay_probe_mode(U, V, u_idx, k, probes, gid, cap, mask):
    """The kernel's probe mode in numpy: one top-k over every probed slot by
    (value desc, global id asc), masked slots at -1e30 (the scores are the
    float32 products of the whole layout, taken by column)."""
    rows = np.concatenate([np.arange(p * cap, (p + 1) * cap) for p in probes])
    s = (torch.from_numpy(U)[torch.from_numpy(u_idx).long()] @ torch.from_numpy(V).T).numpy()
    s = s[:, rows]
    s[:, mask[rows]] = np.float32(-1e30)
    g = gid[rows]
    out_v, out_i = [], []
    for r in range(len(u_idx)):
        order = np.lexsort((g, -s[r].astype(np.float64)))[:k]
        out_v.append(s[r, order])
        out_i.append(g[order])
    return np.array(out_v), np.array(out_i)


@pytest.mark.parametrize("case", ["random", "ties", "small-clusters"])
def test_probe_mode_selection_equals_the_per_probe_merge(case):
    rng = np.random.default_rng(9)
    if case == "ties":
        U = rng.integers(-2, 3, (16, 4)).astype(np.float32)
        V = rng.integers(-2, 3, (90, 4)).astype(np.float32)
    else:
        U, V = (x[:, :4] for x in _random(n_users=16, n_items=90))
    nlist = 30 if case == "small-clusters" else 5  # clusters of ~3 < k
    k = 12
    index = ivf.build_index(V, nlist)
    layout = sharding.build_layout(index.plan, score_kernel.pad_block_items)
    Vl = layout.take_rows(V)
    gid, mask, cap = layout.gid, layout.pad_mask, layout.cap_pad
    u_idx = rng.integers(0, len(U), 9).astype(np.int32)
    sizes = index.plan.shard_sizes()
    for n_probes in range(1, index.nlist + 1):
        probes = rng.permutation(index.nlist)[:n_probes]
        if sizes[probes].sum() < k:
            continue  # the scorer never probes fewer real items than k (min_probes)
        want_v, want_i = _replay_probe_mode(U, Vl, u_idx, k, probes, gid, cap, mask)
        got_v, got_i = score_kernel.probed_score_topk_reference(
            torch.from_numpy(U), torch.from_numpy(Vl), torch.from_numpy(u_idx), k,
            torch.from_numpy(probes.astype(np.int32)), torch.from_numpy(gid), cap,
            torch.from_numpy(mask))
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_select_probes_is_lax_order():
    # tied centroid scores go to the smaller cluster id, as lax.top_k sends them
    C = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [2.0, 0.0]])
    U = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    got = score_kernel.select_probes(U, torch.tensor([0, 1], dtype=torch.int32), C, 3)
    assert got.dtype == torch.int32 and got.tolist() == [3, 0, 1]


def test_select_probes_leaves_the_tf32_flag_alone_across_threads():
    # serving threads pick probes on every dispatch: none may switch the
    # process-global TF32 flag, which other threads' matmuls read
    import threading

    rng = np.random.default_rng(5)
    U = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    u = torch.arange(16, dtype=torch.int32)
    want = score_kernel.select_probes(U, u, C, 5).tolist()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    seen, answers = set(), []

    def worker():
        for _ in range(300):
            answers.append(score_kernel.select_probes(U, u, C, 5).tolist())
            seen.add(torch.backends.cuda.matmul.allow_tf32)

    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cuda.matmul.allow_tf32 is True and seen == {True}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert len(answers) == 600 and all(a == want for a in answers)


def test_probe_budget_widens_with_rung_and_clamps(jax_ctx, clean_env):
    U, V = _clustered()
    port, ref = _pair(jax_ctx, U, V, "f32", nlist=6, nprobe=2)
    probes = port.stats()["retrieval"]["probes_per_rung"]
    assert probes == ref.stats()["retrieval"]["probes_per_rung"]
    assert probes["1"] >= 2 and probes["64"] == 6


def test_min_probes_keeps_padding_out_of_topk(jax_ctx, clean_env):
    rng = np.random.default_rng(5)
    centers = (rng.normal(size=(12, 4)) * 4.0).astype(np.float32)
    V = (np.repeat(centers, 4, axis=0) + rng.normal(size=(48, 4)) * 0.1).astype(np.float32)
    U = centers[:3].copy()
    port, ref = _pair(jax_ctx, U, V, "f32", nlist=12, nprobe=1)
    st = port.stats()["retrieval"]
    assert st["min_probes"] >= 3 and st["min_probes"] == ref.stats()["retrieval"]["min_probes"]
    idx, vals = port.score_topk(np.arange(3), 10)
    assert idx.min() >= 0 and idx.max() < 48 and np.isfinite(vals).all()
    ri, rv = ref.score_topk(np.arange(3), 10)
    assert not topk_mismatches(vals, idx, np.asarray(rv), np.asarray(ri), TOL)


def test_deploy_nprobe_override_clamped(clean_env):
    U, V = _clustered()
    index = ivf.build_index(V, 6, nprobe=2)
    clean_env.setenv("PIO_IVF_NPROBE", "999")
    sc = BucketedScorer(CPU, U, V, max_k=5, ivf_index=index, retrieval="ivf")
    assert sc.stats()["retrieval"]["nprobe"] == 6
    clean_env.setenv("PIO_IVF_NPROBE", "0")
    sc = BucketedScorer(CPU, U, V, max_k=5, ivf_index=index, retrieval="ivf")
    assert sc.stats()["retrieval"]["nprobe"] == 1


def test_an_index_the_probe_mode_cannot_take_raises_at_build(clean_env, monkeypatch):
    U, V = _clustered()
    index = ivf.build_index(V, 6)
    with pytest.raises(KernelError, match="k=9000"):
        score_kernel.check_probe_plan(4, 4096, 4, 9000, 10)
    with pytest.raises(KernelError, match="rank 300"):
        score_kernel.check_probe_plan(4, 64, 4, 10, 300)
    monkeypatch.setattr(score_kernel, "MAX_PROBED_SLOTS", 50)
    with pytest.raises(KernelError, match="probe mode"):
        BucketedScorer(CPU, U, V, max_k=5, ivf_index=index, retrieval="ivf")


def test_a_sharding_plan_raises_naming_item_10(clean_env, caplog):
    """Sharded serving is ported: an IVF index under a plan that serves
    sharded serves exact sharded with the JAX package's warning, and its
    answers equal the exact replicated scorer's bit for bit."""
    U, V = _clustered()
    mesh = DeviceContext.create(devices=["cpu"] * 4)
    plan = sharding.build_plan(len(V), 4)
    fp = BucketedScorer(mesh, U, V, max_k=5, plan=plan, ivf_index=ivf.build_index(V, 6),
                        retrieval="ivf")
    assert (fp.sharding, fp.retrieval) == ("sharded", "exact")
    assert "serving exact sharded" in caplog.text
    exact = BucketedScorer(CPU, U, V, max_k=5)
    users = np.arange(len(U))
    (si, sv), (ei, ev) = fp.score_topk(users, 5), exact.score_topk(users, 5)
    assert np.array_equal(si, ei) and sv.tobytes() == ev.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_filtered_per_query_calls_stay_exact_under_ivf(clean_env, dtype):
    U, V = _clustered(n_items=150)
    Uq, us = quantize.quantize_factors(U, dtype)
    Vq, vs = quantize.quantize_factors(V, dtype)
    kw = dict(max_k=10, factor_dtype=dtype, user_scale=us, item_scale=vs)
    exact = BucketedScorer(CPU, Uq, Vq, **kw)
    pruned = BucketedScorer(CPU, Uq, Vq, ivf_index=ivf.build_index(V, 6, nprobe=1),
                            retrieval="ivf", **kw)
    excl, cand = np.arange(0, 150, 3), np.arange(40, 140)
    for u in range(5):
        for args in ((excl, None), (None, cand), (excl, cand)):
            ei, ev = exact.score_topk_filtered(u, 10, *args)
            pi, pv = pruned.score_topk_filtered(u, 10, *args)
            assert np.array_equal(ei, pi) and ev.tobytes() == pv.tobytes()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_ivf_delta_rows_equal_jax_apply(jax_ctx, clean_env, dtype):
    U, V = _clustered(n_items=200, nlist=8, n_users=50)
    port, ref = _pair(jax_ctx, U, V, dtype, nlist=8, nprobe=2)
    rng = np.random.default_rng(3)
    users = np.array([1, 7, 30], np.int32)
    items = np.array([0, 55, 199, 120], np.int32)
    u_rows = rng.normal(size=(3, 8)).astype(np.float32) * 4
    i_rows = rng.normal(size=(4, 8)).astype(np.float32) * 4
    got = port.apply_delta_rows(users, u_rows, items, i_rows)
    ref.apply_delta_rows(users, u_rows, items, i_rows)
    assert got["users"] == 3 and got["items"] == 4
    for b in RUNGS:
        who = np.concatenate([users, rng.integers(0, len(U), b)])[:b]
        (gi, gv), (ri, rv) = port.score_topk(who, 10), ref.score_topk(who, 10)
        assert not topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), TOL), b
    # the patched item rows sit in their cluster slots, the layout untouched
    slots = port._layout_slots()
    Vl = port._V.float().numpy()
    if dtype == "f32":
        np.testing.assert_array_equal(Vl[slots[items]], i_rows)
    assert port.stats()["retrieval"]["fingerprint"] == ref.stats()["retrieval"]["fingerprint"]


# -- publish lifecycle -----------------------------------------------------------------


def _publish(pkg, tmp_path, monkeypatch, iid, env, U, V):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod, bimap = (jax_als, JaxBiMap) if pkg == "jax" else (als, BiMap)
    m = mod.CheckpointedALSModel(U, V, bimap.string_int(f"u{i}" for i in range(len(U))),
                                 bimap.string_int(f"i{i}" for i in range(len(V))), None)
    assert m.save(iid, None) is True
    d = mod.CheckpointedALSModel._dir(iid)
    with open(os.path.join(d, "maps.pkl"), "rb") as f:
        meta = pickle.load(f)
    return d, meta


_GATE = {"PIO_IVF_NLIST": "8", "PIO_IVF_NPROBE": "8"}  # full probe: recall 1.0


@pytest.mark.parametrize("case", ["seal", "refuse", "default-nprobe", "unset"])
def test_publish_records_equal_jax(tmp_path, clean_env, case):
    U, V = _clustered(n_items=160, nlist=8, n_users=70)
    env = {"seal": _GATE, "refuse": dict(_GATE, PIO_IVF_MIN_RECALL="1.01"),
           "default-nprobe": {"PIO_IVF_NLIST": "8", "PIO_IVF_MIN_RECALL": "0"},
           "unset": {}}[case]
    jd, jmeta = _publish("jax", tmp_path, clean_env, "inst", env, U, V)
    pd, pmeta = _publish("port", tmp_path, clean_env, "inst", env, U, V)
    assert pmeta["ivf"] == jmeta["ivf"]
    assert pmeta["sharding"] == jmeta["sharding"] == {"n_shards": 0}
    sealed = os.path.exists(os.path.join(pd, "ivf.blob"))
    assert sealed == os.path.exists(os.path.join(jd, "ivf.blob")) == (case in (
        "seal", "default-nprobe"))
    if sealed:
        assert (open(os.path.join(pd, "ivf.blob"), "rb").read()
                == open(os.path.join(jd, "ivf.blob"), "rb").read())
    if case == "refuse":
        assert pmeta["ivf"]["refused"] == 8 and pmeta["ivf"]["nlist"] == 0


@pytest.mark.parametrize("threshold", ["0.95", "1.01"])
def test_gate_index_record_equals_jax_publish(tmp_path, clean_env, threshold):
    # publish and `pio ivf rebuild` share gate_index: its record is JAX's
    U, V = _clustered(n_items=160, nlist=8, n_users=70)
    _, jmeta = _publish("jax", tmp_path, clean_env, "inst",
                        dict(_GATE, PIO_IVF_MIN_RECALL=threshold), U, V)
    sealed, record = ivf.gate_index(U, V, ivf.build_index(V, 8, nprobe=8), float(threshold))
    assert record == jmeta["ivf"]
    assert (sealed is None) == (threshold == "1.01")
    if sealed is not None:
        assert (sealed.recall_at_publish, sealed.recall_threshold, sealed.recall_k) == (
            1.0, 0.95, 10)
        assert sealed.fingerprint == record["fingerprint"]


@pytest.mark.parametrize("damage", ["none", "corrupt", "missing", "fingerprint", "exact-env"])
def test_deploy_degrades_as_jax(tmp_path, clean_env, jax_ctx, damage):
    U, V = _random(n_users=60, n_items=120)
    loaded = {}
    for pkg in ("jax", "port"):
        d, _ = _publish(pkg, tmp_path, clean_env, "inst", _GATE, U, V)
        blob, maps = os.path.join(d, "ivf.blob"), os.path.join(d, "maps.pkl")
        if damage == "corrupt":
            data = open(blob, "rb").read()
            with open(blob, "wb") as f:
                f.write(data[:-7] + b"XXXXXXX")
        elif damage == "missing":
            os.remove(blob)
        elif damage == "fingerprint":
            with open(maps, "rb") as f:
                meta = pickle.load(f)
            meta["ivf"]["fingerprint"] = "0" * 16
            with open(maps, "wb") as f:
                pickle.dump(meta, f)
        if damage == "exact-env":
            clean_env.setenv("PIO_RETRIEVAL", "exact")
        mod = jax_als if pkg == "jax" else als
        loaded[pkg] = mod.CheckpointedALSModel.load("inst", None, jax_ctx if pkg == "jax" else CPU)
        clean_env.delenv("PIO_RETRIEVAL", raising=False)
    pm, jm = loaded["port"], loaded["jax"]
    assert (pm.ivf_index is None) == (jm.ivf_index is None) == (damage != "none")
    fp = als.ALSScorer(CPU, pm).enable_fastpath()
    st = fp.stats()
    assert st["retrieval_backend"] == ("ivf" if damage == "none" else "exact")
    if damage == "none":
        assert pm.ivf_index.fingerprint == jm.ivf_index.fingerprint
        assert st["retrieval"]["recall_at_publish"] == jm.ivf_index.recall_at_publish == 1.0


def test_degrade_warnings_name_the_fallback(tmp_path, clean_env, caplog):
    U, V = _random()
    d, _ = _publish("port", tmp_path, clean_env, "inst", _GATE, U, V)
    os.remove(os.path.join(d, "ivf.blob"))
    als.CheckpointedALSModel.load("inst", None, CPU)
    assert "IVF index unavailable" in caplog.text and "serving exact" in caplog.text


def _jax_auto_model(U, V, index):
    m = jax_als.ALSModel(U, V, JaxBiMap.string_int(f"u{i}" for i in range(len(U))),
                         JaxBiMap.string_int(f"i{i}" for i in range(len(V))),
                         jax_als.ALSConfig(rank=U.shape[1], iterations=3))
    m.ivf_index = index
    return m


def test_jax_auto_mode_blob_with_an_index_deploys_and_answers_as_jax(jax_ctx, clean_env):
    U, V = _clustered(n_items=240, nlist=10, n_users=70)
    jm = _jax_auto_model(U, V, jax_ivf.build_index(V, 10, nprobe=2))
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=8))
    blob = jax_persistence.serialize_models("x", [algo], [jm], [algo.params])
    port_algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=8))
    pm = persistence.deserialize_models(blob, "x", [port_algo], [port_algo.params], CPU)[0][0]
    assert isinstance(pm, als.ALSModel) and isinstance(pm.ivf_index, ivf.IVFIndex)
    assert isinstance(pm.ivf_index.plan, sharding.ShardingPlan)
    assert pm.ivf_index.fingerprint == jm.ivf_index.fingerprint
    port_fp = port_algo._scorer(pm).enable_fastpath()
    jax_fp = JaxBucketedScorer(jax_ctx, U, V, max_k=100, backend="reference",
                               ivf_index=jm.ivf_index)
    assert port_fp.retrieval == jax_fp.retrieval == "ivf"
    rng = np.random.default_rng(8)
    for b in RUNGS:
        users = rng.integers(0, len(U), b)
        (gi, gv), (ri, rv) = port_fp.score_topk(users, 10), jax_fp.score_topk(users, 10)
        assert not topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), TOL), b
    # an auto-mode model of the port pickles its own index with it
    again = persistence.load_models_blob(pickle.dumps(port_algo.make_serializable_model(pm)))
    assert again.ivf_index.fingerprint == jm.ivf_index.fingerprint


def test_jax_auto_mode_blob_with_a_sharding_plan_still_names_item_10(clean_env):
    """A JAX auto-mode blob carrying a plan and an index loads: both cross
    with their fingerprints; one device serves the index (the plan is wider
    than the mesh), a mesh of the plan's placements serves exact sharded."""
    U, V = _clustered()
    jm = _jax_auto_model(U, V, jax_ivf.build_index(V, 6, nprobe=6))
    jm.sharding_plan = jax_sharding.build_plan(len(V), n_shards=2)
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=8))
    blob = jax_persistence.serialize_models("x", [algo], [jm], [algo.params])
    port_algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=8))
    pm = persistence.deserialize_models(blob, "x", [port_algo], [port_algo.params], CPU)[0][0]
    assert isinstance(pm.sharding_plan, sharding.ShardingPlan)
    assert pm.sharding_plan.fingerprint == jm.sharding_plan.fingerprint
    assert pm.sharding_plan.to_payload() == jm.sharding_plan.to_payload()
    one = als.ALSScorer(CPU, pm).enable_fastpath()
    two = als.ALSScorer(DeviceContext.create(devices=["cpu"] * 2), pm).enable_fastpath()
    assert (one.sharding, one.retrieval) == ("replicated", "ivf")
    assert (two.sharding, two.retrieval) == ("sharded", "exact")
    users = np.arange(len(U))
    (ai, av), (bi, bv) = one.score_topk(users, 10), two.score_topk(users, 10)
    assert np.array_equal(ai, bi) and av.tobytes() == bv.tobytes()  # full probe = exact


# -- observability ---------------------------------------------------------------------


def test_bridge_emits_only_while_ivf_live():
    stats = {"retrieval": None}
    reg, jreg = port_metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    bridges.bridge_ivf(reg, lambda: stats)
    jax_bridges.bridge_ivf(jreg, lambda: stats)
    assert not any(n.startswith("pio_ivf_")
                   for (n, _) in port_metrics.parse_prometheus(reg.render_prometheus()))
    stats["retrieval"] = {
        "backend": "ivf", "nlist": 6, "nprobe": 2, "min_probes": 1, "cap_pad": 24,
        "dispatches": 3, "probed_blocks": 6, "scanned_rows": 144, "scanned_fraction": 0.5,
        "recall_at_publish": 0.97, "resident_extra_bytes": 1024, "fingerprint": "abc123",
    }
    text = reg.render_prometheus()
    assert text == jreg.render_prometheus()
    series = port_metrics.parse_prometheus(text)
    assert series[("pio_ivf_info", (("fingerprint", "abc123"),))] == 6
    assert series[("pio_ivf_scanned_fraction", ())] == 0.5


# -- the CLI: pio train under PIO_IVF_NLIST, deploy, pio ivf show / rebuild -------------


def _http(url, body=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        raw = r.read()
    return json.loads(raw) if not url.endswith("/metrics") else raw.decode()


def _wait(url):
    t_end = time.monotonic() + 60
    while time.monotonic() < t_end:
        try:
            urllib.request.urlopen(url, timeout=5).close()
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"{url} never answered")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_deploy_show_rebuild_reload(tmp_path, monkeypatch, capsys):
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_QUANT_", "PIO_ALS_", "PIO_IVF_", "PIO_RETRIEVAL")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    Storage.reset_instance()
    port = _free_port()
    try:
        assert port_cli.main(["app", "new", "IvfApp"]) == 0
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("IvfApp").id
        rng = np.random.default_rng(6)
        storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                  target_entity_type="item", target_entity_id=f"i{int(i)}",
                  properties={"rating": int(r)}, event_time=1_767_225_600.0 + k)
            for k, (u, i, r) in enumerate(zip(rng.integers(0, 60, 2000),
                                              rng.integers(0, 200, 2000),
                                              rng.integers(1, 6, 2000)))], app_id)
        eng = tmp_path / "engine"
        eng.mkdir()
        (eng / "engine.json").write_text(json.dumps({
            "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
            "datasource": {"params": {"appName": "IvfApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 6, "numIterations": 3, "persistMode": "checkpoint"}}]}))
        monkeypatch.setenv("PIO_IVF_NLIST", "8")
        monkeypatch.setenv("PIO_IVF_NPROBE", "8")
        assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 0
        iid = re.search(r"Engine instance ID: (\S+)", capsys.readouterr().out).group(1)
        monkeypatch.delenv("PIO_IVF_NLIST")
        monkeypatch.delenv("PIO_IVF_NPROBE")
        model = als.CheckpointedALSModel.load(iid, None, CPU)
        want = jax_ivf.build_index(model.item_factors, 8, nprobe=8)
        assert model.ivf_index.fingerprint == want.fingerprint
        assert port_cli.main(["ivf", "show", "--instance", iid]) == 0
        shown = json.loads(capsys.readouterr().out)
        assert shown[0]["instance"] == iid and shown[0]["fingerprint"] == want.fingerprint
        assert shown[0]["recall_at_publish"] == 1.0

        t = threading.Thread(target=port_cli.main, args=([
            "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
            "--batching", "--device", "cpu"],), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        _wait(f"{base}/readyz")
        fp = _http(f"{base}/")["fastpath"][0]
        assert fp["retrieval_backend"] == "ivf"
        assert fp["retrieval"]["fingerprint"] == want.fingerprint
        answers = [_http(f"{base}/queries.json", {"user": f"u{u}", "num": 5}) for u in range(10)]
        metrics = _http(f"{base}/metrics")
        assert f'pio_ivf_info{{fingerprint="{want.fingerprint}"}} 8' in metrics

        # rebuild at another nlist behind the gate, then adopt it live
        assert port_cli.main(["ivf", "rebuild", "--instance", iid, "--nlist", "5",
                              "--nprobe", "5"]) == 0
        want5 = jax_ivf.build_index(model.item_factors, 5, nprobe=5)
        assert f'"fingerprint": "{want5.fingerprint}"' in capsys.readouterr().out
        assert _http(f"{base}/reload", {}, method="POST")["engineInstanceId"] == iid
        fp = _http(f"{base}/")["fastpath"][0]
        assert fp["retrieval"]["fingerprint"] == want5.fingerprint
        # a refused rebuild leaves the sealed index as it was
        assert port_cli.main(["ivf", "rebuild", "--instance", iid, "--nlist", "5",
                              "--min-recall", "1.01"]) == 1
        assert "REFUSED" in capsys.readouterr().err
        assert ivf.load_index(os.path.join(als.CheckpointedALSModel._dir(iid),
                                           "ivf.blob")).fingerprint == want5.fingerprint
        assert port_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(30)
    finally:
        Storage.reset_instance()
        port_sqlite.close_all_dbs()
    # full probe: the served answers are the exact ranking
    items = {it: j for j, it in enumerate(model.item_map.keys())}
    for u, a in enumerate(answers):
        row = model.user_factors[model.user_map[f"u{u}"]] @ model.item_factors.T
        ref = np.argsort(-row, kind="stable")[:5]
        got = a["itemScores"]
        assert not topk_mismatches(
            np.array([[x["score"] for x in got]]), np.array([[items[x["item"]] for x in got]]),
            row[ref][None], ref[None], TOL)


def test_auto_mode_train_declares_the_index_as_jax(clean_env):
    from predictionio_tpu_torch.data.batch import interactions_from_arrays

    rng = np.random.default_rng(1)
    u, i = rng.integers(0, 40, 800), rng.integers(0, 90, 800)
    inter = interactions_from_arrays(u, i, rng.integers(1, 6, 800).astype(np.float32),
                                     np.zeros(800), [f"u{x}" for x in range(40)],
                                     [f"i{x}" for x in range(90)])
    clean_env.setenv("PIO_IVF_NLIST", "6")
    m = als.train_als(CPU, inter, als.ALSConfig(rank=4, iterations=2))
    want = jax_ivf.build_index(m.item_factors, 6)
    assert m.ivf_index.fingerprint == want.fingerprint and m.ivf_index.nprobe == want.nprobe
