"""Streaming micro-generations in the port, against the JAX package.

Mirrors ``tests/test_streaming.py`` on ``predictionio_tpu_torch``
(``TestDeltaLogApplier``, ``TestExactlyOnceFold``, ``TestExactEquality``,
``TestResultCacheDeltaInvalidation``, ``TestStreamingServer`` over HTTP,
``TestEventServerPublisher``, ``TestStreamingKill9``; the router's push is
not ported yet), and holds the port against the JAX package on the same
seeded inputs:

* the same committed events through the JAX ``DeltaPublisher`` and the
  port's seal equal ``user_idx``, ``user_ids``, ``cooc_updates``,
  ``event_ids`` and fingerprint, and ``user_rows`` within 1e-6;
  ``fold_in_users`` agrees within 1e-6 at f32, bf16 and the f64 reference;
* a log either package sealed is read, and caught up, by the other;
* the port's ``BucketedScorer`` on the CPU after ``apply_delta_rows``
  equals the JAX ``BucketedScorer`` (reference backend) after its own, at
  f32, bf16 and int8: the patched rows bit for bit, the top-k by
  ``testing.topk_mismatches`` (ROADMAP rule 4);
* one logged difference (ROADMAP §3): the JAX server's apply never
  patches its device scorer (only its host model), the port's patches the
  scorer on the card, whose batched answers equal the JAX host path's.
"""

import copy
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.core import delta as jax_delta
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving.fastpath import BucketedScorer as JaxBucketedScorer
from predictionio_tpu_torch.core import delta as delta_mod
from predictionio_tpu_torch.core import persistence as port_persistence
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import memory as port_memory
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSConfig, ALSModel, fold_in_users
from predictionio_tpu_torch.ops import quantize
from predictionio_tpu_torch.serving.fastpath import BucketedScorer
from predictionio_tpu_torch.templates import recommendation as port_rec
from predictionio_tpu_torch.testing import topk_mismatches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRASH_RC = 137  # faults.CRASH_EXIT_CODE: 128 + SIGKILL
TOL = 1e-5


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("PIO_STREAMING", "PIO_DELTA_DIR", "PIO_DELTA_MAX_EVENTS", "PIO_DELTA_MIN_OVERLAP",
              "PIO_DELTA_GATE_SAMPLE", "PIO_FRESHNESS_SLO_MS", "PIO_ALS_COMPUTE_DTYPE",
              "PIO_ALS_SOLVER", "PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_FAULT_SPEC",
              "PIO_HOTSET_SIZE", "PIO_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)


def _arrays(rank, n_users, n_items, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, rank)).astype(np.float32),
            rng.standard_normal((n_items, rank)).astype(np.float32))


def tiny_model(rank=4, n_users=12, n_items=10, seed=7, **cfg):
    """Deterministic base generation: same seed ⇒ same fingerprint."""
    U, V = _arrays(rank, n_users, n_items, seed)
    return ALSModel(
        user_factors=U, item_factors=V,
        user_map=BiMap.string_int([f"u{i}" for i in range(n_users)]),
        item_map=BiMap.string_int([f"i{i}" for i in range(n_items)]),
        config=ALSConfig(rank=rank, iterations=1, **cfg),
    )


def jax_tiny_model(rank=4, n_users=12, n_items=10, seed=7, **cfg):
    U, V = _arrays(rank, n_users, n_items, seed)
    return jax_als.ALSModel(
        user_factors=U, item_factors=V,
        user_map=JaxBiMap.string_int([f"u{i}" for i in range(n_users)]),
        item_map=JaxBiMap.string_int([f"i{i}" for i in range(n_items)]),
        config=jax_als.ALSConfig(rank=rank, iterations=1, **cfg),
    )


class Ev:
    """Committed-event shape the publisher sink consumes."""

    def __init__(self, entity_id, target_entity_id, rating=1.0, event_id=None):
        self.entity_id = entity_id
        self.target_entity_id = target_entity_id
        self.properties = {"rating": rating}
        self.event_id = event_id


def publish(model, log_dir, events, module=delta_mod, **kw):
    """Seal one micro-generation from ``events``; (receipt, publisher)."""
    log = module.DeltaLog(log_dir)
    pub = module.DeltaPublisher(model, log, **kw)
    pub.on_committed(events)
    return pub.flush(), pub


# -- delta log + applier units ----------------------------------------------


class TestDeltaLogApplier:
    def test_seal_read_roundtrip_monotonic_epochs(self, tmp_path):
        m = tiny_model()
        r1, pub = publish(m, str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        assert r1["sealed"] and r1["epoch"] == 1
        pub.on_committed([Ev("u3", "i4", 2.0)])
        r2 = pub.flush()
        assert r2["sealed"] and r2["epoch"] == 2
        log = delta_mod.DeltaLog(str(tmp_path))
        assert log.epochs() == [1, 2]
        dl = log.read(1)
        assert dl.epoch == 1
        assert dl.base_fingerprint == pub.base_fingerprint
        assert "u1" in dl.user_ids
        assert dl.user_rows.shape[1] == m.config.rank

    def test_fence_refuses_foreign_base_generation(self, tmp_path):
        _, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        dl = delta_mod.DeltaLog(str(tmp_path)).read(1)
        applied = []
        applier = delta_mod.DeltaApplier("not-the-base-fingerprint", applied.append)
        receipt = applier.apply(dl)
        assert receipt["refused"] and receipt["reason"] == "fingerprint"
        assert applied == []  # a fenced delta never touches the model
        assert applier.applied_epoch == 0

    def test_replay_of_applied_epoch_is_idempotent_noop(self, tmp_path):
        _, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        dl = delta_mod.DeltaLog(str(tmp_path)).read(1)
        applied = []
        applier = delta_mod.DeltaApplier(pub.base_fingerprint, applied.append)
        assert applier.apply(dl)["applied"]
        again = applier.apply(dl)
        assert again["noop"] and len(applied) == 1
        assert applier.stats()["noops"] == 1

    def test_gap_triggers_catch_up_from_sealed_log(self, tmp_path):
        _, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        for ev in ([Ev("u2", "i3", 4.0)], [Ev("u4", "i5", 3.0)]):
            pub.on_committed(ev)
            assert pub.flush()["sealed"]
        log = delta_mod.DeltaLog(str(tmp_path))
        applied = []
        applier = delta_mod.DeltaApplier(
            pub.base_fingerprint, lambda d: applied.append(d.epoch), delta_log=log)
        receipt = applier.apply(log.read(3))  # 1 and 2 replay from the log first
        assert receipt["applied"]
        assert applied == [1, 2, 3]
        assert applier.applied_epoch == 3

    def test_torn_blob_stops_catch_up_at_last_good(self, tmp_path):
        _, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        pub.on_committed([Ev("u2", "i3", 4.0)])
        assert pub.flush()["sealed"]
        log = delta_mod.DeltaLog(str(tmp_path))
        raw = bytearray(open(log.path(2), "rb").read())
        raw[-3] ^= 0xFF
        open(log.path(2), "wb").write(bytes(raw))
        applied = []
        applier = delta_mod.DeltaApplier(
            pub.base_fingerprint, lambda d: applied.append(d.epoch), delta_log=log)
        rc = applier.catch_up()
        assert applied == [1]  # everything before the tear is real
        assert applier.applied_epoch == 1
        assert rc["refused"] and rc["reason"] == "integrity"

    def test_quality_gate_quarantines_and_rolls_back(self, tmp_path):
        receipt, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)],
                               min_overlap=1.1)
        assert receipt["refused"] and receipt["reason"] == "quality"
        assert receipt["rolled_back_to"] == 0
        assert delta_mod.DeltaLog(str(tmp_path)).epochs() == []
        refusal = json.load(open(os.path.join(str(tmp_path), "refusal-00000001.json")))
        assert refusal["reason"] == "quality"
        assert refusal["overlap"] < refusal["threshold"]
        pub.min_overlap = 0.0  # the epoch was not burned
        pub.on_committed([Ev("u1", "i2", 5.0)])
        assert pub.flush()["epoch"] == 1

    def test_log_prune_keeps_newest(self, tmp_path):
        _, pub = publish(tiny_model(), str(tmp_path), [Ev("u1", "i2", 5.0)], min_overlap=0.0)
        for i in range(4):
            pub.on_committed([Ev(f"u{i + 2}", "i3", 2.0)])
            assert pub.flush()["sealed"]
        log = delta_mod.DeltaLog(str(tmp_path))
        assert log.epochs() == [1, 2, 3, 4, 5]
        log.prune(keep=2)
        assert log.epochs() == [4, 5]
        assert log.last_epoch() == 5

    @pytest.mark.parametrize("payload", [
        pickle.dumps({"version": 1, "epoch": 1, "quality": threading.Lock}),
        pickle.dumps(os.getcwd),
        b"\x80\x04not a pickle",
        pickle.dumps([1, 2]),
    ])
    def test_a_payload_that_is_not_a_delta_is_an_integrity_error(self, payload):
        """The restricted unpickler admits a delta's own types only:
        anything else raises before any of it is called."""
        with pytest.raises(port_persistence.ModelIntegrityError):
            delta_mod.Delta.from_payload(payload)


# -- exactly-once fold --------------------------------------------------------


class TestExactlyOnceFold:
    def test_concurrent_flushes_allocate_distinct_epochs(self, tmp_path):
        m = tiny_model()
        log = delta_mod.DeltaLog(str(tmp_path))
        pub = delta_mod.DeltaPublisher(m, log, min_overlap=0.0)
        per_thread, threads = 5, 8
        ids = [f"e{t}-{j}" for t in range(threads) for j in range(per_thread)]
        start = threading.Barrier(threads)

        def worker(t):
            start.wait()
            for j in range(per_thread):
                pub.on_committed([Ev(f"u{(t + j) % 12}", f"i{j % 10}", 3.0,
                                     event_id=f"e{t}-{j}")])
                pub.flush()

        ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        pub.flush()  # the drain-time final fold
        epochs = log.epochs()
        assert epochs == list(range(1, len(epochs) + 1))  # no holes
        folded = []
        for e in epochs:
            folded.extend(log.read(e).event_ids)
        assert sorted(folded) == sorted(ids)  # each event in exactly one epoch
        assert pub.stats()["sealed"] == len(epochs)

    def test_restarted_publisher_skips_already_folded_events(self, tmp_path):
        base = tiny_model()
        events = [Ev("u1", "i2", 5.0, event_id="e-1"), Ev("u3", "i4", 2.0, event_id="e-2")]
        r1, _ = publish(copy.deepcopy(base), str(tmp_path), events, min_overlap=0.0)
        assert r1["sealed"] and r1["epoch"] == 1
        log = delta_mod.DeltaLog(str(tmp_path))
        pub2 = delta_mod.DeltaPublisher(copy.deepcopy(base), log, min_overlap=0.0)
        pub2.on_committed(events)  # the replayed delivery
        assert pub2.pending() == 0
        assert pub2.stats()["dedup_skipped"] == 2
        assert pub2.flush() is None
        assert log.epochs() == [1]
        pub2.on_committed(events + [Ev("u5", "i6", 4.0, event_id="e-3")])
        assert pub2.flush()["sealed"]
        assert log.read(2).event_ids == ("e-3",)

    def test_history_fn_cooc_counts_only_new_events(self, tmp_path):
        m = tiny_model()
        histories = {"u1": [("i1", 5.0), ("i2", 4.0)]}

        def history_fn(user_id):
            return list(histories.get(user_id, []))

        log = delta_mod.DeltaLog(str(tmp_path))
        pub = delta_mod.DeltaPublisher(m, log, history_fn=history_fn, min_overlap=0.0)
        i1, i2, i3 = (m.item_map[k] for k in ("i1", "i2", "i3"))
        pub.on_committed([Ev("u1", "i1", 5.0), Ev("u1", "i2", 4.0)])
        assert pub.flush()["sealed"]
        np.testing.assert_array_equal(log.read(1).cooc_updates, [[min(i1, i2), max(i1, i2), 1]])
        histories["u1"].append(("i3", 3.0))
        pub.on_committed([Ev("u1", "i3", 3.0)])
        assert pub.flush()["sealed"]
        got = {(int(a), int(b)): int(c) for a, b, c in log.read(2).cooc_updates}
        assert got == {(min(i1, i3), max(i1, i3)): 1, (min(i2, i3), max(i2, i3)): 1}


# -- exact-equality property -------------------------------------------------


class TestExactEquality:
    def test_base_plus_deltas_equals_fresh_fold(self, tmp_path):
        """base + N sequential deltas == folding the same events into a
        fresh model (same top-k), with full histories and the gate off."""
        base = tiny_model(n_users=10, n_items=12, seed=11)
        histories: dict = {}

        def history_fn(user_id):
            return list(histories.get(user_id, []))

        log = delta_mod.DeltaLog(str(tmp_path))
        pub = delta_mod.DeltaPublisher(copy.deepcopy(base), log, history_fn=history_fn,
                                       min_overlap=0.0)
        rng = np.random.default_rng(5)
        batches = []
        for _ in range(3):
            batch = []
            for _ in range(6):
                u, i = f"u{rng.integers(10)}", f"i{rng.integers(12)}"
                r = float(rng.integers(1, 6))
                histories.setdefault(u, []).append((i, r))
                batch.append(Ev(u, i, r))
            batches.append(batch)

        replica = copy.deepcopy(base)

        def apply_fn(dl):
            replica.user_factors[np.asarray(dl.user_idx)] = dl.user_rows

        applier = delta_mod.DeltaApplier(pub.base_fingerprint, apply_fn, delta_log=log)
        touched = set()
        for epoch, batch in enumerate(batches, start=1):
            pub.on_committed(batch)
            receipt = pub.flush()
            assert receipt["sealed"] and receipt["epoch"] == epoch
            assert applier.apply(log.read(epoch))["applied"]
            touched |= {e.entity_id for e in batch}

        fresh = copy.deepcopy(base)
        cfg = fresh.config
        interactions = {fresh.user_map[u]: [(fresh.item_map[i], r) for i, r in pairs]
                        for u, pairs in histories.items()}
        user_idx = np.array(sorted(interactions), dtype=np.int32)
        rows = fold_in_users(fresh.item_factors, {u: interactions[u] for u in user_idx},
                             rank=cfg.rank, reg=cfg.reg, implicit=cfg.implicit,
                             alpha=cfg.alpha, compute_dtype=cfg.compute_dtype)
        fresh.user_factors[user_idx] = rows
        V = base.item_factors
        for u in sorted(touched):
            uidx = base.user_map[u]
            np.testing.assert_array_equal(np.argsort(-(replica.user_factors[uidx] @ V.T))[:5],
                                          np.argsort(-(fresh.user_factors[uidx] @ V.T))[:5])
            np.testing.assert_allclose(replica.user_factors[uidx], fresh.user_factors[uidx],
                                       rtol=1e-6, atol=1e-6)


# -- the port against the JAX package ----------------------------------------


EVENTS = [
    Ev("u1", "i2", 5.0, "p-1"), Ev("u1", "i7", 3.0, "p-2"), Ev("u3", "i4", 2.0, "p-3"),
    Ev("u3", "i4", 4.0, "p-4"), Ev("u9", "i0", 1.0, "p-5"), Ev("nobody", "i1", 5.0, "p-6"),
    Ev("u5", "nothing", 5.0, "p-7"), Ev("u5", "i9", 2.5, "p-8"), Ev("u11", "i3", 4.0, "p-9"),
]


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_users_matches_jax(compute_dtype, implicit):
    V = np.random.default_rng(3).standard_normal((23, 6)).astype(np.float32)
    rng = np.random.default_rng(4)
    inter = {int(u): [(int(i), float(rng.integers(1, 6))) for i in rng.choice(23, 5)]
             for u in rng.choice(40, 9, replace=False)}
    kw = dict(rank=6, reg=0.05, implicit=implicit, alpha=2.0, compute_dtype=compute_dtype)
    got = fold_in_users(V, inter, **kw)
    ref = jax_als.fold_in_users(V, inter, **kw)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg,history", [
    ({}, False), ({"implicit": True, "alpha": 2.0}, False), ({"compute_dtype": "bf16"}, False),
    ({}, True),
])
def test_same_events_seal_the_same_delta_as_jax(tmp_path, cfg, history):
    """One committed-event stream through both packages' publishers: the
    same receipts and sealed deltas (rows within 1e-6)."""
    histories = {"u1": [("i5", 4.0)], "u3": [("i8", 1.0), ("i4", 2.0)]}

    def history_fn(user_id):
        return list(histories.get(user_id, [])) + [
            (e.target_entity_id, e.properties["rating"]) for e in EVENTS if e.entity_id == user_id]

    kw = dict(min_overlap=0.0, gate_sample=4, history_fn=history_fn if history else None)
    pr, ppub = publish(tiny_model(**cfg), str(tmp_path / "port"), EVENTS, **kw)
    jr, jpub = publish(jax_tiny_model(**cfg), str(tmp_path / "jax"), EVENTS, module=jax_delta,
                       **kw)
    assert ppub.base_fingerprint == jpub.base_fingerprint
    drop = ("path",)
    assert {k: v for k, v in pr.items() if k not in drop} == {
        k: v for k, v in jr.items() if k not in drop}
    got = delta_mod.DeltaLog(str(tmp_path / "port")).read(1)
    ref = jax_delta.DeltaLog(str(tmp_path / "jax")).read(1)
    assert got.base_fingerprint == ref.base_fingerprint
    assert got.user_ids == ref.user_ids and got.event_ids == ref.event_ids
    assert got.events == ref.events and got.quality == ref.quality
    np.testing.assert_array_equal(got.user_idx, ref.user_idx)
    np.testing.assert_array_equal(got.cooc_updates, ref.cooc_updates)
    np.testing.assert_allclose(got.user_rows, ref.user_rows, rtol=1e-6, atol=1e-6)
    assert ppub.stats()["unknown_users"] == jpub.stats()["unknown_users"] == 1


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_a_log_either_package_sealed_is_read_and_caught_up_by_the_other(tmp_path, sealer):
    seal_mod, read_mod = (jax_delta, delta_mod) if sealer == "jax" else (delta_mod, jax_delta)
    model = jax_tiny_model() if sealer == "jax" else tiny_model()
    _, pub = publish(model, str(tmp_path), EVENTS[:4], module=seal_mod, min_overlap=0.0)
    pub.on_committed(EVENTS[7:])
    assert pub.flush()["sealed"]
    sealed = [seal_mod.DeltaLog(str(tmp_path)).read(e) for e in (1, 2)]
    replica = tiny_model() if sealer == "jax" else jax_tiny_model()
    fp = read_mod.model_fingerprint(replica.user_factors, replica.item_factors)
    assert fp == pub.base_fingerprint

    def apply_fn(dl):
        replica.user_factors[np.asarray(dl.user_idx)] = dl.user_rows

    applier = read_mod.DeltaApplier(fp, apply_fn, delta_log=read_mod.DeltaLog(str(tmp_path)))
    rc = applier.catch_up()
    assert rc == {"caught_up": 2, "applied_epoch": 2}
    for dl in sealed:
        got = read_mod.DeltaLog(str(tmp_path)).read(dl.epoch)
        np.testing.assert_array_equal(got.user_rows, dl.user_rows)
        np.testing.assert_array_equal(got.user_idx, dl.user_idx)
        np.testing.assert_array_equal(got.cooc_updates, dl.cooc_updates)
        assert (got.user_ids, got.event_ids, got.quality) == (dl.user_ids, dl.event_ids,
                                                             dl.quality)
    last = sealed[-1]
    np.testing.assert_array_equal(replica.user_factors[last.user_idx], last.user_rows)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_patched_scorer_matches_jax_after_its_own_apply(dtype):
    """Both scorers patch the same rows (users and items, some past the
    matrices, which both drop): the resident rows and scales are equal bit
    for bit, and the top-k of every user agrees by the tolerance rule."""
    rng = np.random.default_rng(9)
    U = rng.normal(size=(40, 6)).astype(np.float32)
    V = rng.normal(size=(29, 6)).astype(np.float32)
    jU, jus = jax_quantize.quantize_factors(U, dtype)
    jV, jvs = jax_quantize.quantize_factors(V, dtype)
    pU, _ = quantize.quantize_factors(U, dtype)
    pV, _ = quantize.quantize_factors(V, dtype)
    port = BucketedScorer(DeviceContext.create(device="cpu"), pU, pV, max_k=7,
                          factor_dtype=dtype, user_scale=jus, item_scale=jvs)
    ref = JaxBucketedScorer(MeshContext.create(devices=jax.devices()[:1]), jU, jV, max_k=7,
                            factor_dtype=dtype, user_scale=jus, item_scale=jvs,
                            backend="reference")
    users = np.array([3, 17, 39, 40, 55], np.int32)  # 40 and 55 lie past U
    u_rows = rng.normal(size=(5, 6)).astype(np.float32) * 3
    items = np.array([0, 28, 29], np.int32)  # 29 lies past V (its pad row stays)
    i_rows = rng.normal(size=(3, 6)).astype(np.float32)
    got = port.apply_delta_rows(users, u_rows, item_idx=items, item_rows=i_rows)
    want = ref.apply_delta_rows(users, u_rows, item_idx=items, item_rows=i_rows)
    assert (got["users"], got["items"]) == (want["users"], want["items"]) == (3, 2)
    assert got["warmup_executions"] == port.warmup_executions
    np.testing.assert_array_equal(_port_bits(port._U), _jax_bits(ref._U))
    np.testing.assert_array_equal(_port_bits(port._V)[:29], _jax_bits(ref._V)[:29])
    if dtype == "int8":
        np.testing.assert_array_equal(port._Uscale.numpy(), np.asarray(ref._Uscale))
        np.testing.assert_array_equal(port._Vscale.numpy()[:29], np.asarray(ref._Vscale)[:29])
    all_users = np.arange(40, dtype=np.int32)
    gi, gv = port.score_topk(all_users, 7)
    ri, rv = ref.score_topk(all_users, 7)
    bad = topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), TOL)
    assert not bad, bad[:3]
    # and against the plain product of the patched rows
    want_u = quantize.dequantize_factors(*quantize.quantize_factors(U, dtype))
    want_v = quantize.dequantize_factors(*quantize.quantize_factors(V, dtype))
    for u, row in zip(users[:3], u_rows[:3]):
        want_u[u] = quantize.dequantize_factors(*quantize.quantize_factors(row[None], dtype))[0]
    for i, row in zip(items[:2], i_rows[:2]):
        want_v[i] = quantize.dequantize_factors(*quantize.quantize_factors(row[None], dtype))[0]
    s = want_u @ want_v.T
    order = np.argsort(-s, axis=1, kind="stable")[:, :7]
    bad = topk_mismatches(gv, gi, np.take_along_axis(s, order, 1), order, 1e-4)
    assert not bad, bad[:3]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_a_patch_is_whole_to_concurrent_launches(dtype):
    """Launches from six threads while another thread patches 300 rows
    back and forth (a short switch interval forces interleavings): every
    batch's answer is the base or the patched scorer's, whole. The same
    check runs on the card in ``test_torch_cuda.py``."""
    rng = np.random.default_rng(31)
    U = rng.normal(size=(400, 8)).astype(np.float32)
    V = rng.normal(size=(200, 8)).astype(np.float32)
    rows = rng.normal(size=(300, 8)).astype(np.float32) * 2
    users = np.arange(300)
    U2 = U.copy()
    U2[users] = rows
    ctx = DeviceContext.create(device="cpu")

    def scorer(F):
        (fq, fs), (vq, vs) = quantize.quantize_factors(F, dtype), quantize.quantize_factors(V, dtype)
        return BucketedScorer(ctx, fq, vq, max_k=20, factor_dtype=dtype, user_scale=fs,
                              item_scale=vs)

    live = scorer(U)
    want = [{b: s.score_topk(users[b * 60:(b + 1) * 60], 20) for b in range(5)}
            for s in (scorer(U), scorer(U2))]
    stop, errors = threading.Event(), []

    def reader(t):
        r = np.random.default_rng(t)
        while not stop.is_set():
            b = int(r.integers(5))
            got = live.score_topk(users[b * 60:(b + 1) * 60], 20)
            if not any(np.array_equal(got[0], w[b][0]) and np.array_equal(got[1], w[b][1])
                       for w in want):
                errors.append(b)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(t,)) for t in range(6)]
    try:
        for t in threads:
            t.start()
        for n in range(30):
            live.apply_delta_rows(users, rows if n % 2 == 0 else U[users])
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"{len(errors)} answers matched neither version"


def test_a_patch_forgets_the_hot_rows_of_its_users():
    rng = np.random.default_rng(2)
    U = rng.normal(size=(16, 4)).astype(np.float32)
    V = rng.normal(size=(11, 4)).astype(np.float32)
    s = BucketedScorer(DeviceContext.create(device="cpu"), U, V, max_k=5, hot_size=4,
                       hot_refresh_queries=8)
    s.score_topk(np.array([1, 2, 3, 4, 1, 2, 3, 4], np.int32), 5)  # refreshes the table
    assert set(s._hot_rows) == {1, 2, 3, 4}
    before = s._U.clone()
    rc = s.apply_delta_rows(np.array([2], np.int32), np.ones((1, 4), np.float32))
    assert rc["users"] == 1 and set(s._hot_rows) == {1, 3, 4}
    assert torch.equal(before[1], s._U[1]) and torch.equal(s._U[2], torch.ones(4))
    idx, _ = s.score_topk(np.array([2], np.int32), 5)
    np.testing.assert_array_equal(idx[0], np.argsort(-V.sum(1), kind="stable")[:5])


# -- result-cache entity-targeted invalidation -------------------------------


class TestResultCacheDeltaInvalidation:
    def test_delta_touching_user_a_leaves_user_b_hot(self):
        from predictionio_tpu_torch.serving import result_cache as rc

        cache = rc.ResultCache(ttl_s=300.0)
        cache.put("fpA", {"itemScores": [{"item": "i1"}]}, ("uA",), 0)
        cache.put("fpB", {"itemScores": [{"item": "i2"}]}, ("uB",), 0)
        assert cache.get("fpA", 0) is not None
        assert cache.get("fpB", 0) is not None
        assert rc.notify_delta(["uA"]) == 1
        assert cache.get("fpA", 0) is None
        assert cache.get("fpB", 0) is not None
        assert cache.stats()["invalidated_event"] == 1

    def test_notify_delta_ignores_empty_ids(self):
        from predictionio_tpu_torch.serving import result_cache as rc

        cache = rc.ResultCache(ttl_s=300.0)
        cache.put("fpC", {"itemScores": []}, ("uC",), 0)
        assert rc.notify_delta([None, ""]) == 0
        assert cache.get("fpC", 0) is not None  # never a global flush


# -- live-server integration -------------------------------------------------


def call(method, url, body=None, raw=None):
    ctype = "application/octet-stream" if raw is not None else "application/json"
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


VARIANT = {"algorithms": [{"name": "als", "params": {"rank": 4}}]}


def _publish_instance(storage, model, engine_variant="default"):
    import datetime as dt

    engine = port_rec.RecommendationEngine.apply()
    params = engine.params_from_variant(VARIANT)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = port_base.EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant=engine_variant,
        engine_factory="f", **params.to_json_strings())
    iid = instances.insert(inst)
    raw = port_persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                            [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(
        port_base.Model(id=iid, models=port_persistence.seal_model_blob(raw)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


@pytest.fixture()
def trained_streaming(tmp_path, monkeypatch):
    """A published model and the streaming env: PIO_STREAMING=1, a pinned
    delta dir, and a catch-up pace slow enough that every apply is driven
    by an explicit push or wake."""
    monkeypatch.setenv("PIO_STREAMING", "1")
    monkeypatch.setenv("PIO_DELTA_DIR", str(tmp_path / "deltas"))
    monkeypatch.setenv("PIO_DELTA_CATCHUP_MS", "60000")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    name = "ST" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })
    model = tiny_model(rank=4, n_users=20, n_items=16, seed=3)
    _publish_instance(storage, model)
    yield {"storage": storage, "model": model}
    port_memory.reset_store(name)


def make_server(trained, batching=True):
    from predictionio_tpu_torch.serving.query_server import QueryServer

    return QueryServer(port_rec.RecommendationEngine.apply(), storage=trained["storage"],
                       ctx=DeviceContext.create(device="cpu"), batching=batching)


def _host_top(model, user, n):
    s = model.user_factors[model.user_map[user]] @ model.item_factors.T
    order = np.argsort(-s, kind="stable")[:n]
    return [model.item_map.inverse[int(j)] for j in order]


class TestStreamingServer:
    def test_streaming_lifecycle_over_http(self, trained_streaming):
        qs = make_server(trained_streaming)
        st = qs._streaming
        assert st is not None
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            status, rz = call("GET", base + "/readyz")
            assert status == 200 and rz["deltaEpoch"] == 0
            status, _ = call("POST", base + "/queries.json", {"user": "u1", "num": 3})
            assert status == 200

            pub_model = copy.deepcopy(st["model"])
            log = delta_mod.DeltaLog(st["dir"])
            pub = delta_mod.DeltaPublisher(pub_model, log, min_overlap=0.0)
            assert pub.base_fingerprint == st["fingerprint"]
            pub.on_committed([Ev("u1", "i3", 5.0), Ev("u1", "i7", 5.0)])
            receipt = pub.flush()
            assert receipt["sealed"] and receipt["epoch"] == 1

            scorer = st["algo"]._scorers[id(st["model"])]._fastpath
            warm = scorer.warmup_executions
            blob = open(log.path(1), "rb").read()
            status, ack = call("POST", base + "/delta", raw=blob)
            assert status == 200 and ack["applied"] and ack["epoch"] == 1
            status, ack2 = call("POST", base + "/delta", raw=blob)  # exactly-once
            assert status == 200 and ack2["noop"]
            status, rz = call("GET", base + "/readyz")
            assert status == 200 and rz["deltaEpoch"] == 1

            # the patched rows serve: u1's answer is the publisher's rows'
            status, after = call("POST", base + "/queries.json", {"user": "u1", "num": 3})
            assert status == 200
            assert [x["item"] for x in after["itemScores"]] == _host_top(pub_model, "u1", 3)
            status, _ = call("POST", base + "/queries.json", {"user": "u2", "num": 3})
            assert status == 200
            assert scorer.warmup_executions == warm  # no new warm-up, no new scorer
            assert st["algo"]._scorers[id(st["model"])]._fastpath is scorer
            status, stats = call("GET", base + "/delta/stats")
            assert status == 200 and stats["last_apply"]["users"] == 1
            assert stats["last_apply"]["warmup_executions"] == warm

            # torn blob → integrity refusal receipt; serving keeps going
            status, bad = call("POST", base + "/delta", raw=b"PIOM1" + b"garbage" * 3)
            assert status == 200 and bad["refused"] and bad["reason"] == "integrity"
            status, _ = call("POST", base + "/queries.json", {"user": "u1", "num": 3})
            assert status == 200

            # fence: a delta from a DIFFERENT base generation is refused
            foreign = tiny_model(rank=4, n_users=20, n_items=16, seed=99)
            fdir = os.path.join(st["dir"], "..", "foreign")
            publish(foreign, fdir, [Ev("u1", "i1", 5.0)], min_overlap=0.0)
            fblob = open(delta_mod.DeltaLog(fdir).path(1), "rb").read()
            status, fref = call("POST", base + "/delta", raw=fblob)
            assert status == 200 and fref["refused"] and fref["reason"] == "fingerprint"

            # SLO breach: seal epoch 2 but don't push; the next answer is
            # served degraded (annotated, never failed) and wakes catch-up
            pub.on_committed([Ev("u3", "i2", 4.0)])
            assert pub.flush()["epoch"] == 2
            st["slo_ms"] = 0.0
            st["staleness_checked"] = 0.0
            time.sleep(0.05)
            status, res = call("POST", base + "/queries.json", {"user": "u2", "num": 3})
            assert status == 200
            assert res.get("degraded") is True and "staleness_ms" in res
            deadline = time.time() + 10
            while time.time() < deadline and st["applier"].applied_epoch < 2:
                time.sleep(0.05)
            assert st["applier"].applied_epoch == 2

            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                text = r.read().decode()
            for fam in ("pio_delta_epoch", "pio_delta_refused_total",
                        "pio_freshness_staleness_ms", "pio_freshness_degraded_total"):
                assert fam in text
        finally:
            qs.stop()

    def test_catch_up_gates_readmission(self, trained_streaming):
        qs = make_server(trained_streaming)
        st = qs._streaming
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            pub = delta_mod.DeltaPublisher(copy.deepcopy(st["model"]),
                                           delta_mod.DeltaLog(st["dir"]), min_overlap=0.0)
            pub.on_committed([Ev("u4", "i1", 5.0)])
            assert pub.flush()["sealed"]
            status, rz = call("GET", base + "/readyz")
            if status == 503:
                assert rz["status"] == "delta catch-up"
            deadline = time.time() + 10
            while time.time() < deadline and st["applier"].applied_epoch < 1:
                time.sleep(0.05)
            assert st["applier"].applied_epoch == 1
            status, rz = call("GET", base + "/readyz")
            assert status == 200 and rz["deltaEpoch"] == 1
        finally:
            qs.stop()

    def test_restarted_replica_rejoins_at_log_epoch(self, trained_streaming):
        qs = make_server(trained_streaming)
        st = qs._streaming
        pub = delta_mod.DeltaPublisher(copy.deepcopy(st["model"]),
                                       delta_mod.DeltaLog(st["dir"]), min_overlap=0.0)
        for ev in ([Ev("u5", "i2", 5.0)], [Ev("u6", "i3", 1.0)]):
            pub.on_committed(ev)
            assert pub.flush()["sealed"]
        qs.stop()

        qs2 = make_server(trained_streaming)
        try:
            st2 = qs2._streaming
            assert st2["applier"].applied_epoch == 2
            assert st2["applier"].stats()["applied"] == 2
            # the restarted replica's scorer serves the caught-up rows
            scorer = st2["algo"]._scorers[id(st2["model"])]._fastpath
            for u in ("u5", "u6"):
                idx, _ = scorer.score_topk(np.array([st2["model"].user_map[u]], np.int32), 3)
                got = [st2["model"].item_map.inverse[int(j)] for j in idx[0]]
                assert got == _host_top(pub.model, u, 3)
        finally:
            qs2.stop()

    def test_wedged_replica_serves_degraded_not_503(self, trained_streaming):
        qs = make_server(trained_streaming)
        st = qs._streaming
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            log = delta_mod.DeltaLog(st["dir"])
            pub = delta_mod.DeltaPublisher(copy.deepcopy(st["model"]), log, min_overlap=0.0)
            pub.on_committed([Ev("u7", "i4", 3.0)])
            assert pub.flush()["sealed"]
            raw = bytearray(open(log.path(1), "rb").read())
            raw[-3] ^= 0xFF
            open(log.path(1), "wb").write(bytes(raw))
            deadline = time.time() + 10
            wedged = False
            while time.time() < deadline:
                status, rz = call("GET", base + "/readyz")
                if status == 200 and rz.get("deltaWedged"):
                    wedged = True
                    break
                time.sleep(0.1)
            assert wedged, "permanently torn blob must not 503-wedge"
            status, res = call("POST", base + "/queries.json", {"user": "u1", "num": 3})
            assert status == 200 and len(res["itemScores"]) == 3
            assert st["applier"].applied_epoch == 0
        finally:
            qs.stop()

    def test_streaming_off_is_invisible(self, trained_streaming, monkeypatch):
        monkeypatch.setenv("PIO_STREAMING", "0")
        qs = make_server(trained_streaming)
        assert qs._streaming is None
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            status, rz = call("GET", base + "/readyz")
            assert status == 200 and "deltaEpoch" not in rz
            status, ref = call("POST", base + "/delta", raw=b"anything")
            assert status == 409 and ref["refused"]
            status, res = call("POST", base + "/queries.json", {"user": "u1", "num": 3})
            assert status == 200 and "degraded" not in res and "staleness_ms" not in res
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                text = r.read().decode()
            assert "pio_delta_" not in text and "pio_freshness_" not in text
        finally:
            qs.stop()

    def test_a_jax_sealed_delta_applies_over_http(self, trained_streaming):
        """The JAX publisher on a JAX copy of the same factors seals into
        the replica's log directory; the port's server applies the pushed
        blob, and an int8 server of the same base re-quantizes its rows."""
        qs = make_server(trained_streaming)
        st = qs._streaming
        base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
        try:
            m = st["model"]
            jm = jax_als.ALSModel(
                user_factors=m.user_factors.copy(), item_factors=m.item_factors.copy(),
                user_map=JaxBiMap.string_int([m.user_map.inverse[i] for i in range(20)]),
                item_map=JaxBiMap.string_int([m.item_map.inverse[i] for i in range(16)]),
                config=jax_als.ALSConfig(rank=4, iterations=1))
            jr, jpub = publish(jm, st["dir"], [Ev("u8", "i9", 5.0), Ev("u8", "i1", 4.0)],
                               module=jax_delta, min_overlap=0.0)
            assert jpub.base_fingerprint == st["fingerprint"]
            status, ack = call("POST", base + "/delta",
                               raw=open(jax_delta.DeltaLog(st["dir"]).path(1), "rb").read())
            assert status == 200 and ack["applied"]
            status, res = call("POST", base + "/queries.json", {"user": "u8", "num": 4})
            assert [x["item"] for x in res["itemScores"]] == _host_top(jpub.model, "u8", 4)
        finally:
            qs.stop()

    def test_jax_batched_server_keeps_base_rows_the_port_serves_the_delta(
            self, trained_streaming, tmp_path, monkeypatch):
        """The logged difference (ROADMAP §3): the JAX server's apply looks
        for ``algo._fastpath``, which the template's algorithm does not
        have, so it never patches its device scorer and only the host model
        moves (on the CPU, jax may alias that numpy memory, so which rows
        its scorer reads there is not fixed); the port patches its scorer,
        and its batched answers equal the JAX server's host answers."""
        import datetime as dt

        from predictionio_tpu.core import persistence as jax_persistence
        from predictionio_tpu.data.storage import base as jax_base
        from predictionio_tpu.data.storage import memory as jax_memory
        from predictionio_tpu.data.storage.registry import Storage as JaxStorage
        from predictionio_tpu.serving.query_server import QueryServer as JaxQueryServer
        from predictionio_tpu.templates import recommendation as jax_rec

        m = trained_streaming["model"]
        jm = jax_als.ALSModel(
            user_factors=m.user_factors.copy(), item_factors=m.item_factors.copy(),
            user_map=JaxBiMap.string_int([m.user_map.inverse[i] for i in range(20)]),
            item_map=JaxBiMap.string_int([m.item_map.inverse[i] for i in range(16)]),
            config=jax_als.ALSConfig(rank=4, iterations=1))
        name = "JS" + uuid.uuid4().hex[:8].upper()
        js = JaxStorage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
                             "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
                             "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
                             "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name})
        engine = jax_rec.RecommendationEngine.apply()
        params = engine.params_from_variant(VARIANT)
        now = dt.datetime.now(tz=dt.timezone.utc)
        inst = jax_base.EngineInstance(
            id="", status="INIT", start_time=now, end_time=now, engine_id="default",
            engine_version="default", engine_variant="default", engine_factory="f",
            **params.to_json_strings())
        instances = js.get_meta_data_engine_instances()
        iid = instances.insert(inst)
        raw = jax_persistence.serialize_models(iid, engine.make_algorithms(params), [jm],
                                               [p for _, p in params.algorithm_params_list])
        js.get_model_data_models().insert(jax_base.Model(
            id=iid, models=jax_persistence.seal_model_blob(raw)))
        inst.status = "COMPLETED"
        instances.update(inst)
        jax_patches = []
        monkeypatch.setattr(JaxBucketedScorer, "apply_delta_rows",
                            lambda self, *a, **k: jax_patches.append(a))
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "jaxbase"))
        jqs = JaxQueryServer(engine, storage=js, ctx=MeshContext.create(devices=jax.devices()[:1]),
                             batching=True)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
        qs = make_server(trained_streaming)
        try:
            st, jst = qs._streaming, jqs._streaming
            assert jst["fingerprint"] == st["fingerprint"]
            pub = delta_mod.DeltaPublisher(copy.deepcopy(st["model"]),
                                           delta_mod.DeltaLog(st["dir"]), min_overlap=0.0)
            pub.on_committed([Ev("u2", "i5", 5.0), Ev("u2", "i11", 5.0)])
            assert pub.flush()["sealed"]
            assert st["applier"].apply(delta_mod.DeltaLog(st["dir"]).read(1))["applied"]
            assert jst["applier"].apply(jax_delta.DeltaLog(st["dir"]).read(1))["applied"]
            scorer = st["algo"]._scorers[id(st["model"])]._fastpath
            jscorer = jst["algo"]._scorers[id(jst["model"])]._fastpath
            assert jscorer is not None and getattr(jst["algo"], "_fastpath", None) is None
            assert jax_patches == [] and scorer.delta_applies == 1  # the difference

            def answer(server, mod, batched):
                d = server._deployed
                algo, model, q = d.algorithms[0], d.models[0], mod.Query(user="u2", num=5)
                pred = (dict(algo.batch_predict(model, [(0, q)]))[0] if batched
                        else algo.predict(model, q))
                return [x.item for x in pred.itemScores]

            port_batched = answer(qs, port_rec, True)
            assert port_batched == answer(jqs, jax_rec, False) == _host_top(pub.model, "u2", 5)
        finally:
            qs.stop()
            jqs.stop()
            jax_memory.reset_store(name)


# -- event-server publisher ---------------------------------------------------


@pytest.fixture()
def es_storage():
    name = "EP" + uuid.uuid4().hex[:8].upper()
    yield Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
                       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
                       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
                       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name})
    port_memory.reset_store(name)


class TestEventServerPublisher:
    def test_attach_replays_events_committed_before_enable(self, es_storage, tmp_path,
                                                           monkeypatch):
        monkeypatch.setenv("PIO_STREAMING", "1")
        monkeypatch.setenv("PIO_DELTA_FLUSH_MS", "60000")
        from predictionio_tpu_torch.data.api.event_server import EventServer

        es = EventServer(storage=es_storage, telemetry=False)
        try:
            es._notify_committed([Ev("u1", "i2", 5.0), Ev("u3", "i4", 2.0)])
            pub = es.enable_delta_publisher(tiny_model(), delta_dir=str(tmp_path / "log"),
                                            min_overlap=0.0)
            assert pub is not None
            assert pub.pending() == 2  # ring replay fed the backlog
            es._delta_flush_once()
            st = pub.stats()
            assert st["sealed"] == 1 and st["log_epoch"] == 1
            dl = delta_mod.DeltaLog(str(tmp_path / "log")).read(1)
            assert set(dl.user_ids) == {"u1", "u3"}
        finally:
            es.stop()

    def test_replayed_commits_never_double_fold(self, es_storage, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_STREAMING", "1")
        monkeypatch.setenv("PIO_DELTA_FLUSH_MS", "60000")
        from predictionio_tpu_torch.data.api.event_server import EventServer

        es = EventServer(storage=es_storage, telemetry=False)
        try:
            events = [Ev("u1", "i2", 5.0, event_id="wal-1"), Ev("u3", "i4", 2.0, event_id="wal-2")]
            es._notify_committed(events)
            pub = es.enable_delta_publisher(tiny_model(), delta_dir=str(tmp_path / "log"),
                                            min_overlap=0.0)
            es._delta_flush_once()
            assert pub.stats()["sealed"] == 1
            es._notify_committed(events)  # the WAL-replay shape
            assert pub.pending() == 0
            assert pub.stats()["dedup_skipped"] == 2
            es._delta_flush_once()
            st = pub.stats()
            assert st["sealed"] == 1 and st["log_epoch"] == 1
        finally:
            es.stop()

    def test_publisher_is_noop_when_streaming_off(self, es_storage, tmp_path):
        from predictionio_tpu_torch.data.api.event_server import EventServer

        es = EventServer(storage=es_storage, telemetry=False)
        try:
            assert es.enable_delta_publisher(tiny_model(), delta_dir=str(tmp_path)) is None
            assert es._recent_committed is None
        finally:
            es.stop()

    def test_posted_events_fold_with_their_stored_ids(self, es_storage, tmp_path, monkeypatch):
        """Every write path notifies the sinks with the id storage holds:
        the buffered fast path, the plain path and the batch path."""
        monkeypatch.setenv("PIO_STREAMING", "1")
        monkeypatch.setenv("PIO_DELTA_FLUSH_MS", "60000")
        from predictionio_tpu_torch.data.api.event_server import EventServer

        app_id = es_storage.get_meta_data_apps().insert(port_base.App(0, "pubapp"))
        key = es_storage.get_meta_data_access_keys().insert(port_base.AccessKey("", app_id, []))
        ids = []
        for mode in ("fast", "off"):
            es = EventServer(storage=es_storage, ingest_mode=mode, ingest_flush_ms=2.0,
                             telemetry=False)
            base = f"http://127.0.0.1:{es.start('127.0.0.1', 0)}"
            pub = es.enable_delta_publisher(tiny_model(), delta_dir=str(tmp_path / mode),
                                            min_overlap=0.0)
            try:
                ev = {"event": "rate", "entityType": "user", "entityId": "u1",
                      "targetEntityType": "item", "targetEntityId": "i2",
                      "properties": {"rating": 4}}
                status, body = call("POST", base + f"/events.json?accessKey={key}", ev)
                posted = [body["eventId"]]
                status, body = call("POST", base + f"/batch/events.json?accessKey={key}",
                                    [dict(ev, entityId="u2"), dict(ev, entityId="u3")])
                posted += [x["eventId"] for x in body]
                deadline = time.time() + 5
                while pub.pending() < 3 and time.time() < deadline:
                    time.sleep(0.01)
                es._delta_flush_once()
                dl = delta_mod.DeltaLog(str(tmp_path / mode)).read(1)
                assert sorted(dl.event_ids) == sorted(posted)
                ids += posted
            finally:
                es.stop()
        stored = {e.event_id for e in es_storage.get_l_events().find(app_id)}
        assert set(ids) <= stored


# -- kill-9 chaos (subprocess) -----------------------------------------------


def run_py(code, env, timeout=60):
    return subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; sys.modules['predictionio_tpu'] = None\n" + code],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


MODEL_SRC = """
import numpy as np
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.als import ALSConfig, ALSModel

def tiny_model(rank=4, n_users=12, n_items=10, seed=7):
    rng = np.random.default_rng(seed)
    return ALSModel(
        user_factors=rng.standard_normal((n_users, rank)).astype(np.float32),
        item_factors=rng.standard_normal((n_items, rank)).astype(np.float32),
        user_map=BiMap.string_int([f"u{i}" for i in range(n_users)]),
        item_map=BiMap.string_int([f"i{i}" for i in range(n_items)]),
        config=ALSConfig(rank=rank, iterations=1, compute_dtype="f32"),
    )
"""


@pytest.fixture()
def chaos_env(tmp_path):
    src = "SCHAOS"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PIO_FAULT_SPEC", "PIO_INGEST_BUFFER", "PIO_DELTA_DIR", "PIO_STREAMING")}
    env.update({
        "PYTHONPATH": ROOT,
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "sqlite",
        f"PIO_STORAGE_SOURCES_{src}_PATH": str(tmp_path / "events.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
        "PIO_WAL_DIR": str(tmp_path / "wal"),
        "PIO_STREAMING": "1",
        "PIO_DELTA_DIR": str(tmp_path / "deltas"),
        "PIO_DELTA_FLUSH_MS": "60000",
        "CHAOS_ACKED_FILE": str(tmp_path / "acked.txt"),
        "CHAOS_APPLIED_FILE": str(tmp_path / "applied.txt"),
    })
    return env


SEAL_CRASH = MODEL_SRC + """
import os, time
from predictionio_tpu_torch.data.api.event_server import EventServer
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage

storage = Storage()
storage.get_l_events().init(1)
es = EventServer(storage=storage, ingest_mode="fast", wal_dir=os.environ["PIO_WAL_DIR"],
                 ingest_flush_ms=300.0, telemetry=False)
# max_events=8: the 8th committed event folds inline during the group
# commit's on_commit hook, after the WAL ack, before wal.commit
pub = es.enable_delta_publisher(tiny_model(), min_overlap=0.0, max_events=8)
assert pub is not None
ack_log = open(os.environ["CHAOS_ACKED_FILE"], "a")
for i in range(8):
    e = Event(event="rate", entity_type="user", entity_id=f"u{i}",
              target_entity_type="item", target_entity_id=f"i{i % 5}",
              properties={"rating": 5.0}, event_id=f"delta-ev-{i:03d}")
    es.ingest_buffer.submit(e, 1)  # WAL-journaled before return: acked
    ack_log.write(e.event_id + "\\n")
    ack_log.flush()
    os.fsync(ack_log.fileno())
time.sleep(30)
raise SystemExit("crash site never fired")
"""

SEAL_VERIFY = MODEL_SRC + """
import json, os
from predictionio_tpu_torch.core import delta as delta_mod
from predictionio_tpu_torch.data.api.event_server import EventServer
from predictionio_tpu_torch.data.storage.registry import Storage

storage = Storage()
es = EventServer(storage=storage, ingest_mode="fast", wal_dir=os.environ["PIO_WAL_DIR"],
                 telemetry=False)
pub = es.enable_delta_publisher(tiny_model(), min_overlap=0.0)
es._delta_flush_once()
st = pub.stats()
ids = sorted(e.event_id for e in storage.get_l_events().find(1))
dl = delta_mod.DeltaLog(pub.log.directory)
delta = dl.read(dl.last_epoch()) if dl.last_epoch() else None
print(json.dumps({
    "replayed": es.wal_replayed, "ids": ids,
    "stats": {"sealed": st["sealed"], "log_epoch": st["log_epoch"]},
    "delta_users": sorted(delta.user_ids) if delta else [],
}))
es.stop()
"""

APPLY_CRASH = MODEL_SRC + """
import os
from predictionio_tpu_torch.core import delta as delta_mod

class Ev:
    def __init__(self, e, t, r):
        self.entity_id, self.target_entity_id = e, t
        self.properties = {"rating": r}

log = delta_mod.DeltaLog(os.environ["CHAOS_DELTA_LOG"])
pub = delta_mod.DeltaPublisher(tiny_model(), log, min_overlap=0.0)
for ev in ([Ev("u1", "i2", 5.0)], [Ev("u3", "i4", 2.0)]):
    pub.on_committed(ev)
    assert pub.flush()["sealed"]
applied = open(os.environ["CHAOS_APPLIED_FILE"], "a")

def apply_fn(dl):
    applied.write(f"{dl.epoch}\\n")
    applied.flush()
    os.fsync(applied.fileno())

applier = delta_mod.DeltaApplier(pub.base_fingerprint, apply_fn, delta_log=log)
applier.catch_up()  # crash:delta:mid_apply kills us BEFORE apply_fn runs
raise SystemExit("crash site never fired")
"""

APPLY_VERIFY = MODEL_SRC + """
import json, os
from predictionio_tpu_torch.core import delta as delta_mod

model = tiny_model()
log = delta_mod.DeltaLog(os.environ["CHAOS_DELTA_LOG"])
fp = delta_mod.model_fingerprint(model.user_factors, model.item_factors)
applied = open(os.environ["CHAOS_APPLIED_FILE"], "a")

def apply_fn(dl):
    applied.write(f"{dl.epoch}\\n")
    applied.flush()
    os.fsync(applied.fileno())

applier = delta_mod.DeltaApplier(fp, apply_fn, delta_log=log)
rc = applier.catch_up()
print(json.dumps({"caught_up": rc.get("caught_up"), "applied_epoch": applier.applied_epoch,
                  "log_epoch": log.last_epoch()}))
"""


@pytest.mark.chaos
class TestStreamingKill9:
    def test_seal_crash_loses_nothing_delta_regrows_on_replay(self, chaos_env):
        """kill -9 between the WAL ack and the seal: no acked event lost,
        and the restarted event server regrows the delta from the same
        durable events (WAL replay → ring → publisher attach)."""
        env = dict(chaos_env)
        env["PIO_FAULT_SPEC"] = "site=crash:delta:before_seal,kind=crash,times=1"
        crash = run_py(SEAL_CRASH, env)
        assert crash.returncode == CRASH_RC, crash.stderr[-2000:]
        acked = [x for x in open(env["CHAOS_ACKED_FILE"]).read().splitlines() if x]
        assert len(acked) == 8
        for _, _, files in os.walk(env["PIO_DELTA_DIR"]):
            assert not [f for f in files if f.startswith("delta-")]
        assert os.listdir(env["PIO_WAL_DIR"])

        verify = run_py(SEAL_VERIFY, chaos_env)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert out["replayed"] >= 8
        assert set(acked) <= set(out["ids"])  # zero acked-event loss
        assert out["stats"]["sealed"] == 1 and out["stats"]["log_epoch"] == 1
        assert out["delta_users"] == [f"u{i}" for i in range(8)]

    def test_mid_apply_crash_restart_catches_up_to_fleet_epoch(self, chaos_env, tmp_path):
        env = dict(chaos_env)
        env["CHAOS_DELTA_LOG"] = str(tmp_path / "applylog")
        env["PIO_FAULT_SPEC"] = "site=crash:delta:mid_apply,kind=crash,times=1"
        crash = run_py(APPLY_CRASH, env)
        assert crash.returncode == CRASH_RC, crash.stderr[-2000:]
        assert open(env["CHAOS_APPLIED_FILE"]).read().strip() == ""

        venv = dict(chaos_env)
        venv["CHAOS_DELTA_LOG"] = env["CHAOS_DELTA_LOG"]
        verify = run_py(APPLY_VERIFY, venv)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert out["caught_up"] == 2
        assert out["applied_epoch"] == out["log_epoch"] == 2
        assert open(venv["CHAOS_APPLIED_FILE"]).read().split() == ["1", "2"]
