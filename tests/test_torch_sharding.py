"""Sharded serving on the port, held against the JAX package.

Mirrors ``tests/test_sharding.py``: the plan builder (byte-equal payloads
and equal fingerprints across the packages), sealed persistence, backend
resolution, the sharded fast path on a mesh of repeated CPU placements
(equal to the port's replicated path bit for bit at every rung and dtype,
cross-shard ties and exclusion masks included, and to the JAX sharded
``BucketedScorer`` on a 4-device CPU mesh by rule 4), the pod layout's
two-tier merge, delta rows on the sharded layout, the publish round trip
with its degrade-to-replicated matrix, the ``pio_shard_*`` bridge, ``pio
shards show|rebuild`` with a live ``POST /reload``, and JAX-written plans
deploying in the port with jax blocked.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.core.persistence import ModelIntegrityError as JaxIntegrityError
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.obs import bridges as jax_bridges
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.ops.topk import merge_topk as jax_merge_topk
from predictionio_tpu.parallel.mesh import MeshContext as JaxMeshContext
from predictionio_tpu.serving import sharding as jax_sharding
from predictionio_tpu.serving.fastpath import BucketedScorer as JaxBucketedScorer
from predictionio_tpu_torch.core.persistence import ModelIntegrityError
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSScorer, CheckpointedALSModel, _declare_sharding_plan
from predictionio_tpu_torch.obs import bridges, metrics
from predictionio_tpu_torch.ops.quantize import quantize_factors
from predictionio_tpu_torch.ops.topk import merge_topk, two_tier_merge_topk
from predictionio_tpu_torch.parallel.mesh import MeshContext
from predictionio_tpu_torch.serving import sharding
from predictionio_tpu_torch.serving.fastpath import BucketedScorer, resolve_serving_backend
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.testing import topk_mismatches, warm_cpu_math
from predictionio_tpu_torch.tools import cli as port_cli

warm_cpu_math()  # the first exp/log of a process can be off: testing.warm_cpu_math

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS, RANK = 70, 301, 8
TOL = 1e-5
DTYPES = ("f32", "bf16", "int8")
RUNGS = (1, 8, 16, 32, 64)
CPU = DeviceContext.create(device="cpu")
ENV = ("PIO_SHARD_COUNT", "PIO_SHARD_HBM_BUDGET", "PIO_SHARD_STRATEGY", "PIO_POD_HOST_GROUPS",
       "PIO_SERVING_SHARDING", "PIO_RETRIEVAL", "PIO_QUANT_DTYPE", "PIO_IVF_NLIST")


@pytest.fixture(scope="module")
def ctx():
    """Eight repeated CPU placements: the JAX tests' eight host devices."""
    return MeshContext.create(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_ctx4():
    return JaxMeshContext.create(devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(17)
    U = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    return U, V


@pytest.fixture(scope="module")
def plan(factors):
    _, V = factors
    return sharding.build_plan(N_ITEMS, 4, weights=np.linalg.norm(V, axis=1), strategy="popularity")


@pytest.fixture()
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _equal(a, b):
    (ai, av), (bi, bv) = a, b
    assert np.array_equal(ai, bi) and np.asarray(av).tobytes() == np.asarray(bv).tobytes()


# -- the plan builder -----------------------------------------------------------


class TestBuildPlan:
    @pytest.mark.parametrize("strategy", sharding.STRATEGIES)
    def test_every_strategy_builds_the_jax_plan(self, strategy):
        w = np.random.default_rng(3).random(100)
        w[::7] = w[0]  # ties in the popularity order
        p = sharding.build_plan(100, 4, weights=w, strategy=strategy)
        j = jax_sharding.build_plan(100, 4, weights=w, strategy=strategy)
        p.validate(100)
        assert p.to_payload() == j.to_payload() and p.fingerprint == j.fingerprint
        assert p.shard_sizes().max() <= int(np.ceil(100 / 4))

    @pytest.mark.parametrize("n_items,n_shards,host_groups", [(59, 4, 1), (1000, 7, 1),
                                                             (240, 6, 3), (5, 5, 1)])
    def test_popularity_lpt_equals_jax_at_other_sizes(self, n_items, n_shards, host_groups):
        w = np.random.default_rng(n_items).zipf(1.5, n_items).astype(np.float64)
        p = sharding.build_plan(n_items, n_shards, weights=w, host_groups=host_groups)
        j = jax_sharding.build_plan(n_items, n_shards, weights=w, host_groups=host_groups)
        assert p.to_payload() == j.to_payload()

    def test_popularity_balances_skewed_weights(self):
        w = 1.0 / (np.arange(200) + 1.0)
        lpt = sharding.build_plan(200, 4, weights=w, strategy="popularity")
        naive = sharding.build_plan(200, 4, weights=w, strategy="contiguous")
        assert max(lpt.load_share) / min(lpt.load_share) < 1.05
        assert max(naive.load_share) / min(naive.load_share) > 2.0

    def test_shard_items_ascending(self, plan):
        for s in range(plan.n_shards):
            assert np.all(np.diff(plan.shard_items(s)) > 0)

    def test_budget_derived_count(self):
        assert sharding.shard_count_for_budget(300, 32.0, 2500) == 4
        p = sharding.build_plan(300, capacity_budget_bytes=2500, bytes_per_item=32.0)
        assert p.n_shards == 4 and p.capacity_budget_bytes == 2500
        assert p.to_payload() == jax_sharding.build_plan(
            300, capacity_budget_bytes=2500, bytes_per_item=32.0).to_payload()

    def test_budget_rounding_fills_host_rows_without_overrunning_catalog(self):
        p = sharding.build_plan(300, capacity_budget_bytes=2500, bytes_per_item=32.0,
                                host_groups=3)
        assert p.n_shards == 6 and p.host_groups == 3
        with pytest.raises(ValueError, match="PIO_POD_HOST_GROUPS"):
            sharding.build_plan(7, capacity_budget_bytes=4, bytes_per_item=4.0, host_groups=5)

    def test_explicit_count_indivisible_by_host_groups_names_knob(self):
        with pytest.raises(ValueError, match="PIO_POD_HOST_GROUPS"):
            sharding.build_plan(100, 10, host_groups=3)

    def test_fingerprint_stable_and_assignment_sensitive(self):
        w = np.arange(50, dtype=np.float64)
        a, b = sharding.build_plan(50, 2, weights=w), sharding.build_plan(50, 2, weights=w)
        c = sharding.build_plan(50, 2, weights=w, strategy="round_robin")
        assert a.fingerprint == b.fingerprint != c.fingerprint
        hg = sharding.build_plan(50, 2, weights=w, host_groups=2)
        assert hg.fingerprint == jax_sharding.build_plan(50, 2, weights=w, host_groups=2).fingerprint
        assert hg.fingerprint != a.fingerprint

    def test_invalid_inputs_rejected(self):
        with pytest.raises(ValueError):
            sharding.build_plan(10, 11)
        with pytest.raises(ValueError):
            sharding.build_plan(10, 2, weights=np.ones(9))
        with pytest.raises(ValueError):
            sharding.build_plan(10, 2, weights=-np.ones(10))
        with pytest.raises(ValueError):
            sharding.build_plan(10, 2, strategy="hash")
        with pytest.raises(ValueError):
            sharding.build_plan(10)
        bad = sharding.ShardingPlan(n_shards=3, assignment=np.zeros(6, np.int32),
                                    strategy="popularity", load_share=np.ones(3) / 3)
        with pytest.raises(ValueError, match="empty"):
            bad.validate(6)

    def test_plan_from_env(self, clean_env):
        assert sharding.plan_from_env(100) is None
        clean_env.setenv("PIO_SHARD_COUNT", "3")
        assert sharding.plan_from_env(100).to_payload() == jax_sharding.plan_from_env(100).to_payload()
        clean_env.delenv("PIO_SHARD_COUNT")
        clean_env.setenv("PIO_SHARD_HBM_BUDGET", "2500")
        clean_env.setenv("PIO_SHARD_STRATEGY", "round_robin")
        clean_env.setenv("PIO_POD_HOST_GROUPS", "2")
        p = sharding.plan_from_env(300, bytes_per_item=32.0)
        assert (p.n_shards, p.strategy, p.host_groups) == (4, "round_robin", 2)
        assert p.to_payload() == jax_sharding.plan_from_env(300, bytes_per_item=32.0).to_payload()

    def test_groups_of_shards_and_items_match_jax(self):
        p = sharding.build_plan(60, 6, host_groups=3)
        j = jax_sharding.build_plan(60, 6, host_groups=3)
        assert [p.group_of_shard(s) for s in range(6)] == [j.group_of_shard(s) for s in range(6)]
        assert [p.group_of_item(i) for i in range(60)] == [j.group_of_item(i) for i in range(60)]
        assert p.describe() == j.describe()


class TestPlanPersistence:
    def test_payload_round_trip_across_packages(self, plan):
        j = jax_sharding.ShardingPlan.from_payload(plan.to_payload())
        back = sharding.ShardingPlan.from_payload(j.to_payload())
        assert j.fingerprint == back.fingerprint == plan.fingerprint
        np.testing.assert_array_equal(back.assignment, plan.assignment)

    def test_sealed_file_round_trip_across_packages(self, plan, tmp_path):
        port_path, jax_path = str(tmp_path / "p.blob"), str(tmp_path / "j.blob")
        sharding.save_plan(port_path, plan)
        jax_sharding.save_plan(jax_path, jax_sharding.ShardingPlan.from_payload(plan.to_payload()))
        assert open(port_path, "rb").read() == open(jax_path, "rb").read()
        assert sharding.load_plan(jax_path).fingerprint == plan.fingerprint
        assert jax_sharding.load_plan(port_path).fingerprint == plan.fingerprint

    def test_torn_blob_raises_integrity_error(self, plan, tmp_path):
        path = str(tmp_path / "plan.blob")
        sharding.save_plan(path, plan)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:-5] + b"XXXXX")
        with pytest.raises(ModelIntegrityError):
            sharding.load_plan(path)
        with pytest.raises(JaxIntegrityError):
            jax_sharding.load_plan(path)


# -- backend resolution -----------------------------------------------------------


class TestResolveServingBackend:
    def test_auto_without_plan_is_replicated(self, ctx, clean_env):
        assert resolve_serving_backend(plan=None, ctx=ctx) == "replicated"

    def test_auto_with_plan_and_devices_is_sharded(self, ctx, plan, clean_env):
        assert ctx.n_devices >= plan.n_shards
        assert resolve_serving_backend(plan=plan, ctx=ctx) == "sharded"

    def test_plan_wider_than_mesh_degrades(self, ctx, clean_env, caplog):
        wide = sharding.build_plan(N_ITEMS, ctx.n_devices + 1)
        assert resolve_serving_backend("sharded", plan=wide, ctx=ctx) == "replicated"
        assert "serving replicated" in caplog.text
        assert resolve_serving_backend(plan=wide, ctx=ctx) == "replicated"

    def test_one_card_default_serves_a_plan_replicated(self, plan, clean_env):
        assert resolve_serving_backend(plan=plan, ctx=CPU) == "replicated"
        assert resolve_serving_backend("sharded", plan=plan, ctx=CPU) == "replicated"

    def test_explicit_sharded_without_plan_raises(self, ctx, clean_env):
        with pytest.raises(ValueError, match="requires a ShardingPlan"):
            resolve_serving_backend("sharded", plan=None, ctx=ctx)

    def test_explicit_replicated_ignores_plan(self, ctx, plan, clean_env):
        assert resolve_serving_backend("replicated", plan=plan, ctx=ctx) == "replicated"

    def test_env_knob_respected(self, ctx, plan, clean_env):
        clean_env.setenv("PIO_SERVING_SHARDING", "replicated")
        assert resolve_serving_backend(plan=plan, ctx=ctx) == "replicated"
        clean_env.setenv("PIO_SERVING_SHARDING", "bogus")
        with pytest.raises(ValueError):
            resolve_serving_backend(plan=plan, ctx=ctx)


# -- the sharded fast path: bit for bit the replicated one ------------------------


def _args(U, V, dtype):
    if dtype == "f32":
        return (U, V), {}
    Uq, us = quantize_factors(U, dtype)
    Vq, vs = quantize_factors(V, dtype)
    return (Uq, Vq), {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}


def _scorer_pair(ctx, U, V, plan, dtype, max_k=20):
    args, kw = _args(U, V, dtype)
    repl = BucketedScorer(CPU, *args, max_k=max_k, **kw)
    shrd = BucketedScorer(ctx, *args, max_k=max_k, plan=plan, sharding="sharded", **kw)
    return repl, shrd


class TestShardedBitIdentical:
    @pytest.fixture(scope="class", params=DTYPES)
    def pair(self, request, ctx, factors, plan):
        U, V = factors
        return (request.param, *_scorer_pair(ctx, U, V, plan, request.param))

    @pytest.mark.parametrize("batch", RUNGS)
    def test_exact_equality_per_rung(self, pair, batch):
        _, repl, shrd = pair
        users = np.random.default_rng(batch).integers(0, N_USERS, batch).astype(np.int32)
        _equal(shrd.score_topk(users, 20), repl.score_topk(users, 20))

    def test_beyond_top_rung_chunks(self, pair):
        _, repl, shrd = pair
        users = (np.arange(150, dtype=np.int32) * 3) % N_USERS
        _equal(shrd.score_topk(users, 7), repl.score_topk(users, 7))

    def test_stats_carry_sharding_block(self, pair):
        _, repl, shrd = pair
        shrd.score_topk(np.arange(16, dtype=np.int32), 20)
        assert repl.stats()["sharding"] is None and repl.stats()["serving_backend"] == "replicated"
        st = shrd.stats()
        sh = st["sharding"]
        assert st["serving_backend"] == "sharded" and st["pod"] is None
        assert sh["plan"]["n_shards"] == 4 and sum(sh["result_wins"]) > 0
        assert sh["merge_bytes"] > 0 and len(sh["resident_bytes"]) == 4
        assert sh["local_k"] == 20

    def test_matches_the_jax_sharded_scorer(self, pair, factors, plan, jax_ctx4):
        """Rule 4 against the JAX sharded scorer (reference backend) on a
        4-device CPU mesh."""
        dtype, _, shrd = pair
        U, V = factors
        if dtype == "f32":
            args, kw = (U, V), {}
        else:
            Uq, us = jax_quantize.quantize_factors(U, dtype)
            Vq, vs = jax_quantize.quantize_factors(V, dtype)
            args, kw = (Uq, Vq), {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}
        jplan = jax_sharding.ShardingPlan.from_payload(plan.to_payload())
        jfp = JaxBucketedScorer(jax_ctx4, *args, max_k=20, plan=jplan, sharding="sharded",
                                backend="reference", **kw)
        assert jfp.sharding == "sharded"
        users = np.random.default_rng(5).integers(0, N_USERS, 64).astype(np.int32)
        gi, gv = shrd.score_topk(users, 20)
        ri, rv = jfp.score_topk(users, 20)
        assert not topk_mismatches(gv, gi, np.asarray(rv), np.asarray(ri), TOL)


class TestCrossShardTies:
    def test_duplicate_rows_on_different_shards_tie_break_by_id(self, ctx, factors):
        U, V = factors
        Vt = V.copy()
        Vt[:10] = 0.0
        Vt[:10, 0] = 100.0
        tie_plan = sharding.build_plan(N_ITEMS, 4, strategy="round_robin")
        repl, shrd = _scorer_pair(ctx, U, Vt, tie_plan, "f32")
        users = np.where(U[:, 0] > 0.5)[0][:32].astype(np.int32)
        assert len(users) >= 8
        ri, rv = repl.score_topk(users, 20)
        np.testing.assert_array_equal(ri[:, :10], np.tile(np.arange(10), (len(users), 1)))
        _equal(shrd.score_topk(users, 20), (ri, rv))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_exclusion_mask_spanning_shards(self, ctx, factors, plan, dtype):
        """A per-query exclusion mask laid out over the shards merges to the
        replicated masked top-k exactly: an item excluded on one shard never
        comes back through another's leaderboard."""
        U, V = factors
        repl, shrd = _scorer_pair(ctx, U, V, plan, dtype)
        rng = np.random.default_rng(9)
        mask = rng.random(N_ITEMS) < 0.3
        mask[:40] = True
        excl = np.flatnonzero(mask)
        cand = np.arange(30, 250)
        for u in range(8):
            for args in ((excl, None), (None, cand), (excl, cand)):
                got = shrd.score_topk_filtered(u, 20, *args)
                _equal(got, repl.score_topk_filtered(u, 20, *args))
            assert not mask[shrd.score_topk_filtered(u, 20, excl, None)[0]].any()

    def test_fewer_real_items_than_k_keep_padding_out(self, ctx):
        """Shards smaller than k give their whole block; pad slots carry
        PAD_SENTINEL and never win, even with most items excluded."""
        rng = np.random.default_rng(4)
        U = rng.normal(size=(5, 4)).astype(np.float32)
        V = rng.normal(size=(13, 4)).astype(np.float32)
        p = sharding.build_plan(13, 4, strategy="contiguous")
        repl, shrd = _scorer_pair(ctx, U, V, p, "f32", max_k=13)
        _equal(shrd.score_topk(np.arange(5, dtype=np.int32), 13),
               repl.score_topk(np.arange(5, dtype=np.int32), 13))
        got = shrd.score_topk_filtered(0, 13, np.arange(10), None)
        _equal(got, repl.score_topk_filtered(0, 13, np.arange(10), None))
        assert (got[0] < 13).all()


# -- the pod layout: the two-tier merge ----------------------------------------------


class TestPodLayout:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_pod_plan_merges_in_two_tiers_bit_for_bit(self, ctx, factors, dtype):
        U, V = factors
        pod = sharding.build_plan(N_ITEMS, 4, weights=np.linalg.norm(V, axis=1), host_groups=2)
        repl, shrd = _scorer_pair(ctx, U, V, pod, dtype)
        assert shrd._pod and shrd._shard_ctx.mesh.shape == {"host": 2, "data": 2}
        for b in RUNGS:
            users = np.random.default_rng(b).integers(0, N_USERS, b).astype(np.int32)
            _equal(shrd.score_topk(users, 20), repl.score_topk(users, 20))
        st = shrd.stats()["pod"]
        assert (st["host_groups"], st["shards_per_group"], st["process_count"]) == (2, 2, 1)
        assert st["dispatches"] == len(RUNGS) and st["cross_host_merge_bytes"] > 0

    def test_two_tier_merge_equals_the_flat_merge_and_jax(self):
        rng = np.random.default_rng(2)
        vals = [torch.from_numpy(rng.integers(0, 6, (5, 7)).astype(np.float32)) for _ in range(6)]
        ids = [torch.from_numpy(rng.permutation(1000)[:35].reshape(5, 7).astype(np.int32))
               for _ in range(6)]
        tv, ti = two_tier_merge_topk(vals, ids, 9, host_groups=3)
        fv, fi = merge_topk(torch.cat(vals, 1), torch.cat(ids, 1), 9)
        jv, ji = jax_merge_topk(jax.numpy.asarray(torch.cat(vals, 1).numpy()),
                                jax.numpy.asarray(torch.cat(ids, 1).numpy()), 9)
        assert torch.equal(tv, fv) and torch.equal(ti, fi)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        with pytest.raises(ValueError, match="divide"):
            two_tier_merge_topk(vals, ids, 9, host_groups=4)

    def test_pod_bridge_emits_the_second_tier(self, ctx, factors):
        U, V = factors
        pod = sharding.build_plan(N_ITEMS, 4, host_groups=2)
        _, shrd = _scorer_pair(ctx, U, V, pod, "f32")
        shrd.score_topk(np.arange(8, dtype=np.int32), 20)
        reg = metrics.MetricsRegistry()
        bridges.bridge_pod(reg, lambda: shrd.stats()["pod"])
        series = metrics.parse_prometheus(reg.render_prometheus())
        assert series[("pio_pod_host_groups", ())] == 2.0
        assert series[("pio_pod_cross_host_merge_bytes_total", ())] == 2 * 8 * 20 * 8
        info = {k[1]: v for k, v in series.items() if k[0] == "pio_pod_process_info"}
        assert list(info.values()) == [1.0]
        assert dict(next(iter(info))) == {"index": "0", "count": "1"}


class TestDeltaRows:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_delta_rows_land_in_their_shard_slots(self, ctx, factors, plan, dtype):
        U, V = factors
        repl, shrd = _scorer_pair(ctx, U, V, plan, dtype)
        rng = np.random.default_rng(11)
        items = np.array([0, 7, 100, 200, 300, N_ITEMS + 5])  # the last is dropped
        rows_i = rng.normal(size=(len(items), RANK)).astype(np.float32) * 3
        rows_u = rng.normal(size=(3, RANK)).astype(np.float32)
        before = shrd._factors[4]
        for fp in (repl, shrd):
            out = fp.apply_delta_rows([1, 2, 3], rows_u, items, rows_i)
            assert (out["users"], out["items"]) == (3, 5)
        # the global ids (and masks) are never copied
        assert all(a is b for a, b in zip(shrd._factors[4], before))
        for b in RUNGS:
            users = np.arange(b, dtype=np.int32) % N_USERS
            _equal(shrd.score_topk(users, 20), repl.score_topk(users, 20))
        assert shrd.stats()["deltas"] == {"applied": 1, "rows": 8}


# -- publish → load round trip ----------------------------------------------------


def _model(n_users=40, n_items=60, rank=6, seed=3):
    rng = np.random.default_rng(seed)
    return CheckpointedALSModel(
        rng.standard_normal((n_users, rank)).astype(np.float32),
        rng.standard_normal((n_items, rank)).astype(np.float32),
        BiMap.string_int(f"u{i}" for i in range(n_users)),
        BiMap.string_int(f"i{i}" for i in range(n_items)),
        None,
    )


@pytest.fixture()
def basedir(tmp_path, clean_env):
    clean_env.setenv("PIO_FS_BASEDIR", str(tmp_path))
    return tmp_path


def _shard_meta(instance_id):
    with open(os.path.join(CheckpointedALSModel._dir(instance_id), "maps.pkl"), "rb") as f:
        return pickle.load(f)["sharding"]


class TestPublishRoundTrip:
    def test_plan_survives_save_load(self, ctx, basedir):
        m = _model()
        m.sharding_plan = sharding.build_plan(60, 3)
        assert m.save("inst-plan", None)
        assert os.path.exists(os.path.join(CheckpointedALSModel._dir("inst-plan"), "plan.blob"))
        meta = _shard_meta("inst-plan")
        assert meta == {"n_shards": 3, "strategy": "popularity",
                        "fingerprint": m.sharding_plan.fingerprint, "host_groups": 1}
        m2 = CheckpointedALSModel.load("inst-plan", None, ctx)
        assert m2.sharding_plan.fingerprint == m.sharding_plan.fingerprint
        fp = ALSScorer(ctx, m2).enable_fastpath()
        assert fp.sharding == "sharded"
        ref = ALSScorer(CPU, m).enable_fastpath()
        _equal(fp.score_topk(np.arange(10), 5), ref.score_topk(np.arange(10), 5))

    def test_unsharded_publish_records_zero(self, ctx, basedir):
        m = _model()
        m.save("inst-none", None)
        assert _shard_meta("inst-none") == {"n_shards": 0}
        m2 = CheckpointedALSModel.load("inst-none", None, ctx)
        assert m2.sharding_plan is None
        assert ALSScorer(ctx, m2).enable_fastpath().sharding == "replicated"

    def test_torn_plan_degrades_to_replicated(self, ctx, basedir, caplog):
        m = _model()
        m.sharding_plan = sharding.build_plan(60, 3)
        m.save("inst-torn", None)
        blob = os.path.join(CheckpointedALSModel._dir("inst-torn"), "plan.blob")
        data = open(blob, "rb").read()
        with open(blob, "wb") as f:
            f.write(data[:-6] + b"YYYYYY")
        m2 = CheckpointedALSModel.load("inst-torn", None, ctx)
        assert m2.sharding_plan is None and "serving replicated" in caplog.text
        np.testing.assert_array_equal(m2.user_factors, m.user_factors)
        assert ALSScorer(ctx, m2).enable_fastpath().sharding == "replicated"

    def test_fingerprint_mismatch_degrades(self, ctx, basedir):
        m = _model()
        m.sharding_plan = sharding.build_plan(60, 3)
        m.save("inst-fpmm", None)
        maps_path = os.path.join(CheckpointedALSModel._dir("inst-fpmm"), "maps.pkl")
        with open(maps_path, "rb") as f:
            meta = pickle.load(f)
        meta["sharding"]["fingerprint"] = "0" * 16
        with open(maps_path, "wb") as f:
            pickle.dump(meta, f)
        assert CheckpointedALSModel.load("inst-fpmm", None, ctx).sharding_plan is None

    def test_env_declared_plan_at_publish_matches_jax(self, basedir, clean_env):
        clean_env.setenv("PIO_SHARD_COUNT", "4")
        m = _declare_sharding_plan(_model())
        jm = jax_als._declare_sharding_plan(jax_als.ALSModel(
            m.user_factors, m.item_factors, None, None, None))
        assert m.sharding_plan.n_shards == 4 and m.sharding_plan.strategy == "popularity"
        assert m.sharding_plan.to_payload() == jm.sharding_plan.to_payload()

    def test_a_bad_declaration_publishes_unsharded(self, basedir, clean_env, caplog):
        clean_env.setenv("PIO_SHARD_COUNT", "1000")  # more shards than items
        m = _declare_sharding_plan(_model())
        assert m.sharding_plan is None and "publishing unsharded" in caplog.text


# -- metrics bridge ------------------------------------------------------------------


class TestBridge:
    def test_bridge_emits_per_shard_series(self, ctx, factors, plan):
        U, V = factors
        _, shrd = _scorer_pair(ctx, U, V, plan, "f32")
        shrd.score_topk(np.arange(16, dtype=np.int32), 10)
        reg = metrics.MetricsRegistry()
        bridges.bridge_sharding(reg, shrd.stats)
        series = metrics.parse_prometheus(reg.render_prometheus())
        fp = plan.fingerprint
        assert series[("pio_shard_info", (("fingerprint", fp), ("strategy", "popularity")))] == 4.0
        for s in range(4):
            lbl = (("shard", str(s)),)
            assert series[("pio_shard_items", lbl)] > 0
            assert series[("pio_shard_resident_bytes", lbl)] > 0
            assert series[("pio_shard_queries_routed_total", lbl)] == 16.0
        assert sum(series[("pio_shard_result_wins_total", (("shard", str(s)),))]
                   for s in range(4)) == 160.0
        assert series[("pio_shard_merge_bytes_total", ())] > 0

    def test_bridge_renders_as_the_jax_bridge(self, ctx, factors, plan):
        U, V = factors
        _, shrd = _scorer_pair(ctx, U, V, plan, "f32")
        shrd.score_topk(np.arange(8, dtype=np.int32), 10)
        stats = shrd.stats()
        reg, jreg = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
        bridges.bridge_sharding(reg, lambda: stats)
        jax_bridges.bridge_sharding(jreg, lambda: stats)
        assert reg.render_prometheus() == jreg.render_prometheus()

    def test_bridge_silent_when_replicated(self, ctx, factors):
        U, V = factors
        repl = BucketedScorer(ctx, U, V, max_k=5, sharding="replicated")
        reg = metrics.MetricsRegistry()
        bridges.bridge_sharding(reg, repl.stats)
        bridges.bridge_pod(reg, lambda: repl.stats()["pod"])
        text = reg.render_prometheus()
        assert "pio_shard_" not in text and "pio_pod_" not in text


# -- the CLI: train under PIO_SHARD_COUNT, show, rebuild, reload -------------------


def _http(url, body=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(url):
    t_end = time.monotonic() + 60
    while time.monotonic() < t_end:
        try:
            urllib.request.urlopen(url, timeout=5).close()
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"{url} never answered")


class TestShardsCLI:
    def test_show_and_rebuild(self, basedir, capsys):
        m = _model()
        m.sharding_plan = sharding.build_plan(60, 3)
        m.save("inst-cli", None)
        old_fp = m.sharding_plan.fingerprint
        assert port_cli.main(["shards", "show"]) == 0
        rows = json.loads(capsys.readouterr().out)
        assert rows[0]["instance"] == "inst-cli" and rows[0]["fingerprint"] == old_fp
        assert port_cli.main(["shards", "rebuild", "--instance", "inst-cli", "--shards", "5",
                              "--strategy", "round_robin", "--weights", "uniform"]) == 0
        out = capsys.readouterr().out
        assert "POST /reload" in out
        m2 = CheckpointedALSModel.load("inst-cli", None, CPU)
        assert (m2.sharding_plan.n_shards, m2.sharding_plan.strategy) == (5, "round_robin")
        assert _shard_meta("inst-cli")["fingerprint"] == m2.sharding_plan.fingerprint != old_fp
        assert m2.sharding_plan.to_payload() == jax_sharding.build_plan(
            60, 5, strategy="round_robin").to_payload()
        # the norm weights are the JAX rebuild's popularity weights
        assert port_cli.main(["shards", "rebuild", "--instance", "inst-cli", "--shards", "4",
                              "--host-groups", "2"]) == 0
        want = jax_sharding.build_plan(60, 4, weights=np.linalg.norm(m.item_factors, axis=1),
                                       host_groups=2)
        assert CheckpointedALSModel.load("inst-cli", None, CPU).sharding_plan.fingerprint == \
            want.fingerprint
        assert port_cli.main(["shards", "rebuild", "--instance", "inst-cli", "--shards", "99"]) == 1
        assert port_cli.main(["shards", "show", "--instance", "nope"]) == 0
        assert "no sharding plan" in capsys.readouterr().out

    def test_cli_train_deploy_rebuild_reload_swaps_the_fingerprint(self, tmp_path, clean_env,
                                                                   capsys):
        """``pio train`` under ``PIO_SHARD_COUNT=4`` in checkpoint mode; a
        one-device ``pio deploy --batching`` serves replicated with no
        fingerprint on ``/readyz``; a server on a mesh of four CPU
        placements serves the plan sharded, and after ``pio shards rebuild
        --shards 2`` a ``POST /reload`` swaps ``shardingFingerprint`` with
        the answers unchanged."""
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_IVF_")):
                clean_env.delenv(k)
        clean_env.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
        Storage.reset_instance()
        port = _free_port()
        factory = port_cli.BUILTIN_TEMPLATES["recommendation"]
        qs = None
        try:
            assert port_cli.main(["app", "new", "ShardApp"]) == 0
            storage = Storage.instance()
            app_id = storage.get_meta_data_apps().get_by_name("ShardApp").id
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
                "engineFactory": factory, "datasource": {"params": {"appName": "ShardApp"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 6, "numIterations": 3, "persistMode": "checkpoint"}}]}))
            clean_env.setenv("PIO_SHARD_COUNT", "4")
            assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 0
            iid = re.search(r"Engine instance ID: (\S+)", capsys.readouterr().out).group(1)
            clean_env.delenv("PIO_SHARD_COUNT")
            model = CheckpointedALSModel.load(iid, None, CPU)
            want = jax_sharding.build_plan(len(model.item_factors), 4,
                                           weights=np.linalg.norm(model.item_factors, axis=1))
            assert model.sharding_plan.fingerprint == want.fingerprint
            assert port_cli.main(["shards", "show", "--instance", iid]) == 0
            assert json.loads(capsys.readouterr().out)[0]["n_shards"] == 4

            # one device: the plan serves replicated
            t = threading.Thread(target=port_cli.main, args=([
                "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
                "--batching", "--device", "cpu"],), daemon=True)
            t.start()
            base = f"http://127.0.0.1:{port}"
            _wait(f"{base}/readyz")
            ready = _http(f"{base}/readyz")
            assert ready["servingBackend"] == "replicated" and "shardingFingerprint" not in ready
            one = [_http(f"{base}/queries.json", {"user": f"u{u}", "num": 5}) for u in range(10)]
            assert port_cli.main(["undeploy", "--port", str(port)]) == 0
            t.join(30)

            # a mesh of four placements: sharded, then the live swap
            qs = QueryServer(port_cli.resolve_engine_from_variant({"engineFactory": factory}),
                             storage=storage, ctx=DeviceContext.create(devices=["cpu"] * 4),
                             engine_id=factory, batching=True)
            base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
            ready = _http(f"{base}/readyz")
            assert ready["servingBackend"] == "sharded"
            assert ready["shardingFingerprint"] == want.fingerprint
            four = [_http(f"{base}/queries.json", {"user": f"u{u}", "num": 5}) for u in range(10)]
            assert four == one
            assert port_cli.main(["shards", "rebuild", "--instance", iid, "--shards", "2"]) == 0
            new_fp = re.findall(r'"fingerprint": "(\w+)"', capsys.readouterr().out)[-1]
            assert _http(f"{base}/reload", {}, method="POST")["engineInstanceId"] == iid
            ready = _http(f"{base}/readyz")
            assert ready["shardingFingerprint"] == new_fp != want.fingerprint
            assert [_http(f"{base}/queries.json", {"user": f"u{u}", "num": 5})
                     for u in range(10)] == one
            fp = _http(f"{base}/")["fastpath"][0]
            assert fp["serving_backend"] == "sharded" and fp["sharding"]["plan"]["n_shards"] == 2
            with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
                text = r.read().decode()
            assert f'pio_shard_info{{fingerprint="{new_fp}",strategy="popularity"}} 2' in text
        finally:
            if qs is not None:
                qs.stop()
            Storage.reset_instance()
            port_sqlite.close_all_dbs()


# -- JAX-written plans deploy in the port with jax blocked ------------------------


def _run_blocked(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_jax_written_sharded_instance_deploys_with_jax_blocked(tmp_path, clean_env):
    """The JAX ``pio train`` under ``PIO_SHARD_COUNT=4`` (auto mode) writes
    an instance whose model carries its plan; a subprocess with jax and
    ``predictionio_tpu`` blocked deploys it with the port on four CPU
    placements, serves it sharded under the JAX plan's fingerprint, and
    answers as the JAX model does (rule 4)."""
    from predictionio_tpu.core import persistence as jax_persistence
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage import sqlite as jax_sqlite
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.templates import recommendation as jax_rec
    from predictionio_tpu.tools import cli as jax_cli

    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_QUANT_")):
            clean_env.delenv(k)
    clean_env.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    clean_env.setattr(jax_cli, "make_ctx", lambda *a, **k: JaxMeshContext.create(
        devices=jax.devices()[:1]), raising=False)
    factory = "predictionio_tpu.templates.recommendation.RecommendationEngine"
    JaxStorage.reset_instance()
    try:
        assert jax_cli.main(["app", "new", "Shared"]) == 0
        storage = JaxStorage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("Shared").id
        rng = np.random.default_rng(2)
        storage.get_l_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                     target_entity_type="item", target_entity_id=f"i{int(i)}",
                     properties={"rating": int(r)}, event_time=1_767_225_600.0 + k)
            for k, (u, i, r) in enumerate(zip(rng.integers(0, 25, 500), rng.integers(0, 20, 500),
                                              rng.integers(1, 6, 500)))], app_id)
        d = tmp_path / "engine"
        d.mkdir()
        (d / "engine.json").write_text(json.dumps({
            "engineFactory": factory, "datasource": {"params": {"appName": "Shared"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3}}]}))
        clean_env.setenv("PIO_SHARD_COUNT", "4")
        assert jax_cli.main(["train", "--engine-dir", str(d)]) == 0
        clean_env.delenv("PIO_SHARD_COUNT")
        inst = storage.get_meta_data_engine_instances().get_latest_completed(
            factory, "default", "default")
        params = jax_rec.ALSAlgorithmParams()
        model = jax_persistence.deserialize_models(
            jax_persistence.open_model_blob(storage.get_model_data_models().get(inst.id).models),
            inst.id, [jax_rec.ALSAlgorithm(params)], [params], None)[0][0]
    finally:
        JaxStorage.reset_instance()
        jax_sqlite.close_all_dbs()
    assert model.sharding_plan is not None and model.sharding_plan.n_shards == 4

    out = _run_blocked(f"""
import json, sys, urllib.request
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
from predictionio_tpu_torch.core.workflow import resolve_engine
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.serving.query_server import QueryServer
qs = QueryServer(resolve_engine({factory!r}), storage=Storage.instance(),
                 ctx=DeviceContext.create(devices=["cpu"] * 4), engine_id={factory!r},
                 batching=True)
base = f"http://127.0.0.1:{{qs.start('127.0.0.1', 0)}}"
def get(path, body=None):
    req = urllib.request.Request(base + path, data=None if body is None else
                                 json.dumps(body).encode(),
                                 headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())
out = {{"ready": get("/readyz"),
        "answers": {{f"u{{k}}": get("/queries.json", {{"user": f"u{{k}}", "num": 5}})
                    for k in range(25)}}}}
qs.stop()
out["foreign"] = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'predictionio_tpu')]
print(json.dumps(out))
""")
    assert out["foreign"] == []
    assert out["ready"]["servingBackend"] == "sharded"
    assert out["ready"]["shardingFingerprint"] == model.sharding_plan.fingerprint
    for u, answer in out["answers"].items():
        got = answer["itemScores"]
        row = model.user_factors[model.user_map[u]] @ model.item_factors.T
        ref = np.argsort(-row, kind="stable")[:5]
        assert not topk_mismatches(np.array([[x["score"] for x in got]]),
                                   np.array([[model.item_map[x["item"]] for x in got]]),
                                   row[ref][None], ref[None], TOL)


def test_jax_written_plan_blob_deploys_with_jax_blocked(basedir):
    """A ``plan.blob`` the JAX package sealed (``save_plan``) beside a port
    checkpoint instance, with the JAX manifest record, loads in a process
    with jax blocked and serves sharded on four CPU placements, equal to
    the replicated answers bit for bit."""
    m = _model()
    m.save("inst-jaxplan", None)
    d = CheckpointedALSModel._dir("inst-jaxplan")
    jplan = jax_sharding.build_plan(60, 4, strategy="contiguous")
    jax_sharding.save_plan(os.path.join(d, "plan.blob"), jplan)
    maps_path = os.path.join(d, "maps.pkl")
    with open(maps_path, "rb") as f:
        meta = pickle.load(f)
    meta["sharding"] = {"n_shards": 4, "strategy": "contiguous",
                        "fingerprint": jplan.fingerprint, "host_groups": 1}
    with open(maps_path, "wb") as f:
        pickle.dump(meta, f)
    out = _run_blocked("""
import json, sys
import numpy as np
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSScorer, CheckpointedALSModel
mesh = DeviceContext.create(devices=["cpu"] * 4)
m = CheckpointedALSModel.load("inst-jaxplan", None, mesh)
shrd = ALSScorer(mesh, m).enable_fastpath()
repl = ALSScorer(DeviceContext.create(device="cpu"), m).enable_fastpath()
users = np.arange(40)
(si, sv), (ri, rv) = shrd.score_topk(users, 10), repl.score_topk(users, 10)
print(json.dumps({"fp": m.sharding_plan.fingerprint, "backend": shrd.sharding,
                  "equal": bool(np.array_equal(si, ri) and sv.tobytes() == rv.tobytes())}))
""")
    assert out == {"fp": jplan.fingerprint, "backend": "sharded", "equal": True}
