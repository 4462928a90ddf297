"""The port's serving fast path against the JAX package's, on the CPU.

The port's ``BucketedScorer`` (on CPU tensors, so every call takes the score
kernel's plain version) is held against the JAX ``BucketedScorer`` with its
XLA ``reference`` backend at every rung × factor dtype, with the hot set on
and off; the per-query ``ALSScorer`` device path (whose blacklist and
whitelist become the kernel's exclusion mask at B = 1) against the JAX
scorer's jitted path; and the copied ``MicroBatcher`` against the behaviour
the JAX tests pin.

Tolerance: values within rtol = atol = 1e-5; indices equal except between
two reference values within that tolerance (``topk_mismatches``).
"""

import threading
import time

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.als import ALSModel as JaxALSModel
from predictionio_tpu.models.als import ALSScorer as JaxALSScorer
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving.fastpath import BucketedScorer as JaxBucketedScorer
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSScorer, als_model_from_arrays
from predictionio_tpu_torch.ops import quantize
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.serving.batching import MicroBatcher
from predictionio_tpu_torch.serving.fastpath import BUCKETS, BucketedScorer, bucket_for

TOL = 1e-5
DTYPES = ("f32", "bf16", "int8")


@pytest.fixture(scope="module")
def ctx():
    return DeviceContext.create(device="cpu")


@pytest.fixture(scope="module")
def jax_ctx():
    return MeshContext.create()


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(5)
    U = rng.normal(size=(40, 6)).astype(np.float32)
    V = rng.normal(size=(29, 6)).astype(np.float32)  # 29: pads to 32 items
    return U, V


def _pair(ctx, jax_ctx, U, V, dtype, max_k=5, **kw):
    """(port scorer, JAX reference scorer) over the same factors."""
    jU, jus = jax_quantize.quantize_factors(U, dtype)
    jV, jvs = jax_quantize.quantize_factors(V, dtype)
    pU, _ = quantize.quantize_factors(U, dtype)
    pV, _ = quantize.quantize_factors(V, dtype)
    port = BucketedScorer(
        ctx, pU, pV, max_k=max_k, factor_dtype=dtype, user_scale=jus,
        item_scale=jvs, **kw,
    )
    ref = JaxBucketedScorer(
        jax_ctx, jU, jV, max_k=max_k, factor_dtype=dtype, user_scale=jus,
        item_scale=jvs, backend="reference", **kw,
    )
    return port, ref


def _assert_match(got, ref):
    (gi, gv), (ri, rv) = got, ref
    bad = topk_mismatches(gv, gi, rv, ri, TOL)
    assert not bad, bad[:3]


class TestBucketLadder:
    def test_bucket_for_picks_smallest_rung(self):
        assert [bucket_for(n) for n in (1, 2, 8, 9, 64)] == [1, 8, 8, 16, 64]

    def test_bucket_for_overflow_is_none(self):
        assert bucket_for(65) is None
        assert bucket_for(3, buckets=(1, 2)) is None

    def test_every_rung_warmed(self, ctx, factors):
        s = BucketedScorer(ctx, *factors, max_k=5)
        assert s.warmup_executions == len(BUCKETS)
        assert s.stats()["kernel"]["warmup_executions"] == len(BUCKETS)
        assert s.stats()["calls"] == 0  # warm-up is not traffic


class TestMatchesJax:
    @pytest.mark.parametrize("batch", BUCKETS)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_rungs(self, ctx, jax_ctx, factors, batch, dtype):
        port, ref = _pair(ctx, jax_ctx, *factors, dtype)
        users = (np.arange(batch, dtype=np.int32) * 7) % 40
        _assert_match(port.score_topk(users, 5), ref.score_topk(users, 5))

    @pytest.mark.parametrize("batch", (3, 11, 40, 100))
    def test_off_rung_and_oversized_batches(self, ctx, jax_ctx, factors, batch):
        port, ref = _pair(ctx, jax_ctx, *factors, "f32")
        users = np.random.default_rng(batch).integers(0, 40, batch)
        got = port.score_topk(users, 3)
        assert got[0].shape == (batch, 3)
        _assert_match(got, ref.score_topk(users, 3))

    def test_hot_set_matches_jax(self, ctx, jax_ctx, factors):
        port, ref = _pair(
            ctx, jax_ctx, *factors, "f32", hot_size=4, hot_refresh_queries=8
        )
        rng = np.random.default_rng(2)
        for _ in range(6):
            users = rng.choice([1, 2, 3, 5, 30], 5)
            _assert_match(port.score_topk(users, 5), ref.score_topk(users, 5))
        ps, rs = port.stats()["hotset"], ref.stats()["hotset"]
        assert ps == rs
        assert ps["refreshes"] > 0 and ps["hits"] > 0

    def test_hit_counters_track_buckets(self, ctx, factors):
        s = BucketedScorer(ctx, *factors, max_k=4)
        s.score_topk(np.zeros(3, np.int32), k=4)  # pads 3 → rung 8
        s.score_topk(np.zeros(8, np.int32), k=4)
        stats = s.stats()
        assert stats["bucket_hits"]["8"] == 2
        assert stats["queries"] == 11
        assert stats["padded_rows"] == 5
        assert stats["row_occupancy"] == round(11 / 16, 4)

    def test_padded_item_tail_never_wins(self, ctx, factors):
        s = BucketedScorer(ctx, *factors, max_k=29)
        idx, _ = s.score_topk(np.arange(16), k=29)
        assert idx.max() < s.n_items

    def test_k_beyond_compiled_width_raises(self, ctx, factors):
        s = BucketedScorer(ctx, *factors, max_k=5)
        with pytest.raises(ValueError):
            s.score_topk(np.array([0]), k=6)


class TestALSScorerDevicePath:
    """``on_device=True`` forces the device branches on a small model: in the
    port they run the kernel's plain version, in the JAX package XLA."""

    @pytest.fixture(scope="class")
    def pair(self, ctx, jax_ctx):
        rng = np.random.default_rng(8)
        U = rng.normal(size=(30, 5)).astype(np.float32)
        V = rng.normal(size=(45, 5)).astype(np.float32)
        users, items = [f"u{i}" for i in range(30)], [f"i{j}" for j in range(45)]
        jm = JaxALSModel(U, V, JaxBiMap.string_int(users), JaxBiMap.string_int(items))
        pm = als_model_from_arrays(U, V, users, items)
        return (
            ALSScorer(ctx, pm, max_k=20, on_device=True),
            JaxALSScorer(jax_ctx, jm, max_k=20, on_device=True),
        )

    @pytest.mark.parametrize(
        "exclude,candidates",
        [(None, None), ([0, 3, 7, 44], None), (None, [2, 5, 9, 11, 40]),
         ([5, 9], [2, 5, 9, 11, 40]), (list(range(44)), None)],
    )
    def test_recommend_filters(self, pair, exclude, candidates):
        port, ref = pair
        for u in (0, 13, 29):
            args = dict(
                exclude_items=None if exclude is None else np.array(exclude),
                candidate_items=None if candidates is None else np.array(candidates),
            )
            pi, pv = port.recommend(u, 10, **args)
            ri, rv = ref.recommend(u, 10, **args)
            assert len(pi) == len(ri)
            _assert_match((pi[None], pv[None]), (np.asarray(ri)[None], np.asarray(rv)[None]))

    def test_recommend_batch(self, pair):
        port, ref = pair
        users = np.arange(0, 30, 3)
        _assert_match(port.recommend_batch(users, 12), ref.recommend_batch(users, 12))

    def test_filtered_call_is_a_rung_one_dispatch(self, ctx):
        """The per-query device path holds no factors of its own: it scores
        through the fast path, and each filtered call is one B = 1 launch
        that the rung-1 counter sees."""
        rng = np.random.default_rng(9)
        U = rng.normal(size=(12, 4)).astype(np.float32)
        V = rng.normal(size=(20, 4)).astype(np.float32)
        pm = als_model_from_arrays(U, V, range(12), range(20))
        scorer = ALSScorer(ctx, pm, max_k=8, on_device=True)
        fp = scorer._fastpath
        assert not hasattr(scorer, "_U") and not hasattr(scorer, "_V")
        scorer.recommend(3, 5, exclude_items=np.array([0, 1]))
        scorer.recommend(4, 5, candidate_items=np.array([2, 6, 7]))
        stats = fp.stats()
        assert stats["bucket_hits"]["1"] == 2 and stats["calls"] == 2
        assert stats["queries"] == 2

    def test_num_beyond_width_goes_to_host(self, pair):
        port, ref = pair
        pi, pv = port.recommend(4, 30)
        ri, rv = ref.recommend(4, 30)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)


class TestMicroBatcher:
    def test_burst_coalesces(self):
        calls = []
        done = threading.Event()

        def run(batch):
            if not done.is_set():
                time.sleep(0.005)  # hold the worker so a burst can pile up
            calls.append(len(batch))
            return [q * 2 for q in batch]

        mb = MicroBatcher(run, max_batch=64, window_ms=50.0)
        try:
            results = [None] * 64
            threads = [
                threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(i)))
                for i in range(64)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            done.set()
            assert results == [i * 2 for i in range(64)]
            assert sum(calls) == 64 and len(calls) < 64
        finally:
            mb.stop()

    def test_trickle_dispatches_immediately(self):
        mb = MicroBatcher(lambda b: list(b), max_batch=64, window_ms=200.0)
        try:
            t0 = time.perf_counter()
            mb.submit("x")
            assert time.perf_counter() - t0 < 0.1
        finally:
            mb.stop()

    @pytest.mark.parametrize("size,expect", [(9, [8, 1]), (64, [64]), (100, [64, 32, 1, 1, 1, 1])])
    def test_held_burst_leaves_as_rung_batches(self, size, expect):
        """A burst queued behind held() dispatches cut at rung boundaries,
        the tail carried into the next batch — never padded."""
        calls = []
        mb = MicroBatcher(lambda b: calls.append(len(b)) or list(b), max_batch=64)
        try:
            results = [None] * size
            threads = [
                threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(i)))
                for i in range(size)
            ]
            with mb.held():
                for t in threads:
                    t.start()
                deadline = time.time() + 5
                while mb.depth() < size - 1 and time.time() < deadline:
                    time.sleep(0.001)
            for t in threads:
                t.join(10)
            assert results == list(range(size))
            assert calls == expect
        finally:
            mb.stop()

    def test_boundary_math(self):
        mb = MicroBatcher(lambda b: list(b), max_batch=64, window_ms=1.0)
        try:
            assert [mb._boundary(n) for n in (1, 8, 9, 63, 64)] == [1, 8, 8, 32, 64]
        finally:
            mb.stop()

    def test_error_propagates_to_every_waiter(self):
        def run(batch):
            raise RuntimeError("boom")

        mb = MicroBatcher(run, max_batch=8, window_ms=5.0)
        try:
            with pytest.raises(RuntimeError, match="boom"):
                mb.submit("q")
        finally:
            mb.stop()

    def test_stats_counters(self):
        mb = MicroBatcher(lambda b: list(b), max_batch=8, window_ms=1.0)
        try:
            for _ in range(3):
                mb.submit("q")
            stats = mb.stats()
            assert stats["queries"] == 3 and stats["batches"] >= 1
            assert sum(stats["batch_sizes"].values()) == stats["batches"]
        finally:
            mb.stop()
