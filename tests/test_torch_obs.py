"""The port's observability modules against the JAX package's, on the CPU.

The same registry operations give the same ``/metrics`` text, byte for
byte, and the same JSON; ``parse_prometheus`` of either side's text gives
the same series and round-trips the values; the tracer samples, stages and
retains slow traces alike on an injected clock; the bridges of the ported
components emit the same families from the same stats; the devprof cost
models ``score_cost``/``fused_score_cost`` and ``DeviceUtilization``
snapshots from the same records agree within rtol 1e-12 (the CPU row of
the peak table is the same in both; the port drops the TPU row and adds
the H100's two).
"""

import math
import types

import numpy as np
import pytest

from predictionio_tpu import obs as jax_obs
from predictionio_tpu.common import resilience as jax_res
from predictionio_tpu.obs import bridges as jax_bridges
from predictionio_tpu.obs import devprof as jax_devprof
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu.utils import profiling as jax_prof
from predictionio_tpu_torch import obs as port_obs
from predictionio_tpu_torch.common import resilience as port_res
from predictionio_tpu_torch.obs import bridges as port_bridges
from predictionio_tpu_torch.obs import devprof as port_devprof
from predictionio_tpu_torch.obs import metrics as port_metrics
from predictionio_tpu_torch.obs import tracing as port_tracing
from predictionio_tpu_torch.utils import profiling as port_prof

PAIRS = ((jax_metrics, jax_bridges, jax_res, jax_prof), (port_metrics, port_bridges, port_res, port_prof))


def _populate(metrics, bridges, res, prof, seed, with_bridges=True):
    """One seeded sequence of registry operations: labeled counters,
    gauges and histograms, callback gauges, collectors, and (unless
    ``with_bridges`` is False) the ported bridges over the same stats."""
    rng = np.random.default_rng(seed)
    reg = metrics.MetricsRegistry()
    c = reg.counter("t_requests_total", "Requests by route.", ("route", "status"))
    g = reg.gauge("t_depth", "Queue depth.")
    h = reg.histogram("t_latency_seconds", "Latency.", ("route",),
                      buckets=metrics.DEFAULT_LATENCY_BUCKETS)
    for _ in range(300):
        route = ["/q", "/e", 'we"ird\\route\n'][int(rng.integers(3))]
        c.labels(route, str(int(rng.choice([200, 404, 503])))).inc(float(rng.integers(1, 3)))
        h.labels(route).observe(float(rng.exponential(0.01)))
        g.set(float(rng.integers(0, 50)))
    reg.gauge_fn("t_fn", "A callback gauge.", lambda: 2.5)
    reg.gauge_fn("t_nan", "A NaN gauge.", lambda: float("nan"))
    reg.register_collector(lambda: [metrics.Family(
        "t_collected", "gauge", "From a collector.",
        [("", (("k", "a"),), 1.0), ("", (("k", "b"),), math.inf)])])
    if not with_bridges:
        return reg
    counters = res.ErrorCounters("shed", "degraded")
    counters.inc("shed", 3)
    bridges.bridge_error_counters(reg, "t_errors_total", "Errors.", counters)
    hist = prof.LatencyHistogram()
    for v in rng.exponential(0.003, 200):
        hist.observe(float(v))
    bridges.bridge_latency_histogram(reg, "t_query_seconds", "Queries.", hist)
    batcher = {"batches": 40, "inline_batches": 10, "queries": 200, "coalesced": 7,
               "expired_dropped": 1, "depth": 3, "avg_batch": 5.0,
               "batch_sizes": {"1": 10, "8": 20, "16": 10}, "avg_window_wait_ms": 0.4,
               "ewma_gap_ms": 0.2, "ewma_run_ms": 0.3}
    bridges.bridge_batcher(reg, lambda: batcher)
    fastpath = {"compile_count": 0, "calls": 40, "queries": 200, "padded_rows": 30,
                "row_occupancy": 0.87, "bucket_hits": {"1": 10, "8": 20, "16": 10},
                "hotset": {"hits": 5, "misses": 9, "refreshes": 1, "size": 8, "resident": 8},
                "kernel": {"backend": "fused", "factor_dtype": "f32",
                           "resident_factor_bytes": 4096, "intensity_flops_per_byte": 3.2,
                           "warmup_executions": 5}}
    bridges.bridge_fastpath(reg, lambda: fastpath)
    snap = {"platform": "cpu", "window_s": 60.0, "elapsed_s": 10.0, "dispatches_window": 40,
            "dispatches_total": 40, "busy_s": 0.5, "busy_fraction": 0.05,
            "flops_per_s": 1e9, "hbm_gbps": 2.0, "mfu": 0.001, "hbm_util": 0.02}
    bridges.bridge_devprof(reg, lambda: snap, lambda: 3)
    cache = {"hits": 9, "misses": 4, "entries": 4, "evictions": 0, "invalidated": 1,
             "expired": 0, "generation_flushes": 2, "max_entries": 64}
    bridges.bridge_result_cache(reg, lambda: cache)
    breaker = res.CircuitBreaker("feedback", failure_threshold=2)
    breaker.record_failure()
    bridges.bridge_resilience(reg, lambda: {"breakers": [breaker.stats()]}, prefix="t_fb")
    return reg


def _assert_same_series(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == b[key] or (math.isnan(a[key]) and math.isnan(b[key])), key


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_text_byte_for_byte(seed):
    jax_reg, port_reg = (_populate(*p, seed, with_bridges=False) for p in PAIRS)
    jt, pt = jax_reg.render_prometheus(), port_reg.render_prometheus()
    assert jt == pt
    assert jax_reg.render_json() == port_reg.render_json()
    assert "t_requests_total" in pt and "t_latency_seconds_bucket" in pt


@pytest.mark.parametrize("seed", [0, 1])
def test_bridges_emit_the_same_series(seed):
    """The ported bridges over the same stats: the same families, types,
    labels and values. Only HELP texts differ where the port's truth does
    (no XLA compilations, no XLA cost analysis)."""
    jax_reg, port_reg = (_populate(*p, seed) for p in PAIRS)
    jt, pt = jax_reg.render_prometheus(), port_reg.render_prometheus()
    _assert_same_series(port_metrics.parse_prometheus(jt), port_metrics.parse_prometheus(pt))

    def types_of(text):
        return [ln for ln in text.splitlines() if ln.startswith("# TYPE")]

    assert types_of(jt) == types_of(pt)
    assert "t_errors_total" in pt and "pio_batcher_batches_total" in pt
    assert "pio_device_busy_fraction" in pt and "pio_result_cache_lookups_total" in pt


@pytest.mark.parametrize("seed", [0, 3])
def test_parse_prometheus_round_trips(seed):
    text = _populate(*PAIRS[1], seed).render_prometheus()
    a, b = jax_metrics.parse_prometheus(text), port_metrics.parse_prometheus(text)
    _assert_same_series(a, b)
    # the parsed series re-render to the same values: each counter child
    reg = _populate(*PAIRS[1], seed)
    fams = {f.name: f for f in reg.collect()}
    for suffix, labels, value in fams["t_requests_total"].samples:
        assert b[("t_requests_total" + suffix, tuple(labels))] == value
    with pytest.raises(ValueError):
        port_metrics.parse_prometheus("t_bad{le=} 1\n")


def _trace_run(tracing, monkeypatch):
    """Seeded requests through a tracer on a fake clock: sampling, staged
    time (directly, through ``stage`` and across threads by ``scope``),
    finish and the slow-trace ring."""
    clock = {"t": 100.0}
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["t"], time=lambda: 0.0, monotonic=lambda: clock["t"]))
    tracer = tracing.Tracer(sample_rate=0.25, ring_size=16, slow_quantile=0.9, slow_ring_size=4)
    rng = np.random.default_rng(11)
    sampled = []
    for i in range(200):
        rid = f"r{i}" if i % 17 == 0 else None
        t = tracer.begin(request_id=rid, name="POST /queries.json")
        sampled.append(t is not None)
        if t is None:
            continue
        with tracing.scope((t,)):
            with tracing.stage("decode"):
                clock["t"] += float(rng.exponential(1e-4))
            tracing.add_stage("device_compute", float(rng.exponential(5e-5)))
            t.annotate(bucket=int(rng.choice([1, 8])))
        clock["t"] += float(rng.exponential(1e-3))
        t.finish(status=200)
        tracer.record(t)
    strip = [{k: v for k, v in d.items() if k != "requestId"} for d in tracer.recent()]
    slow = [{k: v for k, v in d.items() if k != "requestId"} for d in tracer.slow_recent()]
    return sampled, tracer.seen, tracer.sampled, strip, slow, tracer.slow_threshold_s()


def test_tracer_stages_and_sampling_alike(monkeypatch):
    a = _trace_run(jax_tracing, monkeypatch)
    b = _trace_run(port_tracing, monkeypatch)
    assert a == b
    stages = set().union(*(d["stagesMs"] for d in b[3]))
    assert stages == {"decode", "device_compute", "other"} and b[4]
    assert port_tracing.TRACE_HEADER == jax_tracing.TRACE_HEADER == "X-Request-Id"


def test_profiling_stage_hook_and_histogram_alike(monkeypatch):
    for prof, tracing in ((jax_prof, jax_tracing), (port_prof, port_tracing)):
        t = tracing.Trace("x")
        with tracing.scope((t,)):
            with prof.trace(stage="device_compute"):
                pass
        assert set(t.stages) == {"device_compute"}
    rng = np.random.default_rng(2)
    hs = [jax_prof.LatencyHistogram(), port_prof.LatencyHistogram()]
    for v in rng.exponential(0.01, 500):
        for h in hs:
            h.observe(float(v))
    assert hs[0].summary() == hs[1].summary()
    # the JAX module's device-trace capture is ROADMAP item 15 in the port
    with pytest.raises(NotImplementedError, match="item 15"):
        with port_prof.trace(log_dir="/nonexistent"):
            pass
    monkeypatch.setenv("PIO_PROFILE_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="item 15"):
        with port_prof.trace():
            pass


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch,n_items,rank,k", [(1, 59_392, 10, 100), (64, 59_392, 10, 100),
                                                  (8, 1024, 64, 16), (13, 300, 3, 1)])
def test_devprof_cost_models_alike(dtype, batch, n_items, rank, k):
    np.testing.assert_allclose(port_devprof.score_cost(batch, n_items, rank, dtype),
                               jax_devprof.score_cost(batch, n_items, rank, dtype), rtol=1e-12)
    np.testing.assert_allclose(port_devprof.fused_score_cost(batch, n_items, rank, k, dtype),
                               jax_devprof.fused_score_cost(batch, n_items, rank, k, dtype),
                               rtol=1e-12)


def _util_run(devprof, monkeypatch, platform, window):
    clock = {"t": 50.0}
    monkeypatch.setattr(devprof, "time", types.SimpleNamespace(monotonic=lambda: clock["t"]))
    acc = devprof.DeviceUtilization(platform=platform, window_s=window)
    snaps = [acc.snapshot()]
    for b in (1, 8, 64):
        acc.set_cost(b, *devprof.fused_score_cost(b, 59_392, 10, 100), source="analytic-fused")
    rng = np.random.default_rng(4)
    for _ in range(300):
        clock["t"] += float(rng.exponential(0.05))
        acc.record(int(rng.choice([1, 8, 64])), float(rng.exponential(1e-4)))
        if rng.random() < 0.05:
            snaps.append(acc.snapshot())
    snaps.append(acc.snapshot())
    return snaps, acc.costs()


@pytest.mark.parametrize("window", [5.0, 600.0])
def test_device_utilization_snapshots_alike(monkeypatch, window):
    a_snaps, a_costs = _util_run(jax_devprof, monkeypatch, "cpu", window)
    b_snaps, b_costs = _util_run(port_devprof, monkeypatch, "cpu", window)
    assert a_snaps[0] is None and b_snaps[0] is None and len(a_snaps) == len(b_snaps) > 3
    for sa, sb in zip(a_snaps[1:], b_snaps[1:]):
        assert sa.keys() == sb.keys()
        for key in sa:
            if isinstance(sa[key], float):
                np.testing.assert_allclose(sb[key], sa[key], rtol=1e-12)
            else:
                assert sa[key] == sb[key], key
    assert a_costs == b_costs


def test_peak_table_rows():
    assert port_devprof.PEAKS["cpu"] == jax_devprof.PEAKS["cpu"]
    assert "tpu" not in port_devprof.PEAKS
    assert port_devprof.peak_for("h100-sxm") == {"flops": 989e12, "hbm_gbps": 3.35e12}
    assert port_devprof.peak_for("H100-PCIE") == {"flops": 756e12, "hbm_gbps": 2.0e12}
    assert port_devprof.peak_for("NVIDIA A100-SXM4-80GB") is None
    assert port_devprof.peak_for(None) is None
    assert port_devprof.platform_for("cpu") == "cpu"
    # an unlisted card reports null utilization, as the JAX module does
    acc = port_devprof.DeviceUtilization(platform="some card")
    acc.set_cost(1, 1e6, 1e6)
    acc.record(1, 1e-3)
    snap = acc.snapshot()
    assert snap["mfu"] is None and snap["hbm_util"] is None and snap["busy_s"] == 0.001


def test_telemetry_routes_alike(monkeypatch):
    """``Telemetry`` installs the same routes and the same families on a
    fresh service in both packages."""
    from predictionio_tpu.common.http import HttpService as JaxService
    from predictionio_tpu_torch.common.http import HttpService as PortService

    names = []
    for obs, service in ((jax_obs, JaxService), (port_obs, PortService)):
        svc = service("t")
        tel = obs.maybe_install(svc, "t", sample_rate=1.0)
        assert tel is not None and svc.telemetry is tel
        names.append((sorted(p for _, p in svc._exact),
                      sorted(f.name for f in tel.registry.collect())))
        monkeypatch.setenv("PIO_TELEMETRY", "0")
        assert obs.maybe_install(service("u"), "u") is None and not obs.telemetry_enabled()
        monkeypatch.delenv("PIO_TELEMETRY")
    assert names[0] == names[1]
    assert "/metrics" in names[1][0] and "/trace/recent.json" in names[1][0]
