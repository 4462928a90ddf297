"""Bridges: existing component stats → registry Families at scrape time.

Counterpart of ``predictionio_tpu/obs/bridges.py`` with the bridges of the
components the port has: the batcher, the fast path, devprof, the result
cache, error counters, resilience (breakers), the event-server stats and the
latency histogram. The others come with their components.

Every load-bearing runtime layer predates the registry and already keeps
its own thread-safe counters (``MicroBatcher.stats()``, fastpath
``serving_stats``, ``ErrorCounters``, the ingest buffer, the storage
client's breakers, the event-server ``Stats``).  Rather than re-homing
those counters — and adding a second lock acquisition to every hot-path
event — each bridge snapshots the component's existing ``stats()`` dict
when ``/metrics`` is scraped and reshapes it into
:class:`~predictionio_tpu_torch.obs.metrics.Family` samples.  ``/metrics`` is
the single source of truth; the components keep their single lock.

All bridges tolerate missing keys (``.get`` with defaults) so a component
evolving its stats dict degrades a series to 0 instead of breaking the
exposition.
"""

from __future__ import annotations

from typing import Callable, Optional

from predictionio_tpu_torch.obs.metrics import Family, MetricsRegistry

BREAKER_STATE_VALUES = {"closed": 0.0, "open": 1.0, "half_open": 2.0}


def _fam(name: str, kind: str, help: str, samples: list) -> Family:
    return Family(name, kind, help, samples)


def _num(v, default=0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float(default)


# -- serving: micro-batcher --------------------------------------------------

def bridge_batcher(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """MicroBatcher occupancy/EWMA/drop stats → pio_batcher_* series."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        fams = [
            _fam(
                "pio_batcher_batches_total", "counter",
                "Batches executed, split by formation kind.",
                [
                    ("", (("kind", "window"),),
                     _num(s.get("batches")) - _num(s.get("inline_batches"))),
                    ("", (("kind", "inline"),),
                     _num(s.get("inline_batches"))),
                ],
            ),
            _fam(
                "pio_batcher_queries_total", "counter",
                "Queries that passed through the micro-batcher.",
                [("", (), _num(s.get("queries")))],
            ),
            _fam(
                "pio_batcher_coalesced_total", "counter",
                "Single-flight followers served by another identical "
                "query's device slot.",
                [("", (), _num(s.get("coalesced")))],
            ),
            _fam(
                "pio_batcher_expired_dropped_total", "counter",
                "Pendings dropped at dispatch because their deadline "
                "expired while queued.",
                [("", (), _num(s.get("expired_dropped")))],
            ),
            _fam(
                "pio_batcher_depth", "gauge",
                "Queries currently waiting in the batch queue.",
                [("", (), _num(s.get("depth")))],
            ),
            _fam(
                "pio_batcher_avg_batch", "gauge",
                "Mean formed batch size (occupancy) since start.",
                [("", (), _num(s.get("avg_batch")))],
            ),
            _fam(
                "pio_batcher_window_wait_ms", "gauge",
                "Mean window wait per batched query, milliseconds.",
                [("", (), _num(s.get("avg_window_wait_ms")))],
            ),
            _fam(
                "pio_batcher_ewma_gap_ms", "gauge",
                "EWMA of inter-arrival gap driving the adaptive window.",
                [("", (), _num(s.get("ewma_gap_ms")))],
            ),
            _fam(
                "pio_batcher_ewma_run_ms", "gauge",
                "EWMA of batch execution time driving the adaptive window.",
                [("", (), _num(s.get("ewma_run_ms")))],
            ),
        ]
        sizes = s.get("batch_sizes")
        if isinstance(sizes, dict) and sizes:
            fams.append(
                _fam(
                    "pio_batcher_batch_size_total", "counter",
                    "Formed batches by size bucket.",
                    [
                        ("", (("size", str(k)),), _num(v))
                        for k, v in sorted(
                            sizes.items(), key=lambda kv: str(kv[0])
                        )
                    ],
                )
            )
        return fams

    registry.register_collector(collect)


# -- serving: bucketed fast path -----------------------------------------------

def bridge_fastpath(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """BucketedScorer stats → pio_fastpath_* (compiles, bucket hits)."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        fams = [
            _fam(
                "pio_fastpath_compiles_total", "counter",
                "Per-rung compilations by the bucketed scorer; always 0 "
                "on the port (eager PyTorch; the kernel builds once a "
                "process).",
                [("", (), _num(s.get("compile_count")))],
            ),
            _fam(
                "pio_fastpath_calls_total", "counter",
                "score_topk invocations (one per formed batch).",
                [("", (), _num(s.get("calls")))],
            ),
            _fam(
                "pio_fastpath_queries_total", "counter",
                "User rows scored through the fastpath.",
                [("", (), _num(s.get("queries")))],
            ),
            _fam(
                "pio_fastpath_padded_rows_total", "counter",
                "Padding rows wasted by bucket rounding.",
                [("", (), _num(s.get("padded_rows")))],
            ),
            _fam(
                "pio_fastpath_row_occupancy", "gauge",
                "Real rows / padded rows since start (1.0 = no waste).",
                [("", (), _num(s.get("row_occupancy")))],
            ),
        ]
        hits = s.get("bucket_hits")
        if isinstance(hits, dict) and hits:
            fams.append(
                _fam(
                    "pio_fastpath_bucket_hits_total", "counter",
                    "Batches served per bucket rung.",
                    [
                        ("", (("bucket", str(k)),), _num(v))
                        for k, v in sorted(
                            hits.items(), key=lambda kv: _num(kv[0])
                        )
                    ],
                )
            )
        hot = s.get("hotset")
        if isinstance(hot, dict):
            fams.extend([
                _fam(
                    "pio_hotset_lookups_total", "counter",
                    "Fastpath rows answered from the materialized hot-set "
                    "table (hit) vs the bucketed device path (miss).",
                    [
                        ("", (("outcome", "hit"),), _num(hot.get("hits"))),
                        ("", (("outcome", "miss"),), _num(hot.get("misses"))),
                    ],
                ),
                _fam(
                    "pio_hotset_refreshes_total", "counter",
                    "Hot-set re-rank + table materialization passes.",
                    [("", (), _num(hot.get("refreshes")))],
                ),
                _fam(
                    "pio_hotset_size", "gauge",
                    "Configured hot-set working-set bound.",
                    [("", (), _num(hot.get("size")))],
                ),
                _fam(
                    "pio_hotset_resident", "gauge",
                    "Users currently materialized in the hot-set table.",
                    [("", (), _num(hot.get("resident")))],
                ),
            ])
        kern = s.get("kernel")
        if isinstance(kern, dict):
            fams.extend([
                _fam(
                    "pio_kernel_info", "gauge",
                    "Active score-kernel backend and factor dtype "
                    "(info gauge, constant 1; the labels are the signal).",
                    [(
                        "",
                        (
                            ("backend", str(kern.get("backend", ""))),
                            ("dtype", str(kern.get("factor_dtype", ""))),
                        ),
                        1.0,
                    )],
                ),
                _fam(
                    "pio_kernel_resident_factor_bytes", "gauge",
                    "Device-resident factor storage (quantized when a "
                    "bf16/int8 variant is live; int8 ≈ ¼ of fp32).",
                    [("", (), _num(kern.get("resident_factor_bytes")))],
                ),
                _fam(
                    "pio_kernel_intensity_flops_per_byte", "gauge",
                    "Analytic arithmetic intensity of the top scoring "
                    "rung; fused ≫ reference because scores never round-"
                    "trip through HBM.",
                    [("", (), _num(kern.get("intensity_flops_per_byte")))],
                ),
                _fam(
                    "pio_kernel_warmup_executions_total", "counter",
                    "Bucket rungs executed at deploy-time warmup (the "
                    "kernel builds and each rung launches once before the "
                    "first request).",
                    [("", (), _num(kern.get("warmup_executions")))],
                ),
            ])
        return fams

    registry.register_collector(collect)


# -- device utilization -------------------------------------------------------

def bridge_devprof(
    registry: MetricsRegistry,
    snapshot_fn: Callable[[], Optional[dict]],
    generation_fn: Optional[Callable[[], int]] = None,
) -> None:
    """A :class:`~predictionio_tpu_torch.obs.devprof.DeviceUtilization`
    snapshot → the live pio_device_* utilization gauges.

    ``generation_fn`` labels every sample with the model generation the
    live scorer belongs to (the accountant is rebuilt with the scorer on
    reload, so one accountant == one generation). mfu / hbm_util are
    omitted when the platform has no peak-table entry — absent beats a
    fabricated zero.
    """

    def collect():
        s = snapshot_fn()
        if not s:
            return []
        gen = str(generation_fn() if generation_fn is not None else 0)
        lbl = (("generation", gen),)
        fams = [
            _fam(
                "pio_device_busy_fraction", "gauge",
                "Fraction of the rolling window the device spent inside "
                "cost-annotated dispatches.",
                [("", lbl, _num(s.get("busy_fraction")))],
            ),
            _fam(
                "pio_device_flops_per_s", "gauge",
                "Achieved FLOP/s over the rolling window (per-dispatch "
                "cost from the analytic model).",
                [("", lbl, _num(s.get("flops_per_s")))],
            ),
            _fam(
                "pio_device_hbm_gbps", "gauge",
                "Achieved HBM GB/s over the rolling window.",
                [("", lbl, _num(s.get("hbm_gbps")))],
            ),
            _fam(
                "pio_device_dispatches_total", "counter",
                "Cost-annotated device dispatches since this accountant "
                "(== model generation) went live.",
                [("", lbl, _num(s.get("dispatches_total")))],
            ),
            _fam(
                "pio_device_busy_seconds", "gauge",
                "Device seconds spent in dispatches within the window.",
                [("", lbl, _num(s.get("busy_s")))],
            ),
        ]
        if s.get("mfu") is not None:
            fams.append(
                _fam(
                    "pio_device_mfu", "gauge",
                    "Model FLOP utilization: achieved FLOP/s over the "
                    "per-chip peak (devprof.PEAKS).",
                    [("", lbl, _num(s.get("mfu")))],
                )
            )
        if s.get("hbm_util") is not None:
            fams.append(
                _fam(
                    "pio_device_hbm_util", "gauge",
                    "Achieved HBM bandwidth over the per-chip peak.",
                    [("", lbl, _num(s.get("hbm_util")))],
                )
            )
        return fams

    registry.register_collector(collect)


# -- serving: result cache -----------------------------------------------------

def bridge_result_cache(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """ResultCache stats → pio_result_cache_* (hits, invalidation split
    by reason, occupancy)."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        return [
            _fam(
                "pio_result_cache_lookups_total", "counter",
                "Result-cache lookups by outcome.",
                [
                    ("", (("outcome", "hit"),), _num(s.get("hits"))),
                    ("", (("outcome", "miss"),), _num(s.get("misses"))),
                ],
            ),
            _fam(
                "pio_result_cache_invalidated_total", "counter",
                "Cached answers dropped at lookup, by reason: event (an "
                "ingest bump), ttl (backstop lapsed), model (generation "
                "swapped).",
                [
                    ("", (("reason", "event"),),
                     _num(s.get("invalidated_event"))),
                    ("", (("reason", "ttl"),),
                     _num(s.get("invalidated_ttl"))),
                    ("", (("reason", "model"),),
                     _num(s.get("invalidated_model"))),
                ],
            ),
            _fam(
                "pio_result_cache_stores_total", "counter",
                "Answers written into the result cache.",
                [("", (), _num(s.get("stores")))],
            ),
            _fam(
                "pio_result_cache_evictions_total", "counter",
                "LRU evictions under the entry bound.",
                [("", (), _num(s.get("evictions")))],
            ),
            _fam(
                "pio_result_cache_entries", "gauge",
                "Entries currently resident.",
                [("", (), _num(s.get("entries")))],
            ),
            _fam(
                "pio_result_cache_hit_rate", "gauge",
                "Hits / lookups since start.",
                [("", (), _num(s.get("hit_rate")))],
            ),
        ]

    registry.register_collector(collect)


# -- failures and breakers --------------------------------------------------------

def bridge_error_counters(
    registry: MetricsRegistry,
    name: str,
    help: str,
    counters,
) -> None:
    """An :class:`~predictionio_tpu_torch.common.resilience.ErrorCounters` →
    one counter family labeled by kind (includes shed / deadline 504)."""

    def collect():
        snap = counters.snapshot()
        return [
            _fam(
                name, "counter", help,
                [
                    ("", (("kind", str(k)),), _num(v))
                    for k, v in sorted(snap.items())
                ],
            )
        ]

    registry.register_collector(collect)


def bridge_resilience(
    registry: MetricsRegistry,
    stats_fn: Callable[[], Optional[dict]],
    prefix: str = "pio_storage_client",
) -> None:
    """A storage client's ``resilience_stats()`` → retry counter, retry-
    budget gauge, and per-endpoint breaker-state gauges (closed=0,
    open=1, half_open=2)."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        fams = []
        if "retries" in s:
            fams.append(
                _fam(
                    f"{prefix}_retries_total", "counter",
                    "Calls retried under the resilience policy.",
                    [("", (), _num(s.get("retries")))],
                )
            )
        if s.get("retry_budget_tokens") is not None:
            fams.append(
                _fam(
                    f"{prefix}_retry_budget_tokens", "gauge",
                    "Tokens left in the retry budget (exhausted == 0).",
                    [("", (), _num(s.get("retry_budget_tokens")))],
                )
            )
        breakers = s.get("breakers") or []
        if isinstance(breakers, dict):
            breakers = list(breakers.values())
        state_samples, fail_samples, open_samples = [], [], []
        for b in breakers:
            ep = (("endpoint", str(b.get("endpoint", "?"))),)
            state_samples.append(
                ("", ep, BREAKER_STATE_VALUES.get(b.get("state"), -1.0))
            )
            fail_samples.append(
                ("", ep, _num(b.get("consecutive_failures")))
            )
            open_samples.append(("", ep, _num(b.get("open_count"))))
        if state_samples:
            fams.extend(
                [
                    _fam(
                        f"{prefix}_breaker_state", "gauge",
                        "Circuit state per endpoint: 0 closed, 1 open, "
                        "2 half-open.",
                        state_samples,
                    ),
                    _fam(
                        f"{prefix}_breaker_consecutive_failures", "gauge",
                        "Consecutive failures seen by each breaker.",
                        fail_samples,
                    ),
                    _fam(
                        f"{prefix}_breaker_opens_total", "counter",
                        "Times each breaker tripped open.",
                        open_samples,
                    ),
                ]
            )
        return fams

    registry.register_collector(collect)


# -- ingestion ------------------------------------------------------------------

def bridge_event_stats(registry: MetricsRegistry, stats) -> None:
    """Event-server :class:`~predictionio_tpu_torch.data.api.stats.Stats` →
    pio_events_ingested_total{app_id,event,status} (cardinality is capped
    at the Stats layer, overflow bucket included)."""

    def collect():
        samples = []
        for app_id, counts in sorted(stats.snapshot_all().items()):
            for (event, status), n in sorted(counts.items()):
                samples.append(
                    (
                        "",
                        (
                            ("app_id", str(app_id)),
                            ("event", str(event)),
                            ("status", str(status)),
                        ),
                        _num(n),
                    )
                )
        return [
            _fam(
                "pio_events_ingested_total", "counter",
                "Events processed per app, event name, and HTTP status.",
                samples,
            )
        ]

    registry.register_collector(collect)


def bridge_latency_histogram(
    registry: MetricsRegistry, name: str, help: str, hist
) -> None:
    """A :class:`utils.profiling.LatencyHistogram` → Prometheus histogram
    samples (cumulative ``le`` in seconds), without double-observing in
    the hot path."""

    def collect():
        with hist._lock:
            counts = [int(c) for c in hist._counts]
            total = int(hist.total)
        samples = []
        acc = 0
        for b, c in enumerate(counts):
            acc += c
            upper_s = hist._bucket_upper_ms(b) / 1e3
            samples.append(("_bucket", (("le", f"{upper_s:.6g}"),), acc))
        samples.append(("_bucket", (("le", "+Inf"),), total))
        samples.append(("_count", (), total))
        return [_fam(name, "histogram", help, samples)]

    registry.register_collector(collect)
