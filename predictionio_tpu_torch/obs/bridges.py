"""Bridges: existing component stats → registry Families at scrape time.

Counterpart of ``predictionio_tpu/obs/bridges.py`` with the bridges of the
components the port has: the batcher, the fast path, sharded serving and
its pod layout (the router's group fan-out too), IVF retrieval, devprof, the result cache, the
template event cache, tenancy, the pipeline, error counters, resilience
(breakers), the fleet supervisor, the autoscaler, the canary controller,
the event-server stats, the ingest buffer with its WAL and the latency
histogram. The training kernel's bridge comes with the port's first
benchmark (ROADMAP §1 item 12).

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


def bridge_sharding(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """Sharded-serving accounting → pio_shard_* series.

    Emits nothing while the scorer serves replicated (no ``sharding`` block
    in its stats), so the families appear exactly while a plan serves.
    ``pio_shard_busy_fraction`` is attributed: the measured busy fraction
    apportioned across shards by their realized result share. Family names
    and help texts are the JAX package's.
    """

    def collect():
        s = stats_fn()
        sh = (s or {}).get("sharding")
        if not isinstance(sh, dict):
            return []
        plan = sh.get("plan") or {}
        n = int(_num(plan.get("n_shards")))

        def per_shard(values, cast=_num):
            vals = values if isinstance(values, list) else []
            return [
                ("", (("shard", str(i)),), cast(v))
                for i, v in enumerate(vals[:n])
            ]

        fams = [
            _fam(
                "pio_shard_info", "gauge",
                "Active sharding plan (info gauge; value is the shard "
                "count, labels carry the plan identity).",
                [(
                    "",
                    (
                        ("fingerprint", str(plan.get("fingerprint", ""))),
                        ("strategy", str(plan.get("strategy", ""))),
                    ),
                    float(n),
                )],
            ),
            _fam(
                "pio_shard_items", "gauge",
                "Catalog items assigned to each shard by the plan.",
                per_shard(plan.get("items_per_shard")),
            ),
            _fam(
                "pio_shard_resident_bytes", "gauge",
                "Device-resident item-factor bytes per shard (padded "
                "block; must fit the per-shard HBM budget).",
                per_shard(sh.get("resident_bytes")),
            ),
            _fam(
                "pio_shard_queries_routed_total", "counter",
                "Query rows fanned out to each shard (every shard scores "
                "every row of every dispatch).",
                per_shard(sh.get("queries_routed")),
            ),
            _fam(
                "pio_shard_result_wins_total", "counter",
                "Top-k result slots won by each shard's items — the "
                "realized popularity load the plan balances.",
                per_shard(sh.get("result_wins")),
            ),
            _fam(
                "pio_shard_load_share", "gauge",
                "Expected per-shard traffic share the plan was balanced "
                "with (build-time weights).",
                per_shard(plan.get("load_share")),
            ),
            _fam(
                "pio_shard_result_share", "gauge",
                "Realized per-shard share of returned top-k slots.",
                per_shard(sh.get("result_share")),
            ),
            _fam(
                "pio_shard_merge_bytes_total", "counter",
                "Cumulative cross-shard merge collective payload "
                "(all-gathered leaderboard bytes; see perf_roofline.md).",
                [("", (), _num(sh.get("merge_bytes")))],
            ),
            _fam(
                "pio_shard_merge_seconds_total", "counter",
                "Device wall attributed to the merge collective (modeled "
                "as the merge-byte share of each dispatch).",
                [("", (), _num(sh.get("merge_seconds")))],
            ),
        ]
        busy = sh.get("busy_fraction")
        if isinstance(busy, list):
            fams.append(
                _fam(
                    "pio_shard_busy_fraction", "gauge",
                    "Measured window busy fraction attributed across "
                    "shards by realized result-load share; max/min is "
                    "the balance the bench gates on.",
                    per_shard(busy),
                )
            )
        return fams

    registry.register_collector(collect)


def bridge_pod(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """Pod-scale serving accounting → pio_pod_* series. One bridge, two
    emitters: a query server's fast path exposes its ``pod`` block
    (host-group topology, process slot, cross-host merge traffic), a router
    its group fan-out counters (queries routed per group, fleet-wide
    fallbacks). Each family appears exactly when its key is present (see
    :func:`bridge_sharding`)."""

    def collect():
        pod = stats_fn()
        if not isinstance(pod, dict):
            return []
        fams = []
        hg = pod.get("host_groups")
        if hg:
            fams.append(_fam(
                "pio_pod_host_groups", "gauge",
                "Host groups in the active pod serving mesh.",
                [("", (), _num(hg))],
            ))
        routed = pod.get("queries_routed")
        if isinstance(routed, dict):
            fams.append(_fam(
                "pio_pod_queries_routed_total", "counter",
                "Attempts the router fanned to their owning host group "
                "(shard-aware routing; primaries, retries, and hedges "
                "all keep — and count against — the query's affinity).",
                [("", (("group", str(g)),), _num(n))
                 for g, n in sorted(routed.items(), key=lambda kv: str(kv[0]))],
            ))
        if "fallback_broadcasts" in pod:
            fams.append(_fam(
                "pio_pod_fallback_broadcasts_total", "counter",
                "Attempts routed fleet-wide because the owning group had "
                "no eligible replica — the documented degrade path "
                "(retried and hedged attempts included).",
                [("", (), _num(pod.get("fallback_broadcasts")))],
            ))
        if "cross_host_merge_bytes" in pod:
            fams.append(_fam(
                "pio_pod_cross_host_merge_bytes_total", "counter",
                "Cumulative cross-host leaderboard payload: the (H, B, "
                "k) tier-2 gather only (tier-1 stays on-host; "
                "perf_roofline.md derives the S/H reduction).",
                [("", (), _num(pod.get("cross_host_merge_bytes")))],
            ))
        if "cross_host_merge_seconds" in pod:
            fams.append(_fam(
                "pio_pod_cross_host_merge_seconds_total", "counter",
                "Device wall attributed to the cross-host merge tier "
                "(its byte share of each dispatch).",
                [("", (), _num(pod.get("cross_host_merge_seconds")))],
            ))
        if "dispatches" in pod:
            fams.append(_fam(
                "pio_pod_merge_dispatches_total", "counter",
                "Device dispatches that ran the two-tier pod merge.",
                [("", (), _num(pod.get("dispatches")))],
            ))
        if "process_count" in pod:
            fams.append(_fam(
                "pio_pod_process_info", "gauge",
                "This process's slot in the pod launch (info gauge; "
                "labels carry index/count).",
                [(
                    "",
                    (
                        ("index", str(int(_num(pod.get("process_index"))))),
                        ("count", str(int(_num(pod.get("process_count"))))),
                    ),
                    1.0,
                )],
            ))
        return fams

    registry.register_collector(collect)


def bridge_ivf(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """IVF retrieval accounting → pio_ivf_* series.

    Emits nothing while the scorer serves the exact scan (no ``retrieval``
    block in its stats), so the families appear exactly while an IVF index
    is live. ``pio_ivf_scanned_fraction`` is the realized ratio of the rows
    the probe scans read to the rows the exact scans of the same dispatches
    would have read.
    """

    def collect():
        s = stats_fn()
        rv = (s or {}).get("retrieval")
        if not isinstance(rv, dict):
            return []
        return [
            _fam(
                "pio_ivf_info", "gauge",
                "Active IVF index (info gauge; value is the cluster "
                "count, labels carry the index identity).",
                [("", (("fingerprint", str(rv.get("fingerprint", ""))),),
                  _num(rv.get("nlist")))],
            ),
            _fam(
                "pio_ivf_nprobe", "gauge",
                "Serving-time probe budget per query (PIO_IVF_NPROBE "
                "override, else the publish-time default).",
                [("", (), _num(rv.get("nprobe")))],
            ),
            _fam(
                "pio_ivf_probed_blocks_total", "counter",
                "Cluster blocks scanned across all dispatches (rung "
                "probe budgets summed).",
                [("", (), _num(rv.get("probed_blocks")))],
            ),
            _fam(
                "pio_ivf_scanned_fraction", "gauge",
                "Realized scan-bytes fraction vs the exact path for the "
                "same dispatches (probe rows / full-catalog rows).",
                [("", (), _num(rv.get("scanned_fraction")))],
            ),
            _fam(
                "pio_ivf_recall_at_publish", "gauge",
                "Recall@k the sealed index measured at its publish gate "
                "(PIO_IVF_MIN_RECALL receipt).",
                [("", (), _num(rv.get("recall_at_publish")))],
            ),
            _fam(
                "pio_ivf_resident_extra_bytes", "gauge",
                "Device-resident bytes the IVF layout adds over the "
                "replicated exact placement (centroids, id map, pad "
                "mask).",
                [("", (), _num(rv.get("resident_extra_bytes")))],
            ),
        ]

    registry.register_collector(collect)


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


# -- serving: template event cache ---------------------------------------------

def bridge_event_cache(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """ServingEventCache ``stats_dict()`` → pio_event_cache_* families
    (the template-level TTL cache for predict-time storage lookups)."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        return [
            _fam(
                "pio_event_cache_lookups_total", "counter",
                "Event-cache lookups by outcome.",
                [
                    ("", (("outcome", "hit"),), _num(s.get("hits"))),
                    ("", (("outcome", "miss"),), _num(s.get("misses"))),
                ],
            ),
            _fam(
                "pio_event_cache_refreshes_total", "counter",
                "Background refreshes that replaced a stale value.",
                [("", (), _num(s.get("refreshes")))],
            ),
            _fam(
                "pio_event_cache_invalidated_total", "counter",
                "Entries reloaded synchronously after an invalidation-"
                "token change (event-driven).",
                [("", (), _num(s.get("invalidated")))],
            ),
            _fam(
                "pio_event_cache_evictions_total", "counter",
                "Stalest-first evictions under the entry bound.",
                [("", (), _num(s.get("evictions")))],
            ),
            _fam(
                "pio_event_cache_entries", "gauge",
                "Entries currently resident.",
                [("", (), _num(s.get("entries")))],
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


def bridge_tenancy(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """TenantRegistry ``stats()`` → pio_tenant_* families, labeled by
    tenant (and variant for the A/B comparison series).  Emits nothing
    when no registry is installed; label cardinality is bounded by the
    registry's tenant/variant config, under PIO_METRICS_MAX_SERIES."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        req_samples, err_samples, lat_samples = [], [], []
        shed_samples, inflight, caps, tokens = [], [], [], []
        slo, brk, pressure = [], [], []
        for tid, t in sorted(s.items()):
            lab = (("tenant", tid),)
            inflight.append(("", lab, _num(t.get("inflight"))))
            caps.append(("", lab, _num(t.get("cap"))))
            if t.get("tokens") is not None:
                tokens.append(("", lab, _num(t.get("tokens"))))
            slo.append(("", lab, _num(t.get("slo_violations"))))
            brk.append((
                "", lab,
                BREAKER_STATE_VALUES.get(str(t.get("breaker")), 0.0),
            ))
            cap = max(1.0, _num(t.get("cap"), 1.0))
            pressure.append(
                ("", lab, min(1.0, _num(t.get("inflight")) / cap))
            )
            for reason, n in sorted((t.get("shed") or {}).items()):
                shed_samples.append(
                    ("", (("tenant", tid), ("reason", reason)), _num(n))
                )
            for vname, v in sorted((t.get("variants") or {}).items()):
                vlab = (("tenant", tid), ("variant", vname))
                req_samples.append(("", vlab, _num(v.get("requests"))))
                err_samples.append(("", vlab, _num(v.get("errors"))))
                for q in ("p50", "p99"):
                    lat_samples.append((
                        "", vlab + (("quantile", q),),
                        _num(v.get(f"{q}_ms")),
                    ))
        return [
            _fam("pio_tenant_requests_total", "counter",
                 "Requests accounted per tenant and A/B variant.",
                 req_samples),
            _fam("pio_tenant_errors_total", "counter",
                 "Server-error (5xx) responses per tenant and variant — "
                 "the same events that feed the tenant's breaker.",
                 err_samples),
            _fam("pio_tenant_latency_ms", "gauge",
                 "Per-tenant, per-variant latency quantiles (the online "
                 "A/B comparison surface).", lat_samples),
            _fam("pio_tenant_shed_total", "counter",
                 "Per-tenant sheds by reason: quota (token bucket dry), "
                 "inflight (fair-share cap), breaker (tenant breaker "
                 "open).", shed_samples),
            _fam("pio_tenant_inflight", "gauge",
                 "Requests currently inside this tenant's admission "
                 "slice.", inflight),
            _fam("pio_tenant_inflight_cap", "gauge",
                 "Fair-share inflight cap (weight-proportional share of "
                 "the server gate, x PIO_TENANT_BURST).", caps),
            _fam("pio_tenant_quota_tokens", "gauge",
                 "Token-bucket balance for quota'd tenants (absent when "
                 "no quota_qps is set).", tokens),
            _fam("pio_tenant_slo_violations_total", "counter",
                 "Successful answers that exceeded the tenant's slo_ms.",
                 slo),
            _fam("pio_tenant_breaker_state", "gauge",
                 "Tenant circuit-breaker state (0 closed / 1 open / 2 "
                 "half-open).", brk),
            _fam("pio_tenant_pressure", "gauge",
                 "Inflight saturation against the fair-share cap — the "
                 "autoscaler's per-tenant signal.", pressure),
        ]

    registry.register_collector(collect)


def bridge_pipeline(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """PipelineEngine ``stats()`` → pio_pipeline_* families, labeled by
    stage.  Emits nothing while no pipeline is bound."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        runs, overruns, errors, lat, frac = [], [], [], [], []
        for name, st in sorted((s.get("stages") or {}).items()):
            lab = (("stage", name),)
            runs.append(("", lab, _num(st.get("runs"))))
            overruns.append(("", lab, _num(st.get("overruns"))))
            errors.append(("", lab, _num(st.get("errors"))))
            frac.append(("", lab, _num(st.get("budget_fraction"))))
            for q in ("p50", "p99"):
                lat.append((
                    "", lab + (("quantile", q),), _num(st.get(f"{q}_ms")),
                ))
        return [
            _fam("pio_pipeline_stage_runs_total", "counter",
                 "Completed runs per pipeline stage.", runs),
            _fam("pio_pipeline_stage_overruns_total", "counter",
                 "Stage executions that exceeded their share of the "
                 "request deadline.", overruns),
            _fam("pio_pipeline_stage_errors_total", "counter",
                 "Stage executions that raised.", errors),
            _fam("pio_pipeline_stage_latency_ms", "gauge",
                 "Per-stage latency quantiles.", lat),
            _fam("pio_pipeline_stage_budget_fraction", "gauge",
                 "Configured share of the request deadline per stage.",
                 frac),
            _fam("pio_pipeline_degraded_total", "counter",
                 "Answers degraded to the retrieval-only result after a "
                 "later stage overran or failed.",
                 [("", (), _num(s.get("degraded_total")))]),
        ]

    registry.register_collector(collect)


def bridge_fleet(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """FleetSupervisor ``stats()`` → pio_fleet_* process-lifecycle
    series, so crash-restarts and scale events are visible on the
    router's /metrics instead of only in its logs."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        trans = s.get("transitions") or {}
        fams = [
            _fam(
                "pio_fleet_replicas", "gauge",
                "Replica processes currently under supervision.",
                [("", (), _num(s.get("replicas")))],
            ),
            _fam(
                "pio_fleet_replicas_alive", "gauge",
                "Supervised replica processes currently running.",
                [("", (), _num(s.get("alive")))],
            ),
            _fam(
                "pio_fleet_restarts_total", "counter",
                "Crash-restarts performed by the supervisor.",
                [("", (), _num(s.get("restarts")))],
            ),
            _fam(
                "pio_fleet_transitions_total", "counter",
                "Replica lifecycle transitions: up (process spawned) and "
                "down (crash observed or replica scaled away).",
                [
                    ("", (("direction", "up"),), _num(trans.get("up"))),
                    ("", (("direction", "down"),), _num(trans.get("down"))),
                ],
            ),
        ]
        backoff = s.get("backoffMs")
        if isinstance(backoff, dict) and backoff:
            fams.append(
                _fam(
                    "pio_fleet_replica_backoff_ms", "gauge",
                    "Current crash-restart backoff per replica slot "
                    "(0 after a healthy stretch).",
                    [
                        ("", (("replica", str(url)),), _num(ms))
                        for url, ms in sorted(backoff.items())
                    ],
                )
            )
        return fams

    registry.register_collector(collect)


def bridge_autoscaler(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """Autoscaler ``stats()`` → pio_autoscaler_* decision series (the
    composite pressure, its per-signal inputs, and scale events)."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        sigs = s.get("signals") or {}
        decision = {"down": -1.0, "hold": 0.0, "up": 1.0}.get(
            s.get("lastDecision"), 0.0
        )
        return [
            _fam(
                "pio_autoscaler_replicas_target", "gauge",
                "Replica count the autoscaler is currently holding the "
                "fleet at.",
                [("", (), _num(s.get("replicas")))],
            ),
            _fam(
                "pio_autoscaler_pressure", "gauge",
                "Composite load pressure (max of the normalized signals) "
                "driving scale decisions.",
                [("", (), _num(s.get("pressure")))],
            ),
            _fam(
                "pio_autoscaler_signal", "gauge",
                "Normalized [0,1] per-signal pressure feeding the "
                "composite (inflight, shed, hedge, busy).",
                [
                    ("", (("signal", str(k)),), _num(v))
                    for k, v in sorted(sigs.items())
                ],
            ),
            _fam(
                "pio_autoscaler_scale_events_total", "counter",
                "Scale decisions executed, by direction.",
                [
                    ("", (("direction", "up"),), _num(s.get("scaleUps"))),
                    ("", (("direction", "down"),), _num(s.get("scaleDowns"))),
                ],
            ),
            _fam(
                "pio_autoscaler_last_decision", "gauge",
                "Most recent control decision: -1 down, 0 hold, 1 up.",
                [("", (), decision)],
            ),
        ]

    registry.register_collector(collect)


CANARY_STATE_VALUES = {
    "idle": 0.0, "verifying": 1.0, "promoting": 2.0, "soaking": 3.0,
    "rolling_back": 4.0,
}


def bridge_canary(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """CanaryController ``stats()`` → pio_canary_* series: the rollout
    state machine, per-generation verdict inputs, shadow-mirror volume,
    and the quarantine ledger depth."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        counters = s.get("counters") or {}
        shadow = s.get("shadow") or {}
        cand = s.get("candidateStats") or {}
        base = s.get("baselineStats") or {}
        state = str(s.get("state") or "idle")
        fams = [
            _fam(
                "pio_canary_state", "gauge",
                "Controller state: 0 idle, 1 verifying, 2 promoting, "
                "3 soaking, 4 rolling_back.",
                [("", (), CANARY_STATE_VALUES.get(state, 0.0))],
            ),
            _fam(
                "pio_canary_epoch", "gauge",
                "Fencing epoch of the journal owner; bumps on every "
                "canary start and every controller resume.",
                [("", (), _num(s.get("epoch")))],
            ),
            _fam(
                "pio_canary_info", "gauge",
                "Constant-1 info series; the labels carry the current "
                "state and candidate/baseline generation ids.",
                [(
                    "", (
                        ("state", state),
                        ("candidate", str(s.get("candidate") or "")),
                        ("baseline", str(s.get("baseline") or "")),
                    ), 1.0,
                )],
            ),
            _fam(
                "pio_canary_shadow_queries_total", "counter",
                "Shadow-mirrored query pairs replayed against candidate "
                "+ baseline (answers discarded), by outcome.",
                [
                    ("", (("outcome", "ok"),), _num(counters.get("shadow_ok"))),
                    ("", (("outcome", "error"),),
                     _num(counters.get("shadow_errors"))),
                ],
            ),
            _fam(
                "pio_canary_shadow_overlap", "gauge",
                "Mean top-k prediction overlap between candidate and "
                "baseline over this window's shadow pairs.",
                [("", (), _num(shadow.get("meanOverlap"), 0.0))],
            ),
            _fam(
                "pio_canary_candidate_error_rate", "gauge",
                "Attributed online error rate of the candidate "
                "generation (real traffic, router-attributed).",
                [("", (), _num(cand.get("errorRate")))],
            ),
            _fam(
                "pio_canary_candidate_p99_ms", "gauge",
                "Attributed online p99 latency of the candidate "
                "generation, milliseconds.",
                [("", (), _num(cand.get("p99Ms")))],
            ),
            _fam(
                "pio_canary_baseline_p99_ms", "gauge",
                "Attributed online p99 latency of the baseline "
                "generation, milliseconds (the ratio-SLO denominator).",
                [("", (), _num(base.get("p99Ms")))],
            ),
            _fam(
                "pio_canary_verifications_total", "counter",
                "Verification windows concluded, by verdict.",
                [
                    ("", (("outcome", "pass"),),
                     _num(counters.get("verifications_pass"))),
                    ("", (("outcome", "fail"),),
                     _num(counters.get("verifications_fail"))),
                ],
            ),
            _fam(
                "pio_canary_rollbacks_total", "counter",
                "Automatic rollbacks executed, by phase (verify = canary "
                "replica only, soak = runtime fleet-wide to LKG).",
                [
                    ("", (("phase", "verify"),),
                     _num(counters.get("rollbacks_verify"))),
                    ("", (("phase", "soak"),),
                     _num(counters.get("rollbacks_soak"))),
                ],
            ),
            _fam(
                "pio_canary_promotions_total", "counter",
                "Canaries promoted to the full fleet.",
                [("", (), _num(counters.get("promotions")))],
            ),
            _fam(
                "pio_canary_quarantined_generations", "gauge",
                "Engine instance ids currently blocked by a durable "
                "quarantine receipt.",
                [("", (), float(len(s.get("quarantined") or [])))],
            ),
        ]
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


# -- ingest: the write-behind buffer and its WAL ----------------------------

def bridge_ingest_buffer(
    registry: MetricsRegistry, stats_fn: Callable[[], Optional[dict]]
) -> None:
    """Write-behind ingest buffer → depth gauge, flow counters, and the
    flush batch-size histogram."""

    def collect():
        s = stats_fn()
        if not s:
            return []
        fams = [
            _fam(
                "pio_ingest_buffer_depth", "gauge",
                "Events currently buffered awaiting flush.",
                [("", (), _num(s.get("buffered")))],
            ),
            _fam(
                "pio_ingest_buffer_capacity", "gauge",
                "Configured buffer bound (overflow == shed).",
                [("", (), _num(s.get("buffer_max")))],
            ),
            _fam(
                "pio_ingest_events_total", "counter",
                "Buffered-ingest events by outcome.",
                [
                    ("", (("outcome", "accepted"),),
                     _num(s.get("accepted"))),
                    ("", (("outcome", "flushed"),), _num(s.get("flushed"))),
                    ("", (("outcome", "overflow"),),
                     _num(s.get("overflows"))),
                ],
            ),
            _fam(
                "pio_ingest_flushes_total", "counter",
                "Group-commit flushes executed.",
                [("", (), _num(s.get("flushes")))],
            ),
            _fam(
                "pio_ingest_flush_retries_total", "counter",
                "Flush attempts retried under the resilience policy.",
                [("", (), _num(s.get("retries")))],
            ),
            _fam(
                "pio_ingest_flush_errors_total", "counter",
                "Flushes that exhausted retries and failed their tickets.",
                [("", (), _num(s.get("flush_errors")))],
            ),
        ]
        hist = s.get("flush_batch_hist")
        if isinstance(hist, dict) and hist:
            fams.append(
                _fam(
                    "pio_ingest_flush_batch_total", "counter",
                    "Flushes by batch-size bucket.",
                    [
                        ("", (("size", str(k)),), _num(v))
                        for k, v in hist.items()
                    ],
                )
            )
        wal = s.get("wal")
        if isinstance(wal, dict):
            fams.extend([
                _fam(
                    "pio_wal_depth", "gauge",
                    "WAL records journaled but not yet flush-committed.",
                    [("", (), _num(wal.get("depth")))],
                ),
                _fam(
                    "pio_wal_segments", "gauge",
                    "WAL segment files currently on disk.",
                    [("", (), _num(wal.get("segments")))],
                ),
                _fam(
                    "pio_wal_records_total", "counter",
                    "WAL record flow (appended / committed / replayed).",
                    [
                        ("", (("op", "appended"),), _num(wal.get("appended"))),
                        ("", (("op", "committed"),),
                         _num(wal.get("committed"))),
                        ("", (("op", "replayed"),), _num(wal.get("replayed"))),
                    ],
                ),
                _fam(
                    "pio_wal_syncs_total", "counter",
                    "fsync calls issued by the WAL (policy-dependent).",
                    [("", (), _num(wal.get("synced")))],
                ),
                _fam(
                    "pio_wal_truncated_tails_total", "counter",
                    "Torn segment tails truncated during replay.",
                    [("", (), _num(wal.get("truncated_tails")))],
                ),
                _fam(
                    "pio_wal_reclaimed_segments_total", "counter",
                    "Fully-committed segments reclaimed (unlinked).",
                    [("", (), _num(wal.get("reclaimed_segments")))],
                ),
            ])
        return fams

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
