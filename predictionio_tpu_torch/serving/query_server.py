"""Query server: REST serving of a deployed engine from the card.

Counterpart of ``predictionio_tpu/serving/query_server.py`` (parity:
``core/.../workflow/CreateServer.scala:104-706``), with the constructor
arguments ``pio deploy`` passes and these routes:

* ``POST /queries.json`` — admission (drain, then ``max_inflight``: beyond
  it a 503 with a load-scaled ``Retry-After``) → ``X-Request-Deadline``
  (a lapsed deadline answers 504) → result cache → bind query →
  ``serving.supplement`` → predict → ``serving.serve`` → plugins →
  feedback. With ``batching=True`` queries go through a
  :class:`~predictionio_tpu_torch.serving.batching.MicroBatcher` (with
  single-flight coalescing when ``coalesce``) into one
  ``Algorithm.batch_predict`` per batch (for ALS: one kernel launch).
* ``GET /`` — server info: latency, batcher, fast-path, result-cache and
  resilience counters, and the score kernel's launch count in this process
  (``scoreKernelLaunches``).
* ``GET /healthz``, ``GET /readyz`` (503 while draining or undeployed).
* ``GET|POST /reload`` — hot-swap to the newest (or a named) COMPLETED
  instance; a failed reload keeps the live generation (counted, flagged).
* ``GET /plugins.json``; ``POST /stop`` — drain, then undeploy.
* ``GET /metrics`` and ``GET /trace/recent.json`` when telemetry is on.

**Degraded answers.** As in the JAX server, a scorer or model failure
serves the newest good answer flagged ``"degraded": true`` (counted)
instead of a 500. One exception, a logged difference (ROADMAP §3): a
:class:`~predictionio_tpu_torch.ops._build.KernelError` — a kernel's
refusal or launch failure, or an error the card reported — propagates as
a 500 and counts ``query_errors``, so a broken card never hides behind a
stale answer.

**Reload and last-known-good.** ``reload()`` loads an instance
(``prepare_deploy``) and, for batching deployments, warms the fast path
before the swap. A failure to LOAD (no instance, a missing or corrupt
blob, a seal mismatch) keeps the live generation; at a cold start it falls
back to the persisted last-known-good pointer, then older COMPLETED
instances. A warm-up failure raises out of ``reload()`` (counted
``warmup_errors``): the JAX server counts it and serves on, which on the
card would hide a kernel that failed to build or launch.

Waiting for their ROADMAP items, and raising an error that names them:
tenancy (``tenants``/``PIO_TENANTS``) and pipelines (``pipeline``/
``PIO_PIPELINE``), item 13; streaming micro-generations
(``PIO_STREAMING=1``), item 8; pod serving and its lockstep
(``PIO_POD_GROUP``), item 10. Fault injection waits for a chaos item of its own,
``POST /debug/profile`` for item 15, and quarantined generations (which
``reload(force=True)`` overrides in the JAX server) for the canary, item
13: until then no generation is quarantined.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import secrets
import threading
import time
import urllib.request
from typing import Any, Optional

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.common.resilience import (
    DEADLINE_HEADER,
    BreakerOpen,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    ErrorCounters,
    RateLimitedLogger,
    RetryPolicy,
    call_with_resilience,
    deadline_scope,
    parse_deadline_header,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.workflow import (
    get_latest_completed_instance,
    prepare_deploy,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.obs import bridges as _bridges
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import score_kernel
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.serving.result_cache import (
    canonical_fingerprint,
    coalesce_from_env,
    entity_ids_from,
    result_cache_from_env,
)
from predictionio_tpu_torch.utils.profiling import LatencyHistogram

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to predictionio_tpu_torch yet (ROADMAP §1 item {item})"
    )


class EngineServerPlugin:
    """Parity: workflow/EngineServerPlugin.scala:24-40."""

    OUTPUT_BLOCKER = "outputblocker"
    OUTPUT_SNIFFER = "outputsniffer"

    name = "plugin"
    plugin_type = OUTPUT_SNIFFER

    def process(self, query: Any, prediction: Any, context: dict) -> Any:
        """Blockers return a (possibly rewritten) prediction; sniffers observe."""
        return prediction


# response-field plans: dataclasses.fields() re-derives the field tuple on
# every call; a deployed engine serves the SAME few result types, so the
# names are cached per class after the first walk
_FIELD_PLANS: dict[type, tuple[str, ...]] = {}


def _to_jsonable(obj: Any) -> Any:
    plan = _FIELD_PLANS.get(type(obj))
    if plan is None and dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        plan = tuple(f.name for f in dataclasses.fields(obj))
        _FIELD_PLANS[type(obj)] = plan
    if plan is not None:
        # None-valued fields are omitted, matching the reference's json4s
        # treatment of Option None (absent field, not null)
        return {
            k: _to_jsonable(v) for k in plan if (v := getattr(obj, k)) is not None
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def bind_query(query_cls: Optional[type], data: dict) -> Any:
    """Lenient query binding: unknown JSON fields are ignored, missing ones
    take defaults (parity: JsonExtractor's dual Gson/json4s path)."""
    if query_cls is None or not dataclasses.is_dataclass(query_cls):
        return data
    names = {f.name for f in dataclasses.fields(query_cls)}
    return query_cls(**{k: v for k, v in data.items() if k in names})


@dataclasses.dataclass
class _Deployed:
    instance_id: str
    algorithms: list
    serving: Any
    models: list
    start_time: float


class QueryServer:
    def __init__(
        self,
        engine: Engine,
        storage: Optional[Storage] = None,
        ctx: Optional[DeviceContext] = None,
        engine_id: str = "default",
        engine_version: str = "default",
        engine_variant: str = "default",
        feedback: bool = False,
        event_server_url: Optional[str] = None,
        access_key: Optional[str] = None,
        plugins: Optional[list[EngineServerPlugin]] = None,
        batching: bool = False,
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        max_inflight: int = 256,
        shed_retry_after_s: float = 1.0,
        default_deadline_ms: Optional[float] = None,
        warm_fastpath: Optional[bool] = None,
        telemetry: bool = True,
        result_cache=None,
        coalesce: Optional[bool] = None,
        tenants=None,
        pipeline=None,
    ):
        if tenants is not None or os.environ.get("PIO_TENANTS", "").strip():
            raise _not_ported("multi-tenancy (tenants / PIO_TENANTS)", 13)
        if pipeline is not None or os.environ.get("PIO_PIPELINE", "").strip():
            raise _not_ported("composed pipelines (pipeline / PIO_PIPELINE)", 13)
        if os.environ.get("PIO_STREAMING", "0") == "1":
            raise _not_ported("streaming micro-generations (PIO_STREAMING=1)", 8)
        if os.environ.get("PIO_POD_GROUP", "").strip():
            raise _not_ported("pod serving and its lockstep (PIO_POD_GROUP)", 10)
        self.engine = engine
        self.storage = storage or Storage.instance()
        self.ctx = ctx or DeviceContext.create()
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.feedback = feedback
        self.event_server_url = event_server_url
        self.access_key = access_key
        self.plugins = list(plugins or [])
        self._deployed: Optional[_Deployed] = None
        self._lock = threading.Lock()
        # latency bookkeeping (parity: CreateServer.scala:415-417) plus a
        # full histogram
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.latency = LatencyHistogram()
        self.service = HttpService("queryserver")
        # /metrics + /trace/recent.json, and the HTTP layer's request
        # counter / latency / trace hooks
        self.telemetry = (
            obs.Telemetry("queryserver").install(self.service)
            if telemetry and obs.telemetry_enabled()
            else None
        )
        # feedback POSTs ride a bounded background queue, never the request
        # thread; when the event server can't keep up we drop (and count)
        # rather than let feedback add to serve latency
        self._feedback_queue: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=256)
        self._feedback_dropped = 0
        self._feedback_worker: Optional[threading.Thread] = None
        # admission control, deadlines, degraded fallback, counted and
        # rate-limited failure logging
        self.max_inflight = int(max_inflight)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.default_deadline_ms = default_deadline_ms
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.counters = ErrorCounters(
            "shed", "deadline_exceeded", "breaker_open", "degraded",
            "query_errors", "warmup_errors", "sniffer_errors",
            "feedback_errors", "reload_failed", "drained",
            "drain_abandoned",
        )
        # graceful drain (SIGTERM / POST /stop): /readyz flips to draining,
        # new queries shed, in-flight work finishes inside the budget
        self._draining = False
        self.drain_timeout_ms = float(os.environ.get("PIO_DRAIN_TIMEOUT_MS", 5000.0))
        self._rl_log = RateLimitedLogger(logger)
        # the feedback poster rides the shared retry/breaker policy: a dead
        # event server trips the breaker and feedback drops fast (counted)
        self._feedback_policy = RetryPolicy(max_attempts=3, base_backoff_s=0.1)
        self._feedback_breaker = CircuitBreaker(
            "feedback", failure_threshold=5, reset_timeout_s=15.0
        )
        # degraded fallback: the newest good (jsonable) prediction
        self._last_good: Optional[dict] = None
        self._reload_degraded = False
        # the fast path serves formed batches, so it warms with batching
        self._warm_fastpath = batching if warm_fastpath is None else bool(warm_fastpath)
        self._fastpath_warm = not self._warm_fastpath
        # result cache for identical queries + single-flight coalescing at
        # the batcher; both off unless PIO_RESULT_CACHE / PIO_COALESCE (or
        # the arguments) turn them on. Must exist before the first
        # reload(): a reload bumps the serving generation and flushes it.
        self._result_cache = (
            result_cache_from_env() if result_cache is None else result_cache
        )
        self._coalesce = coalesce_from_env() if coalesce is None else bool(coalesce)
        # model-generation tag: every successful swap increments it, so
        # cached answers from the previous generation never validate
        self._serving_gen = 0
        self._register_routes()
        self.reload()
        self._batcher = None
        if batching:
            from predictionio_tpu_torch.serving import fastpath
            from predictionio_tpu_torch.serving.batching import MicroBatcher

            self._batcher = MicroBatcher(
                self._run_query_batch, max_batch=max_batch,
                window_ms=batch_window_ms, buckets=fastpath.BUCKETS,
            )
        if self.telemetry is not None:
            self._register_metrics()

    # -- model lifecycle -----------------------------------------------------
    def _warm(self, algorithms: list, models: list) -> None:
        """Build the kernel and launch every rung before the swap; a
        failure counts and raises (the live generation stays live)."""
        for algo, model in zip(algorithms, models):
            warm = getattr(algo, "warmup", None)
            if warm is None:
                continue
            try:
                warm(model)
            except Exception:
                self.counters.inc("warmup_errors")
                raise

    def reload(self, instance_id: Optional[str] = None, force: bool = False) -> str:
        """(Re)load the newest COMPLETED instance, or ``instance_id``; warm
        it; swap atomically.

        When loading fails and a generation is live, it keeps serving —
        counted (``reload_failed``) and flagged on ``/readyz`` and ``GET /``.
        A cold start whose instance cannot be loaded falls back to the
        persisted last-known-good pointer, then every other COMPLETED
        instance newest first; with nothing deployable left it raises.
        ``force`` overrides a quarantine in the JAX server; the port has
        no quarantined generations until the canary (ROADMAP §1 item 13).
        """
        del force  # nothing is quarantined yet (see the docstring)
        instance = None
        try:
            if instance_id is not None:
                instance = self.storage.get_meta_data_engine_instances().get(instance_id)
                if instance is None:
                    raise RuntimeError(f"no engine instance {instance_id}")
            else:
                instance = get_latest_completed_instance(
                    self.storage, self.engine_id, self.engine_version,
                    self.engine_variant,
                )
            _, algorithms, serving, models = prepare_deploy(
                self.engine, instance, storage=self.storage, ctx=self.ctx
            )
        except Exception:
            with self._lock:
                last_good = self._deployed
            if last_good is not None:
                self.counters.inc("reload_failed")
                with self._lock:
                    self._reload_degraded = True
                self._rl_log.exception(
                    "reload", "reload failed; serving last good instance %s",
                    last_good.instance_id,
                )
                return last_good.instance_id
            # cold start: nothing in memory to keep serving — reach for the
            # on-disk last-known-good pointer, then older COMPLETED runs
            fallback = self._cold_start_fallback(
                failed_id=instance.id if instance is not None else None
            )
            if fallback is None:
                raise  # truly nothing deployable
            return fallback.instance_id
        if self._warm_fastpath:
            self._warm(algorithms, models)
        self._swap(_Deployed(
            instance_id=instance.id, algorithms=algorithms, serving=serving,
            models=models, start_time=time.time(),
        ), degraded=False)
        logger.info("deployed engine instance %s", instance.id)
        return instance.id

    def _swap(self, deployed: _Deployed, degraded: bool) -> None:
        """Make ``deployed`` the live generation: bump the serving
        generation (the result cache's model tag), flush the cache, and
        persist the last-known-good pointer."""
        with self._lock:
            self._deployed = deployed
            self._fastpath_warm = True
            self._serving_gen += 1
            self._reload_degraded = degraded
        if self._result_cache is not None:
            # answers of the previous generation never serve against this one
            self._result_cache.clear()
        self._record_last_known_good(deployed.instance_id)

    # -- last-known-good pointer (survives restarts) -------------------------
    def _lkg_path(self) -> str:
        from predictionio_tpu_torch.utils.fs import pio_base_dir

        raw = f"{self.engine_id}-{self.engine_version}-{self.engine_variant}"
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in raw)
        return os.path.join(pio_base_dir(), "last_known_good", safe + ".json")

    def _record_last_known_good(self, instance_id: str) -> None:
        """Persist the generation that just deployed; a future cold start
        with a torn newest blob deploys this one instead. Best-effort: a
        pointer write failure never fails a deploy."""
        from predictionio_tpu_torch.utils.fs import atomic_write

        path = self._lkg_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write(path, json.dumps({"instanceId": instance_id}).encode())
        except OSError:
            logger.debug("last-known-good pointer write failed", exc_info=True)

    def _read_last_known_good(self) -> Optional[str]:
        try:
            with open(self._lkg_path(), "r", encoding="utf-8") as f:
                value = json.load(f).get("instanceId")
            return value if isinstance(value, str) else None
        except (OSError, ValueError):
            return None

    def _cold_start_fallback(self, failed_id: Optional[str]) -> Optional[_Deployed]:
        """Deploy an older generation when the newest is unusable at cold
        start: the last-known-good pointer first, then every other
        COMPLETED instance newest first. Serving stale beats not serving;
        the swap is flagged degraded on /readyz and counted. A candidate's
        warm-up failure raises: this covers loading, never a launch."""
        try:
            completed = self.storage.get_meta_data_engine_instances().get_completed(
                self.engine_id, self.engine_version, self.engine_variant
            )
        except Exception:
            return None
        by_id = {i.id: i for i in completed}
        order: list[str] = []
        lkg_id = self._read_last_known_good()
        if lkg_id and lkg_id != failed_id and lkg_id in by_id:
            order.append(lkg_id)
        order += [i.id for i in completed if i.id != failed_id and i.id not in order]
        for iid in order:
            try:
                _, algorithms, serving, models = prepare_deploy(
                    self.engine, by_id[iid], storage=self.storage, ctx=self.ctx
                )
            except Exception:
                self._rl_log.exception("reload", "fallback candidate %s failed to deploy", iid)
                continue
            if self._warm_fastpath:
                self._warm(algorithms, models)
            deployed = _Deployed(
                instance_id=iid, algorithms=algorithms, serving=serving,
                models=models, start_time=time.time(),
            )
            self._swap(deployed, degraded=True)
            self.counters.inc("reload_failed")
            logger.warning(
                "cold start: newest instance %s unusable; serving "
                "last-known-good %s (degraded)", failed_id, iid,
            )
            return deployed
        return None

    # -- observability -------------------------------------------------------
    def _fastpath_stats(self) -> Optional[dict]:
        """First deployed algorithm's serving_stats (registry bridge)."""
        with self._lock:
            d = self._deployed
        if d is None:
            return None
        for algo, model in zip(d.algorithms, d.models):
            get_stats = getattr(algo, "serving_stats", None)
            if get_stats is None:
                continue
            s = get_stats(model)
            if s is not None:
                return s
        return None

    def _register_metrics(self) -> None:
        """Expose every serving stat on the obs registry, making
        ``/metrics`` the single source of truth for this server. Each
        bridge reads its component's ``stats()`` under that component's
        own lock at scrape time: nothing is added to the launch path."""
        reg = self.telemetry.registry
        _bridges.bridge_error_counters(
            reg, "pio_query_errors_total",
            "Serving failures by kind (shed, deadline 504, breaker_open, "
            "degraded, query/warmup/sniffer/feedback/reload).",
            self.counters,
        )
        _bridges.bridge_latency_histogram(
            reg, "pio_query_latency_seconds",
            "handle_query latency, bridged from the serving histogram.",
            self.latency,
        )
        reg.gauge_fn(
            "pio_query_inflight",
            "Queries currently inside the admission gate.",
            lambda: float(self._inflight),
        )
        reg.gauge_fn(
            "pio_query_max_inflight",
            "Admission-control bound; at or beyond it requests shed (503).",
            lambda: float(self.max_inflight),
        )
        if self._batcher is not None:
            _bridges.bridge_batcher(reg, self._batcher.stats)
        _bridges.bridge_fastpath(reg, self._fastpath_stats)
        # live device utilization: the scorer's cost-annotated dispatch
        # accountant, labeled with the generation it serves (the scorer —
        # and its accountant — are rebuilt on every successful reload)
        _bridges.bridge_devprof(
            reg,
            lambda: (self._fastpath_stats() or {}).get("devprof"),
            lambda: self._serving_gen,
        )
        if self._result_cache is not None:
            _bridges.bridge_result_cache(reg, self._result_cache.stats)
        reg.gauge_fn(
            "pio_result_cache_enabled",
            "1 when the serving result cache is active.",
            lambda: 0.0 if self._result_cache is None else 1.0,
        )
        reg.gauge_fn(
            "pio_coalesce_enabled",
            "1 when single-flight coalescing of identical queries is on.",
            lambda: 1.0 if self._coalesce else 0.0,
        )
        _bridges.bridge_resilience(
            reg,
            lambda: {"breakers": [self._feedback_breaker.stats()]},
            prefix="pio_feedback",
        )

        def _serving_families():
            with self._lock:
                rc = self.request_count
                avg = self.avg_serving_sec
                last = self.last_serving_sec
                dropped = self._feedback_dropped
            F = _bridges.Family
            return [
                F("pio_query_requests_total", "counter",
                  "Queries served by the predict hot loop.",
                  [("", (), float(rc))]),
                F("pio_query_avg_serving_seconds", "gauge",
                  "Running mean serving seconds (parity: CreateServer "
                  "avg gauge).", [("", (), float(avg))]),
                F("pio_query_last_serving_seconds", "gauge",
                  "Most recent serving seconds.", [("", (), float(last))]),
                F("pio_feedback_dropped_total", "counter",
                  "Feedback events dropped on a full queue.",
                  [("", (), float(dropped))]),
                F("pio_reload_degraded", "gauge",
                  "1 while serving the last good generation after a "
                  "failed reload.",
                  [("", (), 1.0 if self._reload_degraded else 0.0)]),
                F("pio_draining", "gauge",
                  "1 while the server is draining toward shutdown.",
                  [("", (), 1.0 if self._draining else 0.0)]),
            ]

        reg.register_collector(_serving_families)

    # -- batched path: one Algorithm.batch_predict pass for N queries --------
    def _run_query_batch(self, queries: list) -> list:
        with self._lock:
            deployed = self._deployed
        with _tracing.stage("batch_assembly"):
            supplemented = [
                (i, deployed.serving.supplement(q)) for i, q in enumerate(queries)
            ]
        per_algo = [
            dict(algo.batch_predict(model, supplemented))
            for algo, model in zip(deployed.algorithms, deployed.models)
        ]
        out = []
        for i, (_, sq) in enumerate(supplemented):
            preds = [d[i] for d in per_algo if i in d]
            # pair the supplemented query with its prediction so plugins and
            # feedback see the same supplemented query as the unbatched path
            out.append((sq, deployed.serving.serve(sq, preds)))
        return out

    # -- degraded fallback ---------------------------------------------------
    def _fallback_result(self) -> Optional[dict]:
        """The degraded answer when the scorer fails: the newest good
        prediction this server produced (stale beats empty for a
        recommendation surface). None ⇒ no fallback, the caller answers
        500. (The JAX server first asks an algorithm's
        ``fallback_predict``, which no template defines.)"""
        with self._lock:
            last = self._last_good
        return dict(last) if last is not None else None

    # -- query hot loop (parity: CreateServer.scala:484-634) -----------------
    def handle_query(self, data: dict, deadline: Optional[Deadline] = None) -> dict:
        t0 = time.perf_counter()
        with self._lock:
            deployed = self._deployed
            generation = self._serving_gen
        with _tracing.stage("decode"):
            query = bind_query(self.engine.query_cls, data)
        degraded = False
        cache = self._result_cache
        # one canonical fingerprint serves both layers: the result-cache
        # key here and the single-flight coalescing key at the batcher
        fp = canonical_fingerprint(data) if (cache is not None or self._coalesce) else None
        cache_hit = False
        if cache is not None and fp is not None:
            cached = cache.get(fp, generation)
            if cached is not None:
                cache_hit = True
                result = cached
                # no supplemented form exists on a hit; plugins and
                # feedback see the bound query, as on the degraded path
                supplemented = query
        # flight-recorder context: which generation answered and whether
        # the device was skipped (a hit carries no device stages)
        for t in _tracing.active_traces():
            t.annotate(
                generation=generation,
                **({"cache": "hit" if cache_hit else "miss"} if cache is not None else {}),
            )
        if not cache_hit:
            try:
                if deadline is not None and deadline.expired():
                    raise DeadlineExceeded("deadline expired before predict")
                if self._batcher is not None:
                    supplemented, prediction = self._batcher.submit(
                        query, deadline=deadline, key=fp if self._coalesce else None,
                    )
                else:
                    supplemented = deployed.serving.supplement(query)
                    predictions = [
                        algo.predict(model, supplemented)
                        for algo, model in zip(deployed.algorithms, deployed.models)
                    ]
                    prediction = deployed.serving.serve(supplemented, predictions)
                with _tracing.stage("serialize"):
                    result = _to_jsonable(prediction)
            except DeadlineExceeded:
                self.counters.inc("deadline_exceeded")
                raise
            except (TypeError, KernelError):
                # malformed query values are a CLIENT bug (400), and a
                # kernel's refusal or failure, or a card error, is the
                # CARD's (500): neither hides behind a stale degraded 200
                self.counters.inc("query_errors")
                raise
            except Exception as e:
                # scorer/model failure: serve the degraded fallback rather
                # than a 500 — availability beats freshness for serving
                fallback = self._fallback_result()
                if fallback is None:
                    self.counters.inc("query_errors")
                    raise
                self.counters.inc("degraded")
                self._rl_log.warning(
                    "degraded", "prediction failed (%s); serving degraded fallback", e,
                )
                result = fallback
                result["degraded"] = True
                supplemented = query
                degraded = True
        if not degraded and isinstance(result, dict):
            # remember the newest good answer for the degraded path; shallow
            # copy so prId/plugin rewrites never leak back into it
            with self._lock:
                self._last_good = dict(result)
            if cache is not None and fp is not None and not cache_hit:
                # store the pre-plugin, pre-prId answer: plugins rewrite per
                # caller and run on every hit; degraded answers are never
                # cached (they would outlive the failure)
                cache.put(fp, result, entity_ids_from(data, cache.key_fields), generation)
        # plugins see JSON values, as in the reference (JValue-based process)
        for p in self.plugins:
            if p.plugin_type == EngineServerPlugin.OUTPUT_BLOCKER:
                result = p.process(supplemented, result, {})
        for p in self.plugins:
            if p.plugin_type == EngineServerPlugin.OUTPUT_SNIFFER:
                try:
                    p.process(supplemented, result, {})
                except Exception:
                    self.counters.inc("sniffer_errors")
                    self._rl_log.exception("sniffer", "sniffer plugin %s failed", p.name)
        if self.feedback:
            pr_id = data.get("prId") or secrets.token_hex(8)
            result["prId"] = pr_id
            self._send_feedback(data, result, pr_id, deployed.instance_id)
        dt = time.perf_counter() - t0
        self.latency.observe(dt)
        with self._lock:
            self.request_count += 1
            self.last_serving_sec = dt
            self.avg_serving_sec += (dt - self.avg_serving_sec) / self.request_count
        return result

    # -- feedback loop (parity: CreateServer.scala:527-589) ------------------
    def _send_feedback(self, query, prediction, pr_id, instance_id) -> None:
        """Queue a ``predict`` event for the event server. The request
        thread never blocks on it: a slow or dead event server drops
        feedback (counted) instead of backing up serving."""
        if not self.event_server_url:
            return
        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {
                "engineInstanceId": instance_id,
                "query": query,
                "prediction": prediction,
            },
        }
        if self._feedback_worker is None:
            with self._lock:
                if self._feedback_worker is None:
                    self._feedback_worker = threading.Thread(
                        target=self._feedback_loop, name="queryserver-feedback", daemon=True,
                    )
                    self._feedback_worker.start()
        try:
            self._feedback_queue.put_nowait(event)
        except queue.Full:
            with self._lock:
                self._feedback_dropped += 1
            logger.warning("feedback queue full; dropping event %s", pr_id)

    def _feedback_loop(self) -> None:
        url = f"{self.event_server_url}/events.json"
        if self.access_key:
            url += f"?accessKey={self.access_key}"
        while True:
            event = self._feedback_queue.get()
            if event is None:  # sentinel from stop()
                return
            payload = json.dumps(event).encode()

            def post():
                req = urllib.request.Request(
                    url, data=payload, method="POST",
                    headers={"Content-Type": "application/json"},
                )
                # fire-and-forget: the caller already has its answer, so
                # there is no deadline to propagate; the fixed timeout and
                # the breaker bound the loop instead
                urllib.request.urlopen(req, timeout=5).close()

            try:
                call_with_resilience(post, self._feedback_policy, breaker=self._feedback_breaker)
            except BreakerOpen:
                # event server is down: drop fast (counted) instead of each
                # event burning max_attempts × timeout behind an open breaker
                self.counters.inc("breaker_open")
            except Exception:
                self.counters.inc("feedback_errors")
                self._rl_log.exception("feedback", "feedback POST failed")

    # -- routes ----------------------------------------------------------------
    def retry_after_s(self) -> float:
        """Backpressure-aware ``Retry-After``: ``shed_retry_after_s`` is the
        base. While draining the hint is the drain budget; under load it
        scales with queue depth — inflight plus batcher backlog over the
        admission cap — capped at 30 s."""
        if self._draining:
            return max(self.shed_retry_after_s, self.drain_timeout_ms / 1e3)
        depth = float(self._inflight)
        if self._batcher is not None:
            depth += float(self._batcher.stats().get("depth") or 0)
        load = depth / float(max(1, self.max_inflight))
        return round(min(self.shed_retry_after_s * max(1.0, load), 30.0), 2)

    def _retry_headers(self) -> dict:
        return {"Retry-After": f"{self.retry_after_s():g}"}

    def _register_routes(self):
        svc = self.service

        @svc.route("GET", r"/")
        def index(req: Request):
            with self._lock:
                d = self._deployed
                info = {
                    "status": "alive",
                    "engineInstanceId": d.instance_id if d else None,
                    "engineVariant": self.engine_variant,
                    "startTime": d.start_time if d else None,
                    "requestCount": self.request_count,
                    "avgServingSec": self.avg_serving_sec,
                    "lastServingSec": self.last_serving_sec,
                    "latency": self.latency.summary(),
                    "feedback": self.feedback,
                    "feedbackDropped": self._feedback_dropped,
                    "feedbackQueued": self._feedback_queue.qsize(),
                    "device": str(self.ctx.device),
                }
                algorithms = d.algorithms if d else []
                models = d.models if d else []
            info["batching"] = self._batcher.stats() if self._batcher is not None else None
            info["resultCache"] = (
                self._result_cache.stats() if self._result_cache is not None else None
            )
            info["coalesce"] = self._coalesce
            fp = []
            for algo, model in zip(algorithms, models):
                get_stats = getattr(algo, "serving_stats", None)
                s = get_stats(model) if get_stats is not None else None
                if s is not None:
                    fp.append(s)
            info["fastpath"] = fp or None
            info["scoreKernelLaunches"] = score_kernel.launches.count
            with self._inflight_lock:
                info["inflight"] = self._inflight
            info["resilience"] = {
                "inflight": info["inflight"],
                "maxInflight": self.max_inflight,
                "counters": self.counters.snapshot(),
                "feedbackBreaker": self._feedback_breaker.stats(),
                "reloadDegraded": self._reload_degraded,
            }
            return json_response(200, info)

        @svc.route("GET", r"/healthz")
        def healthz(req: Request):
            # liveness: the process is up and the route table answers
            return json_response(200, {"status": "ok"})

        @svc.route("GET", r"/readyz")
        def readyz(req: Request):
            # readiness: a model is deployed and warm, the admission gate
            # has headroom, and no drain has begun. reloadDegraded is
            # reported but does not fail readiness: the last good
            # generation is still serving.
            with self._lock:
                dep = self._deployed
                generation = self._serving_gen
                warm = self._fastpath_warm
            with self._inflight_lock:
                inflight = self._inflight
            body = {
                "deployed": dep is not None,
                "inflight": inflight,
                "maxInflight": self.max_inflight,
                "reloadDegraded": self._reload_degraded,
                "draining": self._draining,
                "generation": generation,
                # reload() swaps a generation in only after its warm-up
                "fastpathWarm": warm,
                "engineInstanceId": dep.instance_id if dep else None,
            }
            # every not-ready answer carries Retry-After, as the shed paths do
            if self._draining:
                body["status"] = "draining"
                return Response(status=503, body=body, headers=self._retry_headers())
            if dep is None:
                body["status"] = "no engine instance deployed"
                return Response(status=503, body=body, headers=self._retry_headers())
            if inflight >= self.max_inflight:
                body["status"] = "overloaded"
                return Response(status=503, body=body, headers=self._retry_headers())
            body["status"] = "ready"
            return json_response(200, body)

        @svc.route("POST", r"/queries\.json")
        def queries(req: Request):
            with _tracing.stage("decode"):
                data = req.json()
            if not isinstance(data, dict):
                return json_response(400, {"message": "query must be a JSON object"})
            if self._draining:
                # draining: in-flight work finishes, new work goes elsewhere
                return Response(
                    status=503,
                    body={"message": "server draining; retry against another instance"},
                    headers=self._retry_headers(),
                )
            # admission control: beyond max_inflight, queueing only adds
            # latency to requests that will miss their deadlines anyway —
            # shed with 503 + Retry-After so callers back off
            with self._inflight_lock:
                if self._inflight >= self.max_inflight:
                    self.counters.inc("shed")
                    return Response(
                        status=503,
                        body={"message": "server overloaded; request shed"},
                        headers=self._retry_headers(),
                    )
                self._inflight += 1
            try:
                deadline = parse_deadline_header(req.headers.get(DEADLINE_HEADER))
                if deadline is None and self.default_deadline_ms is not None:
                    deadline = Deadline.after_ms(self.default_deadline_ms)
                if deadline is not None and deadline.expired():
                    # already over budget on arrival: never touches the card
                    self.counters.inc("deadline_exceeded")
                    return json_response(504, {"message": "deadline expired before execution"})
                try:
                    # ambient binding: layers below see the budget through
                    # current_deadline() where no parameter reaches them
                    with deadline_scope(deadline):
                        return json_response(200, self.handle_query(data, deadline))
                except DeadlineExceeded as e:
                    return json_response(504, {"message": str(e)})
                except TypeError as e:
                    return json_response(400, {"message": str(e)})
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

        @svc.route("GET", r"/reload")
        @svc.route("POST", r"/reload")
        def reload_route(req: Request):
            # ?instanceId= pins the swap to one generation
            target = (req.params.get("instanceId") or "").strip() or None
            force = (req.params.get("force") or "") in ("1", "true", "yes")
            iid = self.reload(instance_id=target, force=force)
            return json_response(200, {"message": "Reloaded", "engineInstanceId": iid})

        @svc.route("POST", r"/stop")
        def stop_route(req: Request):
            def _stop():
                time.sleep(0.3)  # let the response flush before the socket dies
                self.drain()

            threading.Thread(target=_stop, daemon=True).start()
            return json_response(200, {"message": "Shutting down."})

        @svc.route("GET", r"/plugins\.json")
        def plugins_route(req: Request):
            def of(kind):
                return {
                    p.name: {"class": type(p).__name__}
                    for p in self.plugins if p.plugin_type == kind
                }

            return json_response(200, {"plugins": {
                "outputblockers": of(EngineServerPlugin.OUTPUT_BLOCKER),
                "outputsniffers": of(EngineServerPlugin.OUTPUT_SNIFFER),
            }})

    # -- lifecycle ---------------------------------------------------------------
    def start(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        cert_path: Optional[str] = None,
        key_path: Optional[str] = None,
    ) -> int:
        actual = self.service.start(host, port, cert_path=cert_path, key_path=key_path)
        logger.info("query server listening on %s:%s", host, actual)
        return actual

    def drain(self, timeout_ms: Optional[float] = None) -> bool:
        """Graceful shutdown: flip /readyz to draining (new queries shed),
        wait for in-flight queries — queued micro-batches included — to
        finish inside the budget, then stop. Returns True when nothing was
        abandoned; abandoned work is counted either way."""
        budget_s = (timeout_ms if timeout_ms is not None else self.drain_timeout_ms) / 1e3
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + max(budget_s, 0.0)
        while time.monotonic() < deadline:
            with self._inflight_lock:
                inflight = self._inflight
            if inflight == 0:
                break
            time.sleep(0.005)
        with self._inflight_lock:
            abandoned = self._inflight
        if abandoned:
            self.counters.inc("drain_abandoned", abandoned)
            logger.warning(
                "drain budget (%.0fms) lapsed with %d queries in flight",
                budget_s * 1e3, abandoned,
            )
        else:
            self.counters.inc("drained")
        self.stop()
        return abandoned == 0

    def stop(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
        if self._feedback_worker is not None:
            try:
                self._feedback_queue.put_nowait(None)  # drain-and-exit sentinel
            except queue.Full:
                pass  # worker is wedged; it's a daemon thread, let it die
        self.service.stop()
