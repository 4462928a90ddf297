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
* ``POST /delta`` and ``GET /delta/stats`` under ``PIO_STREAMING=1``.

**Streaming micro-generations** (``PIO_STREAMING=1``, ``core/delta.py``).
After every successful reload the server fingerprints the deployed ALS
model's float32 factors and fences a :class:`~predictionio_tpu_torch.core.
delta.DeltaApplier` on the sealed log under ``PIO_DELTA_DIR/<fingerprint>``,
catching up with it before the reload returns, so a restarted replica is
ready only at the log's epoch. ``POST /delta`` takes a sealed blob (the
router's push; a torn or foreign one is a refusal receipt, never a 5xx),
and a catch-up worker replays the log every ``PIO_DELTA_CATCHUP_MS``. A
delta patches the card's resident factor rows in place
(``BucketedScorer.apply_delta_rows``: no new scorer, warm-up or build),
then the host model, and invalidates only its users' cached answers. An
answer served while the log's oldest unapplied epoch is older than
``PIO_FRESHNESS_SLO_MS`` carries ``"degraded": true`` and ``staleness_ms``;
``/readyz`` reports ``deltaEpoch``, ``deltaLogEpoch`` and ``stalenessMs``
and answers 503 while the replica is behind a log it can read. A card
error in an apply raises as ``KernelError``, as a launch's does.

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

**Fleet surface.** As in the JAX server: ``reload(instance_id)`` refuses
a generation a canary quarantined (``POST /reload`` answers 409) unless
``force``; a cold start honours ``PIO_PIN_INSTANCE`` (the fleet's spawn
pin during a canary) and every newest-COMPLETED walk skips quarantined
ids. Multi-tenancy (``tenants``/``PIO_TENANTS``,
``serving/tenancy.py``): access-key auth, per-tenant fair-share admission
and quota sheds (503 with ``Retry-After``) ahead of the server-wide gate,
per-tenant breakers, A/B variants, and a result-cache namespace per
tenant. A composed pipeline (``pipeline``/``PIO_PIPELINE``,
``serving/pipeline.py``) is bound to each generation at its swap and
answers per query, retrieval then ranking. Fault sites:
``server:generation:<instanceId>`` on ``/queries.json`` and
``client:tenant:<tenant>`` after a tenant's authentication.

``/readyz`` carries ``servingBackend`` and, while a sharding plan serves
sharded, ``shardingFingerprint`` (and a ``pod`` block for a plan with host
groups: its ``group``, which ``PIO_POD_GROUP`` pins for a self-contained
replica); ``/metrics`` carries ``pio_shard_*`` and ``pio_pod_*`` then. A pod
mesh that spans the processes of a launch serves in lockstep only
(:meth:`QueryServer._pod_lockstep`): ``/readyz`` withholds the group and
answers 503, and ``/queries.json`` answers 503, as the JAX server does.

Waiting for its ROADMAP item, and raising an error that names it: ``POST
/debug/profile``, item 15.
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

import numpy as np

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common import faults as _faults
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
from predictionio_tpu_torch.core import delta as _delta
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.persistence import open_model_blob
from predictionio_tpu_torch.core.workflow import (
    get_latest_completed_instance,
    prepare_deploy,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.obs import bridges as _bridges
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import _build, score_kernel
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.models.cooccurrence import fold_increments
from predictionio_tpu_torch.ops import quantize as _quantize
from predictionio_tpu_torch.serving.pipeline import build_pipeline_engine, pipeline_from_env
from predictionio_tpu_torch.serving.tenancy import extract_access_key, tenants_from_env
from predictionio_tpu_torch.serving.result_cache import (
    canonical_fingerprint,
    coalesce_from_env,
    entity_ids_from,
    notify_delta,
    result_cache_from_env,
)
from predictionio_tpu_torch.utils.profiling import LatencyHistogram

logger = logging.getLogger(__name__)


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
        self._pod_lockstep_memo = None
        # streaming micro-generations (PIO_STREAMING=1): the delta state
        # enable_streaming() builds after each successful reload; None when
        # streaming is off or no factor model is live, and every streaming
        # touchpoint does nothing on None
        self._streaming: Optional[dict] = None
        # multi-tenancy: the tenant registry every /queries.json consults
        # (auth, fair-share admission ahead of the server-wide gate,
        # per-tenant breakers and variants); None keeps the open server
        self._tenants = (
            tenants_from_env(total_inflight=self.max_inflight)
            if tenants is None else tenants
        )
        # composed retrieval→ranking pipeline: the sealed config loads
        # here, the engine binds to the deployed model at every swap
        self._pipeline_config = pipeline_from_env() if pipeline is None else pipeline
        self._pipeline_engine = None
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
        ``instance_id`` pins the load to one generation (the canary's
        hot-swap) and refuses a quarantined one unless ``force``: with a
        generation live the refusal raises (``POST /reload`` answers 409;
        the JAX server's check sits inside its load ``try`` and answers 200
        with the live id, ROADMAP §3); at a cold start it falls back as a
        failed load does. With no
        ``instance_id`` the newest non-quarantined COMPLETED instance
        deploys; a cold start honours ``PIO_PIN_INSTANCE`` (the fleet's
        spawn pin while a canary is in flight).
        """
        if instance_id is None and self._deployed is None:
            instance_id = os.environ.get("PIO_PIN_INSTANCE", "").strip() or None
        refused = None
        if instance_id is not None and not force and persistence.is_quarantined(
            instance_id, self.engine_id, self.engine_version, self.engine_variant,
        ):
            refused = RuntimeError(
                f"engine instance {instance_id} is quarantined (failed online "
                "verification); pass force to override"
            )
            if self._deployed is not None:
                # a refusal, not a failed load: the caller hears it (POST
                # /reload answers 409) and the live generation keeps serving
                raise refused
        instance = None
        try:
            if refused is not None:
                raise refused  # a cold start falls back as from a failed load
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
        # a new base generation subsumes every earlier micro-generation:
        # re-base the delta pipeline on the factors just deployed
        self.enable_streaming()
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
        if self._pipeline_config is not None:
            # re-bind the pipeline to this generation; a config that cannot
            # bind (a template without the ALS surface) serves single-stage
            try:
                engine = build_pipeline_engine(
                    self._pipeline_config, deployed.algorithms, deployed.models
                )
            except Exception:
                engine = None
                self._rl_log.exception(
                    "pipeline", "pipeline %s failed to bind; serving single-stage",
                    self._pipeline_config.name,
                )
            with self._lock:
                self._pipeline_engine = engine
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
        # a quarantined generation failed ONLINE verification (a canary
        # rollback): neither the pointer nor the walk may bring it back
        quarantined = persistence.quarantined_instance_ids(
            self.engine_id, self.engine_version, self.engine_variant
        )
        by_id = {i.id: i for i in completed}
        order: list[str] = []
        lkg_id = self._read_last_known_good()
        if lkg_id and lkg_id != failed_id and lkg_id in by_id and lkg_id not in quarantined:
            order.append(lkg_id)
        order += [
            i.id for i in completed
            if i.id != failed_id and i.id not in order and i.id not in quarantined
        ]
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

    # -- streaming micro-generations (crash-safe delta pipeline) -------------
    def enable_streaming(self, delta_dir: Optional[str] = None) -> Optional[dict]:
        """Wire this replica into the sealed delta log (``PIO_STREAMING=1``).

        Fingerprints the first deployed factor model's base generation and
        fences a :class:`~predictionio_tpu_torch.core.delta.DeltaApplier` on
        its log. Catch-up runs here, synchronously, before the caller lets
        ``/readyz`` go ready, so a restarted replica is admitted only at the
        log's epoch. Returns the applier's stats, or None when streaming is
        off or no factor model is deployed.
        """
        self._stop_streaming()
        if not _delta.streaming_enabled():
            return None
        with self._lock:
            d = self._deployed
        if d is None:
            return None
        target = next(
            ((algo, model) for algo, model in zip(d.algorithms, d.models)
             if all(getattr(model, a, None) is not None
                    for a in ("user_factors", "item_factors", "user_map"))),
            None,
        )
        if target is None:
            return None
        algo, model = target
        fp = _delta.model_fingerprint(model.user_factors, model.item_factors)
        directory = delta_dir or _delta.delta_dir_for(fp)
        delta_log = _delta.DeltaLog(directory)
        st: dict = {
            "algo": algo,
            "model": model,
            "log": delta_log,
            "dir": directory,
            "fingerprint": fp,
            # replica-local cooccurrence count accumulator (pair -> count)
            "cooc": {},
            "slo_ms": float(os.environ.get("PIO_FRESHNESS_SLO_MS", "5000")),
            "degraded_served": 0,
            "staleness_ms": 0.0,
            "staleness_checked": 0.0,
            "wedged": None,
            "last_apply": None,
            "wake": threading.Event(),
            "stop": threading.Event(),
            "thread": None,
        }
        st["applier"] = _delta.DeltaApplier(
            fp, lambda dl: self._apply_streaming_delta(st, dl), delta_log=delta_log,
        )
        # one rebind on the reload thread before the worker starts: readers
        # see None or the whole state
        self._streaming = st
        # catch-up before readmission: replay every epoch already sealed
        self._streaming_catch_up(st)
        t = threading.Thread(
            target=self._catchup_loop, args=(st,), name="queryserver-delta-catchup",
            daemon=True,
        )
        st["thread"] = t
        t.start()
        logger.info(
            "streaming enabled: base %s, delta log %s, epoch %d",
            fp, directory, st["applier"].applied_epoch,
        )
        return st["applier"].stats()

    def _stop_streaming(self) -> None:
        st = self._streaming
        self._streaming = None
        if st is not None:
            st["stop"].set()
            st["wake"].set()

    def _apply_streaming_delta(self, st: dict, dl) -> None:
        """One fenced delta in place (the applier's ``apply_fn``): the
        card's resident rows first, then the host model (its quantized
        variant too, which a scorer built later reads), the cooccurrence
        counts, and the result cache's entries of the delta's users."""
        algo, model = st["algo"], st["model"]
        user_idx = np.asarray(dl.user_idx, np.int64)
        item_idx = np.asarray(() if dl.item_idx is None else dl.item_idx, np.int64)
        patch = getattr(algo, "apply_delta_rows", None)
        if patch is not None:
            st["last_apply"] = patch(
                model, dl.user_idx, dl.user_rows, item_idx=dl.item_idx, item_rows=dl.item_rows,
            )
        quantized = getattr(model, "factor_dtype", "f32") != "f32"
        for side, idx, rows in (("user", user_idx, dl.user_rows), ("item", item_idx, dl.item_rows)):
            if not idx.size:
                continue
            host = getattr(model, f"{side}_factors")
            host[idx] = np.asarray(rows, dtype=host.dtype)
            if quantized and getattr(model, f"{side}_factors_q", None) is not None:
                q, scale = _quantize.quantize_factors(rows, model.factor_dtype)
                getattr(model, f"{side}_factors_q")[idx] = q
                if scale is not None:
                    getattr(model, f"{side}_scale")[idx] = scale
        if dl.cooc_updates is not None and len(dl.cooc_updates):
            fold_increments(dl.cooc_updates, st["cooc"])
        # entity-targeted: only the users this delta rewrote lose their
        # cached answers; everyone else stays hot
        notify_delta(dl.user_ids)

    def _streaming_staleness_ms(self) -> float:
        """Age of the oldest sealed-but-unapplied epoch, cached for 250 ms
        so the per-query SLO check never turns into a per-query listdir."""
        st = self._streaming
        if st is None:
            return 0.0
        now = time.monotonic()
        if now - st["staleness_checked"] >= 0.25:
            try:
                age = st["log"].oldest_unapplied_age_s(st["applier"].applied_epoch)
            except OSError:
                age = 0.0
            st["staleness_ms"] = age * 1000.0
            st["staleness_checked"] = now
        return st["staleness_ms"]

    def _catchup_loop(self, st: dict) -> None:
        """Catch-up worker: paces on ``PIO_DELTA_CATCHUP_MS`` (woken early
        by ``/readyz`` or an SLO breach) and replays the log."""
        pace_s = float(os.environ.get("PIO_DELTA_CATCHUP_MS", "1000")) / 1e3
        while not st["stop"].is_set():
            st["wake"].wait(pace_s)
            st["wake"].clear()
            if st["stop"].is_set():
                return
            self._streaming_catch_up(st)

    def _streaming_catch_up(self, st: dict) -> None:
        try:
            rc = st["applier"].catch_up()
        except Exception:
            self._rl_log.exception("delta", "delta catch-up failed")
            return
        # a refused catch-up (torn blob, fence, gap) wedges at the last good
        # epoch: remember it so /readyz stops holding the replica out; it
        # serves degraded instead of flapping on a replay that cannot succeed
        st["wedged"] = rc if rc.get("refused") else None

    def streaming_stats(self) -> Optional[dict]:
        st = self._streaming
        if st is None:
            return None
        out = st["applier"].stats()
        out.update(
            log_epoch=st["log"].last_epoch(),
            staleness_ms=self._streaming_staleness_ms(),
            slo_ms=st["slo_ms"],
            degraded_served=st["degraded_served"],
            cooc_pairs=len(st["cooc"]),
            fingerprint=st["fingerprint"],
            dir=st["dir"],
            last_apply=st["last_apply"],
        )
        return out

    # -- observability -------------------------------------------------------
    def _pod_lockstep(self) -> bool:
        """True when the live fast path's pod mesh spans processes: every
        process must then dispatch the same batches in the same order (the
        cross-process merge is a collective), so this replica cannot answer
        a query routed to it alone (``query_server.py:756-779`` in the JAX
        package). Memoized per serving generation."""
        with self._lock:
            gen = self._serving_gen
            memo = self._pod_lockstep_memo
        if memo is not None and memo[0] == gen:
            return memo[1]
        spans = bool(((self._fastpath_stats() or {}).get("pod") or {}).get("spans_processes"))
        with self._lock:
            self._pod_lockstep_memo = (gen, spans)
        return spans

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

    def _event_cache_stats(self) -> Optional[dict]:
        """First deployed algorithm's ServingEventCache stats, if any (the
        e-commerce template creates one lazily on its first predict)."""
        with self._lock:
            d = self._deployed
        if d is None:
            return None
        for algo in d.algorithms:
            cache = getattr(algo, "_event_cache", None)
            if cache is not None:
                return cache.stats_dict()
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
        # pio_shard_*: emits only while a plan serves sharded (the stats
        # block is absent under replicated placement)
        _bridges.bridge_sharding(reg, self._fastpath_stats)
        # pio_ivf_*: emits only while an IVF index is live (the stats block
        # is absent under exact retrieval)
        _bridges.bridge_ivf(reg, self._fastpath_stats)
        # pio_pod_*: emits only while a plan with host groups serves
        _bridges.bridge_pod(reg, lambda: (self._fastpath_stats() or {}).get("pod"))
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
        _bridges.bridge_event_cache(reg, self._event_cache_stats)
        # pio_tenant_*: only while a tenant registry is installed
        if self._tenants is not None:
            _bridges.bridge_tenancy(reg, self._tenants.stats)
        # pio_pipeline_*: emits only while a composed pipeline is bound
        _bridges.bridge_pipeline(
            reg,
            lambda: self._pipeline_engine.stats() if self._pipeline_engine is not None else None,
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

        def _streaming_families():
            # only while streaming is live: with PIO_STREAMING=0 /metrics
            # is the server's without streaming, byte for byte
            st = self._streaming
            if st is None:
                return []
            a = st["applier"].stats()
            refused = a["refused"] or {}
            F = _bridges.Family
            return [
                F("pio_delta_epoch", "gauge",
                  "Micro-generation epoch applied by this replica.",
                  [("", (), float(a["applied_epoch"]))]),
                F("pio_delta_log_epoch", "gauge",
                  "Newest epoch sealed in this replica's delta log.",
                  [("", (), float(st["log"].last_epoch()))]),
                F("pio_delta_applied_total", "counter",
                  "Deltas applied in place on the serving factors.",
                  [("", (), float(a["applied"]))]),
                F("pio_delta_noop_total", "counter",
                  "Replayed already-applied epochs acked as no-ops "
                  "(the exactly-once path).",
                  [("", (), float(a["noops"]))]),
                F("pio_delta_refused_total", "counter",
                  "Deltas refused by reason (fingerprint fence, gap, "
                  "integrity).",
                  [("", (("reason", r),), float(n))
                   for r, n in sorted(refused.items())] or
                  [("", (("reason", "none"),), 0.0)]),
                F("pio_delta_cooc_pending", "gauge",
                  "Distinct cooccurrence pairs accumulated from applied "
                  "deltas since the last full retrain.",
                  [("", (), float(len(st["cooc"])))]),
                F("pio_freshness_staleness_ms", "gauge",
                  "Age of the oldest sealed-but-unapplied delta epoch.",
                  [("", (), float(self._streaming_staleness_ms()))]),
                F("pio_freshness_slo_ms", "gauge",
                  "Configured freshness SLO (PIO_FRESHNESS_SLO_MS).",
                  [("", (), float(st["slo_ms"]))]),
                F("pio_freshness_visible_p99_ms", "gauge",
                  "p99 event-committed to prediction-visible latency "
                  "over recent applied deltas.",
                  [("", (), float(a["visible_p99_ms"]))]),
                F("pio_freshness_degraded_total", "counter",
                  "Answers served with degraded:true because staleness "
                  "exceeded the freshness SLO.",
                  [("", (), float(st["degraded_served"]))]),
            ]

        reg.register_collector(_streaming_families)

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
    def handle_query(
        self,
        data: dict,
        deadline: Optional[Deadline] = None,
        tenant: Optional[str] = None,
        variant: Optional[str] = None,
    ) -> dict:
        t0 = time.perf_counter()
        with self._lock:
            deployed = self._deployed
            generation = self._serving_gen
            pipe = self._pipeline_engine
        with _tracing.stage("decode"):
            query = bind_query(self.engine.query_cls, data)
        degraded = False
        cache = self._result_cache
        # one canonical fingerprint serves both layers: the result-cache
        # key here and the single-flight coalescing key at the batcher.
        # Under multi-tenancy it is namespaced by tenant, variant and live
        # instance: two tenants' identical bodies never share an answer
        namespace = None
        if tenant is not None:
            namespace = "\x1f".join(
                (tenant, variant or "-", deployed.instance_id if deployed else "")
            )
        fp = (
            canonical_fingerprint(data, namespace=namespace)
            if (cache is not None or self._coalesce) else None
        )
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
                pmeta = None
                if pipe is not None:
                    # composed dataflow: retrieval → ranking under per-stage
                    # shares of this request's deadline; a late or failed
                    # ranking stage yields the retrieval-only answer
                    supplemented = deployed.serving.supplement(query)
                    prediction, pmeta = pipe.run_pipeline(supplemented, deadline)
                    prediction = deployed.serving.serve(supplemented, [prediction])
                elif self._batcher is not None:
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
                if pmeta is not None and pmeta.get("degraded"):
                    # a stage overran its share: retrieval-only, flagged,
                    # counted and never cached
                    if isinstance(result, dict):
                        result["degraded"] = True
                        result["pipelineStage"] = pmeta.get("stage")
                    degraded = True
                    self.counters.inc("degraded")
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
        # freshness SLO: while the sealed log is ahead of this replica by
        # more than PIO_FRESHNESS_SLO_MS the answer is still served,
        # annotated, never failed. After cache.put (the cache copies, so the
        # annotation never sticks to the cached answer), and on hits too: a
        # cached answer is as stale as the factors that computed it.
        st = self._streaming
        if st is not None and isinstance(result, dict):
            stale = self._streaming_staleness_ms()
            if stale > st["slo_ms"]:
                result["degraded"] = True
                result["staleness_ms"] = round(stale, 1)
                st["degraded_served"] += 1
                st["wake"].set()
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
            info["tenancy"] = self._tenants.stats() if self._tenants is not None else None
            info["pipeline"] = (
                self._pipeline_engine.stats() if self._pipeline_engine is not None else None
            )
            fp = []
            for algo, model in zip(algorithms, models):
                get_stats = getattr(algo, "serving_stats", None)
                s = get_stats(model) if get_stats is not None else None
                if s is not None:
                    fp.append(s)
            info["fastpath"] = fp or None
            info["scoreKernelLaunches"] = score_kernel.launches.count
            # kernels built in this process: a delta patch builds none
            info["kernelBuilds"] = len(_build.build_log)
            # which of them this process found in the build cache (no nvcc)
            info["kernelBuildCached"] = {
                name: out == "cached" for name, (_, _, out) in _build.build_log.items()
            }
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
            # the factor placement and, while a plan serves sharded, its
            # fingerprint: a `pio shards rebuild` + reload shows as a change
            fps = self._fastpath_stats()
            if fps and fps.get("serving_backend"):
                body["servingBackend"] = fps["serving_backend"]
                plan = (fps.get("sharding") or {}).get("plan") or {}
                if plan.get("fingerprint"):
                    body["shardingFingerprint"] = plan["fingerprint"]
            # the pod placement: this replica's host group, for the fleet
            # router's group-affine routing (PIO_POD_GROUP pins it for
            # self-contained replicas). A mesh that spans processes is
            # lockstep only: its group is withheld and the replica is not
            # ready, whatever PIO_POD_GROUP says
            pod = (fps or {}).get("pod")
            pod_spans = bool((pod or {}).get("spans_processes"))
            if pod:
                group_env = os.environ.get("PIO_POD_GROUP", "")
                body["pod"] = {
                    "group": None if pod_spans
                    else int(group_env) if group_env.strip()
                    else int(pod.get("process_index") or 0),
                    "groups": int(pod.get("host_groups") or 1),
                    "fingerprint": pod.get("fingerprint"),
                    "processIndex": pod.get("process_index"),
                    "processCount": pod.get("process_count"),
                    "spansProcesses": pod_spans,
                }
            # streaming: the applied epoch and the staleness tell a router
            # where this replica sits in the delta sequence
            st = self._streaming
            delta_behind = False
            if st is not None:
                applied = st["applier"].applied_epoch
                head = st["log"].last_epoch()
                body["deltaEpoch"] = applied
                body["deltaLogEpoch"] = head
                body["stalenessMs"] = round(self._streaming_staleness_ms(), 1)
                # a wedged log (a torn blob, a fence refusal, no progress
                # since) must not hold the replica out forever: it rejoins at
                # its last good epoch and serves degraded instead
                wedged = st.get("wedged")
                stuck = wedged is not None and applied <= int(wedged.get("applied_epoch", -1))
                if stuck:
                    body["deltaWedged"] = wedged.get("reason")
                delta_behind = head > applied and not stuck
            # every not-ready answer carries Retry-After, as the shed paths do
            if self._draining:
                body["status"] = "draining"
                return Response(status=503, body=body, headers=self._retry_headers())
            if dep is None:
                body["status"] = "no engine instance deployed"
                return Response(status=503, body=body, headers=self._retry_headers())
            if delta_behind:
                # catch-up before readmission: wake the worker and refuse
                # traffic until this replica reaches the log's epoch
                st["wake"].set()
                body["status"] = "delta catch-up"
                return Response(status=503, body=body, headers=self._retry_headers())
            if inflight >= self.max_inflight:
                body["status"] = "overloaded"
                return Response(status=503, body=body, headers=self._retry_headers())
            if pod_spans:
                # never admitted into a routed fleet: this process scores
                # only in lockstep with its pod peers
                body["status"] = "pod mesh spans processes (lockstep only)"
                return Response(status=503, body=body, headers=self._retry_headers())
            body["status"] = "ready"
            return json_response(200, body)

        def _serve_admitted(req, data, tenant, variant):
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
                    # current_deadline() where no parameter reaches them.
                    # Untenanted servers keep the two-argument call:
                    # handle_query is a documented override point
                    with deadline_scope(deadline):
                        if tenant is None:
                            result = self.handle_query(data, deadline)
                        else:
                            result = self.handle_query(
                                data, deadline, tenant=tenant, variant=variant
                            )
                        return json_response(200, result)
                except DeadlineExceeded as e:
                    return json_response(504, {"message": str(e)})
                except TypeError as e:
                    return json_response(400, {"message": str(e)})
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

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
            if self._pod_lockstep():
                # refusing beats deadlocking: one process of a pod mesh that
                # spans processes cannot dispatch alone, its peers would never
                # join the cross-process merge
                return Response(
                    status=503,
                    body={"message": "pod mesh spans processes: queries "
                          "must be dispatched in SPMD lockstep on every "
                          "process, not routed to one — serve through "
                          "self-contained host-local replicas instead"},
                    headers=self._retry_headers(),
                )
            if _faults.active() is not None:
                # generation-keyed chaos: a rule on server:generation:<id>
                # degrades only the replica serving that instance (how a
                # test plants a bad canary candidate)
                with self._lock:
                    live = self._deployed
                if live is not None:
                    act = _faults.check(f"server:generation:{live.instance_id}")
                    if act is not None:
                        if act.latency_s:
                            time.sleep(act.latency_s)
                        if act.kind in ("error", "drop", "crash"):
                            return json_response(
                                act.status or 500,
                                {"message": "injected generation fault", "injected": True},
                            )
            reg = self._tenants
            if reg is None:
                return _serve_admitted(req, data, None, None)
            # multi-tenant surface: the event server's auth contract on the
            # query plane (?accessKey=, X-PIO-Access-Key or the body's
            # accessKey, which cache fingerprints leave out)
            key = extract_access_key(req.params, req.headers, data)
            if not key:
                return json_response(401, {"message": "Missing accessKey."})
            spec = reg.authenticate(key)
            if spec is None:
                return json_response(401, {"message": "Invalid accessKey."})
            tenant = spec.tenant_id
            act = _faults.check(f"client:tenant:{tenant}")
            if act is not None:
                # a chaos-injected bad request FROM this tenant feeds this
                # tenant's breaker only
                if act.latency_s:
                    time.sleep(act.latency_s)
                if act.kind in ("error", "drop", "crash"):
                    reg.record_result(tenant, None, ok=False, latency_s=0.0)
                    return json_response(
                        act.status or 503, {"message": "injected fault", "injected": True},
                    )
            adm = reg.admit(tenant)
            if not adm.ok:
                # per-tenant shed (quota, fair-share cap or open breaker):
                # 503 with a quota-aware Retry-After, other tenants untouched
                return Response(
                    status=503,
                    body={"message": f"tenant {tenant} shed", "tenant": tenant,
                          "reason": adm.reason},
                    headers={"Retry-After": f"{adm.retry_after_s:g}"},
                )
            variant = reg.pick_variant(tenant, data.get("user"))
            ok = False
            t0 = time.perf_counter()
            try:
                resp = _serve_admitted(req, data, tenant, variant)
                # 4xx and 503 are the contract working; only 5xx server
                # errors feed this tenant's breaker
                ok = resp.status < 500 or resp.status == 503
                return resp
            finally:
                reg.release(tenant)
                reg.record_result(tenant, variant, ok=ok, latency_s=time.perf_counter() - t0)

        @svc.route("GET", r"/reload")
        @svc.route("POST", r"/reload")
        def reload_route(req: Request):
            # ?instanceId= pins the swap to one generation (the canary's
            # promote and rollback hop); a quarantined id answers 409
            # unless ?force=1
            target = (req.params.get("instanceId") or "").strip() or None
            force = (req.params.get("force") or "") in ("1", "true", "yes")
            try:
                iid = self.reload(instance_id=target, force=force)
            except RuntimeError as e:
                if "quarantined" in str(e):
                    return json_response(409, {"message": str(e)})
                raise
            return json_response(200, {"message": "Reloaded", "engineInstanceId": iid})

        @svc.route("POST", r"/delta")
        def delta_route(req: Request):
            # router → replica hop: the body is the sealed envelope as is.
            # Every answer is a receipt; a torn or forged payload is an
            # integrity REFUSAL (200 + receipt), not a 5xx: the replica keeps
            # serving its last good epoch
            st = self._streaming
            if st is None:
                return json_response(409, {
                    "refused": True, "reason": "streaming disabled",
                    "streaming": _delta.streaming_enabled(),
                })
            try:
                dl = _delta.Delta.from_payload(open_model_blob(req.body))
            except Exception as e:
                return json_response(200, st["applier"].refuse("integrity", error=str(e)))
            receipt = st["applier"].apply(dl)
            if receipt.get("applied"):
                st["wedged"] = None
            return json_response(200, receipt)

        @svc.route("GET", r"/delta/stats")
        def delta_stats_route(req: Request):
            stats = self.streaming_stats()
            if stats is None:
                return json_response(404, {"message": "streaming disabled"})
            return json_response(200, stats)

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
        self._stop_streaming()
        if self._batcher is not None:
            self._batcher.stop()
        if self._feedback_worker is not None:
            try:
                self._feedback_queue.put_nowait(None)  # drain-and-exit sentinel
            except queue.Full:
                pass  # worker is wedged; it's a daemon thread, let it die
        self.service.stop()
