"""Query server: REST serving of a deployed engine from the card.

Counterpart of ``predictionio_tpu/serving/query_server.py`` (parity:
``core/.../workflow/CreateServer.scala:104-706``), with the constructor
arguments ``pio deploy`` passes and these routes:

* ``POST /queries.json`` — bind query → ``serving.supplement`` → predict →
  ``serving.serve``. With ``batching=True`` queries go through a
  :class:`~predictionio_tpu_torch.serving.batching.MicroBatcher` into one
  ``Algorithm.batch_predict`` per batch (for ALS: one kernel launch).
* ``GET /`` — server info, batcher and fast-path counters, and the score
  kernel's launch count in this process (``scoreKernelLaunches``).
* ``GET /readyz`` — 200 once a model is deployed and warm.
* ``POST /stop`` — undeploy.

``reload()`` loads the newest COMPLETED instance (``prepare_deploy``) and,
for batching deployments, warms the fast path before the swap. A warm-up
failure raises out of ``reload()``: the JAX server counts it and serves
on, which on the card would hide a kernel that failed to build or launch.
Likewise a failing scorer answers 500 here; there is no degraded fallback
yet. Tenancy, pipelines, streaming, canary, feedback, the result cache,
telemetry and the fleet come with later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional

from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.common.resilience import DeadlineExceeded
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.workflow import (
    get_latest_completed_instance,
    prepare_deploy,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops import score_kernel

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


def _to_jsonable(obj: Any) -> Any:
    # None-valued fields are omitted, matching the reference's json4s
    # treatment of Option None (absent field, not null)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _to_jsonable(v)
            for f in dataclasses.fields(obj)
            if (v := getattr(obj, f.name)) is not None
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
    ):
        # event_server_url and access_key serve only the feedback loop
        if feedback:
            raise NotImplementedError(
                "the feedback loop is not ported to predictionio_tpu_torch yet"
            )
        self.engine = engine
        self.storage = storage or Storage.instance()
        self.ctx = ctx or DeviceContext.create()
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.plugins = list(plugins or [])
        self._deployed: Optional[_Deployed] = None
        self._lock = threading.Lock()
        # latency bookkeeping (parity: CreateServer.scala:415-417)
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.service = HttpService("queryserver")
        # queries being answered right now (reported on GET /)
        self._inflight = 0
        # the fast path serves formed batches, so it warms with batching
        self._warm_fastpath = batching
        self._serving_gen = 0
        self._register_routes()
        self.reload()
        self._batcher = None
        if batching:
            from predictionio_tpu_torch.serving import fastpath
            from predictionio_tpu_torch.serving.batching import MicroBatcher

            self._batcher = MicroBatcher(
                self._run_query_batch, buckets=fastpath.BUCKETS
            )

    # -- model lifecycle -----------------------------------------------------
    def reload(self) -> str:
        """(Re)load the newest COMPLETED instance, warm it, swap atomically.

        Any failure — no instance, a corrupt blob, a kernel that does not
        build or launch during warm-up — raises, and the generation that
        was live (if any) stays live.
        """
        instance = get_latest_completed_instance(
            self.storage, self.engine_id, self.engine_version, self.engine_variant
        )
        _, algorithms, serving, models = prepare_deploy(
            self.engine, instance, storage=self.storage, ctx=self.ctx
        )
        if self._warm_fastpath:
            for algo, model in zip(algorithms, models):
                warm = getattr(algo, "warmup", None)
                if warm is not None:
                    warm(model)
        deployed = _Deployed(
            instance_id=instance.id,
            algorithms=algorithms,
            serving=serving,
            models=models,
            start_time=time.time(),
        )
        with self._lock:
            self._deployed = deployed
            self._serving_gen += 1
        logger.info("deployed engine instance %s", instance.id)
        return instance.id

    def _fastpath_stats(self, deployed: Optional[_Deployed]) -> list:
        out = []
        if deployed is None:
            return out
        for algo, model in zip(deployed.algorithms, deployed.models):
            get_stats = getattr(algo, "serving_stats", None)
            s = get_stats(model) if get_stats is not None else None
            if s is not None:
                out.append(s)
        return out

    # -- batched path: one Algorithm.batch_predict pass for N queries --------
    def _run_query_batch(self, queries: list) -> list:
        with self._lock:
            deployed = self._deployed
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
            out.append((sq, deployed.serving.serve(sq, preds)))
        return out

    # -- query hot loop (parity: CreateServer.scala:484-634) -----------------
    def handle_query(self, data: dict) -> dict:
        t0 = time.perf_counter()
        with self._lock:
            deployed = self._deployed
        query = bind_query(self.engine.query_cls, data)
        if self._batcher is not None:
            supplemented, prediction = self._batcher.submit(query)
        else:
            supplemented = deployed.serving.supplement(query)
            predictions = [
                algo.predict(model, supplemented)
                for algo, model in zip(deployed.algorithms, deployed.models)
            ]
            prediction = deployed.serving.serve(supplemented, predictions)
        result = _to_jsonable(prediction)
        # plugins see JSON values, as in the reference
        for p in self.plugins:
            if p.plugin_type == EngineServerPlugin.OUTPUT_BLOCKER:
                result = p.process(supplemented, result, {})
        for p in self.plugins:
            if p.plugin_type == EngineServerPlugin.OUTPUT_SNIFFER:
                p.process(supplemented, result, {})
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.last_serving_sec = dt
            self.avg_serving_sec += (dt - self.avg_serving_sec) / self.request_count
        return result

    # -- routes ----------------------------------------------------------------
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
                    "device": str(self.ctx.device),
                }
            info["batching"] = (
                self._batcher.stats() if self._batcher is not None else None
            )
            info["fastpath"] = self._fastpath_stats(d) or None
            info["scoreKernelLaunches"] = score_kernel.launches.count
            with self._lock:
                info["inflight"] = self._inflight
            return json_response(200, info)

        @svc.route("GET", r"/readyz")
        def readyz(req: Request):
            with self._lock:
                dep = self._deployed
                generation = self._serving_gen
            body = {
                "deployed": dep is not None,
                "generation": generation,
                # reload() swaps a generation in only after its warm-up
                "fastpathWarm": dep is not None,
                "engineInstanceId": dep.instance_id if dep else None,
            }
            if dep is None:
                body["status"] = "no engine instance deployed"
                return Response(status=503, body=body)
            body["status"] = "ready"
            return json_response(200, body)

        @svc.route("POST", r"/queries\.json")
        def queries(req: Request):
            data = req.json()
            if not isinstance(data, dict):
                return json_response(400, {"message": "query must be a JSON object"})
            with self._lock:
                self._inflight += 1
            try:
                return json_response(200, self.handle_query(data))
            except DeadlineExceeded as e:
                return json_response(504, {"message": str(e)})
            except TypeError as e:
                # malformed query values are a client bug
                return json_response(400, {"message": str(e)})
            finally:
                with self._lock:
                    self._inflight -= 1

        @svc.route("POST", r"/stop")
        def stop_route(req: Request):
            def _stop():
                time.sleep(0.3)  # let the response flush before the socket dies
                self.stop()

            threading.Thread(target=_stop, daemon=True).start()
            return json_response(200, {"message": "Shutting down."})

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

    def stop(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
        self.service.stop()
