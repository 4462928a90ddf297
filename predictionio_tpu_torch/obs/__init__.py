"""Unified observability: metrics registry, exposition, request tracing.

Counterpart of ``predictionio_tpu/obs/__init__.py``. Of its modules the
port has :mod:`.metrics`, :mod:`.tracing`, :mod:`.bridges` (the ported
components' bridges) and :mod:`.devprof` (serving's cost models and
accountant).

The reference system exposed two serving-seconds gauges and whatever the
Spark UI showed (``CreateServer.scala:415-417``; SURVEY §5).  This package
replaces the reproduction's scattered per-component dicts (``Stats``,
``LatencyHistogram``, ``ErrorCounters``, ``MicroBatcher.stats()``) with one
substrate:

* :mod:`~predictionio_tpu_torch.obs.metrics` — lock-cheap ``Counter`` /
  ``Gauge`` / ``Histogram`` with labels, Prometheus text + JSON exposition,
  and a strict parser for round-trip tests and scraping.
* :mod:`~predictionio_tpu_torch.obs.tracing` — head-sampled request traces with
  a per-stage breakdown, propagated cross-thread (micro-batcher) and
  cross-service (``X-Request-Id``), kept in a bounded in-memory ring.
* :class:`Telemetry` — one bundle per server: installs ``GET /metrics``
  and ``GET /trace/recent.json`` on an
  :class:`~predictionio_tpu_torch.common.http.HttpService` and instruments its
  request loop (request counter, latency histogram, serialize stage).

Knobs (env): ``PIO_TELEMETRY=0`` disables installation, ``PIO_TRACE_SAMPLE``
sets the head-sampling rate (default 0.1), ``PIO_TRACE_RING`` the ring size
(default 256), ``PIO_METRICS_MAX_SERIES`` the per-metric label-cardinality
cap (default 512), ``PIO_SLOW_TRACE_QUANTILE`` / ``PIO_SLOW_TRACE_RING``
the flight recorder's tail-sampling quantile and ring (0.99 / 64).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from predictionio_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    parse_prometheus,
)
from predictionio_tpu_torch.obs.tracing import TRACE_HEADER, Tracer

__all__ = [
    "Telemetry",
    "MetricsRegistry",
    "Tracer",
    "TRACE_HEADER",
    "parse_prometheus",
    "telemetry_enabled",
]

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def telemetry_enabled() -> bool:
    """Global kill switch: ``PIO_TELEMETRY=0`` turns the subsystem off."""
    return os.environ.get("PIO_TELEMETRY", "1") != "0"


class Telemetry:
    """One server's observability bundle: registry + tracer + HTTP hooks.

    Each server owns its own registry (its ``/metrics`` is its own truth —
    two servers in one process never share series), mirroring one
    Prometheus target per listening port.
    """

    def __init__(
        self,
        service_name: str,
        sample_rate: Optional[float] = None,
        ring_size: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.service_name = service_name
        self.registry = registry or MetricsRegistry()
        self.tracer = Tracer(sample_rate=sample_rate, ring_size=ring_size)
        self._start = time.monotonic()
        reg = self.registry
        self._http_requests = reg.counter(
            "pio_http_requests_total",
            "HTTP requests served, by method, route, and status code.",
            ("method", "path", "status"),
        )
        self._http_latency = reg.histogram(
            "pio_http_request_seconds",
            "End-to-end HTTP request latency (accept to last byte).",
            ("path",),
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        info = reg.gauge(
            "pio_server_info",
            "Constant 1, labeled with the serving component's name.",
            ("service",),
        )
        info.labels(service_name).set(1)
        reg.gauge_fn(
            "pio_uptime_seconds",
            "Seconds since this server's telemetry was created.",
            lambda: time.monotonic() - self._start,
        )
        reg.gauge_fn(
            "pio_threads",
            "Live Python threads in this process.",
            lambda: float(threading.active_count()),
        )
        reg.gauge_fn(
            "pio_traces_sampled_total",
            "Requests admitted by the head sampler since start.",
            lambda: float(self.tracer.sampled),
        )
        reg.gauge_fn(
            "pio_trace_ring_size",
            "Finished traces currently held in the in-memory ring.",
            lambda: float(len(self.tracer.ring)),
        )
        reg.gauge_fn(
            "pio_slow_trace_retained",
            "Slow-request exemplars retained by the flight recorder "
            "since start (tail sampling above the rolling quantile).",
            lambda: float(self.tracer.slow_retained),
        )
        reg.gauge_fn(
            "pio_slow_trace_threshold_seconds",
            "Current rolling-quantile wall-time threshold for slow-trace "
            "retention (NaN until the reservoir warms up).",
            lambda: float(self.tracer.slow_threshold_s() or float("nan")),
        )

    # -- HTTP request-loop hooks (called from common/http.py) ---------------
    def observe_http(
        self, method: str, path: str, status: int, seconds: float,
        known_path: bool,
    ) -> None:
        # unknown paths collapse into one label value so a hostile URL
        # stream can't mint unbounded series
        p = path if known_path else "/other"
        self._http_requests.labels(method, p, str(status)).inc()
        self._http_latency.labels(p).observe(seconds)

    # -- route installation --------------------------------------------------
    def install(self, service) -> "Telemetry":
        """Attach to an HttpService: request hooks + exposition routes."""
        service.telemetry = self

        @service.route("GET", r"/metrics")
        def _metrics(req):
            from predictionio_tpu_torch.common.http import Response

            if req.params.get("format") == "json":
                return Response(status=200, body=self.registry.render_json())
            return Response(
                status=200,
                body=self.registry.render_prometheus().encode("utf-8"),
                content_type=PROMETHEUS_CTYPE,
            )

        @service.route("GET", r"/trace/recent\.json")
        def _traces(req):
            from predictionio_tpu_torch.common.http import json_response

            limit = int(req.params.get("limit") or 0) or None
            return json_response(
                200,
                {
                    "service": self.service_name,
                    "sampleRate": self.tracer.sample_rate,
                    "ringSize": self.tracer.ring_max,
                    "traces": self.tracer.recent(limit),
                },
            )

        @service.route("GET", r"/trace/slow\.json")
        def _slow_traces(req):
            from predictionio_tpu_torch.common.http import json_response

            limit = int(req.params.get("limit") or 0) or None
            thr = self.tracer.slow_threshold_s()
            return json_response(
                200,
                {
                    "service": self.service_name,
                    "quantile": self.tracer.slow_quantile,
                    "ringSize": self.tracer.slow_ring_max,
                    "thresholdMs": (
                        None if thr is None else round(thr * 1e3, 4)
                    ),
                    "retained": self.tracer.slow_retained,
                    "traces": self.tracer.slow_recent(limit),
                },
            )

        return self


def maybe_install(service, service_name: str, **kw) -> Optional[Telemetry]:
    """Install a fresh :class:`Telemetry` unless globally disabled."""
    if not telemetry_enabled():
        return None
    return Telemetry(service_name, **kw).install(service)
