"""Request-scoped tracing: per-stage breakdown, sampling, bounded ring.

Counterpart of ``predictionio_tpu/obs/tracing.py``, whole.

A :class:`Trace` is born at HTTP accept (``common/http.py``), rides the
request through the serving pipeline, and lands in a bounded in-memory
ring exposed at ``GET /trace/recent.json``.  Stages recorded on the query
path:

``decode`` → ``queue_wait`` (MicroBatcher) → ``batch_assembly`` → ``h2d``
→ ``device_compute`` (via the :func:`utils.profiling.trace` hook) →
``serialize``; whatever wall time the named stages don't cover lands in
an explicit ``other`` remainder so the stage sum always reconciles with
wall time.

Propagation contract (as in ``predictionio_tpu/obs/tracing.py``):

* The ``X-Request-Id`` header carries the trace id.  A request that
  ARRIVES with one is always sampled (upstream already decided), and the
  id is propagated by the NetworkStorage client on every outgoing call so
  a query's storage round-trips correlate across services.  The response
  echoes the id back.
* Requests without the header are head-sampled at ``PIO_TRACE_SAMPLE``
  (deterministic every-Nth admission — no RNG in the hot path).
* Finished traces are additionally TAIL-sampled: walls above a rolling
  quantile (``PIO_SLOW_TRACE_QUANTILE``) land in a second bounded ring
  (``PIO_SLOW_TRACE_RING``) at ``GET /trace/slow.json`` — the flight
  recorder that explains the p99 instead of merely counting it.

Cross-thread attribution: the micro-batcher executes ONE batch for many
requests, so the worker thread installs every batch member's trace as
"active" (:func:`scope`) and shared stages (``h2d``, ``device_compute``)
are charged to each of them — the per-request view stays truthful about
where its wall time went even when the work was amortized.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional, Sequence

TRACE_HEADER = "X-Request-Id"

DEFAULT_SAMPLE_RATE = 0.1
DEFAULT_RING_SIZE = 256
# flight recorder (tail sampling): retain traces whose wall exceeds this
# rolling quantile of recent request walls, in a ring of this size
DEFAULT_SLOW_QUANTILE = 0.99
DEFAULT_SLOW_RING_SIZE = 64
# wall-time reservoir backing the rolling quantile; threshold is
# recomputed every _SLOW_RECOMPUTE records so the hot path stays O(1)
_SLOW_RESERVOIR = 512
_SLOW_RECOMPUTE = 16
# tail sampling stays off until the reservoir has seen this many walls —
# with two data points "the 99th percentile" would just be the max
_SLOW_MIN_SAMPLES = 16


class Trace:
    """One sampled request: stage durations + identity. Thread-safe."""

    __slots__ = (
        "request_id", "name", "start_unix", "_t0", "stages", "meta",
        "wall_s", "status", "_lock",
    )

    def __init__(self, request_id: str, name: str = ""):
        self.request_id = request_id
        self.name = name
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self.stages: dict[str, float] = {}
        self.meta: dict = {}
        self.wall_s: Optional[float] = None
        self.status: Optional[int] = None
        self._lock = threading.Lock()

    def add_stage(self, stage: str, seconds: float) -> None:
        """Accumulate time into a named stage (re-entry adds, not replaces)."""
        if seconds < 0:
            seconds = 0.0
        with self._lock:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(name, time.perf_counter() - t0)

    def annotate(self, **kv) -> None:
        """Attach request context (bucket, batch size, cache disposition…)
        to the trace — the flight recorder's "why was this slow" fields."""
        with self._lock:
            self.meta.update(kv)

    def finish(self, status: Optional[int] = None) -> None:
        wall = time.perf_counter() - self._t0
        with self._lock:
            self.wall_s = wall
            self.status = status
            # the explicit remainder: stage sum ≡ wall by construction, so
            # a reader never wonders whether missing time means missing
            # instrumentation or missing truth
            covered = sum(self.stages.values())
            self.stages["other"] = max(0.0, wall - covered)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "requestId": self.request_id,
                "name": self.name,
                "startUnix": round(self.start_unix, 6),
                "wallMs": (
                    None if self.wall_s is None
                    else round(self.wall_s * 1e3, 4)
                ),
                "status": self.status,
                "stagesMs": {
                    k: round(v * 1e3, 4) for k, v in self.stages.items()
                },
                **({"meta": dict(self.meta)} if self.meta else {}),
            }


# -- active-trace propagation (thread-local) ---------------------------------

_active = threading.local()


def active_traces() -> Sequence[Trace]:
    return getattr(_active, "traces", ())


@contextlib.contextmanager
def scope(traces: Sequence[Optional[Trace]]):
    """Install traces as this thread's active set for the duration.

    The HTTP thread scopes its single request trace around dispatch; the
    micro-batcher worker scopes the whole batch's traces around execute.
    """
    prev = getattr(_active, "traces", ())
    _active.traces = tuple(t for t in traces if t is not None)
    try:
        yield
    finally:
        _active.traces = prev


@contextlib.contextmanager
def stage(name: str):
    """Charge the enclosed wall time to ``name`` on every active trace.

    The no-trace case is two attribute lookups — cheap enough to leave in
    hot loops permanently.
    """
    traces = getattr(_active, "traces", ())
    if not traces:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        for t in traces:
            t.add_stage(name, dt)


def add_stage(name: str, seconds: float) -> None:
    """Charge an externally-measured duration to every active trace."""
    for t in getattr(_active, "traces", ()):
        t.add_stage(name, seconds)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Head sampler + bounded ring of finished traces + flight recorder.

    The flight recorder is TAIL-based: after a sampled trace finishes,
    its wall time is compared against a rolling quantile
    (``PIO_SLOW_TRACE_QUANTILE``) of recent walls, and outliers are
    retained — with their full stage breakdown and meta — in a second
    bounded ring (``PIO_SLOW_TRACE_RING``) served at
    ``GET /trace/slow.json``.  The p99 is explained, not just counted.
    """

    def __init__(
        self,
        sample_rate: Optional[float] = None,
        ring_size: Optional[int] = None,
        slow_quantile: Optional[float] = None,
        slow_ring_size: Optional[int] = None,
    ):
        if sample_rate is None:
            sample_rate = float(
                os.environ.get("PIO_TRACE_SAMPLE", DEFAULT_SAMPLE_RATE)
            )
        if ring_size is None:
            ring_size = int(
                os.environ.get("PIO_TRACE_RING", DEFAULT_RING_SIZE)
            )
        if slow_quantile is None:
            slow_quantile = float(
                os.environ.get(
                    "PIO_SLOW_TRACE_QUANTILE", DEFAULT_SLOW_QUANTILE
                )
            )
        if slow_ring_size is None:
            slow_ring_size = int(
                os.environ.get(
                    "PIO_SLOW_TRACE_RING", DEFAULT_SLOW_RING_SIZE
                )
            )
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.ring_max = max(1, int(ring_size))
        self.ring: deque = deque(maxlen=self.ring_max)
        self.seen = 0
        self.sampled = 0
        self._acc = 0.0
        self._lock = threading.Lock()
        # flight recorder state (slow_quantile <= 0 disables retention)
        self.slow_quantile = min(1.0, float(slow_quantile))
        self.slow_ring_max = max(1, int(slow_ring_size))
        self.slow_ring: deque = deque(maxlen=self.slow_ring_max)
        self.slow_retained = 0
        self._walls: deque = deque(maxlen=_SLOW_RESERVOIR)
        self._slow_threshold: Optional[float] = None
        self._since_recompute = 0

    def begin(
        self,
        request_id: Optional[str] = None,
        name: str = "",
    ) -> Optional[Trace]:
        """Head-sampling decision; returns a live Trace or None.

        An explicit ``request_id`` (the header arrived) always samples —
        upstream made the decision and cross-service stitching needs the
        downstream half.  Otherwise a deterministic every-Nth accumulator
        admits ``sample_rate`` of traffic with zero RNG cost.
        """
        with self._lock:
            self.seen += 1
            if request_id is None:
                self._acc += self.sample_rate
                if self._acc < 1.0:
                    return None
                self._acc -= 1.0
            self.sampled += 1
        return Trace(request_id or new_request_id(), name=name)

    def record(self, trace: Trace) -> None:
        self.ring.append(trace)  # deque append is atomic
        wall = trace.wall_s
        if wall is None or self.slow_quantile <= 0.0:
            return
        with self._lock:
            # threshold from the reservoir BEFORE admitting this wall, so
            # a request is never judged against a sample that includes it
            thr = self._slow_threshold
            retain = (
                thr is not None
                and len(self._walls) >= _SLOW_MIN_SAMPLES
                and wall > thr
            )
            self._walls.append(wall)
            self._since_recompute += 1
            if (
                self._slow_threshold is None
                or self._since_recompute >= _SLOW_RECOMPUTE
            ):
                self._since_recompute = 0
                ordered = sorted(self._walls)
                i = min(
                    len(ordered) - 1,
                    int(self.slow_quantile * len(ordered)),
                )
                self._slow_threshold = ordered[i]
            if retain:
                self.slow_retained += 1
                self.slow_ring.append(trace)

    def slow_threshold_s(self) -> Optional[float]:
        """Current rolling-quantile wall threshold (None until warmed)."""
        with self._lock:
            if len(self._walls) < _SLOW_MIN_SAMPLES:
                return None
            return self._slow_threshold

    def recent(self, limit: Optional[int] = None) -> list:
        traces = list(self.ring)
        if limit:
            traces = traces[-limit:]
        return [t.to_dict() for t in reversed(traces)]

    def slow_recent(self, limit: Optional[int] = None) -> list:
        """Retained slow-request exemplars, newest first."""
        traces = list(self.slow_ring)
        if limit:
            traces = traces[-limit:]
        return [t.to_dict() for t in reversed(traces)]
