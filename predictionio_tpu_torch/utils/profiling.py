"""Device traces, serving stage timing and latency histograms.

Counterpart of ``predictionio_tpu/utils/profiling.py``:

* :func:`trace` — context manager around ``torch.profiler`` (CPU and, with
  a card, CUDA activities, every thread of the process) writing a Chrome
  trace of the block (set ``PIO_PROFILE_DIR`` or pass ``log_dir``; no-op
  otherwise). With ``stage=`` it charges the enclosed wall time to that
  stage on every active obs trace (:mod:`predictionio_tpu_torch.obs.tracing`)
  — the serving pipeline's device-compute hook.
* :func:`profiled` — the capture both use, ``obs/devprof.capture_profile``
  too: the profiler is process-global, so captures take turns.
* :class:`LatencyHistogram` — log-bucketed latency histogram with
  p50/p90/p99 readout, used by the query server per request.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from typing import Optional

import numpy as np

_profile_lock = threading.Lock()


@contextlib.contextmanager
def profiled(path: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``path`` (its directory is made). CPU activity always, CUDA activity
    when a card is there; every thread of the process where this torch
    offers it (``profile_all_threads``), since the batcher's worker and not
    the caller launches the kernels. One capture at a time in a process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    with _profile_lock:
        with profile(activities=activities, **extra) as prof:
            yield
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                # the block's kernels finish inside the window
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)


_trace_seq = itertools.count()


def _trace_path(log_dir: str) -> str:
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    return os.path.join(log_dir, f"{stamp}-{os.getpid()}-{next(_trace_seq)}.pt.trace.json")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, stage: Optional[str] = None):
    """Capture a device trace if a profile dir is configured; else no-op.

    With ``stage=`` this doubles as the serving pipeline's device-compute
    hook: the enclosed wall time is charged to that stage on every active
    obs trace (:mod:`predictionio_tpu_torch.obs.tracing`). Stage mode does
    NOT consult ``PIO_PROFILE_DIR`` — it runs once per micro-batch, and
    starting and stopping the profiler at that cadence would trash the
    trace it exists to produce; pass ``log_dir`` explicitly to combine both.
    The trace is ``<log_dir>/<stamp>-<pid>-<n>.pt.trace.json``.
    """
    if stage is not None:
        from predictionio_tpu_torch.obs import tracing as _obs_tracing

        if log_dir:
            with profiled(_trace_path(log_dir)):
                with _obs_tracing.stage(stage):
                    yield
            return
        with _obs_tracing.stage(stage):
            yield
        return
    log_dir = log_dir or os.environ.get("PIO_PROFILE_DIR")
    if not log_dir:
        yield
        return
    with profiled(_trace_path(log_dir)):
        yield


class LatencyHistogram:
    """Log₂-bucketed histogram from 0.01 ms to ~100 s."""

    MIN_MS = 0.01
    N_BUCKETS = 48

    def __init__(self):
        self._counts = np.zeros(self.N_BUCKETS, np.int64)
        self._lock = threading.Lock()
        self.total = 0

    def _bucket(self, ms: float) -> int:
        if ms <= self.MIN_MS:
            return 0
        b = int(math.log2(ms / self.MIN_MS) * 2)  # half-octave buckets
        return min(max(b, 0), self.N_BUCKETS - 1)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._counts[self._bucket(seconds * 1e3)] += 1
            self.total += 1

    def _bucket_upper_ms(self, b: int) -> float:
        return self.MIN_MS * 2 ** ((b + 1) / 2)

    def quantile(self, q: float) -> float:
        """Approximate quantile in milliseconds (bucket upper bound)."""
        with self._lock:
            if self.total == 0:
                return 0.0
            target = q * self.total
            acc = 0
            for b in range(self.N_BUCKETS):
                acc += self._counts[b]
                if acc >= target:
                    return self._bucket_upper_ms(b)
        return self._bucket_upper_ms(self.N_BUCKETS - 1)

    def summary(self) -> dict:
        return {
            "count": self.total,
            "p50Ms": self.quantile(0.50),
            "p90Ms": self.quantile(0.90),
            "p99Ms": self.quantile(0.99),
        }
