"""Serving stage timing and latency histograms.

Counterpart of ``predictionio_tpu/utils/profiling.py``:

* :func:`trace` with ``stage=`` charges the enclosed wall time to that
  stage on every active obs trace (:mod:`predictionio_tpu_torch.obs.tracing`)
  — the serving pipeline's device-compute hook.
* :class:`LatencyHistogram` — log-bucketed latency histogram with
  p50/p90/p99 readout, used by the query server per request.

The JAX module's device-trace capture (``log_dir`` / ``PIO_PROFILE_DIR``,
around ``jax.profiler``) is the ``pio profile`` tool of ROADMAP §1 item 15
(it would run on ``torch.profiler``); asking for it raises naming that item.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional

import numpy as np


def _profile_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "device-trace capture (log_dir / PIO_PROFILE_DIR) is not ported to "
        "predictionio_tpu_torch yet (ROADMAP §1 item 15)"
    )


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, stage: Optional[str] = None):
    """Charge the block's wall time to ``stage`` on the active traces.

    Without ``stage`` and without a profile directory this is a no-op; a
    profile directory (``log_dir``, or ``PIO_PROFILE_DIR`` when no stage is
    given) raises: capture is ROADMAP §1 item 15.
    """
    if log_dir or (stage is None and os.environ.get("PIO_PROFILE_DIR")):
        raise _profile_not_ported()
    if stage is None:
        yield
        return
    from predictionio_tpu_torch.obs import tracing as _obs_tracing

    with _obs_tracing.stage(stage):
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
