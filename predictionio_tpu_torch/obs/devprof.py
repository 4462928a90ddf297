"""Device-utilization accounting for serving: cost models, peaks, live rates.

Counterpart of ``predictionio_tpu/obs/devprof.py``'s serving half:

* **One cost model, one peak table.** :func:`score_cost` and
  :func:`fused_score_cost` give the analytic (FLOPs, bytes) of one
  bucketed score+top-k dispatch; :data:`PEAKS` holds the cards' peaks.
* **Rolling-window dispatch accountant** (:class:`DeviceUtilization`).
  The serving fast path annotates every rung with its analytic cost and
  records each dispatch's device time here (a pair of CUDA events around
  the launch on the card); :meth:`DeviceUtilization.snapshot` reduces the
  window into achieved FLOP/s, memory GB/s, utilization against the peak,
  and the device's busy share — the live ``pio_device_*`` gauge families.

The training recorder (``train_recorder``/``train_snapshot``) comes with the
training kernel's bridge, and ``capture_profile`` (``POST /debug/profile``,
``pio profile``) with ROADMAP §1 item 15.

Knobs: ``PIO_DEVPROF_WINDOW`` — rolling-window length in seconds for the
live gauges (default 60).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "PEAKS",
    "peak_for",
    "platform_for",
    "score_cost",
    "fused_score_cost",
    "DeviceUtilization",
]

# Per-card peaks for utilization accounting, from the public spec sheets:
# the dense bf16 tensor-core rate and the memory bandwidth. Utilization is
# defined against the bf16 peak — the number the hardware markets — so a
# 10× regression is visible whatever dtype serves. The H100's two forms
# differ: SXM (the "H100 80GB HBM3") 989 TFLOP/s and 3.35 TB/s, PCIe 756
# TFLOP/s and 2.0 TB/s. The CPU row is an order-of-magnitude stand-in for a
# server socket (~1 TFLOP/s f32 SIMD, ~100 GB/s DRAM): good for ratios
# run over run on one host, not for publishing. A card not listed reports
# null utilization. ``hbm_gbps`` is in bytes per second.
PEAKS = {
    "cpu": {"flops": 1e12, "hbm_gbps": 100e9},
    "h100-sxm": {"flops": 989e12, "hbm_gbps": 3.35e12},
    "h100-pcie": {"flops": 756e12, "hbm_gbps": 2.0e12},
}

DEFAULT_WINDOW_S = 60.0


def peak_for(platform: Optional[str]) -> Optional[dict]:
    """Per-card peak {flops, hbm_gbps} for a platform name, or None."""
    if platform is None:
        return None
    return PEAKS.get(str(platform).lower())


def platform_for(device) -> str:
    """The :data:`PEAKS` row of a torch device: ``"cpu"``, ``"h100-sxm"``,
    ``"h100-pcie"``, or the card's own name (no row: null utilization)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    if "H100" in name and "HBM3" in name:
        return "h100-sxm"
    if "H100" in name and "PCIe" in name:
        return "h100-pcie"
    return name


# bytes per factor element by serving dtype (mirrors ops/quantize.py;
# duplicated here so the obs layer never imports the ops layer)
_FACTOR_BYTES = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}


def score_cost(
    batch: int, n_items: int, rank: int, dtype: str = "f32"
) -> tuple[float, float]:
    """Analytic (FLOPs, bytes) of one score+top-k dispatch that writes its
    score matrix out (the plain version's path).

    The (B, k) × (k, I) score matmul dominates FLOPs (plus ~8 ops/score for
    masking and the top-k compares); bytes are the factor reads, the
    materialized score matrix round-trip, and the (B, k) result write.
    """
    b, i, k = float(batch), float(n_items), float(rank)
    s = _FACTOR_BYTES.get(dtype, 4.0)
    flops = b * i * (2.0 * k + 8.0)
    # quantized reference still materializes the dequantized f32 copy and
    # the f32 score matrix; only the factor stream itself narrows
    nbytes = i * k * s + b * k * s + 2.0 * b * i * 4.0 + b * k * 8.0
    return flops, nbytes


def fused_score_cost(
    batch: int, n_items: int, rank: int, top_k: int, dtype: str = "f32"
) -> tuple[float, float]:
    """Analytic (FLOPs, bytes) of one FUSED score+top-k dispatch.

    The kernel (``csrc/score_topk.cu``) keeps its scores on chip, so the
    plain model's ``2·B·I·4`` round trip disappears: bytes are the one-pass
    factor stream (at the storage dtype), the B gathered user rows, the
    int8 per-row scales when present, the mask stream, and the (B, k)
    result write. FLOPs match :func:`score_cost`.
    """
    b, i, r, k = float(batch), float(n_items), float(rank), float(top_k)
    s = _FACTOR_BYTES.get(dtype, 4.0)
    flops = b * i * (2.0 * r + 8.0)
    nbytes = i * r * s + b * r * s  # item stream + gathered user rows
    if dtype == "int8":
        nbytes += (i + b) * 4.0  # per-row f32 scales
    nbytes += i * 1.0  # exclusion-mask stream
    nbytes += b * 4.0 + b * k * 8.0  # index upload + (vals, idx) readback
    return flops, nbytes


class DeviceUtilization:
    """Rolling-window accountant for cost-annotated device dispatches.

    The owner annotates each dispatch class (serving rung) with its
    FLOPs/bytes once via :meth:`set_cost`, then calls :meth:`record` with
    the measured device time per dispatch. Records older than the window
    age out; :meth:`snapshot` reduces what's left into achieved rates and
    utilization against the platform peak. All methods are thread-safe;
    ``record`` is O(1) amortized.
    """

    def __init__(
        self,
        platform: Optional[str] = None,
        window_s: Optional[float] = None,
    ):
        if window_s is None:
            window_s = float(
                os.environ.get("PIO_DEVPROF_WINDOW", DEFAULT_WINDOW_S)
            )
        self.window_s = max(1.0, float(window_s))
        self.platform = platform
        self._costs: dict = {}  # dispatch key → (flops, bytes)
        self._cost_source: dict = {}  # dispatch key → "analytic" | ...
        # (t_recorded, device_seconds, flops, bytes) per dispatch
        self._records: deque = deque()
        self._lock = threading.Lock()
        self._t_created = time.monotonic()
        self.dispatches = 0  # lifetime, never pruned

    def set_cost(
        self, key, flops: Optional[float], nbytes: Optional[float],
        source: str = "analytic",
    ) -> None:
        """Annotate dispatch class ``key`` with per-dispatch FLOPs/bytes."""
        with self._lock:
            self._costs[key] = (
                float(flops) if flops else 0.0,
                float(nbytes) if nbytes else 0.0,
            )
            self._cost_source[key] = source

    def costs(self) -> dict:
        with self._lock:
            return {
                k: {
                    "flops": f, "bytes": by,
                    "source": self._cost_source.get(k),
                }
                for k, (f, by) in self._costs.items()
            }

    def record(self, key, seconds: float) -> None:
        """Charge one dispatch of class ``key`` with measured device time."""
        if seconds < 0:
            seconds = 0.0
        now = time.monotonic()
        with self._lock:
            flops, nbytes = self._costs.get(key, (0.0, 0.0))
            self._records.append((now, float(seconds), flops, nbytes))
            self.dispatches += 1
            self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._records and self._records[0][0] < cutoff:
            self._records.popleft()

    def snapshot(self) -> Optional[dict]:
        """Windowed rates + utilization; None before the first dispatch.

        ``busy_fraction`` (and the rates) divide by the OBSERVED span —
        window length once the accountant has lived that long, its age
        before that — so a freshly warmed server reports its true duty
        cycle instead of a number diluted by a mostly-empty window.
        """
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            if not self.dispatches:
                return None
            elapsed = min(self.window_s, max(1e-9, now - self._t_created))
            busy = sum(r[1] for r in self._records)
            flops = sum(r[2] for r in self._records)
            nbytes = sum(r[3] for r in self._records)
            n = len(self._records)
        flops_per_s = flops / elapsed
        gbps = nbytes / elapsed
        peak = peak_for(self.platform)
        return {
            "platform": self.platform,
            "window_s": self.window_s,
            "elapsed_s": round(elapsed, 3),
            "dispatches_window": n,
            "dispatches_total": self.dispatches,
            "busy_s": round(busy, 6),
            "busy_fraction": round(min(1.0, busy / elapsed), 6),
            "flops_per_s": round(flops_per_s, 2),
            # 6 decimals: a rank-2 toy model on CPU still reads non-zero
            "hbm_gbps": round(gbps / 1e9, 6),
            "mfu": round(flops_per_s / peak["flops"], 9) if peak else None,
            "hbm_util": round(gbps / peak["hbm_gbps"], 9) if peak else None,
        }
