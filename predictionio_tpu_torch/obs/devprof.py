"""Device-utilization accounting: cost models, peaks, live rates, capture.

Counterpart of ``predictionio_tpu/obs/devprof.py``:

* **One cost model, one peak table.** :func:`score_cost` and
  :func:`fused_score_cost` give the analytic (FLOPs, bytes) of one
  bucketed score+top-k dispatch; :data:`PEAKS` holds the cards' peaks.
* **Rolling-window dispatch accountant** (:class:`DeviceUtilization`).
  The serving fast path annotates every rung with its analytic cost and
  records each dispatch's device time here (a pair of CUDA events around
  the launch on the card); :meth:`DeviceUtilization.snapshot` reduces the
  window into achieved FLOP/s, memory GB/s, utilization against the peak,
  and the device's busy share — the live ``pio_device_*`` gauge families.

* **Training cost models.** :func:`als_train_cost` and
  :func:`train_utilization` are the JAX package's, definition for
  definition. :func:`als_train_cost_amplified` charges the card's own
  gather sector (:data:`SECTOR_BYTES`, 32 B), and :func:`fused_train_cost`
  counts what kernel 2 (``csrc/train_normal_eq.cu``) must move as written,
  the bytes ``chip_smoke.py``'s ``train_bound`` counts.
* **Training recorder** (:func:`train_recorder`, :func:`train_snapshot`):
  ``pio train`` has no server to scrape, so ``models/als.py`` records each
  iteration's device time (CUDA events on the card) into a process-global
  accountant.
* **On-demand profile capture** (:func:`capture_profile`): a bounded
  ``torch.profiler`` window (CPU and CUDA activities) written as a Chrome
  trace under the basedir, driven by the query server's ``POST
  /debug/profile`` and ``pio profile``.

Knobs: ``PIO_DEVPROF_WINDOW`` — rolling-window length in seconds for the
live gauges (default 60).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "PEAKS",
    "peak_for",
    "platform_for",
    "default_platform",
    "als_train_cost",
    "als_train_cost_amplified",
    "fused_train_cost",
    "fused_train_vread_bytes",
    "train_utilization",
    "score_cost",
    "fused_score_cost",
    "DeviceUtilization",
    "train_recorder",
    "train_snapshot",
    "capture_profile",
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


def default_platform() -> Optional[str]:
    """The :data:`PEAKS` row of the default device: the first CUDA card's
    (:func:`platform_for`), else ``"cpu"``; None when torch cannot say."""
    try:
        import torch

        return platform_for("cuda:0" if torch.cuda.is_available() else "cpu")
    except Exception:
        return None


def als_train_cost(
    n_ratings: int, n_users: int, n_items: int, rank: int, dtype: str = "f32"
) -> tuple[float, float]:
    """Analytic (FLOPs, bytes) of ONE dense-solver ALS iteration, the JAX
    package's definition.

    FLOPs: per rating 2·(2k² + 4k) madds (outer product + rhs accumulate,
    both sides) + per entity 2·(k³/3) Cholesky factor+solve madds.
    Bytes: per rating, both sides: k·s gather read + 12 B of idx/rat/msk;
    per entity k·4 factor write + opposite-factor read once per half-step.
    A model, not a measurement.
    """
    k = rank
    s = 2 if dtype == "bf16" else 4  # bytes per factor element
    ents = n_users + n_items
    flops_per_iter = n_ratings * 2 * (2 * k * k + 4 * k) * 2 + ents * (
        2 * k**3 / 3
    )
    bytes_per_iter = (
        n_ratings * 2 * (k * s + 12)  # gather + idx/rat/msk streams
        + ents * k * (4 + s)  # factor write (f32) + opposite read
    )
    return float(flops_per_iter), float(bytes_per_iter)


def train_utilization(
    n_ratings, n_users, n_items, rank, iterations, dtype, dt, n_chips,
    platform,
) -> dict:
    """Analytic achieved FLOP/s + memory GB/s from workload dims and wall
    time: the cost model is :func:`als_train_cost`, the denominators
    :data:`PEAKS`."""
    flops_per_iter, bytes_per_iter = als_train_cost(
        n_ratings, n_users, n_items, rank, dtype
    )
    flops = flops_per_iter * iterations / dt / n_chips
    gbps = bytes_per_iter * iterations / dt / n_chips
    peak = peak_for(platform)
    return {
        "model_flops_per_sec_per_chip": round(flops / 1e9, 2),  # GFLOP/s
        "model_hbm_gbps_per_chip": round(gbps / 1e9, 2),
        "mfu": round(flops / peak["flops"], 6) if peak else None,
        "hbm_util": round(gbps / peak["hbm_gbps"], 6) if peak else None,
    }


# bytes per factor element by serving dtype (mirrors ops/quantize.py;
# duplicated here so the obs layer never imports the ops layer)
_FACTOR_BYTES = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}

# The H100's global-memory sector: a load reads whole 32-byte sectors, so a
# gathered factor row of k·s bytes costs ceil(k·s / 32) of them.
SECTOR_BYTES = 32.0


def als_train_cost_amplified(
    n_ratings: int, n_users: int, n_items: int, rank: int, dtype: str = "f32"
) -> tuple[float, float]:
    """:func:`als_train_cost` with the gather term a row gather pays on the
    card: each gathered row reads whole sectors (:data:`SECTOR_BYTES`), 64 B
    for a rank-10 f32 row of 40 B. The plain version's gather
    (``index_select`` of the opposite rows, then the products) is what this
    models."""
    k = rank
    s = _FACTOR_BYTES.get(dtype, 4.0)
    flops, _ = als_train_cost(n_ratings, n_users, n_items, rank, dtype)
    ents = n_users + n_items
    row = math.ceil(k * s / SECTOR_BYTES) * SECTOR_BYTES
    nbytes = (
        n_ratings * 2 * (row + 12)  # sector reads + idx/rat/msk streams
        + ents * k * (4 + s)  # factor write (f32) + opposite read
    )
    return float(flops), float(nbytes)


def fused_train_vread_bytes(
    n_users: int, n_items: int, rank: int, compute_dtype: str = "f32"
) -> float:
    """Bytes of kernel 2's opposite-factor read over one iteration (both
    half-steps), each side's opposite matrix once at the compute dtype plus
    the per-row f32 scale column when int8. Kernel 2 reads a slot's row from
    global memory each time the slot comes up; the opposite matrix (6.5 MB
    for ML-25M's users at rank 10, f32) sits in the card's 50 MB L2, so the
    memory reads it once, as ``chip_smoke.py``'s ``train_bound`` counts."""
    s = _FACTOR_BYTES.get(compute_dtype, 4.0)
    ents = float(n_users + n_items)
    nbytes = ents * rank * s
    if compute_dtype == "int8":
        nbytes += ents * 4.0
    return nbytes


def fused_train_cost(
    n_ratings: int, n_users: int, n_items: int, rank: int,
    compute_dtype: str = "f32", slots: Optional[int] = None,
    rows: Optional[int] = None,
) -> tuple[float, float]:
    """Analytic (FLOPs, bytes) of ONE ALS iteration through kernel 2.

    Bytes are what ``chip_smoke.py``'s ``train_bound`` counts for the two
    half-steps, so the live gauge and the bound agree:

    * 12 B of idx/rat/msk a slot (``slots``: the buckets' padded n_b·D of
      both sides; 2·n_ratings when not given);
    * the opposite matrices once (:func:`fused_train_vread_bytes`);
    * A (k²), b (k) and cnt (1) written in f32 for each bucket row
      (``rows``: both sides' bucket rows; n_users + n_items when not given).

    FLOPs are :func:`als_train_cost`'s (the same contraction and Cholesky).
    """
    k = rank
    flops, _ = als_train_cost(n_ratings, n_users, n_items, rank)
    slots = 2 * n_ratings if slots is None else slots
    rows = n_users + n_items if rows is None else rows
    nbytes = (
        float(slots) * 12.0  # idx/rat/msk streams, both sides
        + fused_train_vread_bytes(n_users, n_items, rank, compute_dtype)
        + float(rows) * (k * k + k + 1) * 4.0  # A, b and cnt written
    )
    return float(flops), float(nbytes)


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


# -- train-side recorder ------------------------------------------------------
# `pio train` has no HTTP server to scrape, so the train loop records into
# a process-global accountant; the CLI and tests read the snapshot, and the
# loop logs a utilization line per iteration so a long train is visible live.

_train_lock = threading.Lock()
_train_acc: Optional[DeviceUtilization] = None


def train_recorder(platform: Optional[str] = None) -> DeviceUtilization:
    """The process-global training accountant (created on first use, and
    anew when ``platform`` names another row)."""
    global _train_acc
    with _train_lock:
        if _train_acc is None or (
            platform is not None and _train_acc.platform != platform
        ):
            _train_acc = DeviceUtilization(platform=platform)
        return _train_acc


def train_snapshot() -> Optional[dict]:
    with _train_lock:
        acc = _train_acc
    return acc.snapshot() if acc is not None else None


# -- on-demand profile capture ------------------------------------------------


def capture_profile(ms: int, out_dir: Optional[str] = None) -> str:
    """Run ``torch.profiler`` for a bounded window; return the directory of
    its Chrome trace (``trace.json``).

    Blocks the calling thread for ``ms`` milliseconds while the rest of the
    process keeps serving — exactly what the query server's ``POST
    /debug/profile`` wants. The profiler is process-global: one capture at
    a time (``utils/profiling.profiled``). Traces land under
    ``<basedir>/profiles/<stamp>-<pid>`` unless ``out_dir`` overrides.
    Kernel 1 launches through ``ctypes``, not as a torch op: its device
    events come from CUPTI, which sees the whole process; host-side op
    events come from the threads the profiler follows.
    """
    from predictionio_tpu_torch.utils.fs import pio_base_dir
    from predictionio_tpu_torch.utils.profiling import profiled

    ms = max(1, int(ms))
    if out_dir is None:
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        out_dir = os.path.join(
            pio_base_dir(), "profiles", f"{stamp}-{os.getpid()}"
        )
    with profiled(os.path.join(out_dir, "trace.json")):
        time.sleep(ms / 1e3)
    return out_dir
