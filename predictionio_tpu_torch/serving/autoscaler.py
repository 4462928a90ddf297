"""Signal-driven fleet autoscaler: elastic replica counts under SLO.

Counterpart of ``predictionio_tpu/serving/autoscaler.py``: the same
signals, thresholds and ``PIO_AUTOSCALE*`` knobs, so the same signals on
the same clock give the same decisions. A fleet of fixed N wastes the card
at night and sheds at peak (Cloudburst's serverless prediction-serving
result is the reference pattern).  This control loop sizes the
supervised replica set from the ROUTER's own signals — no external
metrics plane:

* **inflight utilization** — total in-flight forwards over the admitted
  fleet's concurrency capacity (``PIO_FLEET_REPLICA_MAX_INFLIGHT`` ×
  admitted replicas);
* **shed rate** — 503s per routed request since the last tick (the
  router only sheds when admission is exhausted);
* **hedge rate** — hedges fired per request (tail latency pain the
  breakers and health gate cannot see);
* **device busy fraction** — the max ``pio_device_busy_fraction``
  scraped from each admitted replica's ``/metrics`` (the device-time
  accountant), so a compute-bound fleet scales before it sheds.

Each signal normalizes to [0, 1]; the composite **pressure** is their
max.  Decisions carry hysteresis (separate up/down thresholds), a
consecutive-low-tick requirement plus cooldowns against flapping, and
hard min/max bounds.  Scale-up spawns one replica through the
supervisor and registers it EJECTED at the router, so admission rides
the existing health gate + 10%→100% slow start — a cold process never
absorbs a full traffic share.  Scale-down reuses the roll machinery's
drain-before-kill: router DRAINING → ``POST /stop`` → reap.

The loop itself (``_control_loop``) paces on the stop Event and
delegates all I/O to ``_safe_tick``.  ``tick(now=...)`` is the deterministic core: tests
drive it with a simulated clock and stubbed signals, no threads.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import urllib.request
from typing import Optional

logger = logging.getLogger(__name__)


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError, TypeError):
        return default


class Autoscaler:
    """Router-signal control loop sizing a :class:`FleetSupervisor`."""

    def __init__(self, router, fleet):
        self.router = router
        self.fleet = fleet
        # knobs, with the JAX package's defaults
        self.interval_ms = _env_num("PIO_AUTOSCALE_INTERVAL_MS", 1000.0, float)
        self.min_replicas = _env_num("PIO_AUTOSCALE_MIN_REPLICAS", 1, int)
        self.max_replicas = _env_num("PIO_AUTOSCALE_MAX_REPLICAS", 8, int)
        self.up_threshold = _env_num("PIO_AUTOSCALE_UP_THRESHOLD", 0.7, float)
        self.down_threshold = _env_num(
            "PIO_AUTOSCALE_DOWN_THRESHOLD", 0.25, float
        )
        self.up_cooldown_s = _env_num("PIO_AUTOSCALE_UP_COOLDOWN_S", 5.0, float)
        self.down_cooldown_s = _env_num(
            "PIO_AUTOSCALE_DOWN_COOLDOWN_S", 30.0, float
        )
        self.down_after = _env_num("PIO_AUTOSCALE_DOWN_AFTER", 5, int)
        self.shed_ref = _env_num("PIO_AUTOSCALE_SHED_REF", 0.05, float)
        self.hedge_ref = _env_num("PIO_AUTOSCALE_HEDGE_REF", 0.5, float)
        self.busy_enabled = _env_num("PIO_AUTOSCALE_BUSY", 1, int) != 0
        self.scrape_timeout_s = 1.0

        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_counters: Optional[dict] = None
        self._no_up_before = 0.0
        self._no_down_before = 0.0
        self._low_streak = 0
        self._ups = 0
        self._downs = 0
        self._last_pressure = 0.0
        self._last_signals: dict = {}
        self._last_decision = "hold"
        self._last_n = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._control_loop, name="autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()

    def _control_loop(self):
        interval_s = self.interval_ms / 1e3
        while not self._stop_evt.wait(interval_s):
            self._safe_tick()

    def _safe_tick(self) -> None:
        try:
            self.tick()
        except Exception:
            logger.exception("autoscaler tick failed")

    # -- signals -------------------------------------------------------------
    def _busy_fraction(self, urls: list[str]) -> float:
        """Max ``pio_device_busy_fraction`` across admitted replicas.
        A replica without telemetry (404) or mid-restart contributes 0 —
        pressure from missing data must never spawn processes."""
        from predictionio_tpu_torch.obs.metrics import parse_prometheus

        best = 0.0
        for url in urls:
            try:
                with urllib.request.urlopen(
                    url + "/metrics", timeout=self.scrape_timeout_s
                ) as r:
                    series = parse_prometheus(
                        r.read().decode("utf-8", "replace")
                    )
            except Exception:
                continue
            for (name, _labels), v in series.items():
                if name == "pio_device_busy_fraction":
                    best = max(best, float(v))
        return best

    def _signals(self) -> dict:
        """Normalized [0, 1] pressure per signal since the last tick."""
        sig = self.router.signals()
        snap = sig["counters"]
        with self._lock:
            prev = (
                self._prev_counters
                if self._prev_counters is not None else snap
            )
            self._prev_counters = snap
        req_delta = sum(
            snap.get(k, 0) - prev.get(k, 0)
            for k in ("ok", "client_error", "failed", "shed", "deadline")
        )
        shed_rate = (
            (snap.get("shed", 0) - prev.get("shed", 0))
            / max(1.0, float(req_delta))
        )
        hedge_rate = (
            (snap.get("hedges_fired", 0) - prev.get("hedges_fired", 0))
            / max(1.0, float(req_delta))
        )
        admitted = max(1, sig["admitted"])
        capacity = float(max(1, sig["replicaMaxInflight"]) * admitted)
        busy = (
            self._busy_fraction(sig["admittedUrls"])
            if self.busy_enabled
            else 0.0
        )
        signals = {
            "inflight": round(min(1.0, sig["inflight"] / capacity), 4),
            "shed": round(
                min(1.0, shed_rate / self.shed_ref)
                if self.shed_ref > 0 else 0.0, 4,
            ),
            "hedge": round(
                min(1.0, hedge_rate / self.hedge_ref)
                if self.hedge_ref > 0 else 0.0, 4,
            ),
            "busy": round(min(1.0, busy), 4),
        }
        if "tenantPressure" in sig:
            # hottest tenant's inflight saturation against its fair-share
            # cap (multi-tenant router).  Quota sheds are deliberately NOT
            # in this signal: a tenant over its paid quota must be shed,
            # not have the fleet scaled up for it.
            signals["tenant"] = round(
                min(1.0, float(sig["tenantPressure"])), 4
            )
        return {
            "rolling": bool(sig.get("rolling")),
            "signals": signals,
        }

    # -- the control decision ------------------------------------------------
    def tick(self, now: Optional[float] = None) -> str:
        """One control decision: gather signals, compare against the
        hysteresis band, act through the supervisor.  Deterministic given
        ``now`` and the router/fleet state — the unit tests drive this
        directly with a simulated clock."""
        now = time.monotonic() if now is None else now
        view = self._signals()
        signals = view["signals"]
        pressure = max(signals.values())
        n = len(self.fleet.status()["replicas"])
        action = "hold"
        with self._lock:
            if view["rolling"]:
                # never fight a roll: its drains look exactly like load
                # that should scale, and its restarts must not race a
                # scale-down
                pass
            elif n < self.min_replicas:
                action = "up"
            elif (
                pressure >= self.up_threshold
                and n < self.max_replicas
                and now >= self._no_up_before
            ):
                action = "up"
            elif pressure <= self.down_threshold and n > self.min_replicas:
                self._low_streak += 1
                if self._low_streak >= self.down_after \
                        and now >= self._no_down_before:
                    action = "down"
            else:
                self._low_streak = 0
        # the fleet calls spawn/drain processes — keep them outside the
        # lock so stats() readers never block on a slow drain
        decision = "hold"
        if action == "up":
            decision = self._scale_up(now)
        elif action == "down":
            decision = self._scale_down(now)
        with self._lock:
            self._last_pressure = round(pressure, 4)
            self._last_signals = signals
            self._last_decision = decision
            self._last_n = len(self.fleet.status()["replicas"])
        return decision

    def _scale_up(self, now: float) -> str:
        added = self.fleet.add_replica()
        if added is None:
            return "hold"
        with self._lock:
            self._ups += 1
            self._low_streak = 0
            self._no_up_before = now + self.up_cooldown_s
            # a fresh replica is cold: suppress scale-down until it has
            # had a chance to absorb its share, or flapping traffic
            # thrashes spawns
            self._no_down_before = max(
                self._no_down_before, now + self.down_cooldown_s
            )
        logger.info("autoscaler: scaled up (+%s)", added.get("url"))
        return "up"

    def _scale_down(self, now: float) -> str:
        removed = self.fleet.remove_replica()
        if removed is None:
            return "hold"
        with self._lock:
            self._downs += 1
            self._low_streak = 0
            self._no_down_before = now + self.down_cooldown_s
        logger.info("autoscaler: scaled down (-%s)", removed.get("url"))
        return "down"

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "minReplicas": self.min_replicas,
                "maxReplicas": self.max_replicas,
                "replicas": self._last_n,
                "pressure": self._last_pressure,
                "signals": dict(self._last_signals),
                "lastDecision": self._last_decision,
                "scaleUps": self._ups,
                "scaleDowns": self._downs,
                "lowStreak": self._low_streak,
                "upThreshold": self.up_threshold,
                "downThreshold": self.down_threshold,
            }
