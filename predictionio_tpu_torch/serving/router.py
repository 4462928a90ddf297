"""Replica-fault-tolerant routing front-end for a query-server fleet.

Counterpart of ``predictionio_tpu/serving/router.py``. One router process
load-balances ``POST /queries.json`` across N query-server replicas, each
a process with its own CUDA context launching kernel 1 on the card; the
router is host code and opens none. Every resilience property proven
inside one process — deadlines, breakers, drain — composes here across
processes:

* **Active health checking** against each replica's ``GET /readyz``:
  consecutive probe failures eject a replica, consecutive successes
  re-admit it with a slow-start weight ramp so a cold process is not
  handed a full share of traffic on its first warm second.  The probe
  gates on *warm* (``fastpathWarm``), not merely *loaded*.
* **Outlier ejection**: a replica whose latency EWMA exceeds
  ``PIO_FLEET_OUTLIER_RATIO`` × the fleet median is ejected for a
  cooldown even while its ``/readyz`` is green (a wedged-but-listening
  process must not keep absorbing a share of traffic).
* **Per-replica circuit breakers + concurrency caps** reusing
  ``common/resilience.py`` — one replica OPEN never gates another.
* **Hedged requests**: when the primary attempt is still in flight
  after a rolling-quantile delay, the query is issued to a second
  replica and the first answer wins.  Hedges are budget-capped via
  :class:`~predictionio_tpu_torch.common.resilience.RetryBudget` so a
  fleet-wide slowdown cannot double traffic.
* **Safe retry** of idempotent queries on connection failure / 5xx /
  replica shed — the mechanism that turns a kill -9 of one replica into
  zero client-visible failures.

The router→replica hop is a first-class fault-injection site
(``client:router:/queries.json`` — ``common/faults.py``), so the chaos
suite can exercise latency / error / drop on the hop itself.

* **Pod-group routing**: replicas that advertise a ``pod`` block on
  ``/readyz`` (self-contained pod replicas, their group pinned by
  ``PIO_POD_GROUP``) get group-affine routing: a query goes to the host
  group that owns it by a crc32 of its user key, falling back fleet-wide
  when that group has no eligible replica (``pio_pod_queries_routed_total
  {group}`` and ``pio_pod_fallback_broadcasts_total``), with the
  ``client:pod:merge`` fault site on the hop. An advert whose mesh spans
  processes is ignored: such a replica serves in lockstep only.

Thread model: request handler threads (HttpService pool), one attempt
thread per forwarded try, and one ``_health_loop`` pacing on the stop
Event.  All router/replica mutable state is guarded by ``self._lock``;
breakers keep their own internal lock.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import zlib
from collections import deque
from typing import Optional

from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.common.http import (
    HttpService, Request, Response, json_response,
)
from predictionio_tpu_torch.common.resilience import (
    DEADLINE_HEADER,
    CircuitBreaker,
    Deadline,
    ErrorCounters,
    RateLimitedLogger,
    RetryBudget,
    parse_deadline_header,
)
from predictionio_tpu_torch import obs
from predictionio_tpu_torch.obs import bridges as _bridges
from predictionio_tpu_torch.serving import tenancy as _tenancy

logger = logging.getLogger(__name__)

QUERY_PATH = "/queries.json"

# replica admission states (the pio_router_replica_state gauge values)
ADMITTED = "admitted"
EJECTED = "ejected"
DRAINING = "draining"
STATE_VALUES = {ADMITTED: 0.0, EJECTED: 1.0, DRAINING: 2.0}


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError, TypeError):
        return default


class ReplicaState:
    """One replica's routing view.  Every field is guarded by the owning
    router's ``_lock`` except ``breaker``, which has its own."""

    def __init__(self, url: str, now: float):
        self.url = url.rstrip("/")
        self.state = ADMITTED
        self.admitted_at = now
        self.healthy_streak = 0
        self.unhealthy_streak = 0
        self.inflight = 0
        self.ewma_ms: Optional[float] = None
        self.samples = 0
        self.generation: Optional[int] = None
        # durable generation identity (engine instance id) from /readyz:
        # the `generation` counter above is a per-process int — canary
        # attribution and hot-swap targeting key on THIS instead
        self.instance_id: Optional[str] = None
        self.delta_epoch: Optional[int] = None
        # the host group this replica's serving mesh belongs to, as
        # advertised on /readyz (None: not a pod replica)
        self.pod_group: Optional[int] = None
        self.pod_groups: Optional[int] = None
        self.pod_fingerprint: Optional[str] = None
        self.warm = True
        self.no_readmit_before = 0.0
        self.last_error = ""
        self.breaker = CircuitBreaker(
            endpoint=self.url,
            failure_threshold=_env_num("PIO_FLEET_BREAKER_THRESHOLD", 5, int),
            reset_timeout_s=_env_num(
                "PIO_FLEET_BREAKER_RESET_S", 5.0, float
            ),
        )


class _Slot:
    """First-answer-wins rendezvous between a request thread and its
    attempt threads (primary + optional hedge)."""

    __slots__ = ("event", "lock", "result", "winner_hedged", "outstanding",
                 "failure", "tried", "group")

    def __init__(self):
        self.event = threading.Event()
        self.lock = threading.Lock()
        self.result = None          # (status, body_bytes, headers)
        self.winner_hedged = False
        self.outstanding = 0
        self.failure = None         # last losing (status, body, headers)
        self.tried: set[str] = set()
        # the query's pod owner group (None: no affinity); retries and
        # hedges keep the primary pick's affinity
        self.group: Optional[int] = None


class Router:
    """HTTP front-end supervising N query-server replicas."""

    def __init__(
        self,
        replica_urls: list[str],
        default_deadline_ms: Optional[float] = None,
        hedge_enabled: Optional[bool] = None,
        telemetry: bool = True,
    ):
        now = time.monotonic()
        self._replicas = [ReplicaState(u, now) for u in replica_urls]
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._draining = False
        self._fleet = None
        self._autoscaler = None
        self._tenants = None
        self._canary = None
        self._rolling = False
        # per-generation online attribution (canary verification input):
        # engine instance id → requests/errors/latency window, recorded on
        # every attempt outcome in _attempt_chain.  Bounded: only the most
        # recently touched generations are tracked (guarded by _lock).
        self._gen_stats: dict[str, dict] = {}
        # shadow-mirror capture: when a canary is verifying, recent REAL
        # query bodies are kept here (bounded, newest-wins) for the
        # controller to replay against candidate+baseline — answers
        # discarded, budget-capped at the controller (guarded by _lock)
        self._shadow_capture = False
        self._shadow_buf: deque[bytes] = deque(maxlen=64)
        self.default_deadline_ms = default_deadline_ms
        # knobs (each read in exactly one place), with the JAX
        # package's defaults
        self.health_interval_ms = _env_num(
            "PIO_FLEET_HEALTH_INTERVAL_MS", 200.0, float
        )
        self.probe_timeout_ms = _env_num(
            "PIO_FLEET_PROBE_TIMEOUT_MS", 1000.0, float
        )
        self.eject_after = _env_num("PIO_FLEET_EJECT_AFTER", 3, int)
        self.readmit_after = _env_num("PIO_FLEET_READMIT_AFTER", 2, int)
        self.slow_start_s = _env_num("PIO_FLEET_SLOW_START_S", 3.0, float)
        self.outlier_ratio = _env_num("PIO_FLEET_OUTLIER_RATIO", 3.0, float)
        self.outlier_cooldown_s = _env_num(
            "PIO_FLEET_OUTLIER_COOLDOWN_S", 5.0, float
        )
        self.outlier_min_samples = _env_num(
            "PIO_FLEET_OUTLIER_MIN_SAMPLES", 20, int
        )
        self.replica_max_inflight = _env_num(
            "PIO_FLEET_REPLICA_MAX_INFLIGHT", 64, int
        )
        self.max_retries = _env_num("PIO_ROUTER_RETRIES", 2, int)
        self.request_timeout_s = (
            _env_num("PIO_ROUTER_TIMEOUT_MS", 30000.0, float) / 1e3
        )
        self.shed_retry_after_s = _env_num(
            "PIO_ROUTER_RETRY_AFTER_S", 1.0, float
        )
        self.hedge_enabled = (
            _env_num("PIO_HEDGE_ENABLED", 1, int) != 0
            if hedge_enabled is None
            else bool(hedge_enabled)
        )
        self.hedge_quantile = _env_num("PIO_HEDGE_QUANTILE", 0.95, float)
        self.hedge_min_ms = _env_num("PIO_HEDGE_MIN_MS", 20.0, float)
        self.budget = RetryBudget(
            ratio=_env_num("PIO_HEDGE_BUDGET_RATIO", 0.1, float)
        )
        # rolling latency window feeding the hedge-delay quantile; the
        # cached quantile is recomputed every _HEDGE_RECALC samples so the
        # hot path never sorts
        self._lat_window: deque[float] = deque(maxlen=256)
        self._hedge_delay_ms = self.hedge_min_ms * 5.0
        self._lat_since_recalc = 0
        self.counters = ErrorCounters(
            "ok", "client_error", "failed", "shed", "deadline", "retries",
            "hedges_fired", "hedges_won", "hedges_denied",
            "ejections_health", "ejections_outlier", "readmissions",
            "pod_fallback",
        )
        # pod fan-out: queries routed to the host group that owns them, by
        # group id (guarded by _lock)
        self._pod_routed: dict[int, int] = {}
        self._rl_log = RateLimitedLogger(logger)
        # streaming delta propagation acks by outcome (push_delta); a
        # plain dict guarded by _lock — outcomes come from receipt shapes,
        # not a fixed counter list
        self._delta_propagated = {"applied": 0, "noop": 0, "refused": 0,
                                  "error": 0}
        self.service = HttpService("router")
        self.telemetry = (
            obs.Telemetry("router").install(self.service)
            if telemetry and obs.telemetry_enabled()
            else None
        )
        self._health_thread: Optional[threading.Thread] = None
        self._register_routes()
        if self.telemetry is not None:
            self._register_metrics()

    _HEDGE_RECALC = 32

    # -- replica selection ---------------------------------------------------
    def _weight(self, rep: ReplicaState, now: float) -> float:
        """Slow-start weight: ramps 0.1 → 1.0 over slow_start_s after
        (re-)admission so a cold replica earns traffic gradually."""
        if self.slow_start_s <= 0:
            return 1.0
        frac = (now - rep.admitted_at) / self.slow_start_s
        return min(1.0, max(0.1, frac))

    def _pick_locked(
        self, exclude: set[str], group: Optional[int] = None
    ) -> Optional[ReplicaState]:
        """Weighted least-loaded admitted replica whose breaker allows the
        call.  ``allow()`` is only consulted on a candidate we are about
        to use, so a half-open probe slot is never burnt on a bystander.
        Replicas of the pod host ``group`` that owns the query are strictly
        preferred; with none eligible the pick falls back fleet-wide."""
        now = time.monotonic()
        cands = []
        owned = []
        for rep in self._replicas:
            if rep.url in exclude or rep.state != ADMITTED:
                continue
            if rep.inflight >= self.replica_max_inflight:
                continue
            load = (rep.inflight + 1.0) / self._weight(rep, now)
            cands.append((load, len(cands), rep))
            if group is not None and rep.pod_group == group:
                owned.append(cands[-1])
        for pool in (owned, cands) if group is not None else (cands,):
            pool.sort(key=lambda t: (t[0], t[1]))
            for _, _, rep in pool:
                if rep.breaker.allow():
                    return rep
        return None

    def available_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == ADMITTED)

    # -- elastic replica set -------------------------------------------------
    def add_replica(self, url: str) -> bool:
        """Register a scale-up replica.  It starts EJECTED: the health
        gate must see /readyz + warm before any traffic lands, and then
        slow start ramps its share 10% → 100% — a cold process never
        absorbs a full split.  Returns False on a duplicate URL."""
        url = url.rstrip("/")
        now = time.monotonic()
        with self._lock:
            if any(r.url == url for r in self._replicas):
                return False
            rep = ReplicaState(url, now)
            rep.state = EJECTED
            self._replicas = self._replicas + [rep]
        logger.info("router: replica %s registered (awaiting health gate)",
                    url)
        return True

    def remove_replica(self, url: str) -> bool:
        """Forget a scaled-down replica entirely (probing included)."""
        url = url.rstrip("/")
        with self._lock:
            keep = [r for r in self._replicas if r.url != url]
            removed = len(keep) != len(self._replicas)
            self._replicas = keep
        if removed:
            logger.info("router: replica %s deregistered", url)
        return removed

    def signals(self) -> dict:
        """The autoscaler's input: one consistent snapshot of the load
        signals the router already maintains for its own decisions."""
        with self._lock:
            admitted = [r for r in self._replicas if r.state == ADMITTED]
            out = {
                "replicas": len(self._replicas),
                "admitted": len(admitted),
                "inflight": sum(r.inflight for r in self._replicas),
                "replicaMaxInflight": self.replica_max_inflight,
                "admittedUrls": [r.url for r in admitted],
                "counters": self.counters.snapshot(),
                "rolling": self._rolling,
            }
            reg = self._tenants
        if reg is not None:
            # per-tenant inflight saturation: the autoscaler treats the
            # hottest tenant's share as one more pressure component
            pressure = reg.pressure()
            out["tenantPressure"] = max(pressure.values(), default=0.0)
            out["tenants"] = pressure
        return out

    def _retry_after_s(self) -> float:
        """Backpressure-aware ``Retry-After``: PIO_ROUTER_RETRY_AFTER_S is
        the BASE, scaled by live fleet state so clients back off longer
        the deeper the overload.  With no admitted replica the hint is
        the health gate's readmission horizon (a fresh or restarted
        process cannot answer sooner than readmit_after probes)."""
        base = self.shed_retry_after_s
        with self._lock:
            admitted = [r for r in self._replicas if r.state == ADMITTED]
            inflight = sum(r.inflight for r in self._replicas)
        if not admitted:
            probe_s = (self.health_interval_ms / 1e3) * max(
                1, self.readmit_after
            )
            return round(min(max(base, probe_s), 30.0), 2)
        load = inflight / float(
            max(1, self.replica_max_inflight) * len(admitted)
        )
        return round(min(base * max(1.0, load), 30.0), 2)

    # -- per-generation attribution (canary verification input) --------------
    _GEN_TRACK_MAX = 8
    _GEN_LAT_WINDOW = 512

    def _note_gen_outcome(
        self, rep: ReplicaState, ok: bool,
        latency_ms: Optional[float] = None,
    ) -> None:
        """Attribute one attempt outcome to the engine instance the
        replica was serving.  Keyed by durable instance id (never the
        per-process generation counter); bounded to the most recently
        touched generations so a long-lived router can't grow this
        without bound."""
        iid = rep.instance_id
        if iid is None:
            return
        with self._lock:
            st = self._gen_stats.get(iid)
            if st is None:
                if len(self._gen_stats) >= self._GEN_TRACK_MAX:
                    oldest = min(
                        self._gen_stats.items(),
                        key=lambda kv: kv[1]["touched"],
                    )[0]
                    del self._gen_stats[oldest]
                st = {
                    "requests": 0, "errors": 0,
                    "lat": deque(maxlen=self._GEN_LAT_WINDOW),
                    "touched": 0.0,
                }
                self._gen_stats[iid] = st
            st["requests"] += 1
            if not ok:
                st["errors"] += 1
            if latency_ms is not None:
                st["lat"].append(latency_ms)
            st["touched"] = time.monotonic()

    def generation_stats(self) -> dict:
        """Per-generation online metrics: requests, server errors, error
        rate and p99 over the rolling latency window — the canary
        controller's verification input."""
        with self._lock:
            snap = {
                iid: (st["requests"], st["errors"], sorted(st["lat"]))
                for iid, st in self._gen_stats.items()
            }
        out = {}
        for iid, (requests, errors, lat) in snap.items():
            p99 = (
                lat[min(len(lat) - 1, int(0.99 * len(lat)))]
                if lat else None
            )
            out[iid] = {
                "requests": requests,
                "errors": errors,
                "errorRate": (errors / requests) if requests else 0.0,
                "p99Ms": p99,
                "latencySamples": len(lat),
            }
        return out

    # -- shadow-mirror capture (canary quality signal) ------------------------
    def set_shadow_capture(self, on: bool) -> None:
        """The canary controller turns capture on for the verification
        window only; turning it off drops any unclaimed bodies."""
        with self._lock:
            self._shadow_capture = bool(on)
            if not on:
                self._shadow_buf.clear()

    def take_shadow_samples(self, n: int) -> list[bytes]:
        """Up to ``n`` captured real query bodies, oldest first; each is
        handed out exactly once (the controller replays it against
        candidate + baseline and discards both answers)."""
        out: list[bytes] = []
        with self._lock:
            while self._shadow_buf and len(out) < n:
                out.append(self._shadow_buf.popleft())
        return out

    def replica_view(self) -> list[dict]:
        """Thin per-replica snapshot for the canary controller: which url
        serves which engine instance, and whether it takes traffic."""
        with self._lock:
            return [
                {
                    "url": r.url,
                    "state": r.state,
                    "instanceId": r.instance_id,
                    "warm": r.warm,
                }
                for r in self._replicas
            ]

    # -- latency window / hedge delay ----------------------------------------
    def _record_latency(self, rep: ReplicaState, ms: float) -> None:
        with self._lock:
            if rep.ewma_ms is None:
                rep.ewma_ms = ms
            else:
                rep.ewma_ms += 0.2 * (ms - rep.ewma_ms)
            rep.samples += 1
            self._lat_window.append(ms)
            self._lat_since_recalc += 1
            if (
                self._lat_since_recalc >= self._HEDGE_RECALC
                and len(self._lat_window) >= 16
            ):
                self._lat_since_recalc = 0
                ordered = sorted(self._lat_window)
                idx = min(
                    len(ordered) - 1,
                    int(self.hedge_quantile * len(ordered)),
                )
                self._hedge_delay_ms = max(
                    self.hedge_min_ms, ordered[idx]
                )

    def hedge_delay_ms(self) -> float:
        with self._lock:
            return self._hedge_delay_ms

    # -- pod host-group fan-out ---------------------------------------------
    def _pod_group_count_locked(self) -> Optional[int]:
        """The fleet's agreed host-group count, or None without one agreed
        plan (no pod replicas, or mismatched fingerprints mid-deploy):
        routing then picks fleet-wide."""
        groups: set[int] = set()
        fps: set[Optional[str]] = set()
        for rep in self._replicas:
            if rep.pod_group is None or not rep.pod_groups:
                continue
            groups.add(rep.pod_groups)
            fps.add(rep.pod_fingerprint)
        if len(groups) != 1 or len(fps) != 1:
            return None
        n = next(iter(groups))
        return n if n > 1 else None

    def _note_pod_pick_locked(self, rep: ReplicaState, group: Optional[int]) -> None:
        """Charge one attempt's pick (caller holds ``_lock``): an owner
        group hit in ``pio_pod_queries_routed_total{group}``, an off-owner
        pick in ``pio_pod_fallback_broadcasts_total``."""
        if group is None:
            return
        if rep.pod_group == group:
            self._pod_routed[group] = self._pod_routed.get(group, 0) + 1
        else:
            self.counters.inc("pod_fallback")

    def _owner_group(self, body: bytes) -> Optional[int]:
        """The host group that owns this query, by a crc32 of its user key;
        None without an agreed pod map or a user key (fleet-wide)."""
        with self._lock:
            n = self._pod_group_count_locked()
        if n is None:
            return None
        try:
            q = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        user = q.get("user") if isinstance(q, dict) else None
        if user is None:
            return None
        return zlib.crc32(str(user).encode("utf-8")) % n

    # -- forwarding ----------------------------------------------------------
    def _forward(
        self,
        rep: ReplicaState,
        body: bytes,
        deadline: Optional[Deadline],
        trace_id: Optional[str],
    ) -> tuple[int, bytes, dict]:
        """One HTTP try against one replica.  Returns (status, body,
        headers) for ANY HTTP answer; raises OSError for transport
        failures (refused / reset / timeout)."""
        act = _faults.check(f"client:router:{QUERY_PATH}")
        if act is not None:
            if act.latency_s:
                time.sleep(act.latency_s)
            if act.kind == "drop":
                raise ConnectionError("injected drop on router->replica hop")
            if act.kind == "error":
                return (
                    act.status,
                    b'{"message":"injected fault"}',
                    {},
                )
        if rep.pod_group is not None:
            # the pod-merge hop: a forward into a host group whose merge can
            # tear when a member dies mid-collective (site client:pod:merge)
            act = _faults.check("client:pod:merge")
            if act is not None:
                if act.latency_s:
                    time.sleep(act.latency_s)
                if act.kind == "drop":
                    raise ConnectionError("injected pod merge tear on router->group hop")
                if act.kind == "error":
                    return (act.status, b'{"message":"injected pod merge fault"}', {})
        headers = {"Content-Type": "application/json"}
        timeout = self.request_timeout_s
        if deadline is not None:
            # every attempt (primary, hedge, retry) forwards
            # the budget REMAINING NOW — never the original header value,
            # which would hand later attempts time the client no longer has
            remaining_ms = deadline.remaining_ms()
            headers[DEADLINE_HEADER] = f"{remaining_ms:.0f}"
            timeout = min(timeout, max(remaining_ms, 1.0) / 1e3)
        if trace_id:
            from predictionio_tpu_torch.obs import tracing as _tracing

            headers[_tracing.TRACE_HEADER] = trace_id
        req = urllib.request.Request(
            rep.url + QUERY_PATH, data=body, method="POST", headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            data = e.read()
            return e.code, data, dict(e.headers or {})

    # -- streaming delta propagation -----------------------------------------
    def push_delta(
        self, payload: bytes, deadline: Optional[Deadline] = None
    ) -> dict:
        """Propagate one sealed delta blob to EVERY replica's ``POST
        /delta`` and collect per-replica apply acknowledgements.

        All replicas are pushed — ejected and draining included: a
        replica that misses the push is not wrong, merely stale, and its
        own catch-up from the sealed log (gated by /readyz) must close
        the gap before readmission.  A transport failure or 5xx becomes
        an ``{"error": ...}`` ack; the push itself never raises.
        """
        with self._lock:
            reps = list(self._replicas)
        acks = {}
        applied = 0
        for rep in reps:
            receipt = self._push_delta_one(rep, payload, deadline)
            acks[rep.url] = receipt
            if receipt.get("applied") or receipt.get("noop"):
                applied += 1
            outcome = (
                "applied" if receipt.get("applied")
                else "noop" if receipt.get("noop")
                else "refused" if receipt.get("refused")
                else "error"
            )
            with self._lock:
                self._delta_propagated[outcome] += 1
        return {"replicas": len(reps), "acked": applied, "acks": acks}

    def _push_delta_one(
        self, rep: ReplicaState, payload: bytes,
        deadline: Optional[Deadline] = None,
    ) -> dict:
        """One router→replica delta hop.  Any failure — injected tear,
        refused connect, 5xx — is shaped into an error ack so the caller
        always gets one receipt per replica."""
        headers = {"Content-Type": "application/octet-stream"}
        timeout = self.request_timeout_s
        if deadline is not None:
            # same contract as _forward: forward the budget REMAINING NOW
            remaining_ms = deadline.remaining_ms()
            headers[DEADLINE_HEADER] = f"{remaining_ms:.0f}"
            timeout = min(timeout, max(remaining_ms, 1.0) / 1e3)
        act = _faults.check("client:replica:delta")
        if act is not None:
            if act.latency_s:
                time.sleep(act.latency_s)
            if act.kind == "drop":
                return {"error": "injected drop on router->replica "
                                 "delta hop"}
            if act.kind == "error":
                return {"error": f"injected {act.status} on delta hop"}
        req = urllib.request.Request(
            rep.url + "/delta", data=payload, method="POST", headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode("utf-8"))
            except (ValueError, OSError):
                return {"error": f"http {e.code}"}
        except (OSError, ValueError) as e:
            return {"error": f"{type(e).__name__}: {e}"}

    # -- attempt threads -----------------------------------------------------
    def _spawn_attempt(self, slot, rep, body, deadline, hedged, trace_id):
        t = threading.Thread(
            target=self._attempt,
            args=(slot, rep, body, deadline, hedged, trace_id),
            name="router-attempt",
            daemon=True,
        )
        t.start()

    def _attempt(self, slot, rep, body, deadline, hedged, trace_id):
        try:
            self._attempt_chain(slot, rep, body, deadline, hedged, trace_id)
        except Exception:
            self._rl_log.exception("attempt", "router attempt crashed")
            self._abandon(slot, None)

    def _attempt_chain(self, slot, rep, body, deadline, hedged, trace_id):
        """Forward to ``rep``; on transport failure / 5xx / shed, retry a
        different replica (budget-capped, deadline-bounded)."""
        retries_left = self.max_retries
        current = rep
        last = None
        while True:
            if deadline is not None and deadline.expired():
                self._abandon(slot, last)
                return
            with self._lock:
                current.inflight += 1
            t0 = time.perf_counter()
            outcome = None
            try:
                outcome = self._forward(current, body, deadline, trace_id)
            except OSError as e:
                current.breaker.record_failure()
                # transport failure attributes against the generation the
                # replica was serving — a candidate that wedges its
                # process must show up in the canary's error rate
                self._note_gen_outcome(current, ok=False)
                with self._lock:
                    current.last_error = f"{type(e).__name__}: {e}"
            finally:
                with self._lock:
                    current.inflight -= 1
            if outcome is not None:
                status = outcome[0]
                if status < 500:
                    current.breaker.record_success()
                    if status < 400:
                        ms = (time.perf_counter() - t0) * 1e3
                        self._record_latency(current, ms)
                        self._note_gen_outcome(current, ok=True,
                                               latency_ms=ms)
                        self._complete(slot, outcome, hedged)
                        return
                    if status != 503:
                        # 4xx is the CLIENT's bug: pass through, no retry
                        # (and no generation attribution — the generation
                        # did nothing wrong)
                        self._complete(slot, outcome, hedged)
                        return
                    # 503 = replica shedding/draining: alive, just not for
                    # us — try another replica
                else:
                    current.breaker.record_failure()
                    self._note_gen_outcome(current, ok=False)
                last = outcome
            # retry path.  A transport failure (kill -9, refused connect)
            # retries FREE — the attempt consumed nothing downstream and
            # absorbing it is the availability contract.  An HTTP-level
            # failure (5xx / shed) retries only inside the shared budget:
            # re-offering work to an overloaded fleet is how retry storms
            # start.
            if retries_left <= 0:
                self._abandon(slot, last)
                return
            if outcome is not None and not self.budget.take():
                self._abandon(slot, last)
                return
            with slot.lock:
                tried = set(slot.tried)
            with self._lock:
                # retries keep the primary pick's group affinity (slot.group
                # is written once, before the first attempt spawns)
                nxt = self._pick_locked(tried, group=slot.group)
                if nxt is not None:
                    self._note_pod_pick_locked(nxt, slot.group)
            if nxt is None:
                self._abandon(slot, last)
                return
            with slot.lock:
                slot.tried.add(nxt.url)
            self.counters.inc("retries")
            retries_left -= 1
            current = nxt

    def _complete(self, slot, result, hedged) -> bool:
        with slot.lock:
            slot.outstanding -= 1
            if slot.result is not None:
                return False
            slot.result = result
            slot.winner_hedged = bool(hedged)
        slot.event.set()
        return True

    def _abandon(self, slot, failure) -> None:
        with slot.lock:
            slot.outstanding -= 1
            if failure is not None:
                slot.failure = failure
            done = slot.outstanding <= 0 and slot.result is None
        if done:
            slot.event.set()

    # -- the query route -----------------------------------------------------
    def _serve_query(self, req: Request) -> Response:
        """Tenant edge gate, then replica routing.  With no registry
        attached this is a straight delegation — byte-identical to the
        pre-tenancy router."""
        reg = self._tenants
        if reg is None:
            return self._route_query(req)
        try:
            data = json.loads(req.body) if req.body else None
        except ValueError:
            data = None
        key = _tenancy.extract_access_key(
            req.params, req.headers, data if isinstance(data, dict) else None
        )
        if not key:
            return json_response(401, {"message": "Missing accessKey."})
        spec = reg.authenticate(key)
        if spec is None:
            return json_response(401, {"message": "Invalid accessKey."})
        tenant = spec.tenant_id
        adm = reg.admit(tenant)
        if not adm.ok:
            self.counters.inc("shed")
            return Response(
                status=503,
                body={"message": f"tenant {tenant} shed", "tenant": tenant,
                      "reason": adm.reason},
                headers={"Retry-After": f"{adm.retry_after_s:g}"},
            )
        variant = (
            reg.pick_variant(tenant, data.get("user"))
            if isinstance(data, dict) else None
        )
        ok = False
        t0 = time.perf_counter()
        try:
            resp = self._route_query(req)
            # 4xx and sheds are the contract working; only 5xx server
            # errors feed this tenant's breaker (tenant isolation)
            ok = resp.status < 500 or resp.status == 503
            return resp
        finally:
            reg.release(tenant)
            reg.record_result(
                tenant, variant, ok=ok,
                latency_s=time.perf_counter() - t0,
            )

    def _route_query(self, req: Request) -> Response:
        if self._draining:
            return Response(
                status=503,
                body={"message": "router draining"},
                headers={"Retry-After": f"{self._retry_after_s():g}"},
            )
        deadline = parse_deadline_header(req.headers.get(DEADLINE_HEADER))
        if deadline is None and self.default_deadline_ms is not None:
            deadline = Deadline.after_ms(self.default_deadline_ms)
        if deadline is not None and deadline.expired():
            self.counters.inc("deadline")
            return json_response(
                504, {"message": "deadline expired before routing"}
            )
        trace_id = getattr(req.trace, "request_id", None)
        if self._shadow_capture and req.body:
            # canary verification window: keep a bounded copy of real
            # traffic for the controller's shadow mirror (newest-wins)
            with self._lock:
                if self._shadow_capture:
                    self._shadow_buf.append(req.body)
        self.budget.on_attempt()
        group = self._owner_group(req.body)
        slot = _Slot()
        slot.group = group
        with self._lock:
            rep = self._pick_locked(slot.tried, group=group)
            if rep is not None:
                slot.tried.add(rep.url)
                slot.outstanding = 1
                # the owner group's hit or the fleet-wide fallback, counted
                # on every attempt (retries and hedges too)
                self._note_pod_pick_locked(rep, group)
        if rep is None:
            self.counters.inc("shed")
            return Response(
                status=503,
                body={"message": "no replica available"},
                headers={"Retry-After": f"{self._retry_after_s():g}"},
            )
        self._spawn_attempt(slot, rep, req.body, deadline, False, trace_id)
        if self.hedge_enabled:
            delay_s = self.hedge_delay_ms() / 1e3
            if deadline is not None:
                delay_s = min(delay_s, max(deadline.remaining_s(), 0.0))
            if not slot.event.wait(delay_s):
                with slot.lock:
                    tried = set(slot.tried)
                with self._lock:
                    hrep = self._pick_locked(tried, group=group)
                if hrep is not None:
                    if self.budget.take():
                        with slot.lock:
                            slot.tried.add(hrep.url)
                            slot.outstanding += 1
                        with self._lock:
                            self._note_pod_pick_locked(hrep, group)
                        self.counters.inc("hedges_fired")
                        self._spawn_attempt(
                            slot, hrep, req.body, deadline, True, trace_id
                        )
                    else:
                        self.counters.inc("hedges_denied")
        wait_s = (
            deadline.remaining_s() + 0.05
            if deadline is not None
            else self.request_timeout_s + 1.0
        )
        if not slot.event.wait(max(wait_s, 0.0)):
            self.counters.inc("deadline")
            return json_response(
                504, {"message": "deadline expired in router"}
            )
        with slot.lock:
            result = slot.result or slot.failure
            hedged_won = slot.winner_hedged and slot.result is not None
        if hedged_won:
            self.counters.inc("hedges_won")
        if result is None:
            self.counters.inc("failed")
            return Response(
                status=502,
                body={"message": "all replicas failed"},
                headers={"Retry-After": f"{self._retry_after_s():g}"},
            )
        status, rbody, rheaders = result
        if status < 400:
            self.counters.inc("ok")
        elif status < 500:
            self.counters.inc("client_error")
        else:
            self.counters.inc("failed")
        out = Response(
            status=status,
            body=rbody,
            content_type="application/json; charset=utf-8",
        )
        retry_after = (rheaders or {}).get("Retry-After")
        if status == 503:
            out.headers["Retry-After"] = (
                retry_after or f"{self._retry_after_s():g}"
            )
        return out

    # -- health checking -----------------------------------------------------
    def _probe_replica(self, rep: ReplicaState):
        """GET /readyz on one replica.  (ok, info-dict-or-None, timed_out)
        — ok means 200 AND the fast path reports warm (admission gates on
        warm); timed_out means the probe got no answer within
        ``probe_timeout_ms`` (a busy replica, not a refusal)."""
        try:
            with urllib.request.urlopen(
                rep.url + "/readyz", timeout=self.probe_timeout_ms / 1e3
            ) as r:
                info = json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                info = json.loads(e.read().decode("utf-8"))
            except (ValueError, OSError):
                info = None
            return False, info, False
        except (OSError, ValueError) as e:
            reason = getattr(e, "reason", e)
            return False, None, isinstance(reason, TimeoutError)
        return bool(info.get("fastpathWarm", True)), info, False

    def _health_loop(self):
        interval_s = self.health_interval_ms / 1e3
        while not self._stop_evt.wait(interval_s):
            self._probe_cycle()

    def _probe_cycle(self):
        results = [(rep, self._probe_replica(rep)) for rep in self._replicas]
        now = time.monotonic()
        with self._lock:
            for rep, (ok, info, timed_out) in results:
                self._apply_probe_locked(rep, ok, info, now, timed_out)
            self._check_outliers_locked(now)

    def _apply_probe_locked(self, rep, ok, info, now, timed_out=False):
        if info is not None:
            gen = info.get("generation")
            if isinstance(gen, int):
                rep.generation = gen
            iid = info.get("engineInstanceId")
            if isinstance(iid, str) and iid:
                rep.instance_id = iid
            de = info.get("deltaEpoch")
            if isinstance(de, int):
                rep.delta_epoch = de
            pod = info.get("pod")
            if isinstance(pod, dict) and not pod.get("spansProcesses"):
                g, n = pod.get("group"), pod.get("groups")
                rep.pod_group = int(g) if isinstance(g, int) else None
                rep.pod_groups = int(n) if isinstance(n, int) else None
                fp = pod.get("fingerprint")
                rep.pod_fingerprint = fp if isinstance(fp, str) else None
            else:
                # a mesh that spans processes serves in lockstep only: one
                # group's queries routed to it would wedge its peers, so it
                # is never a routable pod group member
                rep.pod_group = None
                rep.pod_groups = None
                rep.pod_fingerprint = None
            rep.warm = bool(info.get("fastpathWarm", True))
        if ok:
            rep.healthy_streak += 1
            rep.unhealthy_streak = 0
            if (
                rep.state == EJECTED
                and rep.healthy_streak >= self.readmit_after
                and now >= rep.no_readmit_before
            ):
                rep.state = ADMITTED
                rep.admitted_at = now
                rep.ewma_ms = None
                rep.samples = 0
                self.counters.inc("readmissions")
                logger.info("replica %s re-admitted (slow start)", rep.url)
        else:
            rep.healthy_streak = 0
            rep.unhealthy_streak += 1
            if (
                rep.state == ADMITTED
                and rep.unhealthy_streak >= self.eject_after
            ):
                if timed_out and sum(
                    1 for r in self._replicas if r.state == ADMITTED
                ) <= 1:
                    # the guard outlier ejection has: a probe that timed
                    # out on the last admitted replica means it is busy
                    # (one replica carrying a roll's whole load), and
                    # ejecting it would shed every query with 503; a
                    # refusal or a 503 from /readyz still ejects
                    self._rl_log.warning(
                        "eject-held", "replica %s kept: last admitted, "
                        "/readyz timed out %d probes",
                        rep.url, rep.unhealthy_streak,
                    )
                    return
                rep.state = EJECTED
                self.counters.inc("ejections_health")
                self._rl_log.warning(
                    "eject", "replica %s ejected (unready %d probes)",
                    rep.url, rep.unhealthy_streak,
                )

    def _check_outliers_locked(self, now):
        """Eject latency outliers: EWMA > ratio × fleet median.  Never
        ejects the last admitted replica."""
        admitted = [r for r in self._replicas if r.state == ADMITTED]
        sampled = [
            r for r in admitted
            if r.ewma_ms is not None and r.samples >= self.outlier_min_samples
        ]
        if len(admitted) < 2 or len(sampled) < 2:
            return
        ordered = sorted(r.ewma_ms for r in sampled)
        median = ordered[len(ordered) // 2]
        if median <= 0:
            return
        alive = len(admitted)
        for r in sampled:
            if alive <= 1:
                return
            if r.ewma_ms > self.outlier_ratio * median:
                r.state = EJECTED
                r.no_readmit_before = now + self.outlier_cooldown_s
                r.healthy_streak = 0
                r.ewma_ms = None
                r.samples = 0
                alive -= 1
                self.counters.inc("ejections_outlier")
                self._rl_log.warning(
                    "outlier", "replica %s ejected as latency outlier "
                    "(> %.1fx fleet median %.1fms)",
                    r.url, self.outlier_ratio, median,
                )

    # -- rolling deploys (fleet attachment) ----------------------------------
    def attach_fleet(self, fleet) -> None:
        """Wire a FleetSupervisor so `/fleet` + `/fleet/roll` are live and
        rolls can drain replicas at the ROUTER before the replica sheds."""
        with self._lock:
            self._fleet = fleet
        if self.telemetry is not None and hasattr(fleet, "stats"):
            _bridges.bridge_fleet(self.telemetry.registry, fleet.stats)

    def attach_autoscaler(self, scaler) -> None:
        """Wire an Autoscaler: its decisions surface on `/fleet` and as
        ``pio_autoscaler_*`` families on this router's /metrics."""
        with self._lock:
            self._autoscaler = scaler
        if self.telemetry is not None:
            _bridges.bridge_autoscaler(self.telemetry.registry, scaler.stats)

    def attach_tenants(self, registry) -> None:
        """Wire a TenantRegistry: the router authenticates and fair-share
        admits per tenant BEFORE picking a replica, so one tenant
        saturating its quota sheds here — at the fleet edge — and its
        traffic never occupies replica slots another tenant needs.
        Per-tenant sheds/pressure surface on signals() (the autoscaler's
        input) and as pio_tenant_* families on this router's /metrics."""
        with self._lock:
            self._tenants = registry
        if self.telemetry is not None:
            _bridges.bridge_tenancy(self.telemetry.registry, registry.stats)

    def attach_canary(self, controller) -> None:
        """Wire a CanaryController: `/canary/*` goes live, its state
        surfaces on stats()/signals(), and ``pio_canary_*`` families
        register on this router's /metrics."""
        with self._lock:
            self._canary = controller
        if self.telemetry is not None and hasattr(controller, "stats"):
            _bridges.bridge_canary(self.telemetry.registry, controller.stats)

    def set_replica_draining(self, url: str, draining: bool) -> None:
        """Roll orchestration: stop routing to a replica BEFORE its
        process drains, re-open it for probing afterwards."""
        url = url.rstrip("/")
        with self._lock:
            for rep in self._replicas:
                if rep.url != url:
                    continue
                if draining:
                    rep.state = DRAINING
                else:
                    # readmission goes through the health gate: the new
                    # process must prove /readyz + warm first
                    rep.state = EJECTED
                    rep.healthy_streak = 0
                    rep.unhealthy_streak = 0
                    rep.no_readmit_before = 0.0

    # -- stats / metrics -----------------------------------------------------
    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            replicas = [
                {
                    "url": r.url,
                    "state": r.state,
                    "inflight": r.inflight,
                    "weight": (
                        self._weight(r, now) if r.state == ADMITTED else 0.0
                    ),
                    "ewmaMs": r.ewma_ms,
                    "generation": r.generation,
                    "instanceId": r.instance_id,
                    "deltaEpoch": r.delta_epoch,
                    "podGroup": r.pod_group,
                    "warm": r.warm,
                    "lastError": r.last_error or None,
                    "breaker": r.breaker.stats(),
                }
                for r in self._replicas
            ]
            hedge_delay = self._hedge_delay_ms
            rolling = self._rolling
            pod_groups = self._pod_group_count_locked()
            pod_routed = {str(g): n for g, n in self._pod_routed.items()}
            canary = self._canary
        return {
            "generations": self.generation_stats(),
            "canary": canary.stats() if canary is not None else None,
            "status": "alive",
            "replicas": replicas,
            "pod": {
                "groups": pod_groups,
                "queriesRouted": pod_routed,
                "fallbackBroadcasts": self.counters.get("pod_fallback"),
            } if pod_groups is not None or pod_routed else None,
            "available": sum(
                1 for r in replicas if r["state"] == ADMITTED
            ),
            "counters": self.counters.snapshot(),
            "hedge": {
                "enabled": self.hedge_enabled,
                "delayMs": hedge_delay,
                "budgetTokens": self.budget.tokens(),
            },
            "rolling": rolling,
            "deltaPropagated": dict(self._delta_propagated),
        }

    def _resilience_stats(self) -> dict:
        return {
            "retries": self.counters.get("retries"),
            "retry_budget_tokens": self.budget.tokens(),
            "breakers": [r.breaker.stats() for r in self._replicas],
        }

    def _pod_stats(self) -> Optional[dict]:
        """The pod block for ``bridge_pod``: None until a replica
        advertises a pod map (the families stay absent until then)."""
        with self._lock:
            groups = self._pod_group_count_locked()
            routed = dict(self._pod_routed)
        if groups is None and not routed:
            return None
        return {
            "host_groups": groups,
            "queries_routed": routed,
            "fallback_broadcasts": self.counters.get("pod_fallback"),
        }

    def _register_metrics(self) -> None:
        reg = self.telemetry.registry
        _bridges.bridge_resilience(
            reg, self._resilience_stats, prefix="pio_router"
        )
        _bridges.bridge_pod(reg, self._pod_stats)

        def _router_families():
            now = time.monotonic()
            with self._lock:
                reps = [
                    (
                        r.url,
                        STATE_VALUES.get(r.state, -1.0),
                        float(r.inflight),
                        self._weight(r, now) if r.state == ADMITTED else 0.0,
                        float(r.generation or 0),
                    )
                    for r in self._replicas
                ]
                hedge_delay = self._hedge_delay_ms
                propagated = dict(self._delta_propagated)
            snap = self.counters.snapshot()
            F = _bridges.Family
            lbl = [(("replica", url),) for url, *_ in reps]
            return [
                F("pio_router_replicas", "gauge",
                  "Replicas configured behind this router.",
                  [("", (), float(len(reps)))]),
                F("pio_router_replicas_available", "gauge",
                  "Replicas currently admitted for traffic.",
                  [("", (), float(sum(1 for r in reps if r[1] == 0.0)))]),
                F("pio_router_replica_state", "gauge",
                  "Per-replica admission state: 0 admitted, 1 ejected, "
                  "2 draining.",
                  [("", lbl[i], reps[i][1]) for i in range(len(reps))]),
                F("pio_router_replica_inflight", "gauge",
                  "Requests in flight per replica.",
                  [("", lbl[i], reps[i][2]) for i in range(len(reps))]),
                F("pio_router_replica_weight", "gauge",
                  "Slow-start weight (0.1 → 1.0 after re-admission).",
                  [("", lbl[i], reps[i][3]) for i in range(len(reps))]),
                F("pio_router_replica_generation", "gauge",
                  "Model generation each replica reports on /readyz.",
                  [("", lbl[i], reps[i][4]) for i in range(len(reps))]),
                F("pio_router_requests_total", "counter",
                  "Routed requests by final outcome.",
                  [
                      ("", (("outcome", "ok"),), float(snap.get("ok", 0))),
                      ("", (("outcome", "client_error"),),
                       float(snap.get("client_error", 0))),
                      ("", (("outcome", "failed"),),
                       float(snap.get("failed", 0))),
                      ("", (("outcome", "shed"),),
                       float(snap.get("shed", 0))),
                      ("", (("outcome", "deadline"),),
                       float(snap.get("deadline", 0))),
                  ]),
                F("pio_router_hedges_total", "counter",
                  "Hedged attempts by outcome: fired (second replica "
                  "asked), won (hedge answered first), denied (budget "
                  "refused the hedge).",
                  [
                      ("", (("outcome", "fired"),),
                       float(snap.get("hedges_fired", 0))),
                      ("", (("outcome", "won"),),
                       float(snap.get("hedges_won", 0))),
                      ("", (("outcome", "denied"),),
                       float(snap.get("hedges_denied", 0))),
                  ]),
                F("pio_router_ejections_total", "counter",
                  "Replicas ejected, by reason.",
                  [
                      ("", (("reason", "health"),),
                       float(snap.get("ejections_health", 0))),
                      ("", (("reason", "outlier"),),
                       float(snap.get("ejections_outlier", 0))),
                  ]),
                F("pio_router_readmissions_total", "counter",
                  "Ejected replicas re-admitted after recovery probes.",
                  [("", (), float(snap.get("readmissions", 0)))]),
                F("pio_router_hedge_delay_ms", "gauge",
                  "Current hedge trigger delay (rolling latency "
                  "quantile, floored at PIO_HEDGE_MIN_MS).",
                  [("", (), float(hedge_delay))]),
                F("pio_delta_propagated_total", "counter",
                  "Per-replica delta push acknowledgements by outcome "
                  "(applied, noop, refused, error).",
                  [("", (("outcome", k),), float(v))
                   for k, v in sorted(propagated.items())]),
            ]

        reg.register_collector(_router_families)

    # -- routes --------------------------------------------------------------
    def _register_routes(self):
        svc = self.service

        @svc.route("GET", r"/")
        def index(req: Request):
            return json_response(200, self.stats())

        @svc.route("GET", r"/healthz")
        def healthz(req: Request):
            return json_response(200, {"status": "ok"})

        @svc.route("GET", r"/readyz")
        def readyz(req: Request):
            available = self.available_count()
            body = {
                "replicas": len(self._replicas),
                "available": available,
                "draining": self._draining,
            }
            if self._draining:
                body["status"] = "draining"
            elif available == 0:
                body["status"] = "no replica available"
            else:
                body["status"] = "ready"
                return json_response(200, body)
            return Response(
                status=503, body=body,
                headers={"Retry-After": f"{self._retry_after_s():g}"},
            )

        @svc.route("POST", r"/queries\.json")
        def queries(req: Request):
            return self._serve_query(req)

        @svc.route("GET", r"/fleet")
        def fleet_status(req: Request):
            with self._lock:
                fleet = self._fleet
                scaler = self._autoscaler
                rolling = self._rolling
            if fleet is None:
                return json_response(
                    404, {"message": "no fleet supervisor attached"}
                )
            body = {"rolling": rolling, "fleet": fleet.status()}
            if scaler is not None:
                body["autoscaler"] = scaler.stats()
            return json_response(200, body)

        @svc.route("POST", r"/fleet/roll")
        def fleet_roll(req: Request):
            with self._lock:
                fleet = self._fleet
                if fleet is None:
                    return json_response(
                        404, {"message": "no fleet supervisor attached"}
                    )
                if self._rolling:
                    return json_response(
                        409, {"message": "a roll is already in progress"}
                    )
                self._rolling = True

            def _do_roll():
                try:
                    fleet.roll()
                except Exception:
                    logger.exception("fleet roll failed")
                finally:
                    with self._lock:
                        self._rolling = False

            threading.Thread(
                target=_do_roll, name="fleet-roll", daemon=True
            ).start()
            return json_response(202, {"message": "roll started"})

        @svc.route("GET", r"/canary")
        def canary_status(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            return json_response(200, canary.stats())

        @svc.route("POST", r"/canary/start")
        def canary_start(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            try:
                data = json.loads(req.body) if req.body else {}
            except ValueError:
                data = {}
            try:
                started = canary.start_canary(
                    instance_id=(data or {}).get("instanceId"),
                    force=bool((data or {}).get("force")),
                )
            except ValueError as e:
                return json_response(409, {"message": str(e)})
            if not started:
                return json_response(
                    409, {"message": "a canary is already in flight"}
                )
            return json_response(202, canary.stats())

        @svc.route("POST", r"/canary/promote")
        def canary_promote(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            if not canary.request_promote():
                return json_response(
                    409, {"message": "no canary verifying"}
                )
            return json_response(202, canary.stats())

        @svc.route("POST", r"/canary/abort")
        def canary_abort(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            if not canary.request_abort():
                return json_response(409, {"message": "no canary active"})
            return json_response(202, canary.stats())

        @svc.route("GET", r"/canary/quarantine")
        def canary_quarantine(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            return json_response(200, {"receipts": canary.quarantine()})

        @svc.route("POST", r"/canary/quarantine/release")
        def canary_release(req: Request):
            with self._lock:
                canary = self._canary
            if canary is None:
                return json_response(
                    404, {"message": "no canary controller attached"}
                )
            try:
                data = json.loads(req.body) if req.body else {}
            except ValueError:
                data = {}
            iid = (data or {}).get("instanceId")
            if not iid:
                return json_response(
                    400, {"message": "instanceId required"}
                )
            released = canary.release_quarantine(iid)
            return json_response(
                200 if released else 404,
                {"released": released, "instanceId": iid},
            )

        @svc.route("POST", r"/stop")
        def stop_route(req: Request):
            def _stop():
                time.sleep(0.3)  # let the response flush first
                self.shutdown()

            threading.Thread(target=_stop, daemon=True).start()
            return json_response(200, {"message": "Shutting down."})

    # -- lifecycle -----------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 8000) -> int:
        actual = self.service.start(host, port)
        with self._lock:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="router-health", daemon=True
            )
        self._health_thread.start()
        logger.info(
            "router listening on %s:%s (%d replicas)",
            host, actual, len(self._replicas),
        )
        return actual

    def drain(self) -> None:
        """SIGTERM contract (cli._install_drain_handler): same as
        shutdown — the router holds no queued work of its own; in-flight
        forwards ride daemon attempt threads to completion."""
        self.shutdown()

    def shutdown(self) -> None:
        """Drain: stop admitting, stop probing, stop the fleet children,
        stop listening."""
        with self._lock:
            self._draining = True
            fleet = self._fleet
            canary = self._canary
        self._stop_evt.set()
        if canary is not None:
            canary.stop()
        if fleet is not None:
            fleet.stop()
        self.service.stop()

    # used by tests to stop without killing fleet children
    def stop(self) -> None:
        with self._lock:
            self._draining = True
        self._stop_evt.set()
        self.service.stop()
