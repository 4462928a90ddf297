"""The port's fleet: router, supervisor and autoscaler.

Counterpart of ``tests/test_fleet.py``, against the port's modules, with
three layers of evidence:

* Router units against stub replicas (no ML): per-replica circuit
  breakers are independent (one OPEN never gates another), hedges are
  budget-capped under sustained overload, connection failures retry
  free, unready/slow replicas are ejected and re-admitted through the
  health gate with slow start, deadlines are forwarded as *remaining*
  budget per attempt.
* Supervisor units: a crashed child is respawned with backoff.
* kill-9 / rolling-deploy chaos (``@pytest.mark.chaos``): three real
  query-server subprocesses behind an in-process router; SIGKILL of one
  replica under load produces ZERO client-visible failures and the
  fleet self-heals; ``fleet.roll()`` restarts every replica onto a new
  model generation with zero 5xx observed by the load workers. The
  replicas are the port's query servers on the CPU.

The autoscaler's decisions are held against the JAX package's: the same
stubbed signals on the same simulated clock give the same decision
sequence and stats (exact). The JAX suite's autoscale-under-preemption
test races a live scaler against a live load; its port keeps that test's
deterministic core — scripted pressure through ``tick(now=...)``, a seeded
``crash:fleet:replica`` kill through the supervisor's own preemption
point, replicas from a ``python -c`` child — under the same zero-failure
load.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.common import faults
from predictionio_tpu_torch.common.http import HttpService, Response, json_response
from predictionio_tpu_torch.common.resilience import DEADLINE_HEADER, RetryBudget
from predictionio_tpu_torch.serving.autoscaler import Autoscaler
from predictionio_tpu_torch.serving.fleet import PREEMPT_SITE, FleetSupervisor
from predictionio_tpu_torch.serving.router import ADMITTED, EJECTED, Router

import predictionio_tpu_torch


def call(method, url, body=None, headers=None, timeout=10):
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def wait_until(fn, timeout=5.0, msg="condition never became true"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    pytest.fail(msg)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# -- stub replica -------------------------------------------------------------


class StubReplica:
    """A query-server-shaped HTTP stub: configurable /readyz admission
    state and /queries.json behavior (delay / forced status)."""

    def __init__(self, generation=1):
        self.ready = True
        self.warm = True
        self.generation = generation
        self.delay_s = 0.0
        self.fail_status = None  # None = answer 200
        self.readyz_delay_s = 0.0  # a busy replica: /readyz answers late
        self.readyz_calls = 0
        self.queries = 0
        self.seen_deadlines = []
        self._lock = threading.Lock()
        self.svc = HttpService("stubreplica")

        @self.svc.route("GET", r"/readyz")
        def readyz(req):
            with self._lock:
                self.readyz_calls += 1
            if self.readyz_delay_s:
                time.sleep(self.readyz_delay_s)
            body = {
                "generation": self.generation,
                "fastpathWarm": self.warm,
                "draining": False,
            }
            if self.ready:
                body["status"] = "ready"
                return json_response(200, body)
            body["status"] = "not ready"
            return Response(status=503, body=body,
                            headers={"Retry-After": "1"})

        @self.svc.route("POST", r"/queries\.json")
        def queries(req):
            with self._lock:
                self.queries += 1
                dl = req.headers.get(DEADLINE_HEADER)
                if dl is not None:
                    self.seen_deadlines.append(float(dl))
            if self.delay_s:
                time.sleep(self.delay_s)
            if self.fail_status is not None:
                return Response(
                    status=self.fail_status, body={"message": "stub fault"},
                )
            return json_response(200, {"who": self.url})

    def start(self):
        self.port = self.svc.start("127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.port}"
        return self.url

    def stop(self):
        self.svc.stop()


@pytest.fixture()
def stubs():
    made = []

    def make(n, **kw):
        for _ in range(n):
            s = StubReplica(**kw)
            s.start()
            made.append(s)
        return made[-n:]

    yield make
    for s in made:
        s.stop()


@pytest.fixture()
def router_factory():
    routers = []

    def make(urls, *, fast_health=False, start=True, **kw):
        kw.setdefault("telemetry", False)
        r = Router(urls, **kw)
        if fast_health:
            r.health_interval_ms = 50.0
            r.probe_timeout_ms = 500.0
            r.eject_after = 2
            r.readmit_after = 2
            r.slow_start_s = 0.5
        routers.append(r)
        base = None
        if start:
            port = r.start("127.0.0.1", 0)
            base = f"http://127.0.0.1:{port}"
        return r, base

    yield make
    for r in routers:
        r.stop()


# -- routing basics ----------------------------------------------------------


class TestRouterRouting:
    def test_routes_queries_and_reports_fleet_readiness(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        router, base = router_factory([a.url, b.url])
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 200 and body["who"] in (a.url, b.url)
        status, body, _ = call("GET", base + "/readyz")
        assert status == 200
        assert body["replicas"] == 2 and body["available"] == 2
        status, body, _ = call("GET", base + "/")
        assert body["available"] == 2
        assert all(r["state"] == ADMITTED for r in body["replicas"])

    def test_draining_router_sheds_with_retry_after(
        self, stubs, router_factory
    ):
        (a,) = stubs(1)
        router, base = router_factory([a.url])
        router._draining = True
        status, body, hdrs = call("POST", base + "/queries.json", {"q": 1})
        assert status == 503 and "Retry-After" in hdrs
        status, body, hdrs = call("GET", base + "/readyz")
        assert status == 503 and body["draining"] is True
        assert "Retry-After" in hdrs

    def test_deadline_forwarded_as_remaining_budget(
        self, stubs, router_factory
    ):
        (a,) = stubs(1)
        router, base = router_factory([a.url], hedge_enabled=False)
        status, _, _ = call(
            "POST", base + "/queries.json", {"q": 1},
            headers={DEADLINE_HEADER: "750"},
        )
        assert status == 200
        # the replica saw the budget REMAINING at forward time, not the
        # original client number verbatim-with-extra-slack
        assert len(a.seen_deadlines) == 1
        assert 0 < a.seen_deadlines[0] <= 750
        # an already-expired budget never touches a replica
        status, body, _ = call(
            "POST", base + "/queries.json", {"q": 1},
            headers={DEADLINE_HEADER: "0"},
        )
        assert status == 504
        assert len(a.seen_deadlines) == 1

    def test_no_admitted_replica_sheds_503(self, stubs, router_factory):
        (a,) = stubs(1)
        router, base = router_factory([a.url], hedge_enabled=False)
        router.eject_after = 10**6  # pin admission states for the test
        with router._lock:
            router._replicas[0].state = EJECTED
        status, body, hdrs = call("POST", base + "/queries.json", {"q": 1})
        assert status == 503 and "Retry-After" in hdrs
        status, body, _ = call("GET", base + "/readyz")
        assert status == 503 and body["available"] == 0

    def test_all_replicas_failing_transport_returns_502(self, router_factory):
        (dead,) = free_ports(1)
        router, base = router_factory(
            [f"http://127.0.0.1:{dead}"], hedge_enabled=False
        )
        router.eject_after = 10**6
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 502
        assert "failed" in body["message"]


# -- per-replica breakers ---------------------------------------


class TestBreakerIndependence:
    def test_open_breaker_on_one_replica_never_gates_another(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        a.fail_status = 500  # replica A is broken at the HTTP level
        router, base = router_factory([a.url, b.url], hedge_enabled=False)
        router.eject_after = 10**6  # health probes stay green anyway
        for _ in range(30):
            status, body, _ = call("POST", base + "/queries.json", {"q": 1})
            # every 500 from A is retried onto B: the client never sees it
            assert status == 200 and body["who"] == b.url
        by_url = {
            r["url"]: r for r in router.stats()["replicas"]
        }
        assert by_url[a.url]["breaker"]["open_count"] >= 1
        # THE invariant: A's breaker opened, B's never moved
        assert by_url[b.url]["breaker"]["state"] == "closed"
        assert by_url[b.url]["breaker"]["consecutive_failures"] == 0
        # once OPEN, A stops absorbing picks (bounded by the threshold
        # plus at most a couple of half-open probes)
        assert a.queries <= 10
        assert b.queries >= 30

    def test_pick_skips_open_breaker_without_burning_probe_slots(self):
        router = Router(
            ["http://127.0.0.1:1", "http://127.0.0.1:2"], telemetry=False
        )
        rep_a, rep_b = router._replicas
        for _ in range(rep_a.breaker.failure_threshold):
            rep_a.breaker.record_failure()
        assert rep_a.breaker.stats()["state"] == "open"
        with router._lock:
            picked = router._pick_locked(set())
        assert picked is rep_b
        assert rep_b.breaker.stats()["state"] == "closed"


# -- hedged requests --------------------------------------------


class TestHedging:
    def test_hedge_fires_and_wins_on_slow_primary(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        a.delay_s = 3.0  # primary (first pick on an idle fleet) is slow
        router, base = router_factory([a.url, b.url], hedge_enabled=True)
        router._hedge_delay_ms = 30.0
        t0 = time.monotonic()
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        wall = time.monotonic() - t0
        assert status == 200 and body["who"] == b.url
        assert wall < 2.9  # the hedge answered; nobody waited out A
        snap = router.counters.snapshot()
        assert snap["hedges_fired"] >= 1
        assert snap["hedges_won"] >= 1

    def test_retry_budget_caps_hedges_under_sustained_overload(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        a.delay_s = b.delay_s = 0.08  # EVERY request crosses the trigger
        router, base = router_factory([a.url, b.url], hedge_enabled=True)
        router._hedge_delay_ms = 10.0
        router.budget = RetryBudget(ratio=0.05, cap=1.0)
        for _ in range(20):
            status, _, _ = call("POST", base + "/queries.json", {"q": 1})
            assert status == 200
        snap = router.counters.snapshot()
        # ratio 0.05 over 20 attempts funds ~1 extra hedge beyond the
        # initial token — sustained overload cannot double traffic
        assert snap["hedges_fired"] <= 3
        assert snap["hedges_denied"] >= 15

    def test_connection_failure_retries_free_of_budget(
        self, stubs, router_factory
    ):
        (live,) = stubs(1)
        (dead,) = free_ports(1)
        router, base = router_factory(
            [f"http://127.0.0.1:{dead}", live.url], hedge_enabled=False
        )
        router.eject_after = 10**6  # keep the dead replica pickable
        for _ in range(5):
            status, body, _ = call("POST", base + "/queries.json", {"q": 1})
            assert status == 200 and body["who"] == live.url
        assert router.counters.get("retries") >= 1
        # transport failures consumed NO budget: absorbing a dead replica
        # is the availability contract, not retry amplification
        assert router.budget.tokens() == router.budget.cap


# -- health gate: ejection, readmission, outliers -----------------------------


class TestHealthGate:
    def test_unready_replica_ejected_then_readmitted_with_slow_start(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        router, base = router_factory([a.url, b.url], fast_health=True)
        a.ready = False
        wait_until(
            lambda: router.stats()["replicas"][0]["state"] == EJECTED,
            timeout=5.0, msg="unready replica never ejected",
        )
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 200 and body["who"] == b.url
        assert router.counters.get("ejections_health") >= 1
        a.ready = True
        wait_until(
            lambda: router.stats()["replicas"][0]["state"] == ADMITTED,
            timeout=5.0, msg="recovered replica never re-admitted",
        )
        assert router.counters.get("readmissions") >= 1
        # fresh admission ramps: weight starts low and ewma history is gone
        rep = router.stats()["replicas"][0]
        assert rep["weight"] <= 1.0 and rep["ewmaMs"] is None

    def test_ready_but_cold_replica_not_admitted(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        a.warm = False  # /readyz 200 but fastpathWarm false
        router, base = router_factory([a.url, b.url], fast_health=True)
        wait_until(
            lambda: router.stats()["replicas"][0]["state"] == EJECTED,
            timeout=5.0, msg="cold replica never ejected",
        )
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 200 and body["who"] == b.url

    def test_latency_outlier_ejected_while_readyz_green(
        self, stubs, router_factory
    ):
        a, b, c = stubs(3)
        a.delay_s = 0.15  # wedged-but-listening: readyz stays green
        router, base = router_factory(
            [a.url, b.url, c.url], fast_health=True, hedge_enabled=False
        )
        router.outlier_min_samples = 5
        router.outlier_ratio = 2.0
        router.outlier_cooldown_s = 30.0  # pin the ejection for assertions
        stop = threading.Event()

        def fire():
            while not stop.is_set():
                call("POST", base + "/queries.json", {"q": 1})

        threads = [threading.Thread(target=fire) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            wait_until(
                lambda: router.counters.get("ejections_outlier") >= 1,
                timeout=10.0, msg="latency outlier never ejected",
            )
        finally:
            stop.set()
            for t in threads:
                t.join(5.0)
        rep = router.stats()["replicas"][0]
        assert rep["state"] == EJECTED
        assert router.available_count() == 2


class TestRollSurvivor:
    """A roll of a two-replica fleet drains one replica at the router while
    it restarts, so the other carries every client alone. A survivor that
    still answers queries but whose /readyz answers only after
    ``probe_timeout_ms`` (busy under that load) stays admitted: health
    ejection keeps the last admitted replica on a probe timeout, as outlier
    ejection always has. A refusal or a 503 from /readyz still ejects it."""

    def _roll_one(self, stubs, router_factory):
        a, b = stubs(2)
        router, base = router_factory([a.url, b.url], fast_health=True)
        router.set_replica_draining(a.url, True)  # a restarts
        assert router.available_count() == 1
        return a, b, router, base

    def test_stalled_readyz_keeps_the_last_admitted_replica(
        self, stubs, router_factory
    ):
        a, b, router, base = self._roll_one(stubs, router_factory)
        b.readyz_delay_s = 3 * router.probe_timeout_ms / 1e3
        start = b.readyz_calls
        wait_until(
            lambda: b.readyz_calls - start >= router.eject_after + 1,
            timeout=20.0, msg="the survivor was never probed",
        )
        assert router.stats()["replicas"][1]["state"] == ADMITTED
        assert router.counters.get("ejections_health") == 0
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 200 and body["who"] == b.url
        b.readyz_delay_s = 0.0

    @pytest.mark.parametrize("fault", ["unready", "refused"])
    def test_a_refusal_still_ejects_the_last_admitted_replica(
        self, stubs, router_factory, fault
    ):
        a, b, router, base = self._roll_one(stubs, router_factory)
        if fault == "unready":
            b.ready = False  # /readyz answers 503
        else:
            b.stop()  # the port refuses connections
        wait_until(
            lambda: router.stats()["replicas"][1]["state"] == EJECTED,
            timeout=10.0, msg="the refusing survivor was never ejected",
        )
        assert router.counters.get("ejections_health") >= 1
        status, _, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 503


# -- fleet supervisor ---------------------------------------------------------


class TestFleetSupervisor:
    def test_crashed_child_restarted_with_backoff(self, monkeypatch):
        monkeypatch.setenv("PIO_FLEET_RESTART_BACKOFF_S", "0.1")
        monkeypatch.setenv("PIO_FLEET_RESTART_BACKOFF_MAX_S", "1.0")
        (port,) = free_ports(1)

        def spawn(p):
            return subprocess.Popen(
                [sys.executable, "-c", "import time; time.sleep(600)"]
            )

        fleet = FleetSupervisor(spawn, [port])
        fleet.stop_timeout_s = 0.5  # the sleeper has no /stop to honor
        fleet.start()
        try:
            st = fleet.status()["replicas"][0]
            assert st["alive"] and st["restarts"] == 0
            os.kill(st["pid"], signal.SIGKILL)
            wait_until(
                lambda: fleet.status()["replicas"][0]["restarts"] == 1
                and fleet.status()["replicas"][0]["alive"],
                timeout=5.0, msg="child never restarted after kill -9",
            )
            # a second crash restarts again (backoff grows, stays bounded)
            os.kill(fleet.status()["replicas"][0]["pid"], signal.SIGKILL)
            wait_until(
                lambda: fleet.status()["replicas"][0]["restarts"] == 2
                and fleet.status()["replicas"][0]["alive"],
                timeout=5.0, msg="child never restarted a second time",
            )
            with fleet._lock:
                assert 0.0 < fleet._procs[0].backoff_s <= 1.0
        finally:
            fleet.stop()
        st = fleet.status()["replicas"][0]
        assert not st["alive"]


# -- elastic replica set at the router -----------------------------


class TestElasticRouter:
    def test_add_replica_admits_through_health_gate(
        self, stubs, router_factory
    ):
        a, b = stubs(2)
        router, base = router_factory([a.url], fast_health=True)
        assert router.add_replica(b.url) is True
        # a duplicate registration is refused, not doubled
        assert router.add_replica(b.url + "/") is False
        by_url = {r["url"]: r for r in router.stats()["replicas"]}
        # scale-up replicas start EJECTED: no traffic before the probe
        assert by_url[b.url]["state"] == EJECTED
        wait_until(
            lambda: {
                r["url"]: r for r in router.stats()["replicas"]
            }[b.url]["state"] == ADMITTED,
            timeout=5.0, msg="scale-up replica never admitted",
        )
        # fresh admission rides slow start, weight ramping from 10%
        assert by_url[b.url]["weight"] <= 1.0

    def test_remove_replica_deregisters(self, stubs, router_factory):
        a, b = stubs(2)
        router, base = router_factory([a.url, b.url])
        assert router.remove_replica(b.url) is True
        assert [r["url"] for r in router.stats()["replicas"]] == [a.url]
        assert router.remove_replica(b.url) is False
        # traffic keeps flowing on the survivor
        status, body, _ = call("POST", base + "/queries.json", {"q": 1})
        assert status == 200 and body["who"] == a.url

    def test_signals_snapshot_shape(self, stubs, router_factory):
        a, b = stubs(2)
        router, _ = router_factory([a.url, b.url], start=False)
        sig = router.signals()
        assert sig["replicas"] == 2 and sig["admitted"] == 2
        assert sig["inflight"] == 0 and sig["rolling"] is False
        assert sorted(sig["admittedUrls"]) == sorted([a.url, b.url])
        assert sig["replicaMaxInflight"] >= 1
        assert "shed" in sig["counters"]

    def test_retry_after_scales_with_queue_depth(
        self, stubs, router_factory
    ):
        a, = stubs(1)
        router, _ = router_factory([a.url], start=False)
        router.shed_retry_after_s = 1.0
        router.replica_max_inflight = 10
        # idle fleet: the hint is the base
        assert router._retry_after_s() == 1.0
        # 3x oversubscribed: the hint scales with load
        with router._lock:
            router._replicas[0].inflight = 30
        assert router._retry_after_s() == 3.0
        # no admitted replica: the hint is the readmission horizon
        router.health_interval_ms = 1000.0
        router.readmit_after = 4
        with router._lock:
            router._replicas[0].state = EJECTED
        assert router._retry_after_s() == 4.0


# -- autoscaler control loop ---------------------------------------


class FakeSignalRouter:
    """Router facade: the autoscaler only ever calls ``signals()``."""

    def __init__(self, admitted=2, max_inflight=10):
        self.sig = {
            "replicas": admitted,
            "admitted": admitted,
            "inflight": 0,
            "replicaMaxInflight": max_inflight,
            "admittedUrls": [],
            "counters": {},
            "rolling": False,
        }

    def signals(self):
        return dict(self.sig)


class FakeFleet:
    """Supervisor facade: counts scale ops, never spawns a process."""

    def __init__(self, n=2):
        self.n = n

    def status(self):
        return {
            "replicas": [{"url": f"http://r{i}"} for i in range(self.n)]
        }

    def add_replica(self):
        self.n += 1
        return {"port": 0, "url": f"http://r{self.n}"}

    def remove_replica(self, url=None):
        if self.n == 0:
            return None
        self.n -= 1
        return {"port": 0, "url": f"http://r{self.n}"}


def make_scaler(router, fleet, **overrides):
    sc = Autoscaler(router, fleet)
    sc.min_replicas = 1
    sc.max_replicas = 4
    sc.up_threshold = 0.7
    sc.down_threshold = 0.25
    sc.up_cooldown_s = 5.0
    sc.down_cooldown_s = 10.0
    sc.down_after = 3
    sc.busy_enabled = False
    for k, v in overrides.items():
        setattr(sc, k, v)
    return sc


class TestAutoscaler:
    """Deterministic units: ``tick(now=...)`` with a simulated clock and
    stubbed signals — no threads, no sleeps."""

    def test_scale_up_on_inflight_pressure_with_cooldown(self):
        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = make_scaler(router, fleet)
        router.sig["inflight"] = 20  # capacity 10×2 → pressure 1.0
        assert sc.tick(now=100.0) == "up" and fleet.n == 3
        # inside the up cooldown: pressure alone must not spawn again
        assert sc.tick(now=102.0) == "hold" and fleet.n == 3
        # cooldown expired: still hot → another replica
        assert sc.tick(now=105.5) == "up" and fleet.n == 4
        # hard max bound: never beyond max_replicas
        assert sc.tick(now=120.0) == "hold" and fleet.n == 4
        st = sc.stats()
        assert st["scaleUps"] == 2 and st["scaleDowns"] == 0
        assert st["signals"]["inflight"] == 1.0

    def test_hysteresis_band_holds_and_resets_streak(self):
        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = make_scaler(router, fleet)
        router.sig["inflight"] = 2  # pressure 0.1 ≤ down threshold
        sc.tick(now=10.0)
        sc.tick(now=11.0)
        assert sc.stats()["lowStreak"] == 2
        # mid-band pressure: no decision AND the low streak resets
        router.sig["inflight"] = 10  # pressure 0.5
        assert sc.tick(now=12.0) == "hold"
        assert sc.stats()["lowStreak"] == 0 and fleet.n == 2

    def test_scale_down_needs_streak_then_cooldown(self):
        router, fleet = FakeSignalRouter(admitted=3), FakeFleet(3)
        sc = make_scaler(router, fleet)
        assert sc.tick(now=10.0) == "hold"
        assert sc.tick(now=11.0) == "hold"
        # third consecutive low tick crosses down_after → drain one
        assert sc.tick(now=12.0) == "down" and fleet.n == 2
        # the down cooldown gates the next shrink even at zero pressure
        for t in (13.0, 14.0, 15.0):
            assert sc.tick(now=t) == "hold"
        assert fleet.n == 2
        # past the cooldown with the streak still low → shrink to min
        assert sc.tick(now=23.0) == "down" and fleet.n == 1
        # min bound: never below min_replicas
        for t in (40.0, 41.0, 42.0, 43.0):
            sc.tick(now=t)
        assert fleet.n == 1

    def test_roll_in_progress_holds_everything(self):
        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = make_scaler(router, fleet)
        router.sig["inflight"] = 20  # screaming hot
        router.sig["rolling"] = True
        # never fight a roll: drains look like load, restarts must not
        # race a scale-down
        assert sc.tick(now=50.0) == "hold" and fleet.n == 2
        router.sig["rolling"] = False
        assert sc.tick(now=51.0) == "up" and fleet.n == 3

    def test_shed_rate_signal_uses_counter_deltas(self):
        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = make_scaler(router, fleet, shed_ref=0.05)
        router.sig["counters"] = {"ok": 100, "shed": 0}
        sc.tick(now=10.0)  # baseline tick: deltas are zero
        assert sc.stats()["signals"]["shed"] == 0.0
        # 60 sheds over the next 100 requests: rate 0.6 ≫ shed_ref
        router.sig["counters"] = {"ok": 140, "shed": 60}
        assert sc.tick(now=11.0) == "up"
        assert sc.stats()["signals"]["shed"] == 1.0

    def test_below_min_heals_upward(self):
        router, fleet = FakeSignalRouter(), FakeFleet(1)
        sc = make_scaler(router, fleet, min_replicas=2)
        assert sc.tick(now=10.0) == "up" and fleet.n == 2

    def test_fleet_and_autoscaler_bridges_render(self):
        from predictionio_tpu_torch.obs import bridges as obs_bridges
        from predictionio_tpu_torch.obs import metrics as obs_metrics

        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = make_scaler(router, fleet)
        router.sig["inflight"] = 20
        sc.tick(now=10.0)
        reg = obs_metrics.MetricsRegistry()
        obs_bridges.bridge_autoscaler(reg, sc.stats)
        obs_bridges.bridge_fleet(reg, lambda: {
            "replicas": 3, "alive": 2, "restarts": 5,
            "backoffMs": {"http://r0": 200.0},
            "transitions": {"up": 4, "down": 1},
        })
        series = obs_metrics.parse_prometheus(reg.render_prometheus())
        assert series[("pio_autoscaler_replicas_target", ())] == 3
        assert series[("pio_autoscaler_pressure", ())] == 1.0
        assert series[
            ("pio_autoscaler_signal", (("signal", "inflight"),))
        ] == 1.0
        assert series[
            ("pio_autoscaler_scale_events_total", (("direction", "up"),))
        ] == 1
        assert series[("pio_autoscaler_last_decision", ())] == 1
        assert series[("pio_fleet_replicas", ())] == 3
        assert series[("pio_fleet_replicas_alive", ())] == 2
        assert series[("pio_fleet_restarts_total", ())] == 5
        assert series[
            ("pio_fleet_transitions_total", (("direction", "down"),))
        ] == 1
        assert series[
            ("pio_fleet_replica_backoff_ms", (("replica", "http://r0"),))
        ] == 200.0


# -- roll vs scale-down race ------------------------------


RACE_CHILD = """
import os
import threading
from predictionio_tpu_torch.common.http import HttpService, json_response

svc = HttpService("racechild")

@svc.route("GET", r"/readyz")
def readyz(req):
    return json_response(200, {
        "status": "ready", "generation": 1,
        "fastpathWarm": True, "draining": False,
    })

@svc.route("POST", r"/stop")
def stop(req):
    threading.Timer(0.2, os._exit, args=(0,)).start()
    return json_response(202, {"stopping": True})

svc.start("127.0.0.1", int(os.environ["FLEET_CHILD_PORT"]))
svc.serve_forever()
"""


class TestRollVsScaleDownRace:
    def _spawn(self):
        import predictionio_tpu_torch

        repo_root = os.path.dirname(
            os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + ([env["PYTHONPATH"]]
                           if env.get("PYTHONPATH") else [])
        )

        def spawn(port):
            cenv = dict(env)
            cenv["FLEET_CHILD_PORT"] = str(port)
            return subprocess.Popen(
                [sys.executable, "-c", RACE_CHILD], env=cenv,
            )

        return spawn

    @staticmethod
    def _ready(url):
        try:
            with urllib.request.urlopen(url + "/readyz", timeout=1) as r:
                return r.status == 200
        except OSError:
            return False

    def test_concurrent_roll_and_scale_down_no_double_stop(self):
        """A roll() racing a remove_replica() must neither stop the same
        process twice nor orphan a drained replica: whoever wins the ops
        lock owns the process end to end, the loser skips or retires a
        fully-rolled replica."""
        fleet = FleetSupervisor(self._spawn(), free_ports(2))
        fleet.stop_timeout_s = 5.0
        fleet.roll_timeout_s = 30.0
        fleet.start()
        try:
            for url in fleet.urls():
                wait_until(
                    lambda u=url: self._ready(u), timeout=30.0,
                    msg=f"race child {url} never served /readyz",
                )
            removed = {}

            def do_remove():
                removed["slot"] = fleet.remove_replica()

            t = threading.Thread(target=do_remove, daemon=True)
            t.start()
            report = fleet.roll()
            t.join(30.0)
            assert not t.is_alive()
            # both operations completed without error
            assert removed["slot"] is not None
            assert report["ok"] is True
            # exactly one replica survives, alive and untangled
            st = fleet.status()
            assert len(st["replicas"]) == 1
            surv = st["replicas"][0]
            assert surv["alive"] and not surv["removing"]
            assert not surv["rolling"]
            assert surv["url"] != removed["slot"]["url"]
            # the retired process is really gone (nothing re-listens)
            assert not self._ready(removed["slot"]["url"])
            # the race resolves cleanly whichever side wins: removal
            # before the roll's snapshot filters the slot out (1 entry);
            # removal mid-roll makes the roll skip it (2 entries, one
            # marked skipped); removal after leaves 2 plain entries.
            # Whatever the interleaving, nothing is ever double-stopped.
            assert len(report["replicas"]) in (1, 2)
            for e in report["replicas"]:
                if e.get("skipped"):
                    assert e["url"] == removed["slot"]["url"]
            assert st["transitions"]["down"] >= 1
            # nothing removable left mid-roll is a clean None, not a crash
            with fleet._lock:
                fleet._procs[0].expected_down = True
            assert fleet.remove_replica() is None
            with fleet._lock:
                fleet._procs[0].expected_down = False
        finally:
            fleet.stop()


# -- the autoscaler's decisions equal the JAX package's ------------------------


def _jax_scaler(router, fleet, **overrides):
    from predictionio_tpu.serving.autoscaler import Autoscaler as JaxAutoscaler

    sc = JaxAutoscaler(router, fleet)
    for k, v in dict(min_replicas=1, max_replicas=4, up_threshold=0.7, down_threshold=0.25,
                     up_cooldown_s=5.0, down_cooldown_s=10.0, down_after=3,
                     busy_enabled=False, **overrides).items():
        setattr(sc, k, v)
    return sc


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_autoscaler_decisions_equal_jax(seed):
    """Exact: 200 ticks of seeded signals (inflight, sheds, hedges, tenant
    pressure, rolls) on one simulated clock give the same decisions, the
    same replica counts and the same stats in both packages."""
    rng = np.random.default_rng(seed)
    steps = []
    counters = {"ok": 0, "shed": 0, "hedges_fired": 0}
    for step in range(200):
        quiet = (step // 25) % 2 == 1  # alternating busy and quiet phases
        counters = {k: v + (int(rng.integers(20, 40)) if k == "ok"
                            else 0 if quiet else int(rng.integers(0, 4)))
                    for k, v in counters.items()}
        sig = {"inflight": int(rng.integers(0, 3 if quiet else 45)), "counters": dict(counters),
               "rolling": bool(rng.random() < 0.05)}
        if rng.random() < 0.3:
            sig["tenantPressure"] = float(rng.random() * (0.2 if quiet else 1.0))
        steps.append((float(rng.uniform(0.2, 3.0)), sig))
    out = {}
    for name in ("jax", "port"):
        router, fleet = FakeSignalRouter(), FakeFleet(2)
        sc = (_jax_scaler(router, fleet, shed_ref=0.05, hedge_ref=0.5) if name == "jax"
              else make_scaler(router, fleet, shed_ref=0.05, hedge_ref=0.5))
        now, trace = 100.0, []
        for dt_s, sig in steps:
            now += dt_s
            router.sig.update(sig)
            router.sig["admitted"] = fleet.n
            trace.append((sc.tick(now=now), fleet.n, sc.stats()["pressure"]))
        out[name] = (trace, sc.stats())
    assert out["port"] == out["jax"]
    decisions = [d for d, _, _ in out["port"][0]]
    assert "up" in decisions and "down" in decisions


# -- kill-9 + rolling-deploy chaos (real port replicas on the CPU) -------------


CHILD = """
import os
import sys
sys.modules["jax"] = None  # the replica is the port alone
from predictionio_tpu_torch.data import store as store_mod
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.serving.query_server import QueryServer
from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

storage = Storage()
store_mod.set_storage(storage)
qs = QueryServer(
    RecommendationEngine.apply(), storage=storage,
    ctx=DeviceContext.create(device="cpu"), telemetry=False, batching=True,
)
qs.start("127.0.0.1", int(os.environ["FLEET_CHILD_PORT"]))
qs.service.serve_forever()
"""


def publish(storage, seed):
    """A COMPLETED ALS instance of seeded random factors (20 users, 16
    items) through the port's sealed blob; returns its id."""
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage import base
    from predictionio_tpu_torch.models.als import als_model_from_arrays
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    rng = np.random.default_rng(seed)
    model = als_model_from_arrays(
        rng.normal(size=(20, 4)).astype(np.float32), rng.normal(size=(16, 4)).astype(np.float32),
        [f"u{i}" for i in range(20)], [f"i{i}" for i in range(16)])
    engine = RecommendationEngine.apply()
    params = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 4}}]})
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = base.EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="f", **params.to_json_strings())
    iid = instances.insert(inst)
    raw = persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                       [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(base.Model(id=iid, models=persistence.seal_model_blob(raw)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


@pytest.fixture()
def fleet_env(tmp_path, monkeypatch):
    """Sqlite storage shared between this process (publishing) and the
    replica subprocesses (serving), plus a publisher of new generations."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.storage.sqlite import close_db

    src = "FLEET"
    db = str(tmp_path / "events.sqlite")
    storage_env = {
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "sqlite",
        f"PIO_STORAGE_SOURCES_{src}_PATH": db,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
    }
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__)))
    child_env = dict(os.environ)
    for k in ("PIO_FAULT_SPEC", "PIO_TENANTS", "PIO_PIPELINE", "PIO_PIN_INSTANCE"):
        child_env.pop(k, None)
    child_env.update(storage_env)
    child_env["PIO_FS_BASEDIR"] = str(tmp_path / "fs")
    child_env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([child_env["PYTHONPATH"]] if child_env.get("PYTHONPATH") else []))
    storage = Storage(env=storage_env)
    seeds = iter(range(100))
    publish(storage, next(seeds))
    yield {"child_env": child_env, "train": lambda: publish(storage, next(seeds))}
    close_db(db)


def _boot_fleet(child_env, n=3, child=CHILD):
    """Router + supervisor over n replica subprocesses; returns (router,
    fleet, base_url). The caller shuts down via router.shutdown()."""
    ports = free_ports(n)

    def spawn(port):
        cenv = dict(child_env)
        cenv["FLEET_CHILD_PORT"] = str(port)
        return subprocess.Popen([sys.executable, "-c", child], env=cenv)

    router = Router([f"http://127.0.0.1:{p}" for p in ports], telemetry=False)
    router.health_interval_ms = 100.0
    router.eject_after = 2
    router.readmit_after = 2
    router.slow_start_s = 0.5
    fleet = FleetSupervisor(spawn, ports, router=router)
    fleet.restart_backoff_s = 0.2
    router.attach_fleet(fleet)
    fleet.start()
    port = router.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"

    # replicas start ADMITTED (optimistic) and are ejected within a couple
    # of probe cycles while the children boot; wait for PROVEN readiness
    # (a successful probe records the replica's generation)
    def _proven_ready():
        return all(r["state"] == ADMITTED and r["generation"] is not None
                   for r in router.stats()["replicas"])

    wait_until(_proven_ready, timeout=120.0,
               msg=f"fleet never reached {n} probed-and-admitted replicas")
    return router, fleet, base


class _LoadGen:
    """Closed-loop load workers that tally every client-visible outcome."""

    def __init__(self, base, workers=6):
        self.base = base
        self.stop_evt = threading.Event()
        self.lock = threading.Lock()
        self.ok = 0
        self.failures = []
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(workers)]

    def _run(self, idx):
        i = 0
        while not self.stop_evt.is_set():
            user = f"u{(i * 7 + idx) % 20}"
            try:
                status, body, _ = call("POST", self.base + "/queries.json",
                                       {"user": user, "num": 3}, timeout=30)
            except OSError as e:
                with self.lock:
                    self.failures.append(("exception", str(e)))
                continue
            with self.lock:
                if status == 200:
                    self.ok += 1
                else:
                    self.failures.append((status, body))
            i += 1

    def start(self):
        for t in self.threads:
            t.start()

    def stop(self):
        self.stop_evt.set()
        for t in self.threads:
            t.join(30.0)


@pytest.mark.chaos
class TestFleetChaos:
    def test_kill9_one_replica_under_load_zero_client_failures(self, fleet_env):
        router, fleet, base = _boot_fleet(fleet_env["child_env"], n=3)
        try:
            load = _LoadGen(base)
            load.start()
            try:
                wait_until(lambda: load.ok >= 30, timeout=30.0, msg="load never got going")
                victim = fleet.status()["replicas"][0]
                os.kill(victim["pid"], signal.SIGKILL)
                # keep the pressure on across the death and the ejection
                wait_until(lambda: fleet.status()["replicas"][0]["restarts"] >= 1,
                           timeout=30.0, msg="killed replica never respawned")
                seen = load.ok
                wait_until(lambda: load.ok >= seen + 50, timeout=30.0,
                           msg="load stalled after the kill")
            finally:
                load.stop()
            assert load.failures == []  # THE acceptance line
            assert load.ok > 80
            # the fleet self-heals: respawned, warm, re-admitted
            wait_until(lambda: router.available_count() == 3, timeout=60.0,
                       msg="fleet never healed back to 3 admitted")
            assert router.counters.get("retries") >= 1
        finally:
            router.shutdown()

    def test_rolling_deploy_under_load_zero_5xx(self, fleet_env):
        router, fleet, base = _boot_fleet(fleet_env["child_env"], n=3)
        try:
            old_pids = [r["pid"] for r in fleet.status()["replicas"]]
            new_iid = fleet_env["train"]()  # the generation the roll deploys
            load = _LoadGen(base)
            load.start()
            try:
                wait_until(lambda: load.ok >= 30, timeout=30.0, msg="load never got going")
                status, body, _ = call("POST", base + "/fleet/roll", {})
                assert status == 202
                wait_until(lambda: call("GET", base + "/fleet")[1]["rolling"] is False,
                           timeout=120.0, msg="roll never finished")
            finally:
                load.stop()
            assert load.failures == []  # zero 5xx during the roll
            assert load.ok > 80
            st = fleet.status()["replicas"]
            assert all(a != b for a, b in zip(old_pids, [r["pid"] for r in st]))
            assert all(r["alive"] for r in st)
            assert router.available_count() == 3
            # every replica serves the NEW engine instance
            for r in st:
                _, info, _ = call("GET", r["url"] + "/")
                assert info["engineInstanceId"] == new_iid
        finally:
            router.shutdown()

    def test_autoscale_with_preemption_zero_client_failures(self, fleet_env, monkeypatch):
        """The elastic acceptance line, on its deterministic core: scripted
        pressure scales the fleet up through ``tick(now=...)``, a seeded
        ``crash:fleet:replica`` plan SIGKILLs the victim the seed names
        through the supervisor's preemption point while the surge replica
        is still warming, and once the pressure drops the surge replica
        drains back out — with zero client-visible failures throughout."""
        monkeypatch.setenv("PIO_FLEET_RESTART_BACKOFF_S", "0.2")
        router, fleet, base = _boot_fleet(fleet_env["child_env"], n=2)
        scaler = Autoscaler(router, fleet)
        scaler.min_replicas, scaler.max_replicas = 2, 3
        scaler.up_threshold, scaler.down_threshold = 0.7, 0.25
        scaler.up_cooldown_s, scaler.down_cooldown_s, scaler.down_after = 1.0, 1.0, 2
        scaler.busy_enabled = False
        router.attach_autoscaler(scaler)
        pressure = {"inflight": 1.0}
        monkeypatch.setattr(scaler, "_signals", lambda: {
            "rolling": False, "signals": {"inflight": pressure["inflight"]}})
        plan = faults.FaultPlan(
            [faults.FaultRule(site=PREEMPT_SITE, kind="crash", times=1)], seed=3)
        try:
            load = _LoadGen(base)
            load.start()
            try:
                wait_until(lambda: load.ok >= 30, timeout=30.0, msg="load never got going")
                assert scaler.tick(now=10.0) == "up"
                assert len(fleet.status()["replicas"]) == 3
                # preemption mid-scale-up: the monitor's next tick fires the
                # seeded plan, whose victim is a pure function of the seed
                # and the sorted live pids
                import random

                before = {r["url"]: r["pid"] for r in fleet.status()["replicas"]}
                pids = sorted(before.values())
                want = pids[random.Random(f"{plan.seed}:0:0:victim").randrange(len(pids))]
                faults.install(plan)
                wait_until(lambda: plan.stats()["rules"][0]["fired"] == 1, timeout=10.0,
                           msg="preemption never fired")
                faults.clear()
                wait_until(lambda: any(r["pid"] != before[r["url"]]
                                       for r in fleet.status()["replicas"]),
                           timeout=30.0, msg="preempted replica never respawned")
                killed = [pid for url, pid in before.items()
                          if {r["url"]: r["pid"] for r in fleet.status()["replicas"]}[url] != pid]
                assert killed == [want]
                wait_until(lambda: all(r["alive"] for r in fleet.status()["replicas"])
                           and router.available_count() == 3,
                           timeout=60.0, msg="preempted replica never came back")
                pressure["inflight"] = 0.0
                assert [scaler.tick(now=t) for t in (12.0, 13.0)] == ["hold", "down"]
                assert len(fleet.status()["replicas"]) == 2
                seen = load.ok
                wait_until(lambda: load.ok >= seen + 30, timeout=30.0,
                           msg="load stalled after the scale-down")
            finally:
                load.stop()
            assert load.failures == []  # THE acceptance line
            st = scaler.stats()
            assert st["scaleUps"] == 1 and st["scaleDowns"] == 1
            _, body, _ = call("GET", base + "/fleet")
            assert body["autoscaler"]["scaleUps"] == 1 and body["autoscaler"]["minReplicas"] == 2
        finally:
            faults.clear()
            scaler.stop()
            router.shutdown()
