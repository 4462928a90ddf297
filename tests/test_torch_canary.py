"""The port's SLO-guarded canary rollout (serving/canary.py).

Counterpart of ``tests/test_canary.py`` against the port's modules; the
kill -9 children import the port with jax blocked. Held against the JAX
package: quarantine receipts and the canary journal written by either
package are read by the other (one envelope, one layout), newest-COMPLETED
selection skips a receipt the other package wrote, and ``topk_overlap``
equals the JAX function on seeded answer pairs (exact).

Covers the durable quarantine receipts (checksum envelope, fail-safe
torn reads, operator release), quarantine-aware newest-COMPLETED
selection and replica hot-swap pinning, the controller state machine
(verify -> promote -> soak, breach -> rollback + receipt, operator
abort), split-brain fencing, journal-driven resume, and — under
``@pytest.mark.chaos`` — real kill -9 crashes at the two compiled-in
canary sites proving the fleet lands consistent and the quarantine
verdict is never lost.
"""

import datetime as dt
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from predictionio_tpu_torch.common import faults
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.serving.canary import (
    IDLE,
    PROMOTING,
    ROLLING_BACK,
    SOAKING,
    VERIFYING,
    CanaryController,
    FencedError,
    _topk_overlap,
)

CRASH_RC = 137


# ---------------------------------------------------------------------------
# fakes
# ---------------------------------------------------------------------------


class FakeRouter:
    """The slice of Router the controller consumes: replica view,
    per-generation attribution, shadow capture."""

    def __init__(self, replicas):
        self.replicas = replicas  # list of {url, state, instanceId}
        self.gens = {}
        self.capture = None
        self.shadow_bodies = []

    def replica_view(self):
        return [dict(r) for r in self.replicas]

    def generation_stats(self):
        return {k: dict(v) for k, v in self.gens.items()}

    def set_shadow_capture(self, on):
        self.capture = bool(on)

    def take_shadow_samples(self, n):
        out, self.shadow_bodies = self.shadow_bodies[:n], self.shadow_bodies[n:]
        return out


class FakeFleet:
    def __init__(self):
        self.pin = "UNSET"
        self.protected = {}

    def set_spawn_pin(self, instance_id):
        self.pin = instance_id

    def protect_replica(self, url, on):
        self.protected[url] = bool(on)


class FakeStorage:
    """get_completed newest-first over a fixed id list."""

    def __init__(self, ids_newest_first):
        self._ids = list(ids_newest_first)

    def get_meta_data_engine_instances(self):
        outer = self

        class _Insts:
            def get_completed(self, *a):
                class _I:
                    def __init__(self, iid):
                        self.id = iid

                return [_I(i) for i in outer._ids]

        return _Insts()


def three_replica_router():
    return FakeRouter([
        {"url": "http://a", "state": "admitted", "instanceId": "g1"},
        {"url": "http://b", "state": "admitted", "instanceId": "g1"},
        {"url": "http://c", "state": "admitted", "instanceId": "g1"},
    ])


def make_controller(router, fleet=None, storage=None, worker=False):
    """Controller with the HTTP hot-swap replaced by a recorder that
    also mutates the fake replica view (so promotion/rollback are
    observable), and — unless ``worker`` — the background thread
    suppressed so ticks run synchronously and deterministically."""
    c = CanaryController(router, fleet=fleet, storage=storage)
    reloads = []

    def fake_reload(url, iid, force=False):
        reloads.append((url, iid))
        for r in router.replicas:
            if r["url"] == url:
                r["instanceId"] = iid

    c._reload_replica = fake_reload
    c.reloads = reloads
    if not worker:
        c._spawn_worker = lambda soak_only=False: None
    return c


HEALTHY_GENS = {
    "g2": {"requests": 20, "errors": 0, "errorRate": 0.0,
           "p99Ms": 50.0, "latencySamples": 20},
    "g1": {"requests": 100, "errors": 0, "errorRate": 0.0,
           "p99Ms": 40.0, "latencySamples": 100},
}


@pytest.fixture()
def canary_env(tmp_path, monkeypatch):
    """Isolated on-disk root + fast knobs; no fault plan leakage."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    monkeypatch.setenv("PIO_CANARY_TICK_MS", "10")
    monkeypatch.setenv("PIO_CANARY_MIN_SAMPLES", "5")
    monkeypatch.setenv("PIO_CANARY_WINDOW_S", "0")
    monkeypatch.setenv("PIO_CANARY_SOAK_S", "0")
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faults.install(None)
    yield tmp_path
    faults.install(None)


# ---------------------------------------------------------------------------
# quarantine receipts (core/persistence)
# ---------------------------------------------------------------------------


def test_quarantine_receipt_roundtrip(canary_env):
    assert persistence.read_quarantine_receipts() == []
    path = persistence.write_quarantine_receipt("g2", "p99 breach", epoch=3)
    assert os.path.exists(path)
    assert persistence.is_quarantined("g2")
    assert not persistence.is_quarantined("g1")
    (rec,) = persistence.read_quarantine_receipts()
    assert rec["instanceId"] == "g2"
    assert rec["reason"] == "p99 breach"
    assert rec["epoch"] == 3
    # idempotent: resume() re-issues the write after a crash
    persistence.write_quarantine_receipt("g2", "p99 breach", epoch=3)
    assert persistence.quarantined_instance_ids() == {"g2"}
    # operator release
    assert persistence.clear_quarantine("g2") is True
    assert not persistence.is_quarantined("g2")
    assert persistence.clear_quarantine("g2") is False


def test_torn_receipt_fails_safe(canary_env):
    """A receipt that loses its checksum envelope must BLOCK its id,
    not re-admit it."""
    path = persistence.write_quarantine_receipt("g9", "bad")
    with open(path, "r+b") as f:
        f.write(b"XXXX")  # stomp the magic
    (rec,) = persistence.read_quarantine_receipts()
    assert rec["instanceId"] == "g9"
    assert rec["reason"] == "unreadable-receipt"
    assert "g9" in persistence.quarantined_instance_ids()


@pytest.fixture()
def storage(tmp_path):
    """A port MEMORY store of its own."""
    import uuid

    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.registry import Storage

    name = "CN" + uuid.uuid4().hex[:8].upper()
    yield Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })
    memory.reset_store(name)


def test_selection_skips_quarantined(canary_env, storage):
    from predictionio_tpu_torch.core.workflow import get_latest_completed_instance
    from predictionio_tpu_torch.data.storage.base import EngineInstance

    insts = storage.get_meta_data_engine_instances()
    when = dt.datetime(2026, 1, 1)
    ids = []
    for i in range(3):
        ids.append(insts.insert(EngineInstance(
            id="", status=insts.STATUS_COMPLETED,
            start_time=when + dt.timedelta(hours=i),
            end_time=when + dt.timedelta(hours=i, minutes=5),
            engine_id="default", engine_version="default",
            engine_variant="default", engine_factory="f",
        )))
    assert get_latest_completed_instance(storage).id == ids[2]
    persistence.write_quarantine_receipt(ids[2], "canary rollback")
    assert get_latest_completed_instance(storage).id == ids[1]
    persistence.write_quarantine_receipt(ids[1], "canary rollback")
    assert get_latest_completed_instance(storage).id == ids[0]


# ---------------------------------------------------------------------------
# top-k overlap
# ---------------------------------------------------------------------------


def test_topk_overlap():
    def resp(*items):
        return {"itemScores": [{"item": i, "score": 1.0} for i in items]}

    assert _topk_overlap(resp("a", "b", "c"), resp("a", "b", "c")) == 1.0
    assert _topk_overlap(resp("x", "y"), resp("a", "b")) == 0.0
    assert _topk_overlap(resp("a", "x"), resp("a", "b")) == 0.5
    # only each side's top-k participates
    cand = resp(*[f"c{i}" for i in range(10)] + ["hit"])
    base = resp("hit")
    assert _topk_overlap(cand, base) == 0.0
    # unrankable answers contribute nothing, not a zero
    assert _topk_overlap({}, resp("a")) is None
    assert _topk_overlap(resp("a"), {"itemScores": []}) is None


# ---------------------------------------------------------------------------
# controller state machine (synchronous ticks over fakes)
# ---------------------------------------------------------------------------


def test_start_canary_swaps_one_replica_and_arms_exclusions(canary_env):
    router = three_replica_router()
    fleet = FakeFleet()
    c = make_controller(router, fleet=fleet, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary() is True
    # exactly ONE replica (the last admitted) runs the candidate
    assert c.reloads == [("http://c", "g2")]
    assert [r["instanceId"] for r in router.replicas] == ["g1", "g1", "g2"]
    assert c.stats()["state"] == VERIFYING
    # autoscaler mutual exclusion: scale-ups pinned to the baseline,
    # the canary replica protected from scale-down, shadow capture on
    assert fleet.pin == "g1"
    assert fleet.protected["http://c"] is True
    assert router.capture is True
    # a second canary is refused while one is in flight
    assert c.start_canary() is False


def test_error_breach_rolls_back_and_quarantines(canary_env):
    router = three_replica_router()
    fleet = FakeFleet()
    c = make_controller(router, fleet=fleet, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    router.gens = {"g2": {"requests": 50, "errors": 25, "errorRate": 0.5}}
    assert c._verify_tick() is True
    st = c.stats()
    assert st["state"] == IDLE
    assert st["lastOutcome"]["outcome"] == "quarantined"
    assert "error rate" in st["lastOutcome"]["reason"]
    # blast radius: only the canary replica ever saw the candidate, and
    # it is back on the baseline
    assert c.reloads == [("http://c", "g2"), ("http://c", "g1")]
    assert persistence.is_quarantined("g2")
    # exclusions dropped
    assert fleet.pin is None
    assert fleet.protected["http://c"] is False
    assert router.capture is False
    assert c.counters.get("rollbacks_verify") == 1
    # the durable receipt blocks a re-deploy: g2 is quarantined and g1
    # is already the baseline, so no candidate remains
    with pytest.raises(ValueError):
        c.start_canary()


def test_pass_promotes_then_soaks_clean(canary_env):
    router = three_replica_router()
    fleet = FakeFleet()
    c = make_controller(router, fleet=fleet, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    router.gens = {k: dict(v) for k, v in HEALTHY_GENS.items()}
    assert c._verify_tick() is False  # promoted; worker would soak next
    assert c.stats()["state"] == SOAKING
    # the remainder of the fleet rolled to the candidate
    assert ("http://a", "g2") in c.reloads
    assert ("http://b", "g2") in c.reloads
    assert all(r["instanceId"] == "g2" for r in router.replicas)
    # exclusions end when the soak starts (the canary window is over)
    assert fleet.pin is None
    # PIO_CANARY_SOAK_S=0: the first soak tick closes clean
    assert c._soak_tick() is True
    st = c.stats()
    assert st["state"] == IDLE
    assert st["lastOutcome"] == {"outcome": "promoted", "candidate": "g2"}
    assert not persistence.is_quarantined("g2")
    assert c.counters.get("promotions") == 1


def test_soak_breach_triggers_fleet_wide_rollback(canary_env):
    router = three_replica_router()
    c = make_controller(router, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    router.gens = {k: dict(v) for k, v in HEALTHY_GENS.items()}
    assert c._verify_tick() is False
    assert c.stats()["state"] == SOAKING
    c.soak_s = 60.0  # hold the watchdog open
    # the promoted generation melts down under full traffic
    router.gens["g2"] = {"requests": 140, "errors": 60, "errorRate": 0.43}
    assert c._soak_tick() is True
    # RUNTIME fleet-wide rollback: every replica back on the baseline
    for url in ("http://a", "http://b", "http://c"):
        assert (url, "g1") in c.reloads
    assert all(r["instanceId"] == "g1" for r in router.replicas)
    assert persistence.is_quarantined("g2")
    assert c.counters.get("rollbacks_soak") == 1
    assert c.stats()["lastOutcome"]["outcome"] == "quarantined"


def test_operator_abort_rolls_back_without_quarantine(canary_env):
    router = three_replica_router()
    c = make_controller(router, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    assert c.request_abort() is True
    assert c._verify_tick() is True
    st = c.stats()
    assert st["state"] == IDLE
    assert st["lastOutcome"]["outcome"] == "aborted"
    # an abort is an operator decision, not an online verdict
    assert not persistence.is_quarantined("g2")
    assert c.counters.get("aborts") == 1
    assert ("http://c", "g1") in c.reloads


def test_shadow_overlap_breach(canary_env):
    router = three_replica_router()
    c = make_controller(router, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    # six captured bodies, every mirrored pair disagrees completely
    router.shadow_bodies = [b"{}"] * 6
    c._serve_shadow_pair = lambda body, cu, bu: 0.0
    router.gens = {"g2": {"requests": 3, "errorRate": 0.0}}
    assert c._verify_tick() is True
    st = c.stats()
    assert st["lastOutcome"]["outcome"] == "quarantined"
    assert "overlap" in st["lastOutcome"]["reason"]
    assert st["shadow"]["spent"] == 6
    assert persistence.is_quarantined("g2")


def test_shadow_fault_site_burns_budget_never_verdict(canary_env):
    """client:canary:shadow failures count as shadow errors; they must
    not fail (or pass) the candidate."""
    router = three_replica_router()
    c = make_controller(router, storage=FakeStorage(["g2", "g1"]))
    assert c.start_canary()
    faults.install(faults.FaultPlan([
        faults.FaultRule(site="client:canary:shadow", kind="error"),
    ]))
    router.shadow_bodies = [b"{}"] * 4
    router.gens = {"g2": {"requests": 1, "errorRate": 0.0}}
    assert c._verify_tick() is False  # still waiting, not a verdict
    st = c.stats()
    assert st["state"] == VERIFYING
    assert st["shadow"]["spent"] == 4
    assert st["shadow"]["pairs"] == 0
    assert c.counters.get("shadow_errors") == 4
    assert not persistence.is_quarantined("g2")


def test_resolve_candidate_skips_quarantined_and_respects_force(canary_env):
    router = three_replica_router()
    c = make_controller(router, storage=FakeStorage(["g3", "g2", "g1"]))
    persistence.write_quarantine_receipt("g3", "failed verification")
    # newest-first walk skips the quarantined head
    assert c._resolve_candidate(None, "g1", False) == "g2"
    with pytest.raises(ValueError):
        c._resolve_candidate("g3", "g1", False)
    assert c._resolve_candidate("g3", "g1", True) == "g3"
    with pytest.raises(ValueError):
        c._resolve_candidate("g1", "g1", False)  # already the baseline


def test_swap_failure_ends_experiment_without_receipt(canary_env):
    router = three_replica_router()
    fleet = FakeFleet()
    c = make_controller(router, fleet=fleet, storage=FakeStorage(["g2", "g1"]))

    def boom(url, iid, force=False):
        raise RuntimeError("replica refused the hot-swap")

    c._reload_replica = boom
    with pytest.raises(RuntimeError):
        c.start_canary()
    assert c.stats()["state"] == IDLE
    # the candidate was never observed under traffic: no quarantine
    assert not persistence.is_quarantined("g2")
    assert fleet.pin is None
    assert router.capture is False


# ---------------------------------------------------------------------------
# fencing + resume
# ---------------------------------------------------------------------------


def test_second_controller_fences_the_first(canary_env):
    router = three_replica_router()
    a = make_controller(router, storage=FakeStorage(["g2", "g1"]))
    assert a.start_canary()  # epoch 1, journal VERIFYING
    # a second controller over the same journal (split brain) resumes:
    # a VERIFYING journal means the old controller died mid-window, so
    # it aborts to baseline without quarantining
    b = make_controller(three_replica_router())
    assert b.resume() == "aborted"
    assert b.counters.get("aborts") == 1
    assert not persistence.is_quarantined("g2")
    # the first controller's next journal write is refused
    with pytest.raises(FencedError):
        a._journal(PROMOTING)
    assert a.counters.get("fenced") == 1


def test_resume_rolling_back_lands_the_receipt(canary_env):
    """A journaled ROLLING_BACK intent (quarantine verdict included) is
    finished by resume even though the receipt never hit the disk."""
    seed = make_controller(three_replica_router())
    seed._epoch, seed._token = 1, "t1"
    seed._candidate, seed._baseline = "g2", "g1"
    seed._canary_url = "http://c"
    seed._promote_urls = ["http://a", "http://b"]
    seed._journal(ROLLING_BACK, reason="error spike", quarantine=True,
                  fleetWide=False)
    router = FakeRouter([
        {"url": "http://a", "state": "admitted", "instanceId": "g1"},
        {"url": "http://b", "state": "admitted", "instanceId": "g1"},
        {"url": "http://c", "state": "admitted", "instanceId": "g2"},
    ])
    c = make_controller(router)
    assert c.resume() == "rolled_back"
    assert persistence.is_quarantined("g2")
    (rec,) = [r for r in persistence.read_quarantine_receipts()
              if r["instanceId"] == "g2"]
    assert rec["reason"] == "error spike"
    assert ("http://c", "g1") in c.reloads
    assert c.stats()["state"] == IDLE
    assert c._epoch == 2  # ownership taken


def test_resume_promoting_finishes_idempotently(canary_env):
    seed = make_controller(three_replica_router())
    seed._epoch, seed._token = 1, "t1"
    seed._candidate, seed._baseline = "g2", "g1"
    seed._canary_url = "http://c"
    seed._promote_urls = ["http://a", "http://b"]
    seed._journal(PROMOTING)
    router = FakeRouter([
        {"url": "http://a", "state": "admitted", "instanceId": "g2"},
        {"url": "http://b", "state": "admitted", "instanceId": "g1"},
        {"url": "http://c", "state": "admitted", "instanceId": "g2"},
    ])
    c = make_controller(router)
    assert c.resume() == "promoted"
    # the whole promote list re-runs (idempotent), covering the replica
    # the dead controller never reached
    assert ("http://a", "g2") in c.reloads
    assert ("http://b", "g2") in c.reloads
    assert all(r["instanceId"] == "g2" for r in router.replicas)
    assert c.stats()["state"] == SOAKING
    assert c._soak_tick() is True
    assert c.stats()["lastOutcome"]["outcome"] == "promoted"


def test_resume_absent_or_idle_journal_is_noop(canary_env):
    c = make_controller(three_replica_router())
    assert c.resume() is None
    c2 = make_controller(three_replica_router(),
                         storage=FakeStorage(["g2", "g1"]))
    assert c2.start_canary()
    router = c2.router
    router.gens = {"g2": {"requests": 50, "errors": 25, "errorRate": 0.5}}
    assert c2._verify_tick() is True  # journal back to IDLE
    c3 = make_controller(three_replica_router())
    assert c3.resume() is None


# ---------------------------------------------------------------------------
# worker thread end-to-end (real ticks, fake fleet)
# ---------------------------------------------------------------------------


def test_worker_thread_drives_verify_promote_soak(canary_env):
    router = three_replica_router()
    router.gens = {k: dict(v) for k, v in HEALTHY_GENS.items()}
    c = make_controller(router, storage=FakeStorage(["g2", "g1"]),
                        worker=True)
    try:
        assert c.start_canary() is True
        deadline = time.monotonic() + 10.0
        while c.active() and time.monotonic() < deadline:
            time.sleep(0.02)
        st = c.stats()
        assert st["state"] == IDLE
        assert st["lastOutcome"] == {"outcome": "promoted",
                                     "candidate": "g2"}
        assert all(r["instanceId"] == "g2" for r in router.replicas)
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# kill -9 chaos at the compiled-in canary sites
# ---------------------------------------------------------------------------


PRELUDE = """
import json, os, sys, time
sys.modules["jax"] = None  # the port alone
from predictionio_tpu_torch.serving import canary as cm

class R:
    def __init__(self):
        self.reps = [
            {"url": "r-a", "state": "admitted", "instanceId": "g1"},
            {"url": "r-b", "state": "admitted", "instanceId": "g1"},
            {"url": "r-c", "state": "admitted", "instanceId": "g2"},
        ]
    def replica_view(self):
        return [dict(r) for r in self.reps]
    def generation_stats(self):
        return {}
    def set_shadow_capture(self, on):
        pass
    def take_shadow_samples(self, n):
        return []

router = R()
ctrl = cm.CanaryController(router)

def _reload(url, iid, force=False):
    with open(os.environ["PROMOTE_LOG"], "a") as f:
        f.write(url + " " + iid + "\\n")
    for r in router.reps:
        if r["url"] == url:
            r["instanceId"] = iid

ctrl._reload_replica = _reload
"""


def run_py(code, env, timeout=60):
    import predictionio_tpu_torch

    env = dict(env)
    root = os.path.dirname(os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join([root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=env, capture_output=True, text=True, timeout=timeout,
    )


def _reload_log(env):
    try:
        with open(env["PROMOTE_LOG"]) as f:
            return [tuple(line.split()) for line in f.read().splitlines()]
    except OSError:
        return []


@pytest.mark.chaos
class TestCanaryChaos:
    @pytest.fixture()
    def chaos_env(self, tmp_path):
        env = dict(os.environ)
        env["PIO_FS_BASEDIR"] = str(tmp_path / "fs")
        env["PIO_CANARY_TICK_MS"] = "10"
        env["PIO_CANARY_SOAK_S"] = "0"
        env["PROMOTE_LOG"] = str(tmp_path / "promotes.log")
        env.pop("PIO_FAULT_SPEC", None)
        return env

    def _journal(self, env):
        key = persistence._engine_key("default", "default", "default")
        path = os.path.join(env["PIO_FS_BASEDIR"], "canary", key,
                            "state.json")
        return json.loads(persistence.open_blob_file(path).decode("utf-8"))

    def _receipt_path(self, env, iid):
        key = persistence._engine_key("default", "default", "default")
        return os.path.join(env["PIO_FS_BASEDIR"], "quarantine", key,
                            f"{iid}.json")

    RESUME = PRELUDE + """
out = ctrl.resume()
deadline = time.time() + 20
while ctrl.active() and time.time() < deadline:
    time.sleep(0.05)
print(json.dumps({"resumed": out, "active": ctrl.active()}))
"""

    def test_kill9_mid_promotion_resumes_to_full_promotion(self, chaos_env):
        code = PRELUDE + """
ctrl._epoch, ctrl._token = 1, "t1"
ctrl._candidate, ctrl._baseline = "g2", "g1"
ctrl._canary_url = "r-c"
ctrl._promote_urls = ["r-a", "r-b"]
ctrl._journal(cm.PROMOTING)
ctrl._promote()
print("UNREACHABLE")
"""
        env = dict(chaos_env)
        # let the first replica promote, die before the second
        env["PIO_FAULT_SPEC"] = (
            "site=crash:canary:mid_promote,kind=crash,times=1,after=1"
        )
        crash = run_py(code, env)
        assert crash.returncode == CRASH_RC, crash.stderr
        assert "UNREACHABLE" not in crash.stdout
        # half-promoted: exactly one replica moved, intent journaled
        assert _reload_log(env) == [("r-a", "g2")]
        disk = self._journal(env)
        assert disk["state"] == PROMOTING
        assert disk["epoch"] == 1
        # a fresh controller (fault cleared = the restarted process)
        # finishes the promotion idempotently and soaks to a clean idle
        resume = run_py(self.RESUME, chaos_env)
        assert resume.returncode == 0, resume.stderr
        out = json.loads(resume.stdout.strip().splitlines()[-1])
        assert out == {"resumed": "promoted", "active": False}
        log = _reload_log(chaos_env)
        assert ("r-b", "g2") in log  # the replica the crash skipped
        disk = self._journal(chaos_env)
        assert disk["state"] == IDLE
        assert disk["outcome"] == "promoted"
        assert disk["epoch"] == 2  # ownership was taken over
        assert not os.path.exists(self._receipt_path(chaos_env, "g2"))

    def test_kill9_before_receipt_still_quarantines(self, chaos_env):
        code = PRELUDE + """
ctrl._epoch, ctrl._token = 1, "t1"
ctrl._candidate, ctrl._baseline = "g2", "g1"
ctrl._canary_url = "r-c"
ctrl._promote_urls = ["r-a", "r-b"]
ctrl._journal(cm.VERIFYING)
ctrl._rollback(reason="error spike", quarantine=True, fleet_wide=False,
               counter=None)
print("UNREACHABLE")
"""
        env = dict(chaos_env)
        env["PIO_FAULT_SPEC"] = (
            "site=crash:canary:before_receipt,kind=crash,times=1"
        )
        crash = run_py(code, env)
        assert crash.returncode == CRASH_RC, crash.stderr
        assert "UNREACHABLE" not in crash.stdout
        # the canary replica already rolled back, the receipt never
        # landed — but the verdict is journaled
        assert _reload_log(env) == [("r-c", "g1")]
        assert not os.path.exists(self._receipt_path(env, "g2"))
        disk = self._journal(env)
        assert disk["state"] == ROLLING_BACK
        assert disk["quarantine"] is True
        assert disk["reason"] == "error spike"
        # resume finishes the rollback AND lands the receipt
        resume = run_py(self.RESUME, chaos_env)
        assert resume.returncode == 0, resume.stderr
        out = json.loads(resume.stdout.strip().splitlines()[-1])
        assert out == {"resumed": "rolled_back", "active": False}
        receipt = self._receipt_path(chaos_env, "g2")
        assert os.path.exists(receipt)
        rec = json.loads(persistence.open_blob_file(receipt).decode("utf-8"))
        assert rec["instanceId"] == "g2"
        assert rec["reason"] == "error spike"
        disk = self._journal(chaos_env)
        assert disk["state"] == IDLE
        assert disk["outcome"] == "quarantined"


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_receipts_cross_packages(canary_env, writer):
    """A receipt either package writes is read, listed and honoured by the
    other: the same envelope under the same path, the same fields; a torn
    one fails safe in both; either package's release clears it."""
    from predictionio_tpu.core import persistence as jax_persistence

    mods = {"jax": jax_persistence, "port": persistence}
    w, r = mods[writer], mods["port" if writer == "jax" else "jax"]
    key = dict(engine_id="eng", engine_version="1", engine_variant="v/a")
    path = w.write_quarantine_receipt("g7", "p99 breach", epoch=4, details={"p99": 12.5}, **key)
    assert path == r.write_quarantine_receipt.__globals__["_receipt_path"](
        r.quarantine_dir(**key), "g7")
    assert r.is_quarantined("g7", **key) and r.quarantined_instance_ids(**key) == {"g7"}
    (got,) = r.read_quarantine_receipts(**key)
    (own,) = w.read_quarantine_receipts(**key)
    assert got == own and got["details"] == {"p99": 12.5} and got["epoch"] == 4
    w.write_quarantine_receipt("g8", "torn", **key)
    with open(w.write_quarantine_receipt.__globals__["_receipt_path"](
            w.quarantine_dir(**key), "g8"), "r+b") as f:
        f.write(b"XXXX")
    assert {"instanceId": "g8", "reason": "unreadable-receipt"} in r.read_quarantine_receipts(**key)
    assert r.clear_quarantine("g7", **key) and not w.is_quarantined("g7", **key)


def test_selection_skips_a_receipt_the_jax_package_wrote(canary_env, storage):
    from predictionio_tpu.core import persistence as jax_persistence
    from predictionio_tpu_torch.core.workflow import get_latest_completed_instance
    from predictionio_tpu_torch.data.storage.base import EngineInstance

    insts = storage.get_meta_data_engine_instances()
    when = dt.datetime(2026, 1, 1)
    ids = [insts.insert(EngineInstance(
        id="", status=insts.STATUS_COMPLETED, start_time=when + dt.timedelta(hours=i),
        end_time=when + dt.timedelta(hours=i, minutes=5), engine_id="default",
        engine_version="default", engine_variant="default", engine_factory="f",
    )) for i in range(2)]
    jax_persistence.write_quarantine_receipt(ids[1], "canary rollback")
    assert get_latest_completed_instance(storage).id == ids[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_overlap_equals_jax(seed):
    from predictionio_tpu.serving.canary import _topk_overlap as jax_overlap

    rng = np.random.default_rng(seed)

    def resp():
        if rng.random() < 0.05:
            return {} if rng.random() < 0.5 else {"itemScores": []}
        n = int(rng.integers(1, 15))
        return {"itemScores": [{"item": f"i{j}", "score": 1.0}
                               for j in rng.choice(25, size=n, replace=False)]}

    pairs = [(resp(), resp(), int(rng.integers(1, 12))) for _ in range(300)]
    assert [_topk_overlap(a, b, k) for a, b, k in pairs] == [jax_overlap(a, b, k) for a, b, k in pairs]


def test_journal_written_by_the_port_resumes_in_jax(canary_env):
    """The canary journal is one sealed blob in one place: a journal the
    port's controller wrote mid-rollback is resumed by the JAX package's
    controller, which lands the receipt the port's selection then honours."""
    from predictionio_tpu.serving import canary as jax_canary

    router = three_replica_router()
    c = make_controller(router)
    c._epoch, c._token = 1, "t1"
    c._candidate, c._baseline, c._canary_url = "g2", "g1", "http://c"
    c._promote_urls = ["http://a", "http://b"]
    c._journal(ROLLING_BACK, quarantine=True, reason="error spike")
    j = jax_canary.CanaryController(router)
    j._reload_replica = lambda url, iid, force=False: None
    assert j.resume() == "rolled_back"
    assert persistence.is_quarantined("g2")
    assert c._read_journal()["state"] == IDLE
