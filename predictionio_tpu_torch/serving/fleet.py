"""Fleet supervisor: replica subprocess lifecycle + zero-downtime rolls.

Counterpart of ``predictionio_tpu/serving/fleet.py``. Each replica is a
process of its own with its own CUDA context, and each launches kernel 1
on the card; the supervisor itself is host code and opens no context.

The :class:`~predictionio_tpu_torch.serving.router.Router` decides where
traffic goes; this module decides which processes exist.  It spawns N
query-server replica subprocesses, restarts crashed ones with
exponential backoff (reset after a healthy period), and orchestrates
**rolling deploys**: one replica at a time it

1. marks the replica draining at the ROUTER (traffic routes away
   first — the replica's own shed path is only the safety net),
2. drains the process through its ``POST /stop`` route,
3. restarts it — the new process deploys the latest COMPLETED model
   generation through the unchanged atomic-publish/LKG machinery,
4. verifies ``GET /readyz`` answers 200 **and warm**
   (``fastpathWarm``), and
5. re-opens the replica at the router (readmission still goes through
   the health gate + slow start), then moves on.

``pio deploy --fleet N`` builds one of these around child ``pio
deploy`` processes; ``pio fleet roll`` triggers ``roll()`` through the
router's ``POST /fleet/roll``.

The fleet is **elastic**: :meth:`add_replica` spawns one
more replica on a freshly allocated port and registers it EJECTED at
the router (admission rides the health gate + slow start), and
:meth:`remove_replica` retires one with the same drain-before-kill
sequence a roll uses.  ``_ops_lock`` serializes rolls against
scale-downs so the same process is never stopped twice and a drained
replica is never orphaned — the roll-vs-scale-down race has dedicated
test coverage.  The monitor loop doubles as the preemption chaos site:
each tick consults ``crash:fleet:replica`` through
:func:`~predictionio_tpu_torch.common.faults.kill_point`, so a seeded fault
plan can SIGKILL a random replica *while* the fleet is scaling.

The supervisor is process-management only: it never sits on the query
path.  Spawning is delegated to a ``spawn_fn(port) -> subprocess.Popen``
so tests can run replicas from a ``python -c`` script and the CLI can
re-exec itself.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from predictionio_tpu_torch.common import faults as _faults

logger = logging.getLogger(__name__)

#: Fault site the monitor loop exposes for preemption chaos: a matching
#: ``crash`` rule SIGKILLs one live replica per firing (seeded victim).
PREEMPT_SITE = "crash:fleet:replica"


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError, TypeError):
        return default


class ReplicaProc:
    """One supervised replica slot.  Fields guarded by the supervisor's
    ``_lock``."""

    def __init__(self, port: int, url: str):
        self.port = port
        self.url = url
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.backoff_s = 0.0
        self.next_restart_at = 0.0
        self.started_at = 0.0
        self.expected_down = False  # a roll is restarting it on purpose
        self.removing = False  # a scale-down is retiring it for good


class FleetSupervisor:
    """Spawn/respawn N replica subprocesses; orchestrate rolling deploys."""

    def __init__(
        self,
        spawn_fn: Callable[[int], subprocess.Popen],
        ports: list[int],
        host: str = "127.0.0.1",
        router=None,
        port_allocator: Optional[Callable[[], int]] = None,
    ):
        self.spawn_fn = spawn_fn
        self.host = host
        self.router = router
        self.port_allocator = port_allocator
        self._procs = [
            ReplicaProc(p, f"http://{host}:{p}") for p in ports
        ]
        self._lock = threading.Lock()
        # serializes whole-replica operations (roll step, scale-down) so
        # concurrent ops can never double-stop or orphan one process;
        # always acquired BEFORE _lock, never the other way around
        self._ops_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._transitions = {"up": 0, "down": 0}
        # canary mutual exclusion (guarded by _lock): while a canary is
        # in flight, every spawn is pinned to the verified BASELINE
        # generation (autoscaler scale-ups and crash restarts must never
        # come up on the unverified candidate), and the canary replica's
        # url is protected from scale-down (removing the one replica
        # under verification would silently end the experiment)
        self._spawn_pin: Optional[str] = None
        self._protected: set[str] = set()
        self.restart_backoff_s = _env_num(
            "PIO_FLEET_RESTART_BACKOFF_S", 0.5, float
        )
        self.restart_backoff_max_s = _env_num(
            "PIO_FLEET_RESTART_BACKOFF_MAX_S", 10.0, float
        )
        self.stop_timeout_s = _env_num("PIO_FLEET_STOP_TIMEOUT_S", 10.0, float)
        self.roll_timeout_s = _env_num("PIO_FLEET_ROLL_TIMEOUT_S", 60.0, float)

    def urls(self) -> list[str]:
        return [rp.url for rp in self._procs]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            for rp in self._procs:
                self._spawn_locked(rp)
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True
            )
        self._monitor_thread.start()

    def _spawn_locked(self, rp: ReplicaProc) -> None:
        # the pin rides the process environment: children inherit it at
        # spawn (cli re-exec) and the query server honors it at cold
        # start only — an explicit /reload?instanceId= still overrides
        pin = self._spawn_pin
        if pin:
            os.environ["PIO_PIN_INSTANCE"] = pin
        try:
            rp.proc = self.spawn_fn(rp.port)
        finally:
            if pin:
                os.environ.pop("PIO_PIN_INSTANCE", None)
        rp.started_at = time.monotonic()
        rp.expected_down = False
        self._transitions["up"] += 1
        logger.info(
            "fleet: replica on port %d spawned (pid %s)",
            rp.port, rp.proc.pid,
        )

    def _monitor_loop(self):
        while not self._stop_evt.wait(0.25):
            self._check_children()

    def _check_children(self) -> None:
        """Restart crashed replicas with exponential backoff; a replica
        that stayed up past its backoff window resets to the base."""
        self._preempt_point()
        now = time.monotonic()
        with self._lock:
            for rp in self._procs:
                if rp.proc is None or rp.expected_down:
                    continue
                if rp.proc.poll() is None:
                    # alive: a healthy stretch forgives past crashes
                    if (
                        rp.backoff_s
                        and now - rp.started_at > self.restart_backoff_max_s
                    ):
                        rp.backoff_s = 0.0
                    continue
                if rp.next_restart_at == 0.0:
                    # first observation of this crash: restart after the
                    # current backoff (0 after a healthy run), then double
                    # it for the next crash
                    delay = rp.backoff_s
                    rp.backoff_s = min(
                        max(rp.backoff_s * 2, self.restart_backoff_s),
                        self.restart_backoff_max_s,
                    )
                    rp.next_restart_at = now + delay
                    self._transitions["down"] += 1
                    logger.warning(
                        "fleet: replica on port %d exited rc=%s; restart "
                        "in %.1fs", rp.port, rp.proc.returncode, delay,
                    )
                if now >= rp.next_restart_at:
                    rp.restarts += 1
                    rp.next_restart_at = 0.0
                    self._spawn_locked(rp)

    def _preempt_point(self) -> None:
        """Preemption chaos site: let a seeded ``crash:fleet:replica``
        fault rule SIGKILL one live replica.  The monitor tick is the
        ordinal clock, so ``after=N`` schedules a kill ~N*0.25s in."""
        if _faults.active() is None:
            return
        with self._lock:
            pids = [
                rp.proc.pid
                for rp in self._procs
                if rp.proc is not None
                and not rp.expected_down
                and rp.proc.poll() is None
            ]
        pid = _faults.kill_point(PREEMPT_SITE, pids)
        if pid is not None:
            logger.warning(
                "fault shim preempted replica pid %d (kill -9)", pid
            )

    # -- canary mutual exclusion ---------------------------------------------
    def set_spawn_pin(self, instance_id: Optional[str]) -> None:
        """While set, children spawned by this supervisor (scale-ups,
        crash restarts) cold-start pinned to ``instance_id`` — the canary
        controller pins the BASELINE for the verification window so a
        mid-canary scale-up can never come up on the unverified
        candidate.  ``None`` clears the pin."""
        with self._lock:
            self._spawn_pin = instance_id or None

    def protect_replica(self, url: str, protected: bool) -> None:
        """Exempt one replica from scale-down (the canary replica during
        its verification window); clearing re-enables removal."""
        url = url.rstrip("/")
        with self._lock:
            if protected:
                self._protected.add(url)
            else:
                self._protected.discard(url)

    # -- elastic scaling -----------------------------------------------------
    def _alloc_port(self) -> int:
        if self.port_allocator is not None:
            return self.port_allocator()
        s = socket.socket()
        try:
            s.bind((self.host, 0))
            return s.getsockname()[1]
        finally:
            s.close()

    def add_replica(self) -> Optional[dict]:
        """Scale up by one: spawn a replica on a fresh port and register
        it at the router (EJECTED — the health gate + slow start admit
        it).  Returns the new slot, or None if the spawn failed."""
        with self._ops_lock:
            port = self._alloc_port()
            rp = ReplicaProc(port, f"http://{self.host}:{port}")
            try:
                with self._lock:
                    self._spawn_locked(rp)
                    self._procs.append(rp)
            except Exception:
                logger.exception(
                    "fleet: scale-up spawn on port %d failed", port
                )
                return None
            if self.router is not None:
                self.router.add_replica(rp.url)
            return {"port": rp.port, "url": rp.url}

    def remove_replica(self, url: Optional[str] = None) -> Optional[dict]:
        """Scale down by one: drain-before-kill (router DRAINING →
        ``POST /stop`` → reap), then forget the slot and deregister the
        URL at the router.  Picks the newest removable replica unless
        ``url`` names one.  Returns the retired slot, or None when the
        fleet has nothing removable (e.g. everything is mid-roll)."""
        with self._ops_lock:
            with self._lock:
                cands = [
                    rp for rp in self._procs
                    if not rp.expected_down and not rp.removing
                    and rp.url not in self._protected
                ]
                if url is not None:
                    cands = [rp for rp in cands if rp.url == url]
                if not cands:
                    return None
                rp = cands[-1]  # newest first: keep long-warm replicas
                rp.removing = True
                rp.expected_down = True  # monitor must not respawn it
                proc = rp.proc
            try:
                if self.router is not None:
                    self.router.set_replica_draining(rp.url, True)
                if proc is not None and proc.poll() is None:
                    self._post_stop(rp.url)
                    try:
                        proc.wait(timeout=self.stop_timeout_s)
                    except subprocess.TimeoutExpired:
                        logger.warning(
                            "fleet: replica on port %d ignored scale-down "
                            "drain; killing", rp.port,
                        )
                        proc.kill()
                        try:
                            proc.wait(timeout=5)
                        except subprocess.TimeoutExpired:
                            pass
            finally:
                with self._lock:
                    self._procs = [p for p in self._procs if p is not rp]
                    self._transitions["down"] += 1
                if self.router is not None:
                    self.router.remove_replica(rp.url)
            logger.info("fleet: replica on port %d scaled down", rp.port)
            return {"port": rp.port, "url": rp.url}

    # -- rolling deploy ------------------------------------------------------
    def roll(self) -> dict:
        """Drain → restart → verify each replica in sequence.  Returns a
        per-replica report; raises nothing (a failed replica is reported
        and the roll continues — partial fleets beat dead rolls).

        Target resolution happens in each restarted CHILD: it cold-starts
        on the newest COMPLETED generation via
        ``workflow.get_latest_completed_instance``, which skips
        quarantined instance ids — so a roll can never re-deploy a
        generation a canary rolled back."""
        with self._lock:
            procs = [rp for rp in self._procs if not rp.removing]
        report = []
        for rp in procs:
            entry = {"port": rp.port, "url": rp.url}
            try:
                if self._roll_one(rp):
                    entry["ok"] = True
                else:
                    # a concurrent scale-down retired it first — nothing
                    # to roll, and definitely nothing to stop twice
                    entry["ok"] = True
                    entry["skipped"] = "scaled down"
            except Exception as e:
                entry["ok"] = False
                entry["error"] = f"{type(e).__name__}: {e}"
                logger.exception(
                    "fleet roll: replica on port %d failed", rp.port
                )
            report.append(entry)
        return {"replicas": report, "ok": all(e["ok"] for e in report)}

    def _roll_one(self, rp: ReplicaProc) -> bool:
        """Roll one replica; returns False when a concurrent scale-down
        already retired it (the ops lock makes the check authoritative:
        whoever holds it owns the replica's process end to end)."""
        with self._ops_lock:
            return self._roll_one_owned(rp)

    def _roll_one_owned(self, rp: ReplicaProc) -> bool:
        deadline = time.monotonic() + self.roll_timeout_s
        with self._lock:
            if rp.removing or rp not in self._procs:
                return False
        if self.router is not None:
            self.router.set_replica_draining(rp.url, True)
        with self._lock:
            rp.expected_down = True
            proc = rp.proc
        try:
            if proc is not None and proc.poll() is None:
                self._post_stop(rp.url)
                try:
                    proc.wait(timeout=self.stop_timeout_s)
                except subprocess.TimeoutExpired:
                    logger.warning(
                        "fleet roll: replica on port %d ignored drain; "
                        "killing", rp.port,
                    )
                    proc.kill()
                    proc.wait(timeout=5)
            with self._lock:
                self._spawn_locked(rp)
            self._wait_ready(rp.url, deadline)
        finally:
            with self._lock:
                rp.expected_down = False
            if self.router is not None:
                self.router.set_replica_draining(rp.url, False)
        if self.router is not None:
            self._wait_admitted(rp.url, deadline)
        return True

    def _post_stop(self, url: str) -> None:
        try:
            with urllib.request.urlopen(
                urllib.request.Request(url + "/stop", method="POST"),
                timeout=5,
            ) as r:
                r.read()
        except OSError:
            # the process may tear the socket down mid-response, or be
            # dead already — either way the wait() below decides
            pass

    def _wait_ready(self, url: str, deadline: float) -> None:
        """Poll /readyz until 200 + warm; raise on timeout.

        Under streaming (PIO_STREAMING=1) a restarted or freshly spawned
        replica answers 503 ``delta catch-up`` until it has replayed the
        sealed delta log to the fleet's epoch — this wait is what keeps a
        behind replica out of rotation until it has caught up.
        """
        last = "no probe yet"
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
                    info = json.loads(r.read().decode("utf-8"))
                if info.get("fastpathWarm", True):
                    return
                last = "ready but not warm"
            except urllib.error.HTTPError as e:
                # surface WHY it is held out (draining / delta catch-up /
                # overloaded) instead of a bare status code
                try:
                    status = json.loads(
                        e.read().decode("utf-8")).get("status")
                except (ValueError, OSError, AttributeError):
                    status = None
                last = (
                    f"readyz {e.code} ({status})" if status
                    else f"readyz {e.code}"
                )
            except (OSError, ValueError) as e:
                last = f"{type(e).__name__}: {e}"
            time.sleep(0.1)
        raise TimeoutError(f"replica {url} never became ready ({last})")

    def _wait_admitted(self, url: str, deadline: float) -> None:
        """Wait for the router's health gate to readmit the replica so the
        fleet is back to full strength before the next one drains."""
        url = url.rstrip("/")
        while time.monotonic() < deadline:
            for rep in self.router.stats()["replicas"]:
                if rep["url"] == url and rep["state"] == "admitted":
                    return
            time.sleep(0.05)
        logger.warning(
            "fleet roll: %s not readmitted inside the roll budget", url
        )

    # -- status / shutdown ---------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "replicas": [
                    {
                        "port": rp.port,
                        "url": rp.url,
                        "pid": rp.proc.pid if rp.proc else None,
                        "alive": (
                            rp.proc is not None and rp.proc.poll() is None
                        ),
                        "restarts": rp.restarts,
                        "backoffMs": round(rp.backoff_s * 1e3, 1),
                        "rolling": rp.expected_down,
                        "removing": rp.removing,
                    }
                    for rp in self._procs
                ],
                "transitions": dict(self._transitions),
                "spawnPin": self._spawn_pin,
                "protected": sorted(self._protected),
            }

    def stats(self) -> dict:
        """Flat snapshot for the ``pio_fleet_*`` metrics bridge."""
        st = self.status()
        reps = st["replicas"]
        return {
            "replicas": len(reps),
            "alive": sum(1 for r in reps if r["alive"]),
            "restarts": sum(r["restarts"] for r in reps),
            "backoffMs": {r["url"]: r["backoffMs"] for r in reps},
            "transitions": st["transitions"],
        }

    def stop(self) -> None:
        """Stop supervising and tear the children down (drain first,
        then kill what lingers)."""
        self._stop_evt.set()
        with self._lock:
            procs = [rp.proc for rp in self._procs if rp.proc is not None]
            for rp in self._procs:
                rp.expected_down = True
        for rp in self._procs:
            self._post_stop(rp.url)
        for proc in procs:
            try:
                proc.wait(timeout=self.stop_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass  # unkillable (D-state); nothing more to do
