"""SLO-guarded canary rollout with automatic rollback and durable
generation quarantine.

Counterpart of ``predictionio_tpu/serving/canary.py``: the same state
machine, journal and receipts (either package reads the other's), the
same ``PIO_CANARY_*`` knobs and the same ``topk_overlap``.

Deployment was all-or-nothing: ``fleet.roll()`` moves every replica to
the newest COMPLETED generation with zero online verification, so a
generation that *loads* fine but regresses under traffic (latency
blowup, error spike, quality drift) takes down the whole fleet.  The
:class:`CanaryController` turns deployment into a verified, reversible
dataflow stage:

1. **Canary** — ONE replica hot-swaps to the candidate generation via
   ``POST /reload?instanceId=`` (no respawn); the rest keep serving the
   baseline.  Blast radius is bounded at 1/N of the fleet.
2. **Verify** — the router attributes online metrics *per generation*
   (engine instance id, never the per-process generation counter):
   error rate, p99 — against an absolute SLO or a ratio of the
   baseline's live p99 — and top-k prediction overlap vs the baseline,
   measured by budget-capped **shadow-mirrored** queries: real captured
   bodies replayed to candidate + baseline, answers discarded.
3. **Promote or roll back** — after a minimum-sample verification
   window the remainder of the fleet rolls to the candidate; any SLO
   breach instead rolls the canary back to the baseline and writes a
   durable, epoch-fenced **quarantine receipt** (sealed through the
   core/persistence checksum envelope) that newest-COMPLETED selection,
   cold-start fallback, ``fleet.roll()`` and future canaries all
   consult — a bad generation is never auto-deployed twice.
4. **Soak** — a post-promotion watchdog keeps scoring the candidate
   fleet-wide; a breach triggers *runtime* fleet-wide rollback to the
   last known good generation (previously rollback only existed at
   cold start).

Crash safety: every state transition journals first (sealed + atomic,
``<base>/canary/<engine-key>/state.json``) so a kill -9 mid-promotion
resumes idempotently — or aborts to a consistent all-baseline fleet —
on restart (:meth:`CanaryController.resume`).  The journal carries a
monotonic epoch + owner token: a resumed controller bumps the epoch,
and any write from a stale controller raises :class:`FencedError`
(split-brain fencing).  The rollback intent (including the quarantine
verdict) is journaled BEFORE the receipt write, so a crash at the
``crash:canary:before_receipt`` fault site still quarantines on
resume.

Mutual exclusion with the autoscaler: for the whole canary window the
fleet's spawn pin holds new children on the BASELINE generation (a
scale-up must never come up on the unverified candidate) and the
canary replica's url is protected from scale-down.

Chaos sites: ``crash:canary:mid_promote`` (between per-replica
promotions), ``crash:canary:before_receipt`` (after rollback, before
the receipt lands), ``client:canary:shadow`` (the shadow-mirror hop).

Thread model: one worker thread per canary runs ``_verify_loop`` then
(after promotion) ``_soak_loop`` — both pace on the stop Event and
delegate all I/O to per-tick helpers (the blocking analyzer's hot-loop
contract).  Mutable controller state is guarded by ``_lock``.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.common.resilience import (
    DEADLINE_HEADER,
    Deadline,
    ErrorCounters,
    RateLimitedLogger,
)
from predictionio_tpu_torch.core import persistence

logger = logging.getLogger(__name__)

# controller states (journaled; the pio_canary_state gauge values)
IDLE = "idle"
VERIFYING = "verifying"
PROMOTING = "promoting"
SOAKING = "soaking"
ROLLING_BACK = "rolling_back"
STATE_VALUES = {
    IDLE: 0.0, VERIFYING: 1.0, PROMOTING: 2.0, SOAKING: 3.0,
    ROLLING_BACK: 4.0,
}

MID_PROMOTE_SITE = "crash:canary:mid_promote"
BEFORE_RECEIPT_SITE = "crash:canary:before_receipt"
SHADOW_SITE = "client:canary:shadow"


class FencedError(RuntimeError):
    """A newer controller owns the journal: this one must stop
    mutating the fleet immediately (split-brain fencing)."""


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError, TypeError):
        return default


def _topk_overlap(a: dict, b: dict, k: int = 10) -> Optional[float]:
    """Fraction of the baseline's top-k item ids the candidate also
    ranks in ITS top-k — the canary's quality-drift signal.  None when
    either answer has no rankable item list (overlap then simply does
    not contribute to the verdict)."""
    def items(resp):
        scores = resp.get("itemScores") if isinstance(resp, dict) else None
        if not isinstance(scores, list):
            return None
        out = []
        for entry in scores[:k]:
            if isinstance(entry, dict) and "item" in entry:
                out.append(str(entry["item"]))
        return out or None

    ia, ib = items(a), items(b)
    if ia is None or ib is None:
        return None
    return len(set(ia) & set(ib)) / float(max(len(ib), 1))


class CanaryController:
    """Progressive-delivery controller for one engine key.

    ``router`` must be a :class:`~predictionio_tpu_torch.serving.router.Router`
    (per-generation attribution + shadow capture); ``fleet`` is the
    optional FleetSupervisor (spawn pin + scale-down protection —
    without one those exclusions are skipped); ``storage`` resolves the
    candidate generation (defaults to the process Storage singleton at
    first use).
    """

    def __init__(
        self,
        router,
        fleet=None,
        storage=None,
        engine_id: str = "default",
        engine_version: str = "default",
        engine_variant: str = "default",
    ):
        self.router = router
        self.fleet = fleet
        self._storage = storage
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._rl_log = RateLimitedLogger(logger)
        # knobs (each read exactly once; documented in
        # docs/operations.md "Progressive delivery" — the knobs analyzer
        # diffs the defaults)
        self.tick_s = _env_num("PIO_CANARY_TICK_MS", 250.0, float) / 1e3
        self.min_samples = _env_num("PIO_CANARY_MIN_SAMPLES", 50, int)
        self.window_s = _env_num("PIO_CANARY_WINDOW_S", 30.0, float)
        self.max_error_rate = _env_num(
            "PIO_CANARY_MAX_ERROR_RATE", 0.02, float
        )
        self.p99_slo_ms = _env_num("PIO_CANARY_P99_SLO_MS", 0.0, float)
        self.p99_ratio = _env_num("PIO_CANARY_P99_RATIO", 2.0, float)
        self.min_overlap = _env_num("PIO_CANARY_MIN_OVERLAP", 0.5, float)
        self.shadow_budget = _env_num("PIO_CANARY_SHADOW_BUDGET", 200, int)
        self.shadow_timeout_ms = _env_num(
            "PIO_CANARY_SHADOW_TIMEOUT_MS", 1000.0, float
        )
        self.soak_s = _env_num("PIO_CANARY_SOAK_S", 30.0, float)
        # run state (guarded by _lock)
        self._state = IDLE
        self._epoch = 0
        self._token = ""
        self._candidate: Optional[str] = None
        self._baseline: Optional[str] = None
        self._canary_url: Optional[str] = None
        self._promote_urls: list[str] = []
        self._started_at = 0.0
        self._soak_started_at = 0.0
        self._soak_base: dict = {}
        self._shadow_pairs = 0
        self._shadow_overlap_sum = 0.0
        self._shadow_spent = 0
        self._force_promote = False
        self._abort = False
        self._last_outcome: Optional[dict] = None
        self.counters = ErrorCounters(
            "verifications_pass", "verifications_fail", "promotions",
            "rollbacks_verify", "rollbacks_soak", "aborts",
            "shadow_ok", "shadow_errors", "fenced", "resumed",
        )

    # -- storage / journal ----------------------------------------------------
    def _get_storage(self):
        if self._storage is None:
            from predictionio_tpu_torch.data.storage.registry import Storage

            self._storage = Storage.instance()
        return self._storage

    def _journal_path(self) -> str:
        from predictionio_tpu_torch.utils.fs import pio_base_dir

        key = persistence._engine_key(
            self.engine_id, self.engine_version, self.engine_variant
        )
        return os.path.join(pio_base_dir(), "canary", key, "state.json")

    def _read_journal(self) -> Optional[dict]:
        try:
            return json.loads(
                persistence.open_blob_file(self._journal_path())
                .decode("utf-8")
            )
        except (OSError, ValueError):
            return None
        except persistence.ModelIntegrityError:
            # a torn journal cannot name its owner: treat as absent —
            # the fleet stays consistent because every mutation path is
            # idempotent and quarantine receipts are separate artifacts
            self._rl_log.warning(
                "journal", "canary journal failed its checksum; ignoring"
            )
            return None

    def _journal(self, state: str, **extra) -> None:
        """Durably record a state transition.  FENCED: the write is
        refused (and this controller stops itself) when a newer epoch —
        or another controller's token on the same epoch — owns the
        journal."""
        disk = self._read_journal()
        if disk is not None:
            d_epoch = int(disk.get("epoch", 0))
            if d_epoch > self._epoch or (
                d_epoch == self._epoch
                and disk.get("token") not in ("", self._token)
            ):
                self.counters.inc("fenced")
                raise FencedError(
                    f"canary journal owned by epoch {d_epoch} "
                    f"token {disk.get('token')!r}"
                )
        entry = {
            "epoch": self._epoch,
            "token": self._token,
            "state": state,
            "candidate": self._candidate,
            "baseline": self._baseline,
            "canaryUrl": self._canary_url,
            "promoteUrls": self._promote_urls,
            "updatedAt": time.time(),
        }
        entry.update(extra)
        path = self._journal_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        persistence.seal_blob_file(
            path, json.dumps(entry, sort_keys=True).encode("utf-8")
        )
        with self._lock:
            self._state = state

    # -- public control surface ----------------------------------------------
    def active(self) -> bool:
        with self._lock:
            return self._state != IDLE

    def start_canary(
        self, instance_id: Optional[str] = None, force: bool = False
    ) -> bool:
        """Begin a canary: resolve the candidate generation, hot-swap ONE
        replica to it, and start the verification window.  Returns False
        when a canary is already in flight; raises ValueError when no
        deployable candidate exists (all newer generations quarantined,
        or the fleet already serves the newest)."""
        with self._lock:
            if self._state != IDLE:
                return False
        baseline, canary_url, others = self._pick_replicas()
        candidate = self._resolve_candidate(instance_id, baseline, force)
        disk = self._read_journal()
        with self._lock:
            self._epoch = int((disk or {}).get("epoch", 0)) + 1
            self._token = secrets.token_hex(8)
            self._candidate = candidate
            self._baseline = baseline
            self._canary_url = canary_url
            self._promote_urls = others
            self._started_at = time.monotonic()
            self._shadow_pairs = 0
            self._shadow_overlap_sum = 0.0
            self._shadow_spent = 0
            self._force_promote = False
            self._abort = False
            self._stop_evt.clear()
        self._journal(VERIFYING)
        self._begin_exclusions()
        try:
            self._reload_replica(canary_url, candidate, force=force)
        except Exception:
            # the swap never landed: end the experiment cleanly (no
            # receipt — the candidate was never observed under traffic)
            self._end_exclusions()
            self._journal(IDLE, outcome="swap-failed")
            raise
        self._spawn_worker()
        logger.info(
            "canary started: candidate %s on %s (baseline %s, epoch %d)",
            candidate, canary_url, baseline, self._epoch,
        )
        return True

    def request_promote(self) -> bool:
        """Operator skip-ahead: promote at the next tick unless the
        window has already breached."""
        with self._lock:
            if self._state != VERIFYING:
                return False
            self._force_promote = True
            return True

    def request_abort(self) -> bool:
        """Roll the canary back to the baseline WITHOUT quarantining —
        an abort is an operator decision, not an online verdict."""
        with self._lock:
            if self._state not in (VERIFYING, SOAKING):
                return False
            self._abort = True
            return True

    def quarantine(self) -> list[dict]:
        return persistence.read_quarantine_receipts(
            self.engine_id, self.engine_version, self.engine_variant
        )

    def release_quarantine(self, instance_id: str) -> bool:
        return persistence.clear_quarantine(
            instance_id, self.engine_id, self.engine_version,
            self.engine_variant,
        )

    def stop(self) -> None:
        """Stop the worker thread; fleet state is left as-is (resume()
        on the next controller decides)."""
        self._stop_evt.set()
        with self._lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=5.0)

    # -- resume (crash recovery) ---------------------------------------------
    def resume(self) -> Optional[str]:
        """Recover from a journal left by a dead controller.  Takes
        ownership (epoch bump — the dead controller, if actually alive,
        is fenced on its next write) and drives the fleet to a
        consistent state:

        * ``PROMOTING`` — finish the promotion idempotently, then soak.
        * ``ROLLING_BACK`` — finish the rollback; the journaled
          quarantine verdict still lands its receipt (this is what makes
          ``crash:canary:before_receipt`` safe).
        * ``VERIFYING`` — abort to baseline, NO quarantine: the
          controller died, not the candidate.
        * ``SOAKING`` — restart the soak watchdog.

        Returns the action taken, or None when the journal is absent or
        already idle."""
        disk = self._read_journal()
        if disk is None or disk.get("state") in (None, IDLE):
            return None
        state = disk["state"]
        with self._lock:
            if self._state != IDLE:
                return None
            self._epoch = int(disk.get("epoch", 0)) + 1
            self._token = secrets.token_hex(8)
            self._candidate = disk.get("candidate")
            self._baseline = disk.get("baseline")
            self._canary_url = disk.get("canaryUrl")
            self._promote_urls = list(disk.get("promoteUrls") or [])
            self._started_at = time.monotonic()
            self._stop_evt.clear()
        if not self._candidate or not self._baseline:
            self._journal(IDLE, outcome="unrecoverable-journal")
            return "cleared"
        self.counters.inc("resumed")
        if state == ROLLING_BACK:
            self._rollback(
                reason=str(disk.get("reason") or "resumed-rollback"),
                quarantine=bool(disk.get("quarantine", True)),
                fleet_wide=bool(disk.get("fleetWide", False)),
                counter=None,
            )
            return "rolled_back"
        if state == VERIFYING:
            self._rollback(
                reason="controller-restart", quarantine=False,
                fleet_wide=False, counter="aborts",
            )
            return "aborted"
        if state == PROMOTING:
            self._promote()
            self._spawn_worker(soak_only=True)
            return "promoted"
        if state == SOAKING:
            self._begin_soak()
            self._spawn_worker(soak_only=True)
            return "soaking"
        self._journal(IDLE, outcome=f"unknown-state-{state}")
        return "cleared"

    # -- candidate / replica resolution --------------------------------------
    def _pick_replicas(self) -> tuple[str, str, list[str]]:
        """(baseline instance id, canary replica url, other urls).  The
        canary replica is the LAST admitted replica (mirrors the
        scale-down pick: newest first, keep long-warm replicas on the
        baseline)."""
        view = self.router.replica_view()
        admitted = [
            r for r in view if r["state"] == "admitted" and r["instanceId"]
        ]
        if not admitted:
            raise ValueError(
                "no admitted replica advertises an engine instance id yet"
            )
        baseline = admitted[-1]["instanceId"]
        canary_url = admitted[-1]["url"]
        others = [r["url"] for r in admitted[:-1]]
        return baseline, canary_url, others

    def _resolve_candidate(
        self, instance_id: Optional[str], baseline: str, force: bool
    ) -> str:
        quarantined = persistence.quarantined_instance_ids(
            self.engine_id, self.engine_version, self.engine_variant
        )
        if instance_id:
            if instance_id == baseline:
                raise ValueError(
                    f"candidate {instance_id} is already the baseline"
                )
            if instance_id in quarantined and not force:
                raise ValueError(
                    f"candidate {instance_id} is quarantined; pass "
                    "force to override"
                )
            return instance_id
        completed = (
            self._get_storage().get_meta_data_engine_instances()
            .get_completed(
                self.engine_id, self.engine_version, self.engine_variant
            )
        )
        for inst in completed:
            if inst.id == baseline:
                break
            if inst.id in quarantined:
                continue
            return inst.id
        raise ValueError(
            "no candidate: the fleet already serves the newest "
            "non-quarantined COMPLETED generation"
        )

    # -- exclusions (autoscaler mutual exclusion) ----------------------------
    def _begin_exclusions(self) -> None:
        self.router.set_shadow_capture(True)
        if self.fleet is not None:
            self.fleet.set_spawn_pin(self._baseline)
            if self._canary_url:
                self.fleet.protect_replica(self._canary_url, True)

    def _end_exclusions(self) -> None:
        self.router.set_shadow_capture(False)
        if self.fleet is not None:
            self.fleet.set_spawn_pin(None)
            if self._canary_url:
                self.fleet.protect_replica(self._canary_url, False)

    # -- replica hot-swap -----------------------------------------------------
    def _reload_replica(
        self, url: str, instance_id: str, force: bool = False
    ) -> None:
        """Hot-swap one replica to a specific generation via its
        ``POST /reload?instanceId=`` (control plane; no respawn)."""
        qs = f"/reload?instanceId={instance_id}"
        if force:
            qs += "&force=1"
        req = urllib.request.Request(url + qs, method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=30.0) as r:
            body = json.loads(r.read().decode("utf-8"))
        got = body.get("engineInstanceId")
        if got != instance_id:
            raise RuntimeError(
                f"replica {url} deployed {got!r}, wanted {instance_id!r}"
            )

    # -- worker ---------------------------------------------------------------
    def _spawn_worker(self, soak_only: bool = False) -> None:
        worker = threading.Thread(
            target=self._drive, args=(soak_only,),
            name="canary-controller", daemon=True,
        )
        with self._lock:
            self._worker = worker
        worker.start()

    def _drive(self, soak_only: bool) -> None:
        try:
            if not soak_only:
                self._verify_loop()
            with self._lock:
                soaking = self._state == SOAKING
            if soak_only or soaking:
                self._soak_loop()
        except FencedError:
            self._rl_log.warning(
                "fenced", "canary controller fenced by a newer epoch; "
                "standing down"
            )
        except Exception:
            self._rl_log.exception("canary", "canary worker crashed")

    def _verify_loop(self) -> None:
        # hot-loop contract: pace on the stop Event, delegate every
        # blocking step (HTTP, journal I/O) to the tick helper
        while not self._stop_evt.wait(self.tick_s):
            if self._verify_tick():
                return

    def _soak_loop(self) -> None:
        # same contract as _verify_loop (both names are registered with
        # the blocking analyzer's hot-loop set)
        while not self._stop_evt.wait(self.tick_s):
            if self._soak_tick():
                return

    # -- verification ---------------------------------------------------------
    def _verify_tick(self) -> bool:
        """One verification step; returns True when the canary reached a
        terminal decision (promoted / rolled back / aborted)."""
        with self._lock:
            if self._state != VERIFYING:
                return True
            abort = self._abort
            force = self._force_promote
        if abort:
            self._rollback(
                reason="operator-abort", quarantine=False,
                fleet_wide=False, counter="aborts",
            )
            return True
        self._shadow_tick()
        verdict, detail = self._evaluate()
        if verdict == "fail":
            self.counters.inc("verifications_fail")
            self._rollback(
                reason=detail, quarantine=True, fleet_wide=False,
                counter="rollbacks_verify",
            )
            return True
        if verdict == "pass" or (force and verdict != "fail"):
            self.counters.inc("verifications_pass")
            self._journal(PROMOTING, detail=detail)
            self._promote()
            return False  # _drive continues into _soak_loop
        return False

    def _shadow_tick(self) -> None:
        """Replay a handful of captured real queries against candidate
        and baseline; answers are discarded, only the top-k overlap
        survives.  Budget-capped per canary window."""
        with self._lock:
            remaining = self.shadow_budget - self._shadow_spent
            canary_url = self._canary_url
        if remaining <= 0 or canary_url is None:
            return
        baseline_url = self._baseline_url()
        if baseline_url is None:
            return
        for body in self.router.take_shadow_samples(min(remaining, 8)):
            with self._lock:
                self._shadow_spent += 1
            overlap = self._serve_shadow_pair(
                body, canary_url, baseline_url
            )
            if overlap is None:
                continue
            with self._lock:
                self._shadow_pairs += 1
                self._shadow_overlap_sum += overlap

    def _baseline_url(self) -> Optional[str]:
        with self._lock:
            baseline = self._baseline
        for r in self.router.replica_view():
            if r["state"] == "admitted" and r["instanceId"] == baseline:
                return r["url"]
        return None

    def _serve_shadow_pair(
        self, body: bytes, canary_url: str, baseline_url: str
    ) -> Optional[float]:
        """One shadow mirror: POST the captured body to candidate and
        baseline, discard both answers, return their top-k overlap.
        Any failure (including the ``client:canary:shadow`` chaos site)
        counts as a shadow error, never as a candidate verdict — only
        attributed REAL traffic and measured overlap decide."""
        act = _faults.check(SHADOW_SITE)
        if act is not None:
            if act.latency_s:
                time.sleep(act.latency_s)
            if act.kind in ("error", "drop", "crash"):
                self.counters.inc("shadow_errors")
                return None
        deadline = Deadline.after_ms(self.shadow_timeout_ms)
        answers = []
        for url in (canary_url, baseline_url):
            remaining_ms = deadline.remaining_ms()
            if remaining_ms <= 0:
                self.counters.inc("shadow_errors")
                return None
            headers = {
                "Content-Type": "application/json",
                # shadow hops carry the remaining budget like any other
                # downstream hop (deadline-propagation contract)
                DEADLINE_HEADER: f"{remaining_ms:.0f}",
            }
            req = urllib.request.Request(
                url + "/queries.json", data=body, method="POST",
                headers=headers,
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=max(remaining_ms, 1.0) / 1e3
                ) as r:
                    answers.append(json.loads(r.read().decode("utf-8")))
            except (OSError, ValueError):
                self.counters.inc("shadow_errors")
                return None
        self.counters.inc("shadow_ok")
        return _topk_overlap(answers[0], answers[1])

    def _evaluate(self) -> tuple[str, str]:
        """Score the candidate against the baseline: ``("pass", why)``,
        ``("fail", why)`` or ``("wait", why)``."""
        gens = self.router.generation_stats()
        with self._lock:
            cand_id, base_id = self._candidate, self._baseline
            started = self._started_at
            pairs = self._shadow_pairs
            overlap_sum = self._shadow_overlap_sum
        cand = gens.get(cand_id) or {}
        base = gens.get(base_id) or {}
        requests = cand.get("requests", 0)
        if requests > 0 and cand.get("errorRate", 0.0) > self.max_error_rate:
            if requests >= max(10, self.min_samples // 5):
                # error breaches fire EARLY (a hard-failing candidate
                # must not absorb the whole window of client traffic)
                return (
                    "fail",
                    f"error rate {cand['errorRate']:.3f} > "
                    f"{self.max_error_rate:g} over {requests} requests",
                )
        p99 = cand.get("p99Ms")
        if p99 is not None and cand.get("latencySamples", 0) >= max(
            10, self.min_samples // 5
        ):
            if self.p99_slo_ms > 0 and p99 > self.p99_slo_ms:
                return (
                    "fail",
                    f"p99 {p99:.1f}ms > SLO {self.p99_slo_ms:g}ms",
                )
            base_p99 = base.get("p99Ms")
            if (
                self.p99_slo_ms <= 0
                and base_p99 is not None
                and base_p99 > 0
                and p99 > self.p99_ratio * base_p99
            ):
                return (
                    "fail",
                    f"p99 {p99:.1f}ms > {self.p99_ratio:g}x baseline "
                    f"{base_p99:.1f}ms",
                )
        if pairs > 0:
            mean_overlap = overlap_sum / pairs
            if pairs >= 5 and mean_overlap < self.min_overlap:
                return (
                    "fail",
                    f"top-k overlap {mean_overlap:.2f} < "
                    f"{self.min_overlap:g} over {pairs} shadow pairs",
                )
        elapsed = time.monotonic() - started
        if requests < self.min_samples:
            return ("wait", f"{requests}/{self.min_samples} samples")
        if elapsed < self.window_s:
            return ("wait", f"{elapsed:.1f}/{self.window_s:g}s window")
        return (
            "pass",
            f"{requests} requests, error rate "
            f"{cand.get('errorRate', 0.0):.3f}, p99 "
            f"{p99 if p99 is not None else float('nan'):.1f}ms",
        )

    # -- promotion ------------------------------------------------------------
    def _promote(self) -> None:
        """Roll every remaining baseline replica to the candidate —
        idempotent (a replica already on the candidate reloads to the
        same generation), so a crash at ``crash:canary:mid_promote``
        resumes by simply re-running the list."""
        with self._lock:
            candidate = self._candidate
            urls = list(self._promote_urls)
        for url in urls:
            _faults.crash_point(MID_PROMOTE_SITE)
            try:
                self._reload_replica(url, candidate)
            except Exception:
                self._rl_log.exception(
                    "promote", "promotion reload failed for %s", url
                )
        self.counters.inc("promotions")
        self._begin_soak()

    def _begin_soak(self) -> None:
        gens = self.router.generation_stats()
        with self._lock:
            cand = gens.get(self._candidate) or {}
            self._soak_started_at = time.monotonic()
            self._soak_base = {
                "requests": cand.get("requests", 0),
                "errors": cand.get("errors", 0),
            }
        self._journal(SOAKING)
        self._end_exclusions()

    def _soak_tick(self) -> bool:
        """Post-promotion watchdog step; returns True when the soak
        window closes (clean or rolled back)."""
        with self._lock:
            if self._state != SOAKING:
                return True
            abort = self._abort
            cand_id = self._candidate
            soak_started = self._soak_started_at
            base = dict(self._soak_base)
        if abort:
            self._rollback(
                reason="operator-abort-soak", quarantine=False,
                fleet_wide=True, counter="aborts",
            )
            return True
        gens = self.router.generation_stats()
        cand = gens.get(cand_id) or {}
        d_req = cand.get("requests", 0) - base["requests"]
        d_err = cand.get("errors", 0) - base["errors"]
        breach = None
        if d_req >= max(10, self.min_samples // 5):
            rate = d_err / float(d_req)
            if rate > self.max_error_rate:
                breach = (
                    f"soak error rate {rate:.3f} > "
                    f"{self.max_error_rate:g} over {d_req} requests"
                )
        p99 = cand.get("p99Ms")
        if (
            breach is None
            and self.p99_slo_ms > 0
            and p99 is not None
            and cand.get("latencySamples", 0) >= max(
                10, self.min_samples // 5
            )
            and p99 > self.p99_slo_ms
        ):
            breach = f"soak p99 {p99:.1f}ms > SLO {self.p99_slo_ms:g}ms"
        if breach is not None:
            # RUNTIME fleet-wide rollback to the last known good
            # generation — the capability that previously existed only
            # at cold start
            self._rollback(
                reason=breach, quarantine=True, fleet_wide=True,
                counter="rollbacks_soak",
            )
            return True
        if time.monotonic() - soak_started >= self.soak_s:
            with self._lock:
                outcome = {
                    "outcome": "promoted",
                    "candidate": self._candidate,
                }
                self._last_outcome = outcome
            self._journal(IDLE, **outcome)
            logger.info("canary soak clean: %s is the fleet generation",
                        cand_id)
            return True
        return False

    # -- rollback + quarantine ------------------------------------------------
    def _rollback(
        self,
        reason: str,
        quarantine: bool,
        fleet_wide: bool,
        counter: Optional[str],
    ) -> None:
        """Return the fleet to the baseline generation, then (for a
        verification verdict) write the durable quarantine receipt.

        Ordering is the crash-safety contract: the intent — INCLUDING
        the quarantine verdict — journals first, so a kill -9 anywhere
        in here (``crash:canary:before_receipt`` sits right before the
        receipt write) is finished by resume(), never lost."""
        with self._lock:
            candidate = self._candidate
            baseline = self._baseline
            canary_url = self._canary_url
            epoch = self._epoch
        self._journal(
            ROLLING_BACK, reason=reason, quarantine=quarantine,
            fleetWide=fleet_wide,
        )
        if counter is not None:
            self.counters.inc(counter)
        urls = []
        if fleet_wide:
            urls = [
                r["url"] for r in self.router.replica_view()
                if r["state"] != "ejected" or r["instanceId"] == candidate
            ]
        elif canary_url:
            urls = [canary_url]
        for url in urls:
            try:
                self._reload_replica(url, baseline)
            except Exception:
                self._rl_log.exception(
                    "rollback", "rollback reload failed for %s (child "
                    "selection skips the quarantined id on its next "
                    "restart)", url,
                )
        if quarantine:
            _faults.crash_point(BEFORE_RECEIPT_SITE)
            persistence.write_quarantine_receipt(
                candidate, reason,
                engine_id=self.engine_id,
                engine_version=self.engine_version,
                engine_variant=self.engine_variant,
                epoch=epoch,
                details={"baseline": baseline, "fleetWide": fleet_wide},
            )
        self._end_exclusions()
        outcome = {
            "outcome": "quarantined" if quarantine else "aborted",
            "candidate": candidate,
            "reason": reason,
        }
        with self._lock:
            self._last_outcome = outcome
        self._journal(IDLE, **outcome)
        logger.warning(
            "canary rollback (%s): candidate %s -> baseline %s%s",
            reason, candidate, baseline,
            " [quarantined]" if quarantine else "",
        )

    # -- stats ----------------------------------------------------------------
    def stats(self) -> dict:
        gens = self.router.generation_stats()
        with self._lock:
            state = self._state
            cand_id, base_id = self._candidate, self._baseline
            pairs = self._shadow_pairs
            overlap_sum = self._shadow_overlap_sum
            spent = self._shadow_spent
            out = {
                "state": state,
                "epoch": self._epoch,
                "candidate": cand_id,
                "baseline": base_id,
                "canaryUrl": self._canary_url,
                "lastOutcome": dict(self._last_outcome)
                if self._last_outcome else None,
            }
        out["candidateStats"] = gens.get(cand_id)
        out["baselineStats"] = gens.get(base_id)
        out["shadow"] = {
            "pairs": pairs,
            "spent": spent,
            "budget": self.shadow_budget,
            "meanOverlap": (overlap_sum / pairs) if pairs else None,
        }
        out["counters"] = self.counters.snapshot()
        out["quarantined"] = sorted(
            persistence.quarantined_instance_ids(
                self.engine_id, self.engine_version, self.engine_variant
            )
        )
        return out
