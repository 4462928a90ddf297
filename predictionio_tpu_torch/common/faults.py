"""Deterministic fault-injection harness: the seeded fault plan.

Counterpart of ``predictionio_tpu/common/faults.py``: the same rules, the
same ``PIO_FAULT_SPEC`` DSL and the same seeded schedule, so a plan fires
on the same calls in either package. The port compiles in the crash sites
of its durability-critical paths, consulted through :func:`crash_point`:

* ``crash:ingest:before_flush`` — the ingest buffer's flush, before any
  storage write (fast-acked events live only in the WAL);
* ``crash:ingest:before_flush_commit`` — after the storage write, before
  the WAL records are committed (replay rewrites the same ids);
* ``crash:delta:before_seal`` — ``DeltaLog.seal``, after the WAL ack but
  before the delta blob is sealed (replay regrows it);
* ``crash:delta:mid_apply`` — ``DeltaApplier._apply_one``, before the
  applied epoch advances (a restart catches up from the sealed log).

A matching ``crash`` rule hard-kills the process with ``os._exit(137)``: no
atexit hooks, no flushes, the same observable death as ``kill -9``. Also
``crash:canary:mid_promote`` and ``crash:canary:before_receipt``, between
the canary controller's promotion reloads and before its quarantine
receipt (``serving/canary.py``).

The other sites are consulted through :func:`check`:

* ``server:<service>:<path>`` — the HTTP kit, before dispatch (latency,
  error reply, dropped connection, torn chunked stream);
* ``client:router:<path>`` and ``client:replica:delta`` — the fleet
  router, before a forward and before a delta push to a replica;
* ``client:tenant:<tenant>`` — the query server, after a tenant's
  authentication and before its admission;
* ``server:generation:<instance_id>`` — the query server's
  ``/queries.json`` against the deployed generation (how a canary test
  plants a bad candidate);
* ``server:pipeline:<stage>`` — the pipeline engine, before each stage;
* ``client:canary:shadow`` — the canary controller, before each shadow
  replay.

``crash:fleet:replica`` is the fleet supervisor's preemption site, through
:func:`kill_point`: a matching ``crash`` rule SIGKILLs one seeded-random
child replica per firing.

Nothing fires unless a plan is installed — the shim is one ``is None``
check on the hot path.  Installation is programmatic (:func:`install`,
used by the chaos suite) or environmental (``PIO_FAULT_SPEC`` +
``PIO_FAULT_SEED``, for chaos-testing a real deployment).

**Determinism contract**: a rule's fire/skip decision for its *n*-th
matching call is a pure function of ``(seed, rule index, n)`` — same seed,
same call sequence ⇒ same fault schedule, every run.  Per-rule counters
are atomic, so concurrent callers only contend on which logical request
draws which ordinal, never on the schedule itself.
"""

from __future__ import annotations

import fnmatch
import random
import threading
from dataclasses import dataclass
from typing import Optional

KINDS = ("latency", "error", "drop", "truncate", "crash")

# 128 + SIGKILL: the exit code a shell reports for a kill -9 death, so a
# test harness can't tell an injected crash from a real one.
CRASH_EXIT_CODE = 137


@dataclass(frozen=True)
class FaultAction:
    """What a fault site should do for this call."""

    kind: str
    latency_s: float = 0.0
    status: int = 503
    rule: int = 0  # index of the rule that fired (observability)
    ordinal: int = 0  # the rule's n-th matching call (seeds victim picks)


@dataclass
class FaultRule:
    """One line of a fault plan.

    ``site`` is an ``fnmatch`` pattern over site names; ``p`` the per-call
    fire probability; ``times`` caps total fires (None = unlimited);
    ``after`` skips the first N matching calls (lets a plan warm up a
    connection before killing it).
    """

    site: str
    kind: str
    p: float = 1.0
    times: Optional[int] = None
    after: int = 0
    latency_ms: float = 0.0
    status: int = 503

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")


class FaultPlan:
    """A seeded set of rules; thread-safe; observable via :meth:`stats`."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls = [0] * len(self.rules)  # matching calls per rule
        self._fired = [0] * len(self.rules)

    def _decide(self, idx: int, n: int) -> bool:
        """Pure: does rule ``idx`` fire on its ``n``-th matching call?"""
        rule = self.rules[idx]
        if n < rule.after:
            return False
        if rule.p >= 1.0:
            return True
        # a fresh Random per (seed, rule, ordinal): decision independent of
        # thread interleavings and of how many OTHER rules matched before
        # (string seeds hash via sha512 — stable across runs and versions)
        return random.Random(f"{self.seed}:{idx}:{n}").random() < rule.p

    def on_call(self, site: str) -> Optional[FaultAction]:
        """First firing rule wins; returns None when nothing fires."""
        for idx, rule in enumerate(self.rules):
            if not fnmatch.fnmatch(site, rule.site):
                continue
            with self._lock:
                n = self._calls[idx]
                self._calls[idx] += 1
                if rule.times is not None and self._fired[idx] >= rule.times:
                    continue
                if not self._decide(idx, n):
                    continue
                self._fired[idx] += 1
            return FaultAction(
                kind=rule.kind,
                latency_s=rule.latency_ms / 1e3,
                status=rule.status,
                rule=idx,
                ordinal=n,
            )
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [
                    {
                        "site": r.site,
                        "kind": r.kind,
                        "calls": self._calls[i],
                        "fired": self._fired[i],
                    }
                    for i, r in enumerate(self.rules)
                ],
            }


# -- global shim -------------------------------------------------------------
# One installed plan per process. The env plan loads lazily on first check
# so importing this module costs nothing when chaos is off.

_active: Optional[FaultPlan] = None
_env_loaded = False
_install_lock = threading.Lock()


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or, with None, clear) the process-wide fault plan."""
    global _active, _env_loaded
    with _install_lock:
        _active = plan
        _env_loaded = True  # programmatic install wins over the env plan


def clear() -> None:
    install(None)


def _load_env_plan() -> Optional[FaultPlan]:
    import os

    spec = os.environ.get("PIO_FAULT_SPEC")
    if not spec:
        return None
    seed = int(os.environ.get("PIO_FAULT_SEED", "0"))
    return FaultPlan(parse_spec(spec), seed=seed)


def active() -> Optional[FaultPlan]:
    global _active, _env_loaded
    if not _env_loaded:
        with _install_lock:
            if not _env_loaded:
                _active = _load_env_plan()
                _env_loaded = True
    return _active


def check(site: str) -> Optional[FaultAction]:
    """The fault point: consult the installed plan (None = no chaos)."""
    plan = active()
    if plan is None:
        return None
    return plan.on_call(site)


def crash_point(site: str) -> None:
    """A compiled-in process-death site: one ``is None`` check when chaos
    is off; with a matching ``crash`` rule installed, ``os._exit(137)`` —
    bypassing atexit handlers, finally blocks, and buffered-IO flushes, so
    whatever was mid-write stays torn exactly as a SIGKILL would leave it.

    Rules of other kinds matching a crash site are ignored (a latency rule
    can't meaningfully delay a death), but they still consume their
    ordinal — the schedule stays deterministic either way.
    """
    plan = active()
    if plan is None:
        return
    act = plan.on_call(site)
    if act is not None and act.kind == "crash":
        import os

        os._exit(CRASH_EXIT_CODE)


def kill_point(site: str, pids: list[int]) -> Optional[int]:
    """A SUPERVISOR-side preemption site: where :func:`crash_point` kills
    the calling process, this SIGKILLs one of the given *child* pids on
    the plan's seeded schedule (the fleet monitor consults it as
    ``crash:fleet:replica``, so chaos plans can preempt random replicas
    while the fleet is scaling).  The victim is deterministic for a given
    schedule: ``(seed, rule, ordinal)`` picks an index into the sorted pid
    list.  Returns the killed pid, or None when nothing fired, no pids
    were offered, or the victim died before the signal landed.
    """
    plan = active()
    if plan is None or not pids:
        return None
    act = plan.on_call(site)
    if act is None or act.kind != "crash":
        return None
    import os
    import signal

    ordered = sorted(pids)
    pick = random.Random(
        f"{plan.seed}:{act.rule}:{act.ordinal}:victim"
    ).randrange(len(ordered))
    victim = ordered[pick]
    try:
        os.kill(victim, signal.SIGKILL)
    except OSError:
        return None
    return victim


def parse_spec(spec: str) -> list[FaultRule]:
    """``PIO_FAULT_SPEC`` DSL → rules.

    Rules are ``;``-separated; each rule is ``,``-separated ``key=value``
    pairs (``site`` and ``kind`` required)::

        site=server:storageserver:/pevents/*,kind=drop,times=2;
        site=client:storage:/levents/*,kind=latency,latency_ms=250,p=0.1
    """
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        kv: dict[str, str] = {}
        for pair in chunk.split(","):
            k, sep, v = pair.partition("=")
            if not sep:
                raise ValueError(f"bad fault-rule token {pair!r} in {chunk!r}")
            kv[k.strip()] = v.strip()
        if "site" not in kv or "kind" not in kv:
            raise ValueError(f"fault rule needs site= and kind=: {chunk!r}")
        rules.append(
            FaultRule(
                site=kv["site"],
                kind=kv["kind"],
                p=float(kv.get("p", 1.0)),
                times=int(kv["times"]) if "times" in kv else None,
                after=int(kv.get("after", 0)),
                latency_ms=float(kv.get("latency_ms", 0.0)),
                status=int(kv.get("status", 503)),
            )
        )
    return rules
