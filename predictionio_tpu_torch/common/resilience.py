"""Resilience policies: deadlines, retries with budgets, circuit breakers.

Counterpart of ``predictionio_tpu/common/resilience.py``, whole.

The policy layer every networked component shares (Cloudburst-style
prediction serving and Google's ads stack both win tail latency and
availability this way — admission control + deadline propagation +
bounded retries, not heroic kernels):

* :class:`Deadline` — a monotonic-clock budget that travels with a request
  (``X-Request-Deadline`` carries *remaining milliseconds* on the wire, so
  clock skew between hosts never corrupts it).
* :class:`RetryPolicy` + :class:`RetryBudget` — jittered exponential
  backoff with a global token-bucket budget so a dying dependency sees a
  bounded retry amplification (budget exhausted ⇒ fail fast), never a
  retry storm.
* :class:`CircuitBreaker` — per-endpoint closed → open → half-open; an
  open breaker fails fast without burning a socket, one probe per cooldown
  decides whether to close again.
* :func:`call_with_resilience` — the composition of all three around any
  callable.
* :class:`RateLimitedLogger` / :class:`ErrorCounters` — make failures
  visible (counters on the stats route) without letting a failure loop
  saturate the log.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

DEADLINE_HEADER = "X-Request-Deadline"


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed; subclasses TimeoutError so existing
    timeout handling (batched-query waiters) keeps working."""


class BreakerOpen(Exception):
    """Failed fast: the endpoint's circuit breaker is open."""

    def __init__(self, endpoint: str, retry_after_s: float = 0.0):
        super().__init__(f"circuit breaker open for {endpoint}")
        self.endpoint = endpoint
        self.retry_after_s = retry_after_s


# -- deadlines ---------------------------------------------------------------


@dataclass(frozen=True)
class Deadline:
    """Absolute monotonic deadline. Construct via :meth:`after_ms`."""

    at: float  # time.monotonic() timestamp

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1e3)

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def expired(self) -> bool:
        return self.remaining_s() <= 0

    @staticmethod
    def min(*deadlines: Optional["Deadline"]) -> Optional["Deadline"]:
        live = [d for d in deadlines if d is not None]
        if not live:
            return None
        return min(live, key=lambda d: d.at)


def parse_deadline_header(value: Optional[str]) -> Optional[Deadline]:
    """``X-Request-Deadline: <remaining ms>`` → Deadline (None if absent
    or malformed — a bad header must degrade to "no deadline", never 500)."""
    if not value:
        return None
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    if ms < 0:
        ms = 0.0
    return Deadline.after_ms(ms)


# ambient deadline: request handlers bind the parsed deadline here so
# layers with no deadline parameter in their signature (the storage DAO
# surface, cache fill paths) can still cap their outbound hops.  Same
# shape as obs._tracing.active_traces(): thread-local, scope-managed,
# absent ⇒ None (no deadline), never raises.
_ambient = threading.local()


def current_deadline() -> Optional[Deadline]:
    """The deadline bound to this thread's active request, if any."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


class deadline_scope:
    """``with deadline_scope(d):`` binds ``d`` as the thread's ambient
    deadline.  ``None`` is a valid binding (explicitly "no deadline" —
    shadows any outer scope, e.g. a background loop spawned mid-request).
    Re-entrant; always pops what it pushed."""

    def __init__(self, deadline: Optional[Deadline]):
        self._deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        stack = getattr(_ambient, "stack", None)
        if stack is None:
            stack = _ambient.stack = []
        stack.append(self._deadline)
        return self._deadline

    def __exit__(self, *exc) -> None:
        _ambient.stack.pop()


# -- retry budget + policy ---------------------------------------------------


class RetryBudget:
    """Token bucket bounding cluster-wide retry amplification.

    Every first attempt credits ``ratio`` tokens (capped); every retry
    debits one.  Under a total outage at ratio 0.1 the dependency sees at
    most ~1.1× its normal call volume instead of ``max_attempts``×.
    """

    def __init__(self, ratio: float = 0.1, cap: float = 20.0):
        self.ratio = ratio
        self.cap = cap
        self._tokens = cap
        self._lock = threading.Lock()

    def on_attempt(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def take(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


@dataclass
class RetryPolicy:
    """Jittered exponential backoff. ``seed`` pins the jitter sequence so
    chaos tests replay byte-identical schedules."""

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5  # each backoff is uniform in [b·(1-j), b]
    budget: Optional[RetryBudget] = None
    seed: Optional[int] = None
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._rng_lock = threading.Lock()

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based: first retry = 1)."""
        b = min(
            self.max_backoff_s,
            self.base_backoff_s * self.multiplier ** (attempt - 1),
        )
        if self.jitter <= 0:
            return b
        with self._rng_lock:
            return b * (1.0 - self.jitter * self._rng.random())


# -- circuit breaker ---------------------------------------------------------


class CircuitBreaker:
    """Per-endpoint failure gate: CLOSED → (N consecutive failures) → OPEN
    → (cooldown) → HALF_OPEN (one probe) → CLOSED on success / OPEN again
    on failure."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        endpoint: str = "",
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.endpoint = endpoint
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self.open_count = 0  # times the breaker tripped (observability)
        self.fast_failures = 0  # calls rejected while open

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now?  Transitions OPEN → HALF_OPEN when
        the cooldown has elapsed, admitting exactly one probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    self._probe_inflight = True
                    return True
                self.fast_failures += 1
                return False
            # HALF_OPEN: one probe at a time
            if self._probe_inflight:
                self.fast_failures += 1
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._probe_inflight = False

    def abort_probe(self) -> None:
        """Release the half-open probe slot without judging endpoint health.

        A probe that ends in a non-retryable, request-shaped error (an HTTP
        400 from a legacy replica, say) proves nothing about the endpoint —
        but the slot must come back, or the breaker wedges in HALF_OPEN
        rejecting every call forever with no probe able to run."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.open_count += 1
                self._probe_inflight = False

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(
                0.0, self.reset_timeout_s - (self._clock() - self._opened_at)
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "endpoint": self.endpoint,
                "state": self._state,
                "consecutive_failures": self._failures,
                "open_count": self.open_count,
                "fast_failures": self.fast_failures,
            }


# -- composed call -----------------------------------------------------------


def default_retryable(exc: BaseException) -> bool:
    """Transport-ish errors retry; everything else (bad request, logic
    errors) propagates immediately."""
    status = getattr(exc, "status", None)
    if status is not None:
        return status >= 500
    return isinstance(exc, (ConnectionError, TimeoutError, OSError)) or (
        type(exc).__name__ in ("NetworkStorageError", "URLError")
    )


def call_with_resilience(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    breaker: Optional[CircuitBreaker] = None,
    retryable: Callable[[BaseException], bool] = default_retryable,
    deadline: Optional[Deadline] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` under retry policy + breaker + deadline.

    Raises :class:`BreakerOpen` without calling ``fn`` when the breaker is
    open, :class:`DeadlineExceeded` when the deadline lapses between
    attempts, and the last underlying error when attempts/budget run out.
    """
    if policy.budget is not None:
        policy.budget.on_attempt()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded("deadline expired before attempt") from last
        if breaker is not None and not breaker.allow():
            raise BreakerOpen(breaker.endpoint, breaker.retry_after_s())
        try:
            result = fn()
        except BaseException as e:
            if not retryable(e):
                # a structurally-bad request says nothing about endpoint
                # health: neither a breaker failure nor a retry candidate —
                # but if this call held the half-open probe slot it must be
                # released, or the breaker wedges rejecting all traffic
                if breaker is not None:
                    breaker.abort_probe()
                raise
            if breaker is not None:
                breaker.record_failure()
            last = e
            if attempt >= policy.max_attempts:
                raise
            if policy.budget is not None and not policy.budget.take():
                raise  # budget exhausted: fail fast, no retry storm
            pause = policy.backoff_s(attempt)
            if deadline is not None and deadline.remaining_s() <= pause:
                raise DeadlineExceeded(
                    "deadline expired during backoff"
                ) from e
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(pause)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
    raise last  # pragma: no cover - loop always returns or raises


# -- observability helpers ---------------------------------------------------


class ErrorCounters:
    """Thread-safe named counters surfaced on stats routes."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {n: 0 for n in names}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


class RateLimitedLogger:
    """At most one log line per key per interval; suppressed occurrences
    are folded into the next emitted line (``… (+N suppressed)``)."""

    def __init__(self, logger: logging.Logger, interval_s: float = 10.0):
        self._logger = logger
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._suppressed: dict[str, int] = {}

    def _should_emit(self, key: str) -> tuple[bool, int]:
        now = time.monotonic()
        with self._lock:
            last = self._last.get(key)
            if last is not None and now - last < self.interval_s:
                self._suppressed[key] = self._suppressed.get(key, 0) + 1
                return False, 0
            self._last[key] = now
            n = self._suppressed.pop(key, 0)
            return True, n

    def _emit(self, level: str, key: str, msg: str, *args, exc_info=False):
        emit, suppressed = self._should_emit(key)
        if not emit:
            return
        if suppressed:
            msg += f" (+{suppressed} similar suppressed)"
        getattr(self._logger, level)(msg, *args, exc_info=exc_info)

    def warning(self, key: str, msg: str, *args) -> None:
        self._emit("warning", key, msg, *args)

    def exception(self, key: str, msg: str, *args) -> None:
        self._emit("error", key, msg, *args, exc_info=True)
