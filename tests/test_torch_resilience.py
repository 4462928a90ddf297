"""The port's resilience policies against the JAX package's, on the CPU.

``predictionio_tpu_torch/common/resilience.py`` is the JAX module's
counterpart; the same operations on both must give the same results,
exactly: circuit-breaker state sequences on an injected clock, retry
schedules from a seeded rng, ``X-Request-Deadline`` parsing, the ambient
deadline scope, the composed call, ``ErrorCounters`` and the rate-limited
logger.
"""

import logging
import types

import numpy as np
import pytest

from predictionio_tpu.common import resilience as jax_r
from predictionio_tpu_torch.common import resilience as port_r

MODS = (jax_r, port_r)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_trace(mod, seed):
    """A seeded walk of successes and failures over an injected clock; the
    breaker's answer, state and stats after every step."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    b = mod.CircuitBreaker("ep", failure_threshold=3, reset_timeout_s=5.0, clock=clock)
    out = []
    for _ in range(200):
        clock.t += float(rng.choice([0.0, 0.5, 2.0, 6.0]))
        allowed = b.allow()
        if allowed:
            op = rng.integers(3)
            if op == 0:
                b.record_success()
            elif op == 1:
                b.record_failure()
            else:
                b.abort_probe()
        out.append((allowed, b.state, b.retry_after_s(), b.stats()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_state_sequences_equal(seed):
    a, b = (_breaker_trace(m, seed) for m in MODS)
    assert a == b
    assert {s for _, s, _, _ in a} == {"closed", "open", "half_open"}


@pytest.mark.parametrize("seed", [0, 7, None])
def test_retry_schedules_equal(seed):
    kw = dict(max_attempts=6, base_backoff_s=0.01, multiplier=3.0, max_backoff_s=0.5,
              jitter=0.5 if seed is not None else 0.0, seed=seed)
    a, b = (m.RetryPolicy(**kw) for m in MODS)
    assert [a.backoff_s(i) for i in range(1, 9)] == [b.backoff_s(i) for i in range(1, 9)]


def test_retry_budget_sequences_equal():
    a, b = (m.RetryBudget(ratio=0.3, cap=2.0) for m in MODS)
    trace = []
    for bud in (a, b):
        steps = []
        for i in range(30):
            if i % 3 == 0:
                bud.on_attempt()
            steps.append((bud.take(), round(bud.tokens(), 12)))
        trace.append(steps)
    assert trace[0] == trace[1]


@pytest.mark.parametrize("value", [None, "", "abc", "-5", "0", "12.5", "250", "1e3"])
def test_deadline_headers_parse_alike(value):
    a, b = (m.parse_deadline_header(value) for m in MODS)
    assert (a is None) == (b is None)
    if a is not None:
        # both measure from their own call: within a millisecond
        assert abs(a.remaining_ms() - b.remaining_ms()) < 1.0
        assert a.expired() == b.expired() == (float(value) <= 0)
    assert port_r.DEADLINE_HEADER == jax_r.DEADLINE_HEADER == "X-Request-Deadline"


def test_deadline_scope_nests_alike():
    for m in MODS:
        d1, d2 = m.Deadline.after_ms(100), m.Deadline.after_ms(50)
        assert m.current_deadline() is None
        with m.deadline_scope(d1):
            assert m.current_deadline() is d1
            with m.deadline_scope(None):
                assert m.current_deadline() is None
                with m.deadline_scope(d2):
                    assert m.current_deadline() is d2
            assert m.current_deadline() is d1
        assert m.current_deadline() is None
        assert m.Deadline.min(None, d1, d2) is d2 and m.Deadline.min(None) is None


class _Err(Exception):
    def __init__(self, status):
        super().__init__(f"status {status}")
        self.status = status


@pytest.mark.parametrize("exc", [ConnectionError("x"), TimeoutError("t"), OSError("o"),
                                 _Err(503), _Err(400), ValueError("v"), KeyError("k")])
def test_default_retryable_alike(exc):
    assert jax_r.default_retryable(exc) == port_r.default_retryable(exc)


def _composed_trace(mod, outcomes, **kw):
    """``call_with_resilience`` over a scripted sequence of outcomes (an
    exception or a value per call); what it returned or raised, the calls
    made, the sleeps asked for, and the breaker's stats."""
    calls, sleeps = [], []
    it = iter(outcomes)

    def fn():
        calls.append(1)
        o = next(it)
        if isinstance(o, BaseException):
            raise o
        return o

    clock = _Clock()
    breaker = mod.CircuitBreaker("c", failure_threshold=2, reset_timeout_s=1.0, clock=clock)
    policy = mod.RetryPolicy(max_attempts=3, base_backoff_s=0.01, seed=3,
                             budget=mod.RetryBudget(ratio=0.5, cap=1.0))
    results = []
    for _ in range(4):
        try:
            r = mod.call_with_resilience(fn, policy, breaker=breaker, sleep=sleeps.append, **kw)
            results.append(("ok", r))
        except mod.BreakerOpen as e:
            results.append(("breaker", e.endpoint))
        except Exception as e:
            results.append(("raised", type(e).__name__))
        clock.t += 0.6
    return results, len(calls), sleeps, breaker.stats()


@pytest.mark.parametrize("script", [
    [ConnectionError("a"), "v1", "v2", "v3", "v4"],
    [ConnectionError("a")] * 12,
    [_Err(400), "v", ConnectionError("b"), ConnectionError("c"), "w", "x", "y"],
    [TimeoutError("t"), TimeoutError("t"), "late", "v", "w", "x"],
])
def test_composed_calls_alike(script):
    a = _composed_trace(jax_r, list(script))
    b = _composed_trace(port_r, list(script))
    assert a == b


def test_error_counters_alike():
    names = ("shed", "degraded", "query_errors")
    a, b = (m.ErrorCounters(*names) for m in MODS)
    rng = np.random.default_rng(5)
    for _ in range(100):
        n = names[int(rng.integers(3))] if rng.random() < 0.9 else "other"
        by = int(rng.integers(1, 4))
        a.inc(n, by)
        b.inc(n, by)
    assert a.snapshot() == b.snapshot() and a.get("other") == b.get("other")


def test_rate_limited_logger_alike(caplog, monkeypatch):
    lines = []
    for m in MODS:
        t = [0.0]
        monkeypatch.setattr(m, "time", types.SimpleNamespace(monotonic=lambda: t[0]))
        log = m.RateLimitedLogger(logging.getLogger(f"rl.{m.__name__}"), interval_s=10.0)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            for step in range(30):
                t[0] = step * 1.5
                log.warning("k", "msg %d", step)
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and any("suppressed" in x for x in lines[0])
