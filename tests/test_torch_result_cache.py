"""The port's result cache against the JAX package's, on the CPU.

``predictionio_tpu_torch/serving/result_cache.py`` is the JAX module's
counterpart, whole. The same inputs give the same results, exactly:
``canonical_fingerprint`` and ``entity_ids_from`` of seeded bodies; a
seeded sequence of gets, puts, clock steps, model-generation bumps,
evictions and invalidations (``notify_event``, ``notify_delta``,
``notify_delete``) gives the same hits, misses, values and counters; the
environment knobs build the same cache.
"""

import types

import numpy as np
import pytest

from predictionio_tpu.serving import result_cache as jax_rc
from predictionio_tpu_torch.serving import result_cache as port_rc

MODS = (jax_rc, port_rc)


def _bodies(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = {"user": f"u{int(rng.integers(20))}", "num": int(rng.integers(1, 50))}
        if rng.random() < 0.3:
            body["prId"] = f"p{int(rng.integers(1000))}"
        if rng.random() < 0.2:
            body["accessKey"] = "k"
        if rng.random() < 0.3:
            body["items"] = [f"i{int(j)}" for j in rng.integers(0, 30, int(rng.integers(0, 4)))]
        if rng.random() < 0.2:
            body["blackList"] = {"nested": [1, 2.5, None, True]}
        if rng.random() < 0.05:
            body["bad"] = {1, 2}  # unfingerprintable
        keys = list(body)
        rng.shuffle(keys)
        out.append({k: body[k] for k in keys})
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("namespace", [None, "tenant\x1fA\x1finst"])
def test_fingerprints_equal(seed, namespace):
    for body in _bodies(seed):
        a = jax_rc.canonical_fingerprint(body, namespace=namespace)
        b = port_rc.canonical_fingerprint(body, namespace=namespace)
        assert a == b
        assert jax_rc.entity_ids_from(body, jax_rc.DEFAULT_KEY_FIELDS) == \
            port_rc.entity_ids_from(body, port_rc.DEFAULT_KEY_FIELDS)
    # field order and prId never split a key
    assert port_rc.canonical_fingerprint({"a": 1, "b": 2, "prId": "x"}) == \
        port_rc.canonical_fingerprint({"b": 2, "a": 1})
    assert port_rc.canonical_fingerprint(["not", "a", "dict"]) is None


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _cache_run(mod, seed, use_global):
    """A seeded op sequence; every op's outcome and the final stats."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    index = mod.INVALIDATIONS if use_global else mod.InvalidationIndex(max_entities=8)
    cache = mod.ResultCache(max_entries=6, ttl_s=5.0, index=index, clock=clock)
    gen = 0
    trace = []
    for _ in range(600):
        op = rng.random()
        body = {"user": f"u{int(rng.integers(10))}", "num": int(rng.integers(1, 3))}
        fp = mod.canonical_fingerprint(body)
        if op < 0.45:
            got = cache.get(fp, gen)
            trace.append(("get", got))
            if got is None:
                cache.put(fp, {"itemScores": [{"item": body["user"], "score": op}]},
                          mod.entity_ids_from(body, cache.key_fields), gen)
        elif op < 0.6:
            clock.t += float(rng.choice([0.5, 2.0, 6.0]))
        elif op < 0.7:
            ev = types.SimpleNamespace(
                event=str(rng.choice(["rate", "$set", "buy"])),
                entity_id=f"u{int(rng.integers(10))}" if rng.random() < 0.9 else None,
                target_entity_id=None)
            if use_global:
                mod.notify_event(ev)
            else:
                index.bump_entities([ev.entity_id]) if ev.entity_id else index.bump_all()
        elif op < 0.75:
            trace.append(("delta", mod.notify_delta([f"u{int(rng.integers(10))}", None, ""])
                          if use_global else None))
        elif op < 0.78:
            if use_global:
                mod.notify_delete()
            else:
                index.bump_all()
        elif op < 0.8:
            gen += 1
        elif op < 0.82:
            cache.clear()
        else:
            got = cache.get(fp, gen)
            if got is not None:
                got["prId"] = "mutated"  # a caller's rewrite never leaks back
            trace.append(("get2", got))
    stats = cache.stats()
    return trace, stats, len(cache)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_global", [False, True])
def test_hit_miss_eviction_invalidation_sequences_equal(seed, use_global):
    a = _cache_run(jax_rc, seed, use_global)
    b = _cache_run(port_rc, seed, use_global)
    assert a == b
    stats = b[1]
    assert stats["hits"] and stats["misses"] and stats["evictions"]
    assert stats["invalidated_event"] and stats["invalidated_ttl"] and stats["invalidated_model"]


def test_index_eviction_bumps_global_alike():
    out = []
    for mod in MODS:
        idx = mod.InvalidationIndex(max_entities=3)
        tokens = []
        for i in range(10):
            idx.bump_entities([f"e{i % 5}"])
            tokens.append(idx.token(["e0", "e4"]))
        out.append((tokens, idx.stats()))
    assert out[0] == out[1] and out[1][1]["evictions"]


@pytest.mark.parametrize("env", [
    {}, {"PIO_RESULT_CACHE": "1"}, {"PIO_RESULT_CACHE": "off", "PIO_COALESCE": "yes"},
    {"PIO_RESULT_CACHE": "true", "PIO_RESULT_CACHE_TTL_MS": "250", "PIO_RESULT_CACHE_MAX": "7",
     "PIO_RESULT_CACHE_KEYS": "user, item", "PIO_COALESCE": "0"},
])
def test_env_knobs_build_alike(monkeypatch, env):
    for k in ("PIO_RESULT_CACHE", "PIO_RESULT_CACHE_TTL_MS", "PIO_RESULT_CACHE_MAX",
              "PIO_RESULT_CACHE_KEYS", "PIO_COALESCE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a, b = jax_rc.result_cache_from_env(), port_rc.result_cache_from_env()
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.max_entries, a.ttl_s, a.key_fields) == (b.max_entries, b.ttl_s, b.key_fields)
    assert jax_rc.coalesce_from_env() == port_rc.coalesce_from_env()
    # off by default, as in the JAX package
    if not env:
        assert b is None and not port_rc.coalesce_from_env()
