"""Single-flight coalescing in the port's micro-batcher, against the JAX
package's, on the CPU.

The same scripted arrivals go to ``predictionio_tpu.serving.batching.
MicroBatcher`` and to the port's: N identical keys cost one row; a failed
batch fails every attached waiter; distinct keys and ``key=None`` never
coalesce; a late identical arrival becomes a fresh leader; a follower's
timeout leaves its leader intact; an expired leader promotes its live
follower. The outcomes, the rows each batch ran and the counters must be
equal. Then the port's ``QueryServer(coalesce=True, batching=True)``
answers bursts of identical queries with the answers of the uncoalesced
server (``topk_mismatches`` at 1e-5), paying one row a distinct query.
"""

import threading
import time
import uuid

import numpy as np
import pytest

from predictionio_tpu.common.resilience import Deadline as JaxDeadline
from predictionio_tpu.common.resilience import DeadlineExceeded as JaxDeadlineExceeded
from predictionio_tpu.serving import batching as jax_batching
from predictionio_tpu_torch.common.resilience import Deadline as PortDeadline
from predictionio_tpu_torch.common.resilience import DeadlineExceeded as PortDeadlineExceeded
from predictionio_tpu_torch.serving import batching as port_batching

SIDES = {
    "jax": (jax_batching, JaxDeadline, JaxDeadlineExceeded),
    "port": (port_batching, PortDeadline, PortDeadlineExceeded),
}


def _wait_for(pred, timeout=5.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _outcome(x):
    return ("error", type(x).__name__, str(x)) if isinstance(x, BaseException) else ("ok", x)


def _followers_share(side, n):
    mod, _, _ = SIDES[side]
    gate = threading.Event()
    calls = []

    def run_batch(batch):
        calls.append(list(batch))
        gate.wait(5)
        return [f"r:{q}" for q in batch]

    mb = mod.MicroBatcher(run_batch)
    results = {}

    def submit(i):
        results[i] = mb.submit("q", key="k")

    leader = threading.Thread(target=submit, args=(0,))
    leader.start()
    assert _wait_for(lambda: calls and "k" in mb._inflight_keys)
    followers = [threading.Thread(target=submit, args=(i,)) for i in range(1, n)]
    for t in followers:
        t.start()
    assert _wait_for(lambda: mb.stats()["coalesced"] == n - 1)
    gate.set()
    for t in [leader, *followers]:
        t.join(5)
    stats = mb.stats()
    mb.stop()
    return calls, sorted(results.items()), stats["coalesced"], stats["queries"], dict(mb._inflight_keys)


@pytest.mark.parametrize("n", [2, 5, 17])
def test_identical_keys_cost_one_row(n):
    a, b = (_followers_share(s, n) for s in SIDES)
    assert a == b
    calls, results, coalesced, queries, keys = b
    assert calls == [["q"]] and len(results) == n and coalesced == n - 1 and not keys


def _failed_batch(side):
    mod, _, _ = SIDES[side]
    gate = threading.Event()

    def run_batch(batch):
        gate.wait(5)
        raise RuntimeError("device fell over")

    mb = mod.MicroBatcher(run_batch)
    out = {}

    def submit(i):
        try:
            out[i] = mb.submit("q", key="k", timeout=10)
        except BaseException as e:
            out[i] = e

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
    threads[0].start()
    assert _wait_for(lambda: "k" in mb._inflight_keys)
    for t in threads[1:]:
        t.start()
    assert _wait_for(lambda: mb.stats()["coalesced"] == 2)
    gate.set()
    for t in threads:
        t.join(5)
    mb.stop()
    return sorted((i, _outcome(o)) for i, o in out.items()), dict(mb._inflight_keys)


def test_a_failed_batch_fails_every_waiter():
    a, b = (_failed_batch(s) for s in SIDES)
    assert a == b and all(o[0] == "error" for _, o in b[0]) and not b[1]


def _sequential(side):
    mod, _, _ = SIDES[side]
    calls = []

    def run_batch(batch):
        calls.append(list(batch))
        return [f"r:{q}" for q in batch]

    mb = mod.MicroBatcher(run_batch)
    got = [mb.submit("a", key="ka"), mb.submit("b", key="kb"), mb.submit("a"),
           mb.submit("a"), mb.submit("q", key="k"), mb.submit("q", key="k")]
    stats = mb.stats()
    mb.stop()
    return got, calls, stats["coalesced"], stats["batches"]


def test_distinct_keys_no_key_and_late_arrivals_never_coalesce():
    a, b = (_sequential(s) for s in SIDES)
    assert a == b and b[2] == 0 and len(b[1]) == 6


def _follower_timeout(side):
    mod, _, exc = SIDES[side]
    gate = threading.Event()

    def run_batch(batch):
        gate.wait(5)
        return [f"r:{q}" for q in batch]

    mb = mod.MicroBatcher(run_batch)
    out = {}
    t = threading.Thread(target=lambda: out.update(lead=mb.submit("q", key="k", timeout=10)))
    t.start()
    assert _wait_for(lambda: "k" in mb._inflight_keys)
    try:
        mb.submit("q", key="k", timeout=0.05)
        follower = "answered"
    except exc as e:
        follower = str(e)
    gate.set()
    t.join(5)
    mb.stop()
    return out["lead"], follower


def test_a_follower_timeout_leaves_its_leader_intact():
    a, b = (_follower_timeout(s) for s in SIDES)
    assert a == b == ("r:q", "coalesced query timed out")


def _expired_leader(side):
    mod, deadline, exc = SIDES[side]
    gate = threading.Event()
    calls = []

    def run_batch(batch):
        calls.append(list(batch))
        if len(calls) == 1:
            gate.wait(5)
        return [f"r:{q}" for q in batch]

    mb = mod.MicroBatcher(run_batch)
    out = {}
    t_hold = threading.Thread(target=lambda: out.update(hold=mb.submit("hold")))
    t_hold.start()
    assert _wait_for(lambda: mb._busy.locked())

    def lead():
        try:
            out["lead"] = mb.submit("q", key="k", deadline=deadline.after_ms(60))
        except exc as e:
            out["lead"] = e

    t_lead = threading.Thread(target=lead)
    t_lead.start()
    assert _wait_for(lambda: "k" in mb._inflight_keys)
    t_follow = threading.Thread(target=lambda: out.update(follow=mb.submit("q", key="k", timeout=10)))
    t_follow.start()
    assert _wait_for(lambda: len(mb._inflight_keys["k"].followers) == 1)
    time.sleep(0.12)  # the leader's deadline lapses while it is queued
    gate.set()
    for t in (t_hold, t_lead, t_follow):
        t.join(5)
    stats = mb.stats()
    mb.stop()
    return ({k: _outcome(v) for k, v in sorted(out.items())}, calls,
            stats["expired_dropped"], dict(mb._inflight_keys))


def test_an_expired_leader_promotes_its_follower():
    a, b = (_expired_leader(s) for s in SIDES)
    assert a == b
    outcomes, calls, expired, keys = b
    assert outcomes["lead"][0] == "error" and outcomes["follow"] == ("ok", "r:q")
    assert calls == [["hold"], ["q"]] and expired == 1 and not keys


# -- the query server: coalesced answers equal the uncoalesced ones ----------


@pytest.fixture()
def port_pair(monkeypatch):
    """Two port servers on one random model: coalescing on and off."""
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models.als import als_model_from_arrays
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    for k in ("PIO_RESULT_CACHE", "PIO_COALESCE"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(9)
    model = als_model_from_arrays(rng.standard_normal((60, 4)).astype(np.float32),
                                  rng.standard_normal((90, 4)).astype(np.float32),
                                  [f"u{i}" for i in range(60)], [f"i{j}" for j in range(90)])
    src = "CO" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={f"PIO_STORAGE_SOURCES_{src}_TYPE": "memory",
                           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
                           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src})
    engine = RecommendationEngine.apply()
    params = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 4}}]})
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
                          engine_id="default", engine_version="default",
                          engine_variant="default", engine_factory="f",
                          **params.to_json_strings())
    iid = instances.insert(inst)
    blob = persistence.serialize_models(iid, engine.make_algorithms(params), [model],
                                        [p for _, p in params.algorithm_params_list])
    storage.get_model_data_models().insert(Model(id=iid, models=persistence.seal_model_blob(blob)))
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    servers = [QueryServer(engine, storage=storage, ctx=DeviceContext.create(device="cpu"),
                           batching=True, coalesce=c) for c in (True, False)]
    bases = [f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}" for qs in servers]
    yield servers, bases
    for qs in servers:
        qs.stop()
    memory.reset_store(src)


def test_coalesced_answers_equal_the_uncoalesced_ones(port_pair):
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.testing import topk_mismatches

    (on, off), (base_on, base_off) = port_pair

    def post(base, q):
        req = urllib.request.Request(base + "/queries.json", data=json.dumps(q).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    users = [f"u{i}" for i in (3, 17, 41, 58)]
    burst = [{"user": u, "num": 7} for u in users for _ in range(8)]
    with ThreadPoolExecutor(len(burst)) as pool:
        with on._batcher.held():
            futs = [pool.submit(post, base_on, q) for q in burst]
            assert _wait_for(lambda: on._inflight == len(burst), 20)
            time.sleep(0.05)
        got = [f.result() for f in futs]
    stats = on._fastpath_stats()
    assert on._batcher.stats()["coalesced"] == len(burst) - len(users)
    assert stats["queries"] == len(users)  # one row a distinct query
    bad = []
    for q, a in zip(burst, got):
        ref = post(base_off, q)
        gi = np.array([[int(x["item"][1:]) for x in a["itemScores"]]])
        gv = np.array([[x["score"] for x in a["itemScores"]]])
        ri = np.array([[int(x["item"][1:]) for x in ref["itemScores"]]])
        rv = np.array([[x["score"] for x in ref["itemScores"]]])
        bad += topk_mismatches(gv, gi, rv, ri, 1e-5)
    assert not bad, bad[:3]
    assert off._batcher.stats()["coalesced"] == 0
