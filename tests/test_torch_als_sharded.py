"""ALS over many shards and many processes, held against the JAX package.

* ``_balance_permutation``, ``_sharded_balance_permutation`` and
  ``_sharded_blocks_for_host`` (permutations, pads, degree matrices and
  every bucket's idx/rat/msk) equal the JAX functions EXACTLY for
  (n_hosts, d_local) ∈ {(2, 4), (3, 2), (4, 1)}, from one sqlite file's
  1/N reads (two packages, the same events);
* ``train_als`` on 4 CPU placements (dense with the LPT rebalance, and the
  segment solver) equals the JAX ``train_als`` on 4 CPU devices from the
  same injected threefry draw within rtol = atol = 1e-4 (the trained
  factors' stated tolerance, ROADMAP rule 4);
* two gloo processes of 2 CPU placements each, every one reading its 1/2
  and calling ``train_als`` on its ``ShardedInteractions``, give factors
  equal BIT FOR BIT to a one-process run of the same two hosts' blocks on 4
  placements (the same shards' buckets, in the same order);
* ``pio launch -n 2 -- train --device cpu`` (one placement a process) of the
  recommendation template writes exactly one COMPLETED instance whose
  factors equal a one-process run of the same two hosts' blocks on 2
  placements BIT FOR BIT, and equal the JAX package's sharded train of the
  same two hosts' blocks in one process on 2 devices within 1e-4, entity by
  entity;
* a launch whose process 1 dies after the step-4 checkpoint fails, and the
  relaunch resumes from the coordinator's checkpoint (2 iterations left:
  2 half-steps each a process) to the same factors bit for bit.

The launched workers import a small engine module written by the test,
which hands the JAX draw (by entity name) to ``train_als`` and dumps the
coordinator's trained factors.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.parallel import ingest as jax_ingest
from predictionio_tpu.parallel.mesh import MeshContext as JaxMesh
from predictionio_tpu_torch.data.batch import interactions_from_arrays
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.base import App, PEvents
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.parallel import ingest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
RANK, ITERS, SEED = 4, 6, 3
PARTS = [dict(entity_type="user", event_names=["rate"], target_entity_type="item",
              rating_key="rating", default_rating=4.0),
         dict(entity_type="user", event_names=["buy"], target_entity_type="item",
              default_rating=4.0)]


@pytest.fixture(scope="module", autouse=True)
def jax_udf_under_lock():
    """The JAX package's sqlite store registers its shard function without its
    connection lock; threads sharing the connection then collide."""
    orig = jax_sqlite.SqlitePEvents._ensure_shard_udf

    def locked(self):
        with self.lock:
            orig(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sqlite.SqlitePEvents, "_ensure_shard_udf", locked)
        yield


def _threads(fn, n):
    out, errs = [None] * n, []

    def run(p):
        try:
            out[p] = fn(p)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if errs:
        raise errs[0]
    return out


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One sqlite file of 2,520 ratings and 60 buys, both packages."""
    base = tmp_path_factory.mktemp("als_sharded")
    path = base / "pio.sqlite"
    name = "AS" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{name}_PATH": str(path)}
    port = Storage(env=env)
    app_id = port.get_meta_data_apps().insert(App(0, "L"))
    rng = np.random.default_rng(5)
    # every user rates at least 8 items (MovieLens keeps users with 20 or
    # more): a user with fewer ratings than the rank makes the ALS-WR solve
    # ill-conditioned, and summation-order differences grow past any rule
    pairs = [(u, int(i)) for u in range(90) for i in rng.choice(50, 8, replace=False)]
    pairs += [(int(rng.zipf(1.4) % 90), int(rng.zipf(1.3) % 50)) for _ in range(1800)]
    evs = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                 target_entity_type="item", target_entity_id=f"i{i}",
                 properties={"rating": float(rng.integers(1, 6))})
           for u, i in pairs]
    evs += [Event(event="buy", entity_type="user", entity_id=f"u{k % 90}",
                  target_entity_type="item", target_entity_id=f"i{k % 11}") for k in range(60)]
    port.get_l_events().insert_batch(evs, app_id)
    yield {"port": port, "jax": JaxStorage(env=env), "app_id": app_id, "env": env,
           "path": path, "dir": base}
    port_sqlite.close_all_dbs()
    jax_sqlite.close_all_dbs()


def _sharded(store, n_hosts, pkg="port"):
    key = pkg + uuid.uuid4().hex[:8]
    mod, st = (ingest, store["port"]) if pkg == "port" else (jax_ingest, store["jax"])
    return _threads(lambda p: mod.read_sharded_interactions(
        st, store["app_id"], run_key=key, process_index=p, num_processes=n_hosts,
        parts=PARTS), n_hosts)


def test_balance_permutation_equals_jax():
    rng = np.random.default_rng(1)
    for n_pad, n_shards in ((120, 4), (99, 3), (64, 8)):
        ent = rng.zipf(1.3, 3000) % n_pad
        got = als._balance_permutation(ent, n_pad, n_shards)
        assert np.array_equal(got, jax_als._balance_permutation(ent, n_pad, n_shards))
        assert sorted(got) == list(range(n_pad))


@pytest.mark.parametrize("n_hosts,d_local", [(2, 4), (3, 2), (4, 1)])
def test_sharded_permutation_and_blocks_equal_jax(store, n_hosts, d_local):
    port_sh, jax_sh = _sharded(store, n_hosts), _sharded(store, n_hosts, "jax")
    n_shards = n_hosts * d_local
    for p in range(n_hosts):
        got = als._sharded_blocks_for_host(port_sh[p], n_shards, p, n_hosts)
        want = jax_als._sharded_blocks_for_host(jax_sh[p], n_shards, p, n_hosts)
        assert got[4] == want[4]
        for g, w in ((got[2], want[2]), (got[3], want[3])):  # geometry
            assert g[0] == w[0] and g[1] == w[1]
            assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        for gb, wb in ((got[0], want[0]), (got[1], want[1])):  # blocks
            assert gb.widths == wb.widths and gb.per_shard == wb.per_shard
            assert gb.padded_ratings == wb.padded_ratings
            for f in ("idx", "rat", "msk"):
                for a, b in zip(getattr(gb, f), getattr(wb, f)):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    # the permutation itself, on the exchanged counts
    sh = port_sh[0]
    inv = sh.user_map.inverse
    own = np.array([PEvents.shard_hash(inv[i]) % n_hosts for i in range(sh.n_users)])
    per_shard = max(1, -(-int(np.bincount(own, minlength=n_hosts).max()) // d_local))
    assert np.array_equal(
        als._sharded_balance_permutation(sh.user_counts, own, n_hosts, d_local, per_shard),
        jax_als._sharded_balance_permutation(sh.user_counts, own, n_hosts, d_local, per_shard))


def _triples(seed=0, n_users=70, n_items=45, n=1200):
    rng = np.random.default_rng(seed)
    p_u = (np.arange(1, n_users + 1) + 5.0) ** -0.7
    p_i = (np.arange(1, n_items + 1) + 5.0) ** -1.1
    u = rng.choice(n_users, n, p=p_u / p_u.sum()).astype(np.int32)
    i = rng.choice(n_items, n, p=p_i / p_i.sum()).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r, [f"u{k}" for k in range(n_users)], [f"i{k}" for k in range(n_items)]


@pytest.mark.parametrize("solver,implicit", [("dense", False), ("dense", True),
                                             ("segment", False)])
def test_train_on_four_placements_matches_jax_on_four_devices(solver, implicit):
    from predictionio_tpu.data.batch import Interactions as JI
    from predictionio_tpu.data.bimap import BiMap as JB

    u, i, r, uids, iids = _triples()
    n_u_pad, n_i_pad = 72, 48  # padded to a multiple of 4 shards
    ku, kv = jax.random.split(jax.random.PRNGKey(SEED))
    scale = 1.0 / np.sqrt(RANK)
    U0 = np.asarray(jax.random.normal(ku, (n_u_pad, RANK), jnp.float32) * scale)
    V0 = np.asarray(jax.random.normal(kv, (n_i_pad, RANK), jnp.float32) * scale)
    jinter = JI(user=u, item=i, rating=r, t=np.zeros(len(u)),
                user_map=JB({x: k for k, x in enumerate(uids)}),
                item_map=JB({x: k for k, x in enumerate(iids)}))
    jcfg = jax_als.ALSConfig(rank=RANK, iterations=3, seed=SEED, solver=solver,
                             implicit=implicit, train_kernel="reference")
    want = jax_als.train_als(JaxMesh.create(devices=jax.devices()[:4]), jinter, jcfg)
    pinter = interactions_from_arrays(u, i, r, np.zeros(len(u)), uids, iids)
    cfg = als.ALSConfig(rank=RANK, iterations=3, seed=SEED, solver=solver, implicit=implicit,
                        compute_dtype="f32")
    got = als.train_als(DeviceContext.create(devices=["cpu"] * 4), pinter, cfg,
                        init_factors=(U0, V0))
    np.testing.assert_allclose(got.user_factors, want.user_factors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors, rtol=TOL, atol=TOL)
    # the mesh run is the one-placement run's model within the same rule
    one = als.train_als(DeviceContext.create(device="cpu"), pinter, cfg,
                        init_factors=(U0[:70], V0[:45]))
    if not implicit:  # implicit: the padding rows of V0 enter the gram
        np.testing.assert_allclose(got.item_factors, one.item_factors, rtol=TOL, atol=TOL)


def test_sharded_ingest_needs_the_dense_solver(store):
    sh = _sharded(store, 1)[0]
    with pytest.raises(ValueError, match="dense"):
        als.train_als(DeviceContext.create(device="cpu"), sh,
                      als.ALSConfig(solver="segment", rank=3, iterations=1))


# -- pio launch -----------------------------------------------------------------

ENGINE = """
import os
import numpy as np
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.templates import recommendation as rec

_z = np.load(os.environ["ALS_TEST_INIT"])
_pos = {"U": {n: k for k, n in enumerate(_z["users"])},
        "V": {n: k for k, n in enumerate(_z["items"])}}
_orig_train = rec.train_als
_orig_half = als._dense_half_step
calls = [0]


def _half(*a, **kw):
    calls[0] += 1
    kill = int(os.environ.get("ALS_TEST_KILL_AFTER", "0"))
    if kill and distributed.process_index() == 1 and calls[0] > kill:
        os._exit(9)
    return _orig_half(*a, **kw)


def train_als(ctx, inter, cfg):
    init = (_z["U"][[_pos["U"][n] for n in inter.user_map.keys()]],
            _z["V"][[_pos["V"][n] for n in inter.item_map.keys()]])
    model = _orig_train(ctx, inter, cfg, init_factors=init)
    print("half-steps", calls[0], flush=True)
    if distributed.should_write_storage():
        np.savez(os.environ["ALS_TEST_OUT"], U=model.user_factors, V=model.item_factors,
                 users=np.array(list(model.user_map.keys())),
                 items=np.array(list(model.item_map.keys())))
    return model


als._dense_half_step = _half
rec.train_als = train_als
RecommendationEngine = rec.RecommendationEngine
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_sharded_model(store):
    """The JAX package's sharded train of the same two hosts' blocks in one
    process (each virtual host's ``_sharded_blocks_for_host``, concatenated
    along the shard axis, then ``_make_dense_step`` on 2 devices, as its
    ``dryrun_multichip`` drives it), from its own threefry draw in the
    global-id order; the draw is saved by entity name for the launch."""
    jsh = _sharded(store, 2, "jax")
    cfg = jax_als.ALSConfig(rank=RANK, iterations=ITERS, seed=SEED, solver="dense",
                            train_kernel="reference")
    hosts = [jax_als._sharded_blocks_for_host(jsh[p], 2, p, 2) for p in range(2)]

    def cat(side):
        a, b = hosts[0][side], hosts[1][side]
        return jax_als._DenseBlocks(
            idx=[np.concatenate(x) for x in zip(a.idx, b.idx)],
            rat=[np.concatenate(x) for x in zip(a.rat, b.rat)],
            msk=[np.concatenate(x) for x in zip(a.msk, b.msk)],
            widths=a.widths, per_shard=a.per_shard,
            padded_ratings=a.padded_ratings + b.padded_ratings)

    ub, ib = cat(0), cat(1)
    ctx = JaxMesh.create(devices=jax.devices()[:2])
    rows = ctx.sharding("data")
    bufs = [tuple(jax.device_put(jnp.asarray(a), rows)
                  for k in range(len(b.widths)) for a in (b.idx[k], b.rat[k], b.msk[k]))
            for b in (ub, ib)]
    step = jax_als._make_dense_step(ctx.mesh, ub, ib, cfg)
    ku, kv = jax.random.split(jax.random.PRNGKey(SEED))
    scale = 1.0 / np.sqrt(RANK)
    sh0, u_perm, i_perm = jsh[0], hosts[0][2][2], hosts[0][3][2]
    draws = []
    for k, n, perm in ((ku, sh0.n_users, u_perm), (kv, sh0.n_items, i_perm)):
        d = np.asarray(jax.random.normal(k, (n, RANK), jnp.float32) * scale)
        base = np.zeros((len(perm), RANK), np.float32)
        base[:n] = d
        draws.append((d, jax.device_put(base[np.argsort(perm)], ctx.sharding("data", None))))
    U, V = draws[0][1], draws[1][1]
    for _ in range(ITERS):
        U, V = step(U, V, *bufs)
    users, items = list(sh0.user_map.keys()), list(sh0.item_map.keys())
    np.savez(store["dir"] / "init.npz", U=draws[0][0], V=draws[1][0],
             users=np.array(users), items=np.array(items))
    return (np.asarray(U)[u_perm[:sh0.n_users]], np.asarray(V)[i_perm[:sh0.n_items]],
            users, items)


def _launch(store, tag, extra_env=None, timeout=240):
    d = store["dir"]
    (d / "als_test_engine.py").write_text(ENGINE)
    edir = d / f"engine_{tag}"
    edir.mkdir(exist_ok=True)
    ckpt = d / "ckpt"
    (edir / "engine.json").write_text(
        '{"id": "default", "engineFactory": "als_test_engine.RecommendationEngine", '
        '"datasource": {"params": {"appName": "L"}}, "algorithms": [{"name": "als", '
        f'"params": {{"rank": {RANK}, "numIterations": {ITERS}, "seed": {SEED}, '
        f'"checkpointDir": "{ckpt}", "checkpointInterval": 2}}}}]}}')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(store["env"])
    env.update({
        "PYTHONPATH": f"{d}{os.pathsep}{ROOT}", "PIO_FS_BASEDIR": str(d / "base"),
        "ALS_TEST_INIT": str(d / "init.npz"), "ALS_TEST_OUT": str(d / f"out_{tag}.npz"),
        "OMP_NUM_THREADS": "1",
    })
    env.update(extra_env or {})
    r = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "launch", "-n", "2",
         "--coordinator-port", str(_free_port()), "--", "train", "--engine-dir", str(edir),
         "--device", "cpu"],
        env=env, cwd=d, capture_output=True, text=True, timeout=timeout)
    return r


TWO_BY_TWO = """
import sys
sys.modules["jax"] = None
sys.modules["predictionio_tpu"] = None
import json, os
import numpy as np
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.parallel import distributed, ingest

a = json.loads(os.environ["ALS_TEST_ARGS"])
assert distributed.initialize()
ctx = DeviceContext.create(devices=["cpu"] * 2)
sh = ingest.read_sharded_interactions(Storage(env=a["env"]), a["app_id"], run_key=a["key"],
                                      parts=a["parts"])
z = np.load(a["init"])
pos_u = {n: k for k, n in enumerate(z["users"])}
pos_i = {n: k for k, n in enumerate(z["items"])}
init = (z["U"][[pos_u[n] for n in sh.user_map.keys()]],
        z["V"][[pos_i[n] for n in sh.item_map.keys()]])
cfg = als.ALSConfig(rank=a["rank"], iterations=a["iters"], seed=a["seed"], compute_dtype="f32")
m = als.train_als(ctx, sh, cfg, init_factors=init)
if distributed.should_write_storage():
    np.savez(a["out"], U=m.user_factors, V=m.item_factors,
             users=np.array(list(m.user_map.keys())), items=np.array(list(m.item_map.keys())))
distributed.shutdown()
"""


@pytest.fixture(scope="module")
def two_by_two(store, jax_sharded_model):
    """Two gloo processes of 2 CPU placements each, through ``train_als``."""
    d = store["dir"]
    args = {"env": store["env"], "app_id": store["app_id"], "key": "tbt" + uuid.uuid4().hex[:8],
            "parts": PARTS, "init": str(d / "init.npz"), "out": str(d / "out_2x2.npz"),
            "rank": RANK, "iters": ITERS, "seed": SEED}
    for _attempt in range(3):  # a port taken between bind and use: retry
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update({"PYTHONPATH": str(ROOT), "PIO_COORDINATOR": f"127.0.0.1:{port}",
                    "PIO_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1",
                    "ALS_TEST_ARGS": json.dumps(args)})
        procs = [subprocess.Popen([sys.executable, "-c", TWO_BY_TWO],
                                  env=dict(env, PIO_PROCESS_ID=str(i)), cwd=d,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(2)]
        try:
            outs = [p.communicate(timeout=180)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if all(p.returncode == 0 for p in procs):
            return np.load(args["out"])
        if not any("address already in use" in o.lower() for o in outs):
            break
    raise AssertionError("\n".join(f"[p{i}] rc={p.returncode}\n{o}"
                                   for i, (p, o) in enumerate(zip(procs, outs))))


def test_two_processes_of_two_placements_equal_one_process_of_four_bit_for_bit(
        store, two_by_two):
    cfg = als.ALSConfig(rank=RANK, iterations=ITERS, seed=SEED, compute_dtype="f32")
    _assert_hosts_blocks_in_one_process(store, two_by_two, _sharded(store, 2), cfg, local=2)


def _instances(store):
    ei = store["port"].get_meta_data_engine_instances()
    return [i for i in ei.get_all() if i.engine_factory == "als_test_engine.RecommendationEngine"]


@pytest.fixture(scope="module")
def launched(store, jax_sharded_model):
    r = _launch(store, "clean")
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def _by_name(z):
    return ({n: z["U"][k] for k, n in enumerate(z["users"])},
            {n: z["V"][k] for k, n in enumerate(z["items"])})


def test_launch_writes_exactly_one_completed_instance(store, launched):
    done = [i for i in _instances(store) if i.status == "COMPLETED"]
    assert len(done) == 1 and len(_instances(store)) == 1
    assert store["port"].get_model_data_models().get(done[0].id) is not None
    assert launched.stdout.count("Training completed. Engine instance ID: " + done[0].id) == 2
    assert "[INFO] all 2 processes completed" in launched.stdout
    # 2 sides × 1 local shard × 6 iterations in each process
    assert launched.stdout.count("half-steps 12") == 2


def test_launch_equals_the_hosts_blocks_in_one_process_bit_for_bit(store, launched):
    z = np.load(store["dir"] / "out_clean.npz")
    sh = _sharded(store, 2)
    cfg = als.ALSConfig(rank=RANK, iterations=ITERS, seed=SEED, compute_dtype="f32")
    _assert_hosts_blocks_in_one_process(store, z, sh, cfg, local=1)


def _assert_hosts_blocks_in_one_process(store, z, sh, cfg, local):
    """``z``'s factors equal the two hosts' blocks run in one process on
    2 × ``local`` placements, bit for bit."""
    blocks = [als._sharded_blocks_for_host(sh[p], 2 * local, p, 2) for p in range(2)]
    u_perm, i_perm = blocks[0][2][2], blocks[0][3][2]
    zi = np.load(store["dir"] / "init.npz")
    pos_u = {n: k for k, n in enumerate(zi["users"])}
    pos_i = {n: k for k, n in enumerate(zi["items"])}
    init = (zi["U"][[pos_u[n] for n in sh[0].user_map.keys()]],
            zi["V"][[pos_i[n] for n in sh[0].item_map.keys()]])
    U0, V0 = als.sharded_initial_factors(sh[0], cfg, u_perm, i_perm, init)
    devs = ["cpu"] * local
    u_in = [x for b in blocks for x in als._shard_inputs(b[0], range(local), devs, True)]
    i_in = [x for b in blocks for x in als._shard_inputs(b[1], range(local), devs, True)]
    U_all, V_all = als._run_shards(DeviceContext.create(devices=["cpu"] * (2 * local)),
                                   u_in, i_in, U0, V0, cfg)
    assert list(z["users"]) == list(sh[0].user_map.keys())
    assert z["U"].tobytes() == U_all[u_perm[:sh[0].n_users]].tobytes()
    assert z["V"].tobytes() == V_all[i_perm[:sh[0].n_items]].tobytes()


def test_launch_equals_the_jax_sharded_train_within_the_rule(store, launched, jax_sharded_model):
    jU, jV, users, items = jax_sharded_model
    U, V = _by_name(np.load(store["dir"] / "out_clean.npz"))
    assert set(U) == set(users) and set(V) == set(items)
    np.testing.assert_allclose(np.stack([U[n] for n in users]), jU, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.stack([V[n] for n in items]), jV, rtol=TOL, atol=TOL)


def test_a_killed_launch_resumes_from_the_coordinators_checkpoint(store, launched):
    import shutil

    shutil.rmtree(store["dir"] / "ckpt", ignore_errors=True)
    # process 1 dies inside iteration 5, after the step-4 checkpoint landed
    r = _launch(store, "killed", {"ALS_TEST_KILL_AFTER": str(4 * 2)})
    assert r.returncode != 0
    assert "ERROR: process 1 exited with code 9" in r.stdout, r.stdout + r.stderr
    assert sorted(os.listdir(store["dir"] / "ckpt"))[:2] == ["step_2", "step_2.fp.npy"]
    r = _launch(store, "resumed")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("half-steps 4") == 2  # iterations 5 and 6 only
    a, b = np.load(store["dir"] / "out_clean.npz"), np.load(store["dir"] / "out_resumed.npz")
    assert a["U"].tobytes() == b["U"].tobytes() and a["V"].tobytes() == b["V"].tobytes()
    done = [i for i in _instances(store) if i.status == "COMPLETED"]
    assert len(done) == 2  # the clean launch's and the resumed one's
