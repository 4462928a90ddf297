"""The templates' sharded paths across two gloo processes against one
process, on one sqlite file.

A module fixture writes the events, trains and publishes one recommendation
instance in this process, then runs two worker processes (``--device
cpu``'s mesh under a launch: one CPU placement each) that, each from its
1/N read:

* train co-occurrence (LLR) and the Universal Recommender: their top-n
  lists follow ROADMAP §3's LLR rule against the float64 LLR of the exact
  counts (``testing.llr_topk_mismatches``), the counts summed across the
  processes;
* train e-commerce: the popular counts equal the one-process counts
  EXACTLY, item by item;
* run ``run_batch_predict`` on the published instance: each process writes
  ``<output>.part-<i>`` with the lines ``(line_no - 1) % 2 == i``, and the
  parts together hold the one-process output's answers by rule 4;
* train SASRec data parallel for 4 steps: each step's loss is within 1e-6
  of a one-process step on the same global batch (both processes' rows,
  drawn by their own seeded streams) from the same start;
* ``seq_parallel`` under the launch raises the JAX package's refusal.

Workers block jax and the JAX package, and run on ports bound at 0.
"""

import dataclasses
import datetime as dt
import json
import os
import pathlib
import socket
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import cooccurrence as co
from predictionio_tpu_torch.models import sequential as seq
from predictionio_tpu_torch.serving.batch_predict import run_batch_predict
from predictionio_tpu_torch.templates import ecommerce
from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
from predictionio_tpu_torch.testing import llr_atol, llr_reference64, llr_topk_mismatches

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = DeviceContext.create(device="cpu")
APP = "LT"
N_USERS, N_ITEMS = 60, 30
SAS = dict(d_model=8, n_heads=1, n_layers=1, max_len=8, epochs=4, batch_size=16)
BLOCKED = "import sys\nsys.modules['jax'] = None\nsys.modules['predictionio_tpu'] = None\n"

WORKER = BLOCKED + """
import dataclasses, json, os
import numpy as np
from predictionio_tpu_torch.parallel import distributed, ingest
assert distributed.initialize()
pid = distributed.process_index()
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import cooccurrence as co
from predictionio_tpu_torch.models import sequential as seq
from predictionio_tpu_torch.serving.batch_predict import run_batch_predict
from predictionio_tpu_torch.templates import ecommerce
from predictionio_tpu_torch.templates import universal as ur
from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

st = Storage.instance()
store.set_storage(st)
app_id = st.get_meta_data_apps().get_by_name(APP).id
ctx = DeviceContext.create(device="cpu")
assert ctx.spans_processes and ctx.n_devices == 2
out = {}

def run_id(tag):
    os.environ["PIO_RUN_ID"] = RUN + tag
    distributed.barrier()

run_id("co")
sh = ingest.read_sharded_interactions(st, app_id, entity_type="user", event_names=["buy"],
                                      target_entity_type="item")
m = co.train_cooccurrence(ctx, sh, n=4, use_llr=True)
out["co"] = [list(m.item_map.keys()), m.top_items.tolist(), m.top_scores.tolist(), sh.n_users]

run_id("ur")
td = ur.URDataSource(ur.URDataSourceParams(appName=APP)).read_training(ctx)
assert td.n_hosts == 2
um = ur.URAlgorithm(ur.URAlgorithmParams(appName=APP, maxCorrelatorsPerItem=4)).train(ctx, td)
out["ur"] = [list(um.item_map.keys()), len(td.user_map),
             {k: [v[0].tolist(), v[1].tolist()] for k, v in um.indicators.items()}]

run_id("ecomm")
etd = ecommerce.ECommDataSource(ecommerce.ECommDataSourceParams(appName=APP)).read_training(ctx)
em = ecommerce.ECommAlgorithm(ecommerce.ECommAlgorithmParams(
    appName=APP, rank=3, numIterations=2)).train(ctx, etd)
out["ecomm"] = [list(em.als.item_map.keys()), em.popular.tolist()]

run_id("bp")
n, path = run_batch_predict(RecommendationEngine.apply(), INPUT, OUTPUT, storage=st, ctx=ctx)
out["bp"] = [n, path]

run_id("sas")
ssh = ingest.read_sharded_interactions(st, app_id, entity_type="user", event_names=["view"],
                                       target_entity_type="item", item_pass=False)
cfg = seq.SASRecConfig(**SAS)
start = seq.init_params(0, cfg, ssh.n_items)
sm = seq.train_sasrec(ctx, ssh, cfg, init_params=start)
rows, n_global = seq._sharded_sequences(ssh, cfg)
out["sas"] = [sm.losses.tolist(), rows.tolist(), n_global, ssh.n_items]
try:
    seq.train_sasrec(ctx, ssh, dataclasses.replace(cfg, seq_parallel=True))
    out["sp"] = "trained"
except ValueError as e:
    out["sp"] = str(e)
with open(f"{DIR}/worker{pid}.json", "w") as f:
    json.dump(out, f)
distributed.barrier()
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _events():
    rng = np.random.default_rng(11)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    evs = []
    for u in range(N_USERS):
        for k, i in enumerate(rng.choice(N_ITEMS, int(rng.integers(1, 5)), replace=False)):
            evs.append(Event(event="buy", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{int(i)}",
                             event_time=t0 + dt.timedelta(minutes=u * 100 + k)))
        for k, i in enumerate(rng.choice(N_ITEMS, int(rng.integers(2, 8)), replace=False)):
            evs.append(Event(event="view", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{int(i)}",
                             event_time=t0 + dt.timedelta(minutes=u * 100 + 10 + k)))
        for i in rng.choice(N_ITEMS, 8, replace=False):
            evs.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{int(i)}",
                             properties={"rating": float(rng.integers(1, 6))}))
    return evs


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_templates")
    name = "LT" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{name}_PATH": str(d / "pio.sqlite")}
    for r in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = name
    st = Storage(env=env)
    app_id = st.get_meta_data_apps().insert(App(0, APP))
    st.get_l_events().insert_batch(_events(), app_id)
    store.set_storage(st)
    try:
        engine = RecommendationEngine.apply()
        params = engine.params_from_variant({
            "datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3}}]})
        run_train(engine, params, "predictionio_tpu_torch.templates.recommendation."
                  "RecommendationEngine", storage=st, ctx=CPU)
        with open(d / "queries.jsonl", "w") as f:
            for u in range(0, N_USERS, 2):
                f.write(json.dumps({"user": f"u{u}", "num": 5}) + "\n")
            f.write("not json\n")
        one_n, _ = run_batch_predict(RecommendationEngine.apply(), str(d / "queries.jsonl"),
                                     str(d / "one.jsonl"), storage=st, ctx=CPU)
        wenv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        wenv.update(env)
        wenv.update({"PYTHONPATH": str(ROOT), "PIO_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1",
                     "PIO_FS_BASEDIR": str(d / "base")})
        code = (f"APP = {APP!r}\nRUN = {uuid.uuid4().hex[:8]!r}\nDIR = {str(d)!r}\n"
                f"INPUT = {str(d / 'queries.jsonl')!r}\nOUTPUT = {str(d / 'bp.jsonl')!r}\n"
                f"SAS = {SAS!r}\n" + WORKER)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code], cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(wenv, PIO_COORDINATOR=f"127.0.0.1:{port}", PIO_PROCESS_ID=str(i)))
            for i in range(2)]
        try:
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(outs)
        yield {"dir": d, "storage": st, "workers": [json.load(open(d / f"worker{i}.json"))
                                                     for i in range(2)], "one_n": one_n}
    finally:
        store.set_storage(None)
        port_sqlite.close_all_dbs()


def _pairs(event):
    """Distinct (user, item) pairs of one event type in the file."""
    out = set()
    for e in _events():
        if e.event == event:
            out.add((e.entity_id, e.target_entity_id))
    return out


def _counts(items, primary, secondary):
    """Exact distinct-user counts by the items' order: C (p, s), marginals."""
    pos = {n: k for k, n in enumerate(items)}
    n = len(items)
    users_p = [set() for _ in range(n)]
    users_s = [set() for _ in range(n)]
    for u, i in primary:
        users_p[pos[i]].add(u)
    for u, i in secondary:
        users_s[pos[i]].add(u)
    C = np.array([[len(a & b) for b in users_s] for a in users_p], np.float64)
    return C, np.array([len(a) for a in users_p]), np.array([len(b) for b in users_s])


def test_cooccurrence_follows_the_llr_rule_across_processes(launch):
    items, top_i, top_v, n_users = launch["workers"][0]["co"]
    assert launch["workers"][1]["co"][1] == top_i  # every process holds the model
    buys = _pairs("buy")
    C, pc, _ = _counts(items, buys, buys)
    ref = llr_reference64(C, pc, pc, n_users)
    np.fill_diagonal(ref, -1.0)  # self-pairs excluded
    bad = []
    for j in range(len(items)):
        bad += llr_topk_mismatches(top_i[j], np.maximum(top_v[j], 0), ref[j], llr_atol(n_users))
    assert not bad, bad[:5]


def test_universal_recommender_follows_the_llr_rule_across_processes(launch):
    items, n_users, indicators = launch["workers"][0]["ur"]
    buys = _pairs("buy")
    for name, (top_i, top_v) in indicators.items():
        C, pc, sc = _counts(items, buys, _pairs(name))
        ref = llr_reference64(C, pc, sc, n_users)
        if name == "buy":
            np.fill_diagonal(ref, 0.0)  # the dense path zeroes the diagonal
        bad = []
        for j in range(len(items)):
            bad += llr_topk_mismatches(top_i[j], top_v[j], ref[:, j], llr_atol(n_users))
        assert not bad, (name, bad[:5])


def test_ecommerce_popular_counts_equal_one_process_exactly(launch):
    items, popular = launch["workers"][0]["ecomm"]
    want = {}
    for e in _events():
        if e.event in ("view", "buy"):
            want[e.target_entity_id] = want.get(e.target_entity_id, 0) + 1
    assert {n: int(c) for n, c in zip(items, popular)} == want
    assert launch["workers"][1]["ecomm"][1] == popular


def test_batchpredict_part_files_hold_the_one_process_answers(launch):
    d = launch["dir"]
    w = launch["workers"]
    assert [x["bp"][1] for x in w] == [str(d / "bp.jsonl.part-0"), str(d / "bp.jsonl.part-1")]
    lines = [json.loads(x) for p in range(2) for x in open(d / f"bp.jsonl.part-{p}")]
    one = [json.loads(x) for x in open(d / "one.jsonl")]
    assert len(lines) == len(one) and sum(x["bp"][0] for x in w) == launch["one_n"]
    key = lambda r: json.dumps(r["query"], sort_keys=True)  # noqa: E731
    got = {key(r): r for r in lines}
    for r in one:
        g = got[key(r)]
        if "error" in r:
            assert "error" in g
            continue
        a, b = g["prediction"]["itemScores"], r["prediction"]["itemScores"]
        assert [x["item"] for x in a] == [x["item"] for x in b]
        np.testing.assert_allclose([x["score"] for x in a], [x["score"] for x in b],
                                   rtol=1e-5, atol=1e-5)


def test_sasrec_loss_equals_one_process_steps_on_the_global_batch(launch):
    w = launch["workers"]
    losses, _, n_global, n_items = w[0]["sas"]
    assert w[1]["sas"][0] == losses and len(losses) == SAS["epochs"]
    cfg = seq.SASRecConfig(**SAS)
    batch = min(SAS["batch_size"], n_global + n_global % 2)
    batch += batch % 2
    rows = [np.array(x["sas"][1], np.int64) for x in w]
    rngs = [np.random.default_rng(cfg.seed + 1_000_003 * p) for p in range(2)]
    net = seq.SASRecNet(seq.init_params(0, cfg, n_items), cfg, "cpu", trainable=True)
    opt = seq.adam(net, cfg)
    for step in range(SAS["epochs"]):
        parts = [rows[p][rngs[p].integers(0, len(rows[p]), batch // 2)] for p in range(2)]
        one = float(seq.train_step(net, opt, torch.from_numpy(np.concatenate(parts)), cfg))
        assert abs(one - losses[step]) <= 1e-6, (step, one, losses[step])


def test_seq_parallel_under_a_launch_raises_the_jax_refusal(launch):
    for x in launch["workers"]:
        assert "not supported under pio launch" in x["sp"]
