"""Evaluation in the port against the JAX package, and ``pio eval`` /
``pio batchpredict`` through the port's CLI, on the CPU.

* the metric hierarchy (``core/metrics.py``) and the template's Precision,
  NDCG and MAP@k give the JAX package's values exactly on the same
  seeded predictions; ``k_fold_indices`` gives its folds;
* ``RecommendationDataSource.read_eval`` over the same events in both
  packages' MEMORY stores: equal folds (training rows, id maps, queries and
  held-out actuals), exactly;
* a ``MetricEvaluator`` grid on a deterministic engine (no training
  noise): the score table, the best candidate, the summary and
  ``best.json`` equal the JAX package's exactly, and ``FastEvalCache``
  reads each data source's folds once;
* ``pio eval RecommendationEvaluation --output-best`` on the MEMORY and the
  sqlite store: an EVALCOMPLETED instance in the store whose results name
  the best rank, ``best.json`` equal to it, every candidate × fold's
  batch-predicted answers equal to ``U[u] @ V.T`` ranked on the host for
  that fold's trained factors (rtol = atol = 1e-5, ``topk_mismatches``);
* ``pio batchpredict --input --output``: one line a query, in input order,
  a bad line as an error record, equal to the deployed server's
  ``/queries.json`` answers to the same queries (``topk_mismatches`` at
  1e-5: on the CPU the CLI's chunks score on the host, the server through
  the score kernel's plain version).
"""

import dataclasses
import json
import os
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest

from predictionio_tpu.core import controller as jax_controller
from predictionio_tpu.core import cross_validation as jax_cv
from predictionio_tpu.core import engine as jax_engine
from predictionio_tpu.core import evaluation as jax_evaluation
from predictionio_tpu.core import metrics as jax_metrics
from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import memory as jax_memory
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_rec
from predictionio_tpu_torch.core import controller, cross_validation, engine, evaluation, metrics
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import base, memory
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.testing import topk_mismatches
from predictionio_tpu_torch.tools import cli as port_cli

CPU = DeviceContext.create(device="cpu")
TOL = 1e-5


def _predictions(seed, n=60, n_items=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        top = [f"i{int(j)}" for j in rng.permutation(n_items)[: int(rng.integers(0, 15))]]
        actual = [f"i{int(j)}" for j in rng.choice(n_items, int(rng.integers(0, 8)), replace=False)]
        out.append((top, actual))
    return out


@pytest.mark.parametrize("name", ["PrecisionAtK", "NDCGAtK", "MAPAtK"])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_ranking_metrics_equal_jax(name, k):
    port_m, jax_m = getattr(rec, name)(k=k), getattr(jax_rec, name)(k=k)
    assert port_m.header == jax_m.header
    rows = _predictions(k)
    for top, actual in rows:
        p = rec.PredictedResult([rec.ItemScore(i, 1.0) for i in top])
        j = jax_rec.PredictedResult([jax_rec.ItemScore(i, 1.0) for i in top])
        assert port_m.calculate_one(None, p, actual) == jax_m.calculate_one(None, j, actual)
    qpas_p = [(0, [(None, rec.PredictedResult([rec.ItemScore(i, 1.0) for i in t]), a)
                   for t, a in rows])]
    qpas_j = [(0, [(None, jax_rec.PredictedResult([jax_rec.ItemScore(i, 1.0) for i in t]), a)
                   for t, a in rows])]
    assert port_m.calculate(None, qpas_p) == jax_m.calculate(None, qpas_j)


@pytest.mark.parametrize("base_name", ["AverageMetric", "OptionAverageMetric", "StdevMetric",
                                       "SumMetric", "ZeroMetric"])
def test_metric_statistics_equal_jax(base_name):
    def one(q, p, a):
        return None if (base_name == "OptionAverageMetric" and p % 3 == 0) else p * 0.5 - a

    def make(module):
        cls = getattr(module, base_name)
        attrs = {} if base_name == "ZeroMetric" else {"calculate_one": lambda self, q, p, a: one(q, p, a)}
        return type("M", (cls,), attrs)()

    rng = np.random.default_rng(1)
    qpas = [(f, [(None, int(rng.integers(0, 10)), float(rng.random())) for _ in range(7)])
            for f in range(3)]
    got, ref = make(metrics).calculate(None, qpas), make(jax_metrics).calculate(None, qpas)
    assert got == ref
    assert make(metrics).compare(1.0, 2.0) == make(jax_metrics).compare(1.0, 2.0) == -1
    empty = make(metrics).calculate(None, [])
    assert (np.isnan(empty) and np.isnan(make(jax_metrics).calculate(None, []))) or \
        empty == make(jax_metrics).calculate(None, [])


@pytest.mark.parametrize("n,k", [(10, 2), (11, 3), (7, 7)])
def test_k_fold_equals_jax(n, k):
    for (a, b), (c, d) in zip(cross_validation.k_fold_indices(n, k), jax_cv.k_fold_indices(n, k)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert cross_validation.k_fold(list(range(n)), k) == jax_cv.k_fold(list(range(n)), k)


def _events(n_users=40, n_items=30, n=900, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u, i = f"u{int(rng.integers(n_users))}", f"i{int(rng.integers(n_items))}"
        d = dict(entity_type="user", entity_id=u, target_entity_type="item",
                 target_entity_id=i, event_time=1_767_225_600 + k)
        out.append(dict(event="buy", **d) if k % 7 == 0 else
                   dict(event="rate", properties={"rating": float(rng.integers(1, 6))}, **d))
    return out


@pytest.fixture()
def both_stores():
    name = "E" + uuid.uuid4().hex[:8].upper()
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory"}
    port, ref = Storage(env=env), JaxStorage(env=env)
    evs = _events()
    for s, ev_mod, b in ((port, port_event, base), (ref, jax_event, jax_base)):
        app_id = s.get_meta_data_apps().insert(b.App(0, "EvalApp"))
        s.get_l_events().insert_batch([ev_mod.Event(**d) for d in evs], app_id)
    port_store.set_storage(port)
    jax_store.set_storage(ref)
    yield port, ref
    port_store.set_storage(None)
    jax_store.set_storage(None)
    memory.reset_store(name)
    jax_memory.reset_store(name)


@pytest.mark.parametrize("k_fold,query_num", [(3, 10), (2, 4)])
def test_read_eval_folds_equal_jax(both_stores, k_fold, query_num):
    params = {"appName": "EvalApp", "evalParams": {"kFold": k_fold, "queryNum": query_num}}
    got = rec.RecommendationDataSource(rec.DataSourceParams(**params)).read_eval(CPU)
    ref = jax_rec.RecommendationDataSource(jax_rec.DataSourceParams(**params)).read_eval(None)
    assert len(got) == len(ref) == k_fold
    for (td, qa), (jtd, jqa) in zip(got, ref):
        for f in ("user", "item", "rating", "t"):
            np.testing.assert_array_equal(getattr(td.interactions, f), getattr(jtd.interactions, f))
        assert td.interactions.user_map.to_dict() == jtd.interactions.user_map.to_dict()
        assert td.interactions.item_map.to_dict() == jtd.interactions.item_map.to_dict()
        assert [(dataclasses.asdict(q), a) for q, a in qa] == \
            [(dataclasses.asdict(q), a) for q, a in jqa]


# -- a deterministic engine, written once against either package's classes ---


def _toy_engine(pkg_controller, pkg_engine, reads):
    @dataclasses.dataclass
    class DSParams(pkg_controller.Params):
        n: int = 12
        folds: int = 3

    @dataclasses.dataclass
    class AlgoParams(pkg_controller.Params):
        w: float = 1.0

    @dataclasses.dataclass
    class Q:
        x: int

    class DS(pkg_controller.DataSource):
        params_cls = DSParams

        def read_training(self, ctx):
            return list(range(self.params.n))

        def read_eval(self, ctx):
            reads.append(self.params.n)
            rows = list(range(self.params.n))
            return [([r for r in rows if r % self.params.folds != f],
                     [(Q(r), (r * 7) % 5) for r in rows if r % self.params.folds == f])
                    for f in range(self.params.folds)]

    class Algo(pkg_controller.Algorithm):
        params_cls = AlgoParams

        def train(self, ctx, pd):
            return self.params.w * sum(pd) / len(pd)

        def predict(self, model, q):
            return (model * q.x) % 5

    engine = pkg_engine.Engine(
        data_source_cls=DS, preparator_cls=pkg_controller.IdentityPreparator,
        algorithm_cls_map={"a": Algo}, serving_cls=pkg_controller.FirstServing, query_cls=Q)

    def metric_cls(pkg_metrics):
        class NegAbs(pkg_metrics.AverageMetric):
            def calculate_one(self, q, p, a):
                return -abs(p - a)

        class Hit(pkg_metrics.OptionAverageMetric):
            def calculate_one(self, q, p, a):
                return None if a == 0 else float(round(p) == a)

        return NegAbs, Hit

    return engine, metric_cls


GRID = [{"datasource": {"params": {"n": n}}, "algorithms": [{"name": "a", "params": {"w": w}}]}
        for n in (12, 15) for w in (0.5, 1.0, 1.5, 2.25)]


def test_metric_evaluator_grid_equals_jax(tmp_path):
    out = {}
    for name, ctrl, eng, mets, ev, ctx in (
        ("port", controller, engine, metrics, evaluation, CPU),
        ("jax", jax_controller, jax_engine, jax_metrics, jax_evaluation, MeshContext.create()),
    ):
        reads = []
        e, metric_cls = _toy_engine(ctrl, eng, reads)
        neg_abs, hit = metric_cls(mets)
        path = str(tmp_path / f"{name}.json")
        result = ev.MetricEvaluator(neg_abs(), [hit()]).evaluate_base(
            ctx, e, [e.params_from_variant(v) for v in GRID], output_path=path)
        out[name] = (result, reads, open(path).read())
    (got, reads, best), (ref, jreads, jbest) = out["port"], out["jax"]
    assert [r.score for r in got.all_results] == [r.score for r in ref.all_results]
    assert [r.other_scores for r in got.all_results] == [r.other_scores for r in ref.all_results]
    assert got.best.score == ref.best.score
    assert got.summary == ref.summary and got.to_json() == ref.to_json()
    assert best == jbest
    assert reads == jreads == [12, 15]  # each data source's folds read once


# -- pio eval and pio batchpredict through the CLI ---------------------------


def _store_env(kind, tmp_path):
    if kind == "sqlite":
        return {}
    name = "C" + uuid.uuid4().hex[:8].upper()
    return {f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name}


@pytest.fixture(params=["memory", "sqlite"])
def cli_store(request, tmp_path, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_QUANT_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    for k, v in _store_env(request.param, tmp_path).items():
        monkeypatch.setenv(k, v)
    Storage.reset_instance()
    port_store.set_storage(None)
    storage = Storage.instance()
    app_id = storage.get_meta_data_apps().insert(base.App(0, "default"))
    storage.get_l_events().insert_batch([port_event.Event(**d) for d in _events()], app_id)
    yield storage
    Storage.reset_instance()
    port_store.set_storage(None)
    port_sqlite.close_all_dbs()


def test_pio_eval_through_the_cli(cli_store, tmp_path, monkeypatch, capsys):
    # record every fold's batch prediction to hold it against the host
    seen = []
    batch_predict = rec.ALSAlgorithm.batch_predict

    def recording(self, model, queries):
        out = batch_predict(self, model, queries)
        seen.append((model, queries, out))
        return out

    monkeypatch.setattr(rec.ALSAlgorithm, "batch_predict", recording)
    best = str(tmp_path / "best.json")
    rc = port_cli.main(["eval", "predictionio_tpu_torch.templates.recommendation."
                        "RecommendationEvaluation", "--output-best", best, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Evaluation completed" in out and "[RESULT] Metric evaluation" in out
    iid = out.split("Instance ID: ")[1].split()[0]
    inst = cli_store.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED" and inst.evaluator_results.startswith("[RESULT]")
    results = json.loads(inst.evaluator_results_json)
    assert json.load(open(best)) == results
    scores = [r["score"] for r in results["results"]]
    ranks = [r["engineParams"]["algorithmParamsList"][0]["params"]["rank"] for r in results["results"]]
    assert ranks == [4, 8] and results["bestScore"] == max(scores)
    assert results["bestEngineParams"]["algorithmParamsList"][0]["params"]["rank"] == \
        ranks[int(np.argmax(scores))]
    assert [i.id for i in cli_store.get_meta_data_evaluation_instances().get_completed()] == [iid]
    assert len(seen) == 2 * 3  # candidates × folds
    for model, queries, answers in seen:
        users = np.array([model.user_map[q.user] for _, q in queries])
        scores_ = model.user_factors[users] @ model.item_factors.T
        ref_i = np.argsort(-scores_, axis=1, kind="stable")[:, :10]
        ref_v = np.take_along_axis(scores_, ref_i, axis=1)
        got = dict(answers)
        for row, (i, _) in enumerate(queries):
            g = got[i].itemScores
            bad = topk_mismatches(
                np.array([[s.score for s in g]]),
                np.array([[model.item_map[s.item] for s in g]]),
                ref_v[row:row + 1], ref_i[row:row + 1], TOL)
            assert not bad, bad[:3]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base_url, q):
    req = urllib.request.Request(f"{base_url}/queries.json", data=json.dumps(q).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_pio_batchpredict_equals_the_deployed_server(cli_store, tmp_path, capsys):
    eng = tmp_path / "engine"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps({
        "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
        "datasource": {"params": {"appName": "default"}},
        "algorithms": [{"name": "als", "params": {"rank": 6, "numIterations": 3}}]}))
    assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 0
    rng = np.random.default_rng(2)
    queries = [{"user": f"u{int(u)}", "num": int(n)}
               for u, n in zip(rng.integers(0, 45, 150), rng.integers(1, 12, 150))]
    lines = [json.dumps(q) for q in queries]
    lines.insert(70, "{not json")
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    capsys.readouterr()
    assert port_cli.main(["batchpredict", "--engine-dir", str(eng), "--input",
                          str(tmp_path / "in.jsonl"), "--output", str(tmp_path / "out.jsonl"),
                          "--device", "cpu"]) == 0
    assert "Batch predict completed: 150 predictions" in capsys.readouterr().out
    written = [json.loads(x) for x in (tmp_path / "out.jsonl").read_text().splitlines()]
    assert len(written) == 151 and "error" in written[70] and written[70]["query"] == "{not json"
    written = written[:70] + written[71:]

    port = _free_port()
    t = threading.Thread(target=port_cli.main, args=([
        "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1", "--port", str(port),
        "--batching", "--device", "cpu"],), daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"
    t_end = time.monotonic() + 60
    while True:
        try:
            urllib.request.urlopen(f"{url}/readyz", timeout=5).close()
            break
        except OSError:
            assert time.monotonic() < t_end
            time.sleep(0.05)
    try:
        items = {f"i{k}": k for k in range(30)}
        for q, w in zip(queries, written):
            assert w["query"] == q
            got, ref = w["prediction"]["itemScores"], _post(url, q)["itemScores"]
            # the CLI's batches score on the host, the server's through the
            # score kernel's plain version: equal within rounding
            bad = topk_mismatches(
                np.array([[x["score"] for x in got]]), np.array([[items[x["item"]] for x in got]]),
                np.array([[x["score"] for x in ref]]), np.array([[items[x["item"]] for x in ref]]),
                TOL)
            assert len(got) == len(ref) and not bad, (q, bad[:3])
    finally:
        assert port_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(30)


def test_pio_batchpredict_stops_on_a_kernel_error(cli_store, tmp_path, monkeypatch, capsys):
    """A kernel's refusal or failure in a chunk ends the run with an error:
    the chunk is not retried line by line on the host, and no answer is
    written for it."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops._build import KernelError

    eng = tmp_path / "engine"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps({
        "engineFactory": port_cli.BUILTIN_TEMPLATES["recommendation"],
        "datasource": {"params": {"appName": "default"}},
        "algorithms": [{"name": "als", "params": {"rank": 6, "numIterations": 3}}]}))
    assert port_cli.main(["train", "--engine-dir", str(eng), "--device", "cpu"]) == 0

    def refuse(self, users, num):
        raise KernelError("score_topk kernel launch failed: test")

    per_line = []
    predict = rec.ALSAlgorithm.predict
    monkeypatch.setattr(als.ALSScorer, "recommend_batch", refuse)
    monkeypatch.setattr(rec.ALSAlgorithm, "predict",
                        lambda self, m, q: per_line.append(q) or predict(self, m, q))
    (tmp_path / "in.jsonl").write_text(
        "".join(json.dumps({"user": f"u{u}", "num": 5}) + "\n" for u in range(10)))
    capsys.readouterr()
    rc = port_cli.main(["batchpredict", "--engine-dir", str(eng), "--input",
                        str(tmp_path / "in.jsonl"), "--output", str(tmp_path / "out.jsonl"),
                        "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1 and "score_topk kernel launch failed" in err, err
    assert per_line == []
    assert (tmp_path / "out.jsonl").read_text() == ""


def test_a_batch_scorer_warms_only_the_rungs_it_is_given():
    """``warm_buckets`` limits the warm-up launches (batch prediction warms
    the top rung only); the answers are those of a fully warmed scorer."""
    from predictionio_tpu_torch.serving.fastpath import BUCKETS, BucketedScorer

    rng = np.random.default_rng(3)
    U = rng.standard_normal((90, 6)).astype(np.float32)
    V = rng.standard_normal((200, 6)).astype(np.float32)
    full = BucketedScorer(CPU, U, V, max_k=20)
    top = BucketedScorer(CPU, U, V, max_k=20, warm_buckets=BUCKETS[-1:])
    assert (full.warmup_executions, top.warmup_executions) == (len(BUCKETS), 1)
    users = np.arange(90)
    for a, b in zip(full.score_topk(users, 20), top.score_topk(users, 20)):
        np.testing.assert_array_equal(a, b)
