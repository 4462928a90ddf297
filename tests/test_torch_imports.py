"""The port stands alone: no jax, nothing of ``predictionio_tpu``.

* A subprocess with ``sys.modules['jax']`` and ``sys.modules['predictionio_tpu']``
  set to None (any import of either then raises) imports every module of
  ``predictionio_tpu_torch`` and ``chip_smoke.py``.
* A source scan finds no import of jax, jaxlib, ml_dtypes, orbax or
  ``predictionio_tpu`` in the port or in ``chip_smoke.py``.
* ``DeviceContext.create()`` without CUDA and without ``device="cpu"``
  raises; ``chip_smoke.py`` exits non-zero and prints no result without a
  card, and in a directory that holds nothing else of the repository.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.device import DeviceContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ml_dtypes|orbax|predictionio_tpu)(?:\.|\s|$)",
    re.M,
)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
import predictionio_tpu_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(
    predictionio_tpu_torch.__path__, 'predictionio_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'orbax', 'predictionio_tpu')]
assert not bad, bad
print(" ".join(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 30
    # the training and SASRec slices' modules, by name
    assert {
        "predictionio_tpu_torch.data.event", "predictionio_tpu_torch.data.batch",
        "predictionio_tpu_torch.data.store", "predictionio_tpu_torch.data.storage.base",
        "predictionio_tpu_torch.data.storage.memory",
        "predictionio_tpu_torch.data.storage.registry",
        "predictionio_tpu_torch.ops.train_kernel", "predictionio_tpu_torch.models.als",
        "predictionio_tpu_torch.core.workflow",
        "predictionio_tpu_torch.templates.recommendation",
        # the SASRec serving slice
        "predictionio_tpu_torch.ops.flash_attention", "predictionio_tpu_torch.parallel.ring",
        "predictionio_tpu_torch.models.sequential",
        "predictionio_tpu_torch.templates.sequentialrecommendation",
        # the segment solver's slice
        "predictionio_tpu_torch.ops.segment",
        # the quickstart's operator surface
        "predictionio_tpu_torch.data.storage.sqlite", "predictionio_tpu_torch.data.api.stats",
        "predictionio_tpu_torch.data.api.event_server", "predictionio_tpu_torch.tools.cli",
        # the operators' serving slice
        "predictionio_tpu_torch.common.resilience", "predictionio_tpu_torch.common.http",
        "predictionio_tpu_torch.utils.profiling", "predictionio_tpu_torch.obs",
        "predictionio_tpu_torch.obs.metrics", "predictionio_tpu_torch.obs.tracing",
        "predictionio_tpu_torch.obs.devprof", "predictionio_tpu_torch.obs.bridges",
        "predictionio_tpu_torch.serving.result_cache", "predictionio_tpu_torch.serving.batching",
        "predictionio_tpu_torch.serving.fastpath", "predictionio_tpu_torch.serving.plugins",
        "predictionio_tpu_torch.serving.query_server", "predictionio_tpu_torch.tools.loadtest",
        "predictionio_tpu_torch.tools.scenarios",
        # publish, resume and evaluate
        "predictionio_tpu_torch.core.checkpoint", "predictionio_tpu_torch.core.evaluation",
        "predictionio_tpu_torch.core.metrics", "predictionio_tpu_torch.core.cross_validation",
        "predictionio_tpu_torch.serving.batch_predict",
        # streaming micro-generations and the ingest front door
        "predictionio_tpu_torch.common.faults", "predictionio_tpu_torch.data.api.wal",
        "predictionio_tpu_torch.data.api.ingest_buffer", "predictionio_tpu_torch.core.delta",
        "predictionio_tpu_torch.models.cooccurrence",
        # IVF retrieval
        "predictionio_tpu_torch.ops.ivf", "predictionio_tpu_torch.serving.sharding",
        # the fleet: routing, supervision, autoscaling, canary, tenants, pipelines
        "predictionio_tpu_torch.serving.router", "predictionio_tpu_torch.serving.fleet",
        "predictionio_tpu_torch.serving.autoscaler", "predictionio_tpu_torch.serving.canary",
        "predictionio_tpu_torch.serving.tenancy", "predictionio_tpu_torch.serving.pipeline",
        "predictionio_tpu_torch.parallel.mesh",
        # many processes: the gloo runtime, the sharded read, the launcher
        "predictionio_tpu_torch.parallel.distributed", "predictionio_tpu_torch.parallel.ingest",
        "predictionio_tpu_torch.tools.launcher",
        # the other model families and templates
        "predictionio_tpu_torch.models.naive_bayes", "predictionio_tpu_torch.models.random_forest",
        "predictionio_tpu_torch.models.markov_chain",
        "predictionio_tpu_torch.models.binary_vectorizer",
        "predictionio_tpu_torch.serving.event_cache", "predictionio_tpu_torch.core.self_cleaning",
        "predictionio_tpu_torch.data.aggregator", "predictionio_tpu_torch.templates.universal",
        "predictionio_tpu_torch.templates.similarproduct",
        "predictionio_tpu_torch.templates.ecommerce",
        "predictionio_tpu_torch.templates.similaruser",
        "predictionio_tpu_torch.templates.classification",
    } <= names
    # the SASRec training, segment and operators' slices' names, by attribute
    code = ("import sys; sys.modules['jax'] = None; sys.modules['predictionio_tpu'] = None; "
            "from predictionio_tpu_torch.ops.flash_attention import _FlashAttention, flash_block_bwd, "
            "flash_attention_bwd_reference, bwd_dq_launches, bwd_dkv_launches; "
            "from predictionio_tpu_torch.models.sequential import train_sasrec, build_sequences, "
            "_moe_ffn, _loss_fn, train_step; "
            "from predictionio_tpu_torch.ops.train_kernel import fused_gather_rows, "
            "gather_rows_reference, gather_launches; "
            "from predictionio_tpu_torch.models.als import _make_blocks, _half_step; "
            "from predictionio_tpu_torch.common.resilience import CircuitBreaker, RetryPolicy, "
            "call_with_resilience, deadline_scope, ErrorCounters, RateLimitedLogger; "
            "from predictionio_tpu_torch.obs import Telemetry, telemetry_enabled, maybe_install; "
            "from predictionio_tpu_torch.obs.devprof import DeviceUtilization, PEAKS, peak_for; "
            "from predictionio_tpu_torch.serving.result_cache import ResultCache, notify_event; "
            "from predictionio_tpu_torch.tools.scenarios import parse_scenario, run_scenario; "
            "from predictionio_tpu_torch.tools.loadtest import run_loadtest, run_ingest_loadtest; "
            "from predictionio_tpu_torch.ops._build import KernelError; "
            "from predictionio_tpu_torch.core.delta import Delta, DeltaLog, DeltaApplier, "
            "DeltaPublisher, model_fingerprint, streaming_enabled, delta_dir_for; "
            "from predictionio_tpu_torch.data.api.ingest_buffer import IngestBuffer, Ticket, "
            "BufferFull, wal_encode, wal_decode; "
            "from predictionio_tpu_torch.data.api.wal import WriteAheadLog; "
            "from predictionio_tpu_torch.common.faults import crash_point, active, install; "
            "from predictionio_tpu_torch.models.cooccurrence import cooccurrence_increments, "
            "fold_increments; "
            "from predictionio_tpu_torch.models.als import fold_in_users; "
            "from predictionio_tpu_torch.obs.bridges import bridge_ingest_buffer, bridge_ivf; "
            "from predictionio_tpu_torch.ops.ivf import IVFIndex, build_index, measure_recall, "
            "resolve_retrieval, save_index, load_index; "
            "from predictionio_tpu_torch.serving.sharding import ShardingPlan, build_layout, "
            "plan_from_assignment, PAD_SENTINEL; "
            "from predictionio_tpu_torch.ops.score_kernel import ivf_score_topk, "
            "ivf_score_topk_reference, fused_probed_score_topk, select_probes, ivf_launches; "
            "from predictionio_tpu_torch.core.evaluation import recall_at_k; "
            "from predictionio_tpu_torch.tools.cli import cmd_ivf; "
            "from predictionio_tpu_torch.models.cooccurrence import CooccurrenceModel, "
            "BlockedIncidence, incidence_width, block_incidence, distinct_item_counts, "
            "cross_occurrence_matrix, cooccurrence_matrix, llr_cross_scores, "
            "cross_occurrence_topn, cross_occurrence_block, llr_scores, train_cooccurrence, "
            "DENSE_ITEM_LIMIT; "
            "from predictionio_tpu_torch.ops.topk import topk_two_key; "
            "from predictionio_tpu_torch.data.batch import EventBatch; EventBatch.filter_events; "
            "from predictionio_tpu_torch.data.event import PropertyMap; "
            "from predictionio_tpu_torch.obs.bridges import bridge_event_cache; "
            "from predictionio_tpu_torch.serving.query_server import QueryServer; "
            "QueryServer._event_cache_stats; "
            "from predictionio_tpu_torch.templates.universal import URDataSource, URAlgorithm, "
            "URModel, UniversalRecommenderEngine; "
            "from predictionio_tpu_torch.templates.similarproduct import SimilarALSAlgorithm, "
            "SimilarCooccurrenceAlgorithm, SumServing; "
            "from predictionio_tpu_torch.templates.ecommerce import ECommAlgorithm, ECommModel; "
            "from predictionio_tpu_torch.templates.similaruser import SimilarUserModel; "
            "from predictionio_tpu_torch.templates.classification import Accuracy, "
            "ClassificationEvaluation; "
            "from predictionio_tpu_torch.models.naive_bayes import train_multinomial_nb, "
            "train_categorical_nb; "
            "from predictionio_tpu_torch.models.random_forest import train_random_forest, "
            "_grow_tree; "
            "from predictionio_tpu_torch.models.markov_chain import train_markov_chain; "
            "from predictionio_tpu_torch.models.binary_vectorizer import BinaryVectorizer; "
            "from predictionio_tpu_torch.core.self_cleaning import SelfCleaningDataSource, "
            "clean_persisted_events")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


PUBLIC_NAMES = """
import sys
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
from predictionio_tpu_torch.data import Event
from predictionio_tpu_torch.models import train_als
import predictionio_tpu_torch as pio
import predictionio_tpu_torch.data as data
import predictionio_tpu_torch.data.storage as storage
import predictionio_tpu_torch.models as models
import predictionio_tpu_torch.ops as ops
import predictionio_tpu_torch.parallel as parallel
out = {}
for mod in (data, storage, models, ops, parallel):
    assert all(getattr(mod, n) is not None for n in mod.__all__), mod.__name__
    out[mod.__name__] = sorted(mod.__all__)
out["top"] = sorted(n for n in pio._LAZY_EXPORTS if getattr(pio, n) is not None)
assert pio.Event is Event and models.train_als is train_als
assert pio.Storage.__module__ == "predictionio_tpu_torch.data.storage.registry"
print(__import__("json").dumps(out))
"""


def test_public_names_mirror_the_jax_package():
    """ROADMAP §1 item 18: each package ``__init__`` exports the JAX
    package's ``__all__`` with the port's own objects, and the top level
    its lazy names, with jax blocked; with the mesh ported (``MeshContext``
    and ``make_mesh``) no name is left out."""
    import json

    import predictionio_tpu
    import predictionio_tpu.data
    import predictionio_tpu.data.storage
    import predictionio_tpu.models
    import predictionio_tpu.ops
    import predictionio_tpu.parallel

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PUBLIC_NAMES], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    port = json.loads(r.stdout.strip().splitlines()[-1])
    for name in ("data", "data.storage", "models", "ops", "parallel"):
        jax_all = set(sys.modules[f"predictionio_tpu.{name}"].__all__)
        assert set(port[f"predictionio_tpu_torch.{name}"]) == jax_all, name
    assert set(port["top"]) == set(predictionio_tpu._LAZY_EXPORTS)


def test_every_kernel_source_is_built():
    """``build_all`` (what ``chip_smoke.py`` and the first launch run)
    builds every CUDA source of the port, the flash backward's included."""
    from predictionio_tpu_torch.ops import _build

    assert set(_build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert "flash_bwd" in _build.SOURCES and "gather_rows" in _build.SOURCES


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_device_context_refuses_cpu_fallback():
    if torch.cuda.is_available():
        assert DeviceContext.create().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceContext.create()
    assert DeviceContext.create(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        DeviceContext.create(device="meta")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_jax_written_instance_deploys_with_jax_blocked(tmp_path, monkeypatch):
    """The fault this guards: the sqlite store is shared, and a JAX-written
    blob, manifest or engineFactory used to import ``predictionio_tpu`` (and
    jax) into the port's process. The JAX package writes an auto-mode and a
    checkpoint-mode instance here; a subprocess with jax and
    ``predictionio_tpu`` blocked deploys the first with the port and serves
    the JAX model's answers (``topk_mismatches``, 1e-5), and refuses the
    second (orbax factors) and a foreign class path with errors that name
    them."""
    import json

    import numpy as np

    from predictionio_tpu.core import persistence as jax_persistence
    from predictionio_tpu.data.event import Event
    from predictionio_tpu.data.storage import sqlite as jax_sqlite
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.templates import recommendation as jax_rec
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.testing import topk_mismatches

    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_ALS_", "PIO_QUANT_")):
            monkeypatch.delenv(k)
    base = tmp_path / "base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    factory = "predictionio_tpu.templates.recommendation.RecommendationEngine"
    JaxStorage.reset_instance()
    try:
        assert jax_cli.main(["app", "new", "Shared"]) == 0
        storage = JaxStorage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("Shared").id
        rng = np.random.default_rng(2)
        storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                  target_entity_type="item", target_entity_id=f"i{int(i)}",
                  properties={"rating": int(r)}, event_time=1_767_225_600.0 + k)
            for k, (u, i, r) in enumerate(zip(rng.integers(0, 25, 500), rng.integers(0, 20, 500),
                                              rng.integers(1, 6, 500)))], app_id)
        for variant, mode in (("default", "auto"), ("ckpt", "checkpoint")):
            d = tmp_path / variant
            d.mkdir()
            (d / "engine.json").write_text(json.dumps({
                "id": variant, "engineFactory": factory,
                "datasource": {"params": {"appName": "Shared"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 4, "numIterations": 3, "persistMode": mode}}]}))
            assert jax_cli.main(["train", "--engine-dir", str(d)]) == 0
        inst = storage.get_meta_data_engine_instances().get_latest_completed(
            factory, "default", "default")
        params = jax_rec.ALSAlgorithmParams()
        model = jax_persistence.deserialize_models(
            jax_persistence.open_model_blob(storage.get_model_data_models().get(inst.id).models),
            inst.id, [jax_rec.ALSAlgorithm(params)], [params], None)[0][0]
    finally:
        JaxStorage.reset_instance()
        jax_sqlite.close_all_dbs()

    code = f"""
import json, sys, threading
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.workflow import resolve_engine
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.serving.query_server import QueryServer
out = {{}}
engine = resolve_engine({factory!r})
storage = Storage.instance()
ctx = DeviceContext.create(device="cpu")
qs = QueryServer(engine, storage=storage, ctx=ctx, engine_id={factory!r}, batching=True)
import urllib.request
base = f"http://127.0.0.1:{{qs.start('127.0.0.1', 0)}}"
def post(q):
    req = urllib.request.Request(base + "/queries.json", data=json.dumps(q).encode(),
                                 headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())
out["instance"] = qs._deployed.instance_id
out["answers"] = {{f"u{{k}}": post({{"user": f"u{{k}}", "num": 5}}) for k in range(25)}}
qs.stop()
try:
    QueryServer(engine, storage=storage, ctx=ctx, engine_id={factory!r}, engine_variant="ckpt")
except Exception as e:
    out["checkpoint_error"] = f"{{type(e).__name__}}: {{e}}"
try:
    persistence.resolve_class("predictionio_tpu.serving.fleet.Fleet")
except ImportError as e:
    out["foreign_error"] = str(e)
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'orbax', 'predictionio_tpu')]
out["foreign_modules"] = bad
print(json.dumps(out, default=str))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["foreign_modules"] == [] and out["instance"] == inst.id
    assert "orbax" in out["checkpoint_error"] and "CheckpointedALSModel" in out["checkpoint_error"]
    assert "predictionio_tpu.serving.fleet.Fleet" in out["foreign_error"]
    for u, answer in out["answers"].items():
        got = answer["itemScores"]
        row = model.user_factors[model.user_map[u]] @ model.item_factors.T
        ref = np.argsort(-row, kind="stable")[:5]
        bad = topk_mismatches(np.array([[x["score"] for x in got]]),
                              np.array([[model.item_map[x["item"]] for x in got]]),
                              row[ref][None], ref[None], 1e-5)
        assert not bad, (u, bad[:3])


def _train_item11(name):
    from predictionio_tpu_torch.models import markov_chain, naive_bayes, random_forest

    x = np.random.default_rng(0).random((12, 3)).astype(np.float32)
    y = ["a", "b"] * 6
    if name == "multinomial_nb":
        return naive_bayes.train_multinomial_nb(None, x, y)
    if name == "categorical_nb":
        return naive_bayes.train_categorical_nb(None, [("a", ["r", "s"]), ("b", ["t", "s"])])
    if name == "random_forest":
        return random_forest.train_random_forest(None, x, y, random_forest.RFConfig(n_trees=2, max_depth=2))
    return markov_chain.train_markov_chain(None, np.array([0, 1, 2]), np.array([1, 2, 0]), 3)


@pytest.mark.parametrize("name", ["multinomial_nb", "categorical_nb", "random_forest", "markov_chain"])
def test_model_trainers_without_a_context_need_a_card(name):
    """No context means the card: the trainers never fall back to the CPU."""
    if torch.cuda.is_available():
        assert _train_item11(name) is not None
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _train_item11(name)
