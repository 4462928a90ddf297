"""The port's multi-tenant serving and composed pipelines.

Counterpart of ``tests/test_tenancy.py`` against the port's modules and
query server (trained and served on the CPU). Held against the JAX
package: ``pick_variant`` buckets 10,000 seeded (tenant, user) pairs alike
(exact); the same admission sequence on the same simulated clock gives the
same admissions, Retry-After hints and stats (exact); a sealed pipeline
config either package writes opens in the other; and the pipeline's
answers on a small ALS + IVF model equal the plain exact top-k over the
retrieval stage's candidates, and the JAX pipeline's answers, by the
parity rule (values within 1e-5, indices equal but for ties).

What must hold:

* auth: /queries.json under a tenant registry refuses missing/unknown
  access keys with the event-server's 401 message idiom;
* fair-share admission: a tenant over its qps quota is shed with a
  quota-attributed 503 + Retry-After while OTHER tenants' requests are
  admitted and answered inside their SLO;
* isolation: a chaos fault scoped to one tenant (``client:tenant:<id>``)
  trips only that tenant's breaker — every other tenant's breaker stays
  closed and their traffic is untouched;
* A/B bucketing is a pure function of (tenant, user key): identical
  across registry instances (replicas) and rebuilds (restarts);
* caches never cross tenants: the result-cache fingerprint is
  namespaced by tenant+variant+instance and strips ``accessKey``;
* pipelines: the sealed-blob envelope refuses torn configs, the
  two-stage retrieval→ranking dataflow matches single-stage answers
  when unconstrained, and a ranking stage that blows its share of the
  request deadline degrades to the retrieval-only answer tagged
  ``degraded:true`` instead of failing the request.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.common import faults
from predictionio_tpu_torch.common.resilience import Deadline
from predictionio_tpu_torch.core.persistence import ModelIntegrityError
from predictionio_tpu_torch.serving.pipeline import (
    PipelineConfig,
    StageSpec,
    StageFault,
    build_recommendation_stages,
    load_pipeline,
    pipeline_from_env,
    save_pipeline,
)
from predictionio_tpu_torch.serving.result_cache import (
    ResultCache,
    canonical_fingerprint,
)
from predictionio_tpu_torch.serving.tenancy import (
    DEFAULT_VARIANT,
    TenantRegistry,
    TenantSpec,
    VariantSpec,
    extract_access_key,
    pick_variant,
    registry_from_config,
    tenants_from_env,
)


def call(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear()
    yield
    faults.clear()


# -- specs & config -----------------------------------------------------------


class TestTenantConfig:
    def test_spec_round_trip(self):
        spec = TenantSpec(
            "acme", "k-acme", weight=2.0, quota_qps=50.0, slo_ms=200.0,
            variants=(
                VariantSpec("a", 3.0), VariantSpec("b", 1.0, "exp"),
            ),
        )
        again = TenantSpec.from_dict(spec.to_dict())
        assert again == spec

    def test_validation_rejects_bad_specs(self):
        with pytest.raises(ValueError):
            TenantSpec("t", "").validate()
        with pytest.raises(ValueError):
            TenantSpec("t", "k", weight=0.0).validate()
        with pytest.raises(ValueError):
            TenantSpec("t", "k", quota_qps=-1.0).validate()
        with pytest.raises(ValueError):
            TenantSpec(
                "t", "k",
                variants=(VariantSpec("a"), VariantSpec("a")),
            ).validate()

    def test_registry_rejects_collisions(self):
        with pytest.raises(ValueError):
            TenantRegistry([])
        with pytest.raises(ValueError):
            TenantRegistry(
                [TenantSpec("t", "k1"), TenantSpec("t", "k2")]
            )
        with pytest.raises(ValueError):
            TenantRegistry(
                [TenantSpec("a", "k"), TenantSpec("b", "k")]
            )

    def test_registry_from_config_shapes(self):
        cfg = [{"tenantId": "a", "accessKey": "ka"}]
        assert registry_from_config(cfg).get("a") is not None
        assert registry_from_config({"tenants": cfg}).get("a") is not None
        with pytest.raises(ValueError):
            registry_from_config("nope")

    def test_tenants_from_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PIO_TENANTS", raising=False)
        assert tenants_from_env() is None
        cfg = json.dumps(
            {"tenants": [{"tenantId": "a", "accessKey": "ka"}]}
        )
        monkeypatch.setenv("PIO_TENANTS", cfg)
        assert tenants_from_env().authenticate("ka").tenant_id == "a"
        p = tmp_path / "tenants.json"
        p.write_text(cfg)
        monkeypatch.setenv("PIO_TENANTS", str(p))
        assert tenants_from_env().authenticate("ka").tenant_id == "a"

    def test_extract_access_key_precedence(self):
        assert extract_access_key({"accessKey": "p"}, {"X-PIO-Access-Key": "h"},
                                  {"accessKey": "b"}) == "p"
        assert extract_access_key({}, {"X-PIO-Access-Key": "h"},
                                  {"accessKey": "b"}) == "h"
        assert extract_access_key({}, {}, {"accessKey": "b"}) == "b"
        assert extract_access_key({}, {}, {"user": "u"}) is None


# -- A/B bucketing ------------------------------------------------------------


class TestBucketing:
    VARIANTS = (VariantSpec("control", 3.0), VariantSpec("exp", 1.0))

    def test_deterministic_across_replicas_and_restarts(self):
        # two registry instances built from the same config = two
        # replicas (or one replica before and after a restart): every
        # user must land on the same arm in both, no shared state
        cfg = [{
            "tenantId": "a", "accessKey": "ka",
            "variants": [
                {"name": "control", "weight": 3.0},
                {"name": "exp", "weight": 1.0},
            ],
        }]
        r1 = registry_from_config(cfg)
        r2 = registry_from_config(cfg)
        users = [f"u{i}" for i in range(200)]
        assert [r1.pick_variant("a", u) for u in users] == \
            [r2.pick_variant("a", u) for u in users]
        # and the pure function agrees with the registry wrapper
        assert all(
            r1.pick_variant("a", u) == pick_variant("a", u, self.VARIANTS)
            for u in users
        )

    def test_weights_shape_the_split(self):
        picks = [
            pick_variant("a", f"u{i}", self.VARIANTS) for i in range(4000)
        ]
        share = picks.count("control") / len(picks)
        assert 0.67 <= share <= 0.83  # 3:1 weights → ~0.75

    def test_no_variants_and_anonymous_users(self):
        assert pick_variant("a", "u1", ()) == DEFAULT_VARIANT
        assert pick_variant("a", "", self.VARIANTS) == \
            pick_variant("a", "", self.VARIANTS)

    def test_tenants_bucket_independently(self):
        users = [f"u{i}" for i in range(300)]
        a = [pick_variant("a", u, self.VARIANTS) for u in users]
        b = [pick_variant("b", u, self.VARIANTS) for u in users]
        assert a != b  # same users, different tenants → different split


# -- admission ----------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class TestAdmission:
    def test_quota_token_bucket_sheds_and_refills(self):
        clock = _Clock()
        reg = TenantRegistry(
            [TenantSpec("a", "ka", quota_qps=10.0)],
            total_inflight=64, burst=2.0, clock=clock,
        )
        for _ in range(20):  # 2s of burst banked at 10 qps
            adm = reg.admit("a")
            assert adm.ok
            reg.release("a")
        shed = reg.admit("a")
        assert not shed.ok and shed.reason == "quota"
        assert shed.retry_after_s > 0
        clock.t += 0.2  # two tokens land
        assert reg.admit("a").ok
        reg.release("a")
        assert reg.stats()["a"]["shed"]["quota"] == 1

    def test_inflight_fair_share_cap(self):
        reg = TenantRegistry(
            [TenantSpec("a", "ka"), TenantSpec("b", "kb")],
            total_inflight=4, burst=1.0,
        )
        assert reg.stats()["a"]["cap"] == 2  # half of 4, burst 1
        assert reg.admit("a").ok and reg.admit("a").ok
        third = reg.admit("a")
        assert not third.ok and third.reason == "inflight"
        # the other tenant's share is untouched
        assert reg.admit("b").ok
        reg.release("a")
        assert reg.admit("a").ok

    def test_breaker_isolation_in_registry(self):
        reg = TenantRegistry(
            [TenantSpec("a", "ka"), TenantSpec("b", "kb")],
            total_inflight=16,
        )
        for _ in range(5):
            reg.record_result("a", None, ok=False, latency_s=0.0)
        shed = reg.admit("a")
        assert not shed.ok and shed.reason == "breaker"
        assert reg.admit("b").ok  # b's breaker never saw a's failures
        st = reg.stats()
        assert st["a"]["breaker"] == "open"
        assert st["b"]["breaker"] == "closed"

    def test_pressure_tracks_inflight_not_quota(self):
        clock = _Clock()
        reg = TenantRegistry(
            [TenantSpec("a", "ka", quota_qps=1.0)],
            total_inflight=4, burst=1.0, clock=clock,
        )
        assert reg.admit("a").ok
        for _ in range(5):
            reg.admit("a")  # quota sheds
        p = reg.pressure()
        # quota saturation is a contract, not pressure: only the one
        # admitted inflight slot counts toward the autoscaler signal
        assert p["a"] == pytest.approx(1 / reg.stats()["a"]["cap"], abs=1e-6)

    def test_slo_violations_counted(self):
        reg = TenantRegistry(
            [TenantSpec("a", "ka", slo_ms=10.0)], total_inflight=4,
        )
        reg.record_result("a", "-", ok=True, latency_s=0.005)
        reg.record_result("a", "-", ok=True, latency_s=0.050)
        assert reg.stats()["a"]["slo_violations"] == 1


# -- fingerprint namespacing --------------------------------------------------


class TestTenantFingerprint:
    def test_namespace_splits_identical_queries(self):
        q = {"user": "u1", "num": 3}
        assert canonical_fingerprint(q, namespace="a\x1f-\x1fi1") != \
            canonical_fingerprint(q, namespace="b\x1f-\x1fi1")
        assert canonical_fingerprint(q, namespace=None) != \
            canonical_fingerprint(q, namespace="a\x1f-\x1fi1")

    def test_access_key_never_splits_the_key(self):
        a = canonical_fingerprint({"user": "u1", "accessKey": "ka"})
        b = canonical_fingerprint({"user": "u1", "accessKey": "kb"})
        c = canonical_fingerprint({"user": "u1"})
        assert a == b == c


# -- pipeline config & artifact -----------------------------------------------


def two_stage(candidates=None) -> PipelineConfig:
    params = (("candidates", candidates),) if candidates else ()
    return PipelineConfig(
        name="ivf-als",
        stages=(
            StageSpec("retrieve", "retrieval", 0.4, params=params),
            StageSpec("rank", "ranking", 0.5),
        ),
    )


class TestPipelineConfig:
    def test_validation(self):
        with pytest.raises(ValueError):  # first stage must be retrieval
            PipelineConfig(
                "p", (StageSpec("r", "ranking", 0.5),)
            ).validate()
        with pytest.raises(ValueError):  # budgets may not overdraw
            PipelineConfig("p", (
                StageSpec("a", "retrieval", 0.7),
                StageSpec("b", "ranking", 0.7),
            )).validate()
        with pytest.raises(ValueError):  # unknown kind
            PipelineConfig(
                "p", (StageSpec("a", "mystery", 0.5),)
            ).validate()
        with pytest.raises(ValueError):  # duplicate stage names
            PipelineConfig("p", (
                StageSpec("a", "retrieval", 0.4),
                StageSpec("a", "ranking", 0.4),
            )).validate()

    def test_fingerprint_tracks_content(self):
        assert two_stage().fingerprint == two_stage().fingerprint
        assert two_stage().fingerprint != two_stage(64).fingerprint

    def test_sealed_round_trip_and_torn_blob(self, tmp_path):
        path = str(tmp_path / "pipeline.blob")
        save_pipeline(two_stage(128), path)
        loaded = load_pipeline(path)
        assert loaded == two_stage(128)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF  # torn mid-write / bit-rot
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(ModelIntegrityError):
            load_pipeline(path)

    def test_pipeline_from_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PIO_PIPELINE", raising=False)
        assert pipeline_from_env() is None
        cfg = two_stage(64)
        monkeypatch.setenv(
            "PIO_PIPELINE", json.dumps(
                {"name": cfg.name,
                 "stages": [s.to_dict() for s in cfg.stages]}
            ),
        )
        assert pipeline_from_env() == cfg
        path = str(tmp_path / "p.blob")
        save_pipeline(cfg, path)
        monkeypatch.setenv("PIO_PIPELINE", path)
        assert pipeline_from_env() == cfg


# -- pipeline engine over a synthetic model -----------------------------------


@pytest.fixture(scope="module")
def bound_pipeline():
    """A two-stage engine over a small synthetic ALS surface (host
    scorer), with candidates=catalog so the composed answer is exactly
    comparable to the single-stage one."""
    import types

    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models.als import ALSModel, ALSScorer

    rng = np.random.default_rng(7)
    n_users, n_items, rank = 8, 256, 8
    model = ALSModel(
        user_factors=rng.normal(size=(n_users, rank)).astype(np.float32),
        item_factors=rng.normal(size=(n_items, rank)).astype(np.float32),
        user_map=BiMap({f"u{i}": i for i in range(n_users)}),
        item_map=BiMap({f"i{i}": i for i in range(n_items)}),
    )
    scorer = ALSScorer(DeviceContext.create(device="cpu"), model)
    algo = types.SimpleNamespace(_scorer=lambda m: scorer)
    engine = build_recommendation_stages(two_stage(256), algo, model)
    assert engine is not None
    return {"engine": engine, "scorer": scorer, "model": model,
            "algo": algo}


class TestPipelineEngine:
    def _query(self, **kw):
        from predictionio_tpu_torch.templates.recommendation import Query

        return Query(**{"user": "u1", "num": 5, **kw})

    def test_composed_matches_single_stage(self, bound_pipeline):
        pred, meta = bound_pipeline["engine"].run_pipeline(self._query())
        assert meta == {"degraded": False, "pipeline": True}
        exact_idx, exact_scores = bound_pipeline["scorer"].recommend(1, 5)
        inv = bound_pipeline["model"].item_map.inverse
        assert [s.item for s in pred.itemScores] == \
            [inv[int(i)] for i in exact_idx]
        assert [s.score for s in pred.itemScores] == pytest.approx(
            [float(s) for s in exact_scores]
        )

    def test_unknown_user_short_circuits(self, bound_pipeline):
        pred, meta = bound_pipeline["engine"].run_pipeline(
            self._query(user="nobody")
        )
        assert pred.itemScores == [] and meta["degraded"] is False

    def test_blacklist_respected(self, bound_pipeline):
        pred, _ = bound_pipeline["engine"].run_pipeline(self._query())
        banned = pred.itemScores[0].item
        pred2, _ = bound_pipeline["engine"].run_pipeline(
            self._query(blackList=[banned])
        )
        assert banned not in [s.item for s in pred2.itemScores]

    def test_rank_stage_overrun_degrades_to_retrieval(self, bound_pipeline):
        faults.install(faults.FaultPlan([
            faults.FaultRule(site="server:pipeline:rank", kind="latency",
                             latency_ms=150.0, p=1.0),
        ], seed=1))
        before = bound_pipeline["engine"].stats()["degraded_total"]
        pred, meta = bound_pipeline["engine"].run_pipeline(
            self._query(), deadline=Deadline.after_ms(60.0)
        )
        assert meta["degraded"] is True and meta["stage"] == "rank"
        assert len(pred.itemScores) == 5  # coarse retrieval-only answer
        assert bound_pipeline["engine"].stats()["degraded_total"] == before + 1

    def test_rank_stage_error_degrades(self, bound_pipeline):
        faults.install(faults.FaultPlan([
            faults.FaultRule(site="server:pipeline:rank", kind="error",
                             times=1),
        ], seed=1))
        pred, meta = bound_pipeline["engine"].run_pipeline(self._query())
        assert meta["degraded"] is True and meta["stage"] == "rank"
        assert len(pred.itemScores) == 5

    def test_retrieval_fault_has_nothing_to_degrade_to(self, bound_pipeline):
        faults.install(faults.FaultPlan([
            faults.FaultRule(site="server:pipeline:retrieve", kind="error",
                             times=1),
        ], seed=1))
        with pytest.raises(StageFault):
            bound_pipeline["engine"].run_pipeline(self._query())


# -- query server integration -------------------------------------------------


@pytest.fixture()
def storage():
    """A port MEMORY store of its own."""
    import uuid

    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.registry import Storage

    name = "TN" + uuid.uuid4().hex[:8].upper()
    yield Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })
    memory.reset_store(name)


@pytest.fixture()
def trained(storage, tmp_path, monkeypatch):
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data import Event
    from predictionio_tpu_torch.data import store as store_mod
    from predictionio_tpu_torch.data.storage import App
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for k in ("PIO_TENANTS", "PIO_PIPELINE", "PIO_RESULT_CACHE", "PIO_COALESCE",
              "PIO_ALS_COMPUTE_DTYPE", "PIO_ALS_SOLVER"):
        monkeypatch.delenv(k, raising=False)

    store_mod.set_storage(storage)
    app_id = storage.get_meta_data_apps().insert(App(0, "tenantapp"))
    le = storage.get_l_events()
    le.init(app_id)
    rng = np.random.default_rng(9)
    events = []
    for u in range(20):
        for i in rng.choice(16, size=6, replace=False):
            events.append(
                Event(
                    event="rate",
                    entity_type="user",
                    entity_id=f"u{u}",
                    target_entity_type="item",
                    target_entity_id=f"i{i}",
                    properties={"rating": float(rng.integers(1, 6))},
                )
            )
    le.batch_insert(events, app_id)
    engine = RecommendationEngine.apply()
    ep = engine.params_from_variant(
        {
            "datasource": {"params": {"appName": "tenantapp"}},
            "algorithms": [
                {"name": "als", "params": {"rank": 4, "numIterations": 3}}
            ],
        }
    )
    ctx = DeviceContext.create(device="cpu")
    run_train(engine, ep, "t", storage=storage, ctx=ctx)
    yield {"storage": storage, "engine": engine, "ctx": ctx}
    store_mod.set_storage(None)


def _registry(**alpha_kw) -> TenantRegistry:
    return TenantRegistry(
        [
            TenantSpec("alpha", "key-alpha", **alpha_kw),
            TenantSpec("beta", "key-beta"),
        ],
        total_inflight=32,
    )


class TestQueryServerTenancy:
    def _server(self, trained, **kw):
        from predictionio_tpu_torch.serving.query_server import QueryServer

        qs = QueryServer(
            trained["engine"], storage=trained["storage"],
            ctx=trained["ctx"], **kw,
        )
        port = qs.start("127.0.0.1", 0)
        return qs, f"http://127.0.0.1:{port}"

    def test_auth_contract(self, trained):
        qs, base = self._server(trained, tenants=_registry())
        try:
            url = base + "/queries.json"
            status, body, _ = call("POST", url, {"user": "u1", "num": 3})
            assert (status, body["message"]) == (401, "Missing accessKey.")
            status, body, _ = call(
                "POST", url, {"user": "u1", "num": 3, "accessKey": "wrong"}
            )
            assert (status, body["message"]) == (401, "Invalid accessKey.")
            status, body, _ = call(
                "POST", url, {"user": "u1", "num": 3, "accessKey": "key-alpha"}
            )
            assert status == 200 and len(body["itemScores"]) == 3
            # header auth (the event-server idiom) works too
            status, _, _ = call(
                "POST", url, {"user": "u1", "num": 3},
                headers={"X-PIO-Access-Key": "key-beta"},
            )
            assert status == 200
        finally:
            qs.stop()

    def test_quota_shed_carries_retry_after(self, trained):
        qs, base = self._server(
            trained, tenants=_registry(quota_qps=1.0),
        )
        try:
            url = base + "/queries.json"
            q = {"user": "u1", "num": 3, "accessKey": "key-alpha"}
            statuses = [call("POST", url, q)[0] for _ in range(4)]
            assert statuses.count(200) >= 1 and 503 in statuses
            status, body, headers = call("POST", url, q)
            assert status == 503 and body["reason"] == "quota"
            assert float(headers["Retry-After"]) > 0
            # the unquota'd tenant is untouched by alpha's saturation
            status, _, _ = call(
                "POST", url,
                {"user": "u1", "num": 3, "accessKey": "key-beta"},
            )
            assert status == 200
            st = qs._tenants.stats()
            assert st["alpha"]["shed"]["quota"] >= 1
            assert st["beta"]["shed"] == {
                "quota": 0, "inflight": 0, "breaker": 0,
            }
        finally:
            qs.stop()

    def test_chaos_fault_trips_only_that_tenants_breaker(self, trained):
        qs, base = self._server(trained, tenants=_registry())
        try:
            url = base + "/queries.json"
            faults.install(faults.FaultPlan([
                faults.FaultRule(site="client:tenant:alpha", kind="error",
                                 times=5),
            ], seed=3))
            a = {"user": "u1", "num": 3, "accessKey": "key-alpha"}
            b = {"user": "u2", "num": 3, "accessKey": "key-beta"}
            for _ in range(5):
                status, body, _ = call("POST", url, a)
                assert status == 503 and body.get("injected") is True
                status, body, _ = call("POST", url, b)
                assert status == 200  # beta rides through the chaos
            # alpha's breaker is open: shed fast, attributed to it
            status, body, _ = call("POST", url, a)
            assert status == 503 and body["reason"] == "breaker"
            st = qs._tenants.stats()
            assert st["alpha"]["breaker"] == "open"
            assert st["beta"]["breaker"] == "closed"
            assert st["beta"]["variants"][DEFAULT_VARIANT]["errors"] == 0
            assert st["beta"]["slo_violations"] == 0
        finally:
            qs.stop()

    def test_result_cache_is_tenant_namespaced(self, trained):
        qs, base = self._server(
            trained, tenants=_registry(), result_cache=ResultCache(),
        )
        try:
            url = base + "/queries.json"
            q = {"user": "u1", "num": 3}
            r_a1 = call("POST", url, {**q, "accessKey": "key-alpha"})
            r_a2 = call("POST", url, {**q, "accessKey": "key-alpha"})
            assert r_a1[1] == r_a2[1]
            stats = qs._result_cache.stats()
            assert stats["hits"] == 1 and stats["misses"] == 1
            # same query, other tenant: MUST miss (no cross-tenant reuse)
            call("POST", url, {**q, "accessKey": "key-beta"})
            stats = qs._result_cache.stats()
            assert stats["hits"] == 1 and stats["misses"] == 2
        finally:
            qs.stop()

    def test_variant_metrics_surface_in_info(self, trained):
        reg = TenantRegistry(
            [TenantSpec(
                "alpha", "key-alpha",
                variants=(VariantSpec("control", 1.0),
                          VariantSpec("exp", 1.0)),
            )],
            total_inflight=32,
        )
        qs, base = self._server(trained, tenants=reg)
        try:
            url = base + "/queries.json"
            for u in range(12):
                status, _, _ = call(
                    "POST", url,
                    {"user": f"u{u}", "num": 3, "accessKey": "key-alpha"},
                )
                assert status == 200
            _, info, _ = call("GET", base + "/")
            variants = info["tenancy"]["alpha"]["variants"]
            # arms accumulate independently, and each request landed on
            # the deterministic arm for its user key
            assert sum(v["requests"] for v in variants.values()) == 12
            for u in range(12):
                arm = reg.pick_variant("alpha", f"u{u}")
                assert variants[arm]["requests"] >= 1
        finally:
            qs.stop()

    def test_mixshift_quota_accounting(self, trained):
        from predictionio_tpu_torch.tools.scenarios import (
            parse_scenario, run_scenario,
        )

        qs, base = self._server(
            trained, tenants=_registry(quota_qps=5.0),
        )
        try:
            program = parse_scenario(
                "mixshift:name=shift,rate=40,duration=3,from=0.9,to=0.1"
            )
            res = run_scenario(
                base, {"user": "u1", "num": 3}, program,
                samples={"accessKey": ["key-alpha", "key-beta"]},
                concurrency=8,
            )
            st = qs._tenants.stats()
            # alpha's overage shed on its quota; beta never shed at all
            assert st["alpha"]["shed"]["quota"] > 0
            assert st["beta"]["shed"] == {
                "quota": 0, "inflight": 0, "breaker": 0,
            }
            assert res["errors"] == 0
            # exactly-once accounting: every offered request is either
            # admitted (one tenant's ledger) or attributed to a shed
            offered = sum(p["offered"] for p in res["phases"])
            admitted = sum(t["admitted"] for t in st.values())
            sheds = sum(sum(t["shed"].values()) for t in st.values())
            assert admitted + sheds == offered
            assert res["shed"] == sheds
            assert admitted == sum(p["ok"] for p in res["phases"])
        finally:
            qs.stop()


class TestQueryServerPipeline:
    def _server(self, trained, **kw):
        from predictionio_tpu_torch.serving.query_server import QueryServer

        qs = QueryServer(
            trained["engine"], storage=trained["storage"],
            ctx=trained["ctx"], **kw,
        )
        port = qs.start("127.0.0.1", 0)
        return qs, f"http://127.0.0.1:{port}"

    def test_pipeline_serves_and_reports(self, trained):
        qs, base = self._server(trained, pipeline=two_stage())
        try:
            status, body, _ = call(
                "POST", base + "/queries.json", {"user": "u1", "num": 3},
            )
            assert status == 200
            assert len(body["itemScores"]) == 3
            assert "degraded" not in body
            _, info, _ = call("GET", base + "/")
            stages = info["pipeline"]["stages"]
            assert stages["retrieve"]["runs"] >= 1
            assert stages["rank"]["runs"] >= 1
        finally:
            qs.stop()

    def test_stage_overrun_degrades_with_flag(self, trained):
        qs, base = self._server(
            trained, pipeline=two_stage(), result_cache=ResultCache(),
        )
        try:
            url = base + "/queries.json"
            faults.install(faults.FaultPlan([
                faults.FaultRule(site="server:pipeline:rank", kind="latency",
                                 latency_ms=500.0, times=1),
            ], seed=5))
            status, body, _ = call(
                "POST", url, {"user": "u1", "num": 3},
                headers={"X-Request-Deadline": "250"},
            )
            # the rank stage blew the request budget: the retrieval-only
            # answer arrives INSIDE a 200, flagged, instead of a 504
            assert status == 200
            assert body["degraded"] is True
            assert body["pipelineStage"] == "rank"
            assert len(body["itemScores"]) == 3
            # degraded answers are never cached: the next request (fault
            # exhausted) serves the full two-stage answer fresh
            status, body, _ = call("POST", url, {"user": "u1", "num": 3})
            assert status == 200 and "degraded" not in body
        finally:
            qs.stop()

    def test_tenanted_pipeline_end_to_end(self, trained):
        qs, base = self._server(
            trained, tenants=_registry(), pipeline=two_stage(),
        )
        try:
            status, body, _ = call(
                "POST", base + "/queries.json",
                {"user": "u1", "num": 3, "accessKey": "key-beta"},
            )
            assert status == 200 and len(body["itemScores"]) == 3
            _, info, _ = call("GET", base + "/")
            assert info["tenancy"]["beta"]["admitted"] == 1
            assert info["pipeline"]["stages"]["rank"]["runs"] >= 1
        finally:
            qs.stop()


# -- across the packages ------------------------------------------------------


def test_pick_variant_equals_jax_on_10000_pairs():
    from predictionio_tpu.serving import tenancy as jax_tenancy

    rng = np.random.default_rng(11)
    port_arms = (VariantSpec("control", 3.0), VariantSpec("exp", 1.0), VariantSpec("b", 0.5))
    jax_arms = tuple(jax_tenancy.VariantSpec(v.name, v.weight) for v in port_arms)
    pairs = [(f"t{int(rng.integers(0, 7))}",
              "" if rng.random() < 0.01 else f"user-{int(rng.integers(0, 10**9))}",
              str(int(rng.integers(0, 3))) if rng.random() < 0.2 else "")
             for _ in range(10_000)]
    port = [pick_variant(t, u, port_arms, salt=s) for t, u, s in pairs]
    jax = [jax_tenancy.pick_variant(t, u, jax_arms, salt=s) for t, u, s in pairs]
    assert port == jax
    assert set(port) == {"control", "exp", "b"}


class _SimClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 5])
def test_admission_sequences_equal_jax(seed):
    """Exact: one seeded sequence of admits, releases and results on one
    simulated clock gives the same admissions, reasons, Retry-After hints,
    pressure and stats in both packages."""
    from predictionio_tpu.serving import tenancy as jax_tenancy

    config = [{"tenantId": "a", "accessKey": "ka", "weight": 1.0, "quotaQps": 4.0},
              {"tenantId": "b", "accessKey": "kb", "weight": 3.0, "sloMs": 20.0,
               "variants": [{"name": "x", "weight": 1.0}, {"name": "y", "weight": 2.0}]},
              {"tenantId": "c", "accessKey": "kc", "weight": 0.5, "quotaQps": 1.5}]
    out = {}
    for name, mod in (("jax", jax_tenancy), ("port", None)):
        clock = _SimClock()
        make = (mod.TenantRegistry if mod else TenantRegistry)
        spec = (mod.TenantSpec if mod else TenantSpec)
        reg = make([spec.from_dict(d) for d in config], total_inflight=12, burst=2.0, clock=clock)
        rng = np.random.default_rng(seed)
        trace, held = [], []
        for _ in range(600):
            clock.t += float(rng.exponential(0.08))
            op = rng.random()
            tenant = "abc"[int(rng.integers(0, 3))]
            if op < 0.6:
                adm = reg.admit(tenant)
                trace.append(("admit", tenant, adm.ok, adm.reason, adm.retry_after_s))
                if adm.ok:
                    held.append(tenant)
            elif held:
                who = held.pop(int(rng.integers(0, len(held))))
                reg.release(who)
                variant = reg.pick_variant(who, f"u{int(rng.integers(0, 50))}")
                reg.record_result(who, variant, ok=bool(rng.random() < 0.97),
                                  latency_s=float(rng.exponential(0.01)))
                trace.append(("done", who, variant))
            trace.append(("pressure", tuple(sorted(reg.pressure().items()))))
        out[name] = (trace, reg.stats())
    assert out["port"] == out["jax"]
    reasons = {t[3] for t in out["port"][0] if t[0] == "admit" and not t[2]}
    assert "quota" in reasons


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pipeline_blob_opens_in_the_other_package(tmp_path, writer):
    from predictionio_tpu.serving import pipeline as jax_pipeline
    from predictionio_tpu_torch.serving import pipeline as port_pipeline

    mods = {"jax": jax_pipeline, "port": port_pipeline}
    w, r = mods[writer], mods["port" if writer == "jax" else "jax"]
    d = {"name": "ivf-als", "stages": [s.to_dict() for s in two_stage(48).stages]}
    path = str(tmp_path / "p.blob")
    w.save_pipeline(w.PipelineConfig.from_dict(d), path)
    got = r.load_pipeline(path)
    assert got == r.PipelineConfig.from_dict(d)
    assert got.fingerprint == w.PipelineConfig.from_dict(d).fingerprint
    assert got.describe() == w.load_pipeline(path).describe()


def test_pipeline_answers_on_an_ivf_model_hold_by_rule_4():
    """A small ALS model with an IVF index (nlist 16): the retrieval stage
    pools the best clusters' members (60 candidates), the ranking stage
    ranks them; its answers equal the plain exact top-k over those
    candidates and the JAX pipeline's answers on the same factors and
    index (values within 1e-5, indices equal but for ties)."""
    import types

    import jax

    from predictionio_tpu.data.bimap import BiMap as JaxBiMap
    from predictionio_tpu.models.als import ALSModel as JaxALSModel
    from predictionio_tpu.models.als import ALSScorer as JaxALSScorer
    from predictionio_tpu.ops import ivf as jax_ivf
    from predictionio_tpu.parallel.mesh import MeshContext
    from predictionio_tpu.serving import pipeline as jax_pipeline
    from predictionio_tpu.templates.recommendation import Query as JaxQuery
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models.als import ALSScorer, als_model_from_arrays
    from predictionio_tpu_torch.ops import ivf as port_ivf
    from predictionio_tpu_torch.serving.pipeline import _ivf_candidates
    from predictionio_tpu_torch.templates.recommendation import Query
    from predictionio_tpu_torch.testing import topk_mismatches

    rng = np.random.default_rng(3)
    n_users, n_items, rank, k = 30, 400, 8, 10
    U = rng.normal(size=(n_users, rank)).astype(np.float32)
    V = rng.normal(size=(n_items, rank)).astype(np.float32)
    users, items = [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)]
    cfg = {"name": "ivf-als", "stages": [
        {"name": "retrieve", "kind": "retrieval", "budgetFraction": 0.4,
         "params": {"candidates": 60}},
        {"name": "rank", "kind": "ranking", "budgetFraction": 0.5}]}

    port_model = als_model_from_arrays(U, V, users, items)
    port_model.ivf_index = port_ivf.build_index(V, 16, nprobe=4, seed=0)
    scorer = ALSScorer(DeviceContext.create(device="cpu"), port_model)
    port_engine = build_recommendation_stages(
        PipelineConfig.from_dict(cfg), types.SimpleNamespace(_scorer=lambda m: scorer), port_model)

    jax_model = JaxALSModel(user_factors=U, item_factors=V,
                            user_map=JaxBiMap({u: i for i, u in enumerate(users)}),
                            item_map=JaxBiMap({t: i for i, t in enumerate(items)}))
    jax_model.ivf_index = jax_ivf.build_index(V, 16, nprobe=4, seed=0)
    jax_scorer = JaxALSScorer(MeshContext.create(devices=jax.devices()[:1]), jax_model)
    jax_engine = jax_pipeline.build_recommendation_stages(
        jax_pipeline.PipelineConfig.from_dict(cfg),
        types.SimpleNamespace(_scorer=lambda m: jax_scorer), jax_model)
    np.testing.assert_array_equal(port_model.ivf_index.centroids, jax_model.ivf_index.centroids)

    def arrays(pred):
        return (np.array([[int(s.item[1:]) for s in pred.itemScores]]),
                np.array([[s.score for s in pred.itemScores]], np.float32))

    for u in range(n_users):
        pp, pmeta = port_engine.run_pipeline(Query(user=f"u{u}", num=k))
        jp, _ = jax_engine.run_pipeline(JaxQuery(user=f"u{u}", num=k))
        assert pmeta == {"degraded": False, "pipeline": True}
        pi, pv = arrays(pp)
        ji, jv = arrays(jp)
        assert topk_mismatches(pv, pi, jv, ji) == []
        cand, _ = _ivf_candidates(port_model.ivf_index, U[u], 60)
        exact = V[cand].astype(np.float64) @ U[u].astype(np.float64)
        order = np.lexsort((cand, -exact))[:k]
        ri, rv = cand[order][None, :], exact[order].astype(np.float32)[None, :]
        assert topk_mismatches(pv, pi, rv, ri) == []
        assert set(pi[0]) <= set(cand.tolist())
