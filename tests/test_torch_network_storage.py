"""The port's network storage driver: the JAX suite mirrored, and the wire
held against the JAX package in both directions.

Counterpart of ``tests/test_network_storage.py`` (wire formats, auth,
pushdown, the framed bulk pull, the capability probe and its legacy
fallbacks, a fresh host deploying from the storage server), run on the
port's ``StorageServer`` and client. Then the two packages meet:
``batch_to_npz``/``interactions_to_npz`` bytes of either decode with the
other's readers, and a port client against the JAX server (and a JAX client
against the port's) gives the same ``find``, framed and sharded scans and
``find_interactions`` as each package's own pair, on the same seeded events.
Every server binds port 0 and stops in a ``finally``; clients carry a
30 s timeout.
"""

import datetime as dt
import importlib
import json
import uuid

import numpy as np
import pytest

from predictionio_tpu_torch.data.batch import EventBatch, Interactions
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.network import (
    NetworkStorageError,
    StorageServer,
    batch_from_npz,
    batch_to_npz,
    interactions_from_npz,
    interactions_to_npz,
)
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError

UTC = dt.timezone.utc


def _mem_storage(name):
    return Storage(env={
        f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
    })


@pytest.fixture()
def served():
    name = "N" + uuid.uuid4().hex[:8].upper()
    backing = _mem_storage(name)
    server = StorageServer(backing, secret="s3cret")
    port = server.start("127.0.0.1", 0)
    client = Storage(env={
        "PIO_STORAGE_SOURCES_NET_TYPE": "network",
        "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
        "PIO_STORAGE_SOURCES_NET_SECRET": "s3cret",
        "PIO_STORAGE_SOURCES_NET_TIMEOUT": "30",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
    })
    try:
        yield {"server": server, "backing": backing, "client": client, "port": port}
    finally:
        server.stop()
        from predictionio_tpu_torch.data.storage import memory

        memory.reset_store(name)


class TestWireFormats:
    def test_event_batch_npz_roundtrip(self):
        t0 = dt.datetime(2026, 3, 1, tzinfo=UTC)
        events = [
            Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties={"rating": 4.5, "note": "héllo ünïcode"},
                  event_time=t0, tags=("a", "b"), pr_id="pr1"),
            Event(event="$set", entity_type="user", entity_id="u2",
                  properties={}, event_time=t0 + dt.timedelta(seconds=5)),
        ]
        batch = EventBatch.from_events(events)
        out = batch_from_npz(batch_to_npz(batch))
        assert len(out) == 2
        back = list(out)
        assert back[0].event == "rate"
        assert back[0].target_entity_id == "i1"
        assert back[0].properties["note"] == "héllo ünïcode"
        assert back[0].tags == ("a", "b")
        assert back[0].pr_id == "pr1"
        assert back[1].target_entity_type is None
        assert back[1].event_time == events[1].event_time

    def test_empty_batch_roundtrip(self):
        out = batch_from_npz(batch_to_npz(EventBatch.from_events([])))
        assert len(out) == 0

    def test_interactions_npz_roundtrip(self):
        inter = Interactions(
            user=np.array([0, 1, 0], dtype=np.int32),
            item=np.array([2, 0, 1], dtype=np.int32),
            rating=np.array([1.0, 2.0, 3.0], dtype=np.float32),
            t=np.array([10.0, 20.0, 30.0]),
            user_map=BiMap({"ua": 0, "ub": 1}),
            item_map=BiMap({"ia": 0, "ib": 1, "ic": 2}),
        )
        out = interactions_from_npz(interactions_to_npz(inter))
        np.testing.assert_array_equal(out.user, inter.user)
        np.testing.assert_array_equal(out.item, inter.item)
        np.testing.assert_allclose(out.rating, inter.rating)
        assert out.user_map["ub"] == 1
        assert out.item_map.inverse[2] == "ic"


class TestAuth:
    def test_wrong_secret_rejected(self, served):
        bad = Storage(env={
            "PIO_STORAGE_SOURCES_NET_TYPE": "network",
            "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{served['port']}",
            "PIO_STORAGE_SOURCES_NET_SECRET": "wrong",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
        })
        with pytest.raises(NetworkStorageError, match="secret"):
            bad.get_meta_data_apps().get_all()

    def test_right_secret_accepted(self, served):
        assert served["client"].get_meta_data_apps().get_all() == []

    def test_index_hides_topology_from_unauthenticated(self, served):
        import json
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{served['port']}/", timeout=30
        ) as r:
            info = json.loads(r.read().decode())
        assert info["status"] == "alive"
        assert "repositories" not in info

    def test_refuses_public_bind_without_secret(self):
        server = StorageServer(_mem_storage("NOSEC"), secret=None)
        with pytest.raises(ValueError, match="non-loopback"):
            server.start("0.0.0.0", 0)
        # loopback without a secret is fine (single-host dev)
        try:
            assert server.start("127.0.0.1", 0) > 0
        finally:
            server.stop()


class TestPredicatePushdown:
    def test_levents_find_filters_run_server_side(self, served):
        le = served["client"].get_l_events()
        le.init(9)
        t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
        for i in range(10):
            le.insert(
                Event(event="buy" if i % 2 else "view", entity_type="user",
                      entity_id=f"u{i % 3}", target_entity_type="item",
                      target_entity_id=f"i{i}",
                      event_time=t0 + dt.timedelta(seconds=i)),
                9,
            )
        # spy on the backing DAO: the filters must arrive there, meaning the
        # server — not the client — evaluated them (JDBC pushdown parity)
        backing_le = served["backing"].get_l_events()
        calls = []
        orig = backing_le.find

        def spy(app_id, **kw):
            calls.append(kw)
            return orig(app_id, **kw)

        backing_le.find = spy
        try:
            got = le.find(
                9, event_names=["buy"],
                start_time=t0 + dt.timedelta(seconds=2), limit=2,
            )
        finally:
            backing_le.find = orig
        assert [e.event for e in got] == ["buy", "buy"]
        assert len(got) == 2
        assert calls and calls[0]["event_names"] == ["buy"]
        assert calls[0]["limit"] == 2
        assert calls[0]["start_time"] == t0 + dt.timedelta(seconds=2)

    def test_aggregate_properties_folds_server_side(self, served):
        le = served["client"].get_l_events()
        le.init(9)
        le.insert(Event(event="$set", entity_type="user", entity_id="u1",
                        properties={"a": 1, "b": 2}), 9)
        le.insert(Event(event="$unset", entity_type="user", entity_id="u1",
                        properties={"b": None}), 9)
        snaps = le.aggregate_properties(9, "user")
        assert set(snaps) == {"u1"}
        assert snaps["u1"].to_dict() == {"a": 1}
        assert snaps["u1"].first_updated is not None

    def test_pevents_interactions_columnar(self, served):
        pe = served["client"].get_p_events()
        served["client"].get_l_events().init(9)
        served["client"].get_l_events().batch_insert(
            [
                Event(event="rate", entity_type="user", entity_id=f"u{i % 4}",
                      target_entity_type="item", target_entity_id=f"i{i % 6}",
                      properties={"rating": float(i % 5 + 1)})
                for i in range(24)
            ],
            9,
        )
        inter = pe.find_interactions(
            9, event_names=["rate"], rating_key="rating"
        )
        assert len(inter) == 24
        assert inter.n_users == 4 and inter.n_items == 6
        assert inter.rating.dtype == np.float32


class TestChunkedBulkPull:
    """Framed streaming of the bulk PEvents path (VERDICT r2 item 8).

    The HBase bulk-scan role (HBEventsUtil.scala:83-135): a large find()
    must not travel as one monolithic body against a whole-body deadline.
    """

    def _seed(self, storage, n=500):
        apps = storage.get_meta_data_apps()
        app_id = apps.insert(base.App(0, "bulk"))
        le = storage.get_l_events()
        le.init(app_id)
        events = [
            Event(
                event="view",
                entity_type="user",
                entity_id=f"u{i % 37}",
                target_entity_type="item",
                target_entity_id=f"i{i % 11}",
                properties={"n": i},
            )
            for i in range(n)
        ]
        le.batch_insert(events, app_id)
        return app_id

    def test_multi_frame_pull_equals_single_body(self, served):
        app_id = self._seed(served["backing"], n=500)
        pe = served["client"].get_p_events()
        # force many small frames through the private client config
        pe._c.chunk_rows = 64
        chunked = pe.find(app_id)
        pe._c.chunk_rows = 0  # legacy single-body wire
        single = pe.find(app_id)
        assert len(chunked) == len(single) == 500
        assert list(chunked.entity_id) == list(single.entity_id)
        assert [p["n"] for p in chunked.properties] == [
            p["n"] for p in single.properties
        ]

    def test_empty_result_streams_one_empty_frame(self, served):
        app_id = self._seed(served["backing"], n=3)
        pe = served["client"].get_p_events()
        pe._c.chunk_rows = 10
        batch = pe.find(app_id, event_names=["nonexistent"])
        assert len(batch) == 0

    def test_capability_probe_advertises_framed_scan(self, served):
        pe = served["client"].get_p_events()
        assert "framed_scan" in pe._c.capabilities()
        # cached: a second call must not re-probe (poison the URL to prove it)
        old_url = pe._c.url
        pe._c.url = "http://127.0.0.1:1"
        try:
            assert "framed_scan" in pe._c.capabilities()
        finally:
            pe._c.url = old_url

    def test_legacy_server_stays_on_single_body_wire(self, served, monkeypatch):
        # a pre-capability server advertises nothing on GET /; the client's
        # REAL probe must resolve empty, stay on the legacy wire (no
        # error-text sniffing, no 400s), and not cache the downgrade —
        # once the server upgrades, the next probe picks up framing
        from predictionio_tpu_torch.data.storage import network as net

        app_id = self._seed(served["backing"], n=100)
        pe = served["client"].get_p_events()
        pe._c.chunk_rows = 16
        monkeypatch.setattr(net, "SERVER_CAPABILITIES", frozenset())
        assert pe._c.capabilities() == frozenset()
        batch = pe.find(app_id)
        assert len(batch) == 100
        # mixed fleet finishes upgrading: the very next probe sees framing
        # (an empty probe result must not have been cached)
        monkeypatch.setattr(net, "SERVER_CAPABILITIES", frozenset({"framed_scan"}))
        assert "framed_scan" in pe._c.capabilities()

    def test_mixed_fleet_400_falls_back_single_body(self, served, monkeypatch):
        # probe says framed (upgraded replica) but the data request lands on
        # a legacy replica that 400s on chunk_rows: one structural retry on
        # the legacy wire, gated on the status code — a 5xx propagates
        from predictionio_tpu_torch.data.storage import network as net

        app_id = self._seed(served["backing"], n=50)
        pe = served["client"].get_p_events()
        pe._c.chunk_rows = 16
        assert "framed_scan" in pe._c.capabilities()  # cache the upgraded view
        real_iter = pe._c.iter_frames

        def legacy_replica(path, args):
            if "chunk_rows" in args:
                raise net.NetworkStorageError(
                    f"{path}: unexpected argument chunk_rows", status=400
                )
            return real_iter(path, args)

        monkeypatch.setattr(pe._c, "iter_frames", legacy_replica)
        batch = pe.find(app_id)  # retried on the single-body wire
        assert len(batch) == 50

        def dead_replica(path, args):
            raise net.NetworkStorageError(f"{path}: boom", status=500)

        monkeypatch.setattr(pe._c, "iter_frames", dead_replica)
        with pytest.raises(net.NetworkStorageError):
            pe.find(app_id)

    def test_unframed_response_fallback(self, served):
        # an endpoint that answers with a plain body: iter_frames must
        # yield it once instead of misparsing it as frames
        pe = served["client"].get_p_events()
        frames = list(
            pe._c.iter_frames("/pevents/find", {"app_id": 1, "chunk_rows": 0})
        )
        assert len(frames) == 1
        assert len(batch_from_npz(frames[0])) == 0

    def test_large_pull_many_frames(self, served):
        # a few hundred thousand rows through 32k-row frames: proves the
        # stream survives many frames and per-frame memory stays bounded
        storage = served["backing"]
        apps = storage.get_meta_data_apps()
        app_id = apps.insert(base.App(0, "big"))
        le = storage.get_l_events()
        le.init(app_id)
        n = 130_000
        le.batch_insert(
            [
                Event(
                    event="buy",
                    entity_type="user",
                    entity_id=f"u{i}",
                    target_entity_type="item",
                    target_entity_id=f"i{i % 997}",
                )
                for i in range(n)
            ],
            app_id,
        )
        pe = served["client"].get_p_events()
        pe._c.chunk_rows = 32_768
        batch = pe.find(app_id)
        assert len(batch) == n
        assert batch.entity_id[0] == "u0" and batch.entity_id[-1] == f"u{n-1}"


class TestRemoteModelRepository:
    def test_fresh_host_deploys_from_remote(self, served, tmp_path):
        """Train against the storage server, then deploy from a CLIENT with
        no local state at all — the model must come over the wire
        (parity role: S3Models/HDFSModels remote model repo)."""
        from predictionio_tpu_torch.core.workflow import run_train
        from predictionio_tpu_torch.data import store as store_mod
        from predictionio_tpu_torch.device import DeviceContext
        from predictionio_tpu_torch.serving.query_server import QueryServer
        from predictionio_tpu_torch.templates.recommendation import (
            RecommendationEngine,
        )

        trainer_storage = served["client"]
        store_mod.set_storage(trainer_storage)
        app_id = trainer_storage.get_meta_data_apps().insert(
            base.App(0, "remoteapp")
        )
        le = trainer_storage.get_l_events()
        le.init(app_id)
        rng = np.random.default_rng(7)
        le.batch_insert(
            [
                Event(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties={"rating": float(rng.integers(1, 6))})
                for u in range(15) for i in rng.choice(12, 5, replace=False)
            ],
            app_id,
        )
        engine = RecommendationEngine.apply()
        ep = engine.params_from_variant({
            "datasource": {"params": {"appName": "remoteapp"}},
            "algorithms": [
                {"name": "als", "params": {"rank": 4, "numIterations": 2}}
            ],
        })
        ctx = DeviceContext.create(device="cpu")
        run_train(engine, ep, "f", storage=trainer_storage, ctx=ctx)

        # "another host": a brand-new client of the same server
        fresh = Storage(env={
            "PIO_STORAGE_SOURCES_NET_TYPE": "network",
            "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{served['port']}",
            "PIO_STORAGE_SOURCES_NET_SECRET": "s3cret",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
        })
        qs = QueryServer(
            RecommendationEngine.apply(), storage=fresh, ctx=ctx
        )
        port = qs.start("127.0.0.1", 0)
        try:
            import json
            import urllib.request

            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=json.dumps({"user": "u1", "num": 3}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as r:
                res = json.loads(r.read().decode())
            assert len(res["itemScores"]) == 3
        finally:
            qs.stop()
            store_mod.set_storage(None)


class TestJdbcAlias:
    def test_jdbc_without_postgres_url_fails_loudly(self):
        """TYPE=jdbc + jdbc:postgresql:// now maps to the native postgres
        wire driver (test_postgres.py covers the drop-in path); any OTHER
        jdbc database must still fail loudly, never fall back to a local
        file."""
        s = Storage(env={
            "PIO_STORAGE_SOURCES_PG_TYPE": "jdbc",
            "PIO_STORAGE_SOURCES_PG_URL": "jdbc:mysql://db/pio",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PG",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PG",
        })
        with pytest.raises(StorageError, match="TYPE=postgres"):
            s.get_meta_data_apps()

    def test_postgres_url_detection_is_prefix_based(self):
        from predictionio_tpu_torch.data.storage.registry import (
            _is_postgres_jdbc_url,
        )

        assert _is_postgres_jdbc_url("jdbc:postgresql://db/pio")
        assert _is_postgres_jdbc_url("postgres://db/pio")
        # a jdbc: embedded mid-URL must not be stripped into a false match
        assert not _is_postgres_jdbc_url(
            "jdbc:mysql://db/pio?fwd=jdbc:postgresql://x"
        )
        assert not _is_postgres_jdbc_url("jdbc:mysql://db/pio")


class TestServerInfo:
    def test_index_reports_backing_repositories_to_authed(self, served):
        import json
        import urllib.request

        from predictionio_tpu_torch.data.storage.network import SECRET_HEADER

        req = urllib.request.Request(
            f"http://127.0.0.1:{served['port']}/",
            headers={SECRET_HEADER: "s3cret"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            info = json.loads(r.read().decode())
        assert info["service"] == "pio-storage-server"
        assert info["repositories"]["EVENTDATA"]["type"] == "memory"


class TestPreShardingServer:
    def test_sharded_scan_fails_loudly_not_silently_full(self, served, monkeypatch):
        """A pre-sharding backing DAO must 400 a sharded scan: silently
        returning the FULL result to every worker would duplicate every
        rating N times in a multi-host train."""
        backing_pe = served["backing"].get_p_events()
        orig = backing_pe.find

        def legacy_find(app_id, channel_id=None, **kw):
            if "shard" in kw or "shard_key" in kw:
                raise TypeError("find() got an unexpected keyword 'shard'")
            return orig(app_id, channel_id=channel_id, **kw)

        monkeypatch.setattr(backing_pe, "find", legacy_find)
        pe = served["client"].get_p_events()
        # unsharded scans still work against the legacy server
        assert len(pe.find(1)) == 0
        with pytest.raises(NetworkStorageError):
            pe.find(1, shard=(0, 2), shard_key="entity")


class TestSearchQueryCapability:
    def test_search_and_query_fall_back_on_legacy_server(
        self, served, monkeypatch
    ):
        """A pre-upgrade server advertises no `search_query`: the client
        must evaluate host-side over the legacy wire (find/get_all), never
        dial the new routes (rolling-upgrade contract)."""
        import datetime as dt

        from predictionio_tpu_torch.data.event import Event
        from predictionio_tpu_torch.data.storage import base
        from predictionio_tpu_torch.data.storage import network as net

        backing, client = served["backing"], served["client"]
        le_back = backing.get_l_events()
        le_back.init(5)
        le_back.insert(
            Event(event="rate", entity_type="user", entity_id="Ünïque"), 5
        )
        now = dt.datetime.now(tz=dt.timezone.utc)
        backing.get_meta_data_engine_instances().insert(base.EngineInstance(
            id="", status="COMPLETED", start_time=now, end_time=now,
            engine_id="e", engine_version="1", engine_variant="default",
            engine_factory="f", algorithms_params='[{"name":"als"}]',
        ))
        monkeypatch.setattr(net, "SERVER_CAPABILITIES", frozenset())
        # wrong-route calls must blow up loudly, proving the fallback path
        monkeypatch.setitem(
            net._META_HANDLERS, ("engineinstances", "query"),
            lambda s, a: (_ for _ in ()).throw(AssertionError("new route")),
        )
        hits = client.get_l_events().search(5, "ünïque")
        assert [e.entity_id for e in hits] == ["Ünïque"]
        got = client.get_meta_data_engine_instances().query(text="als")
        assert len(got) == 1 and got[0].status == "COMPLETED"

    def test_search_query_advertised_and_served(self, served):
        from predictionio_tpu_torch.data.storage import network as net

        assert "search_query" in net.SERVER_CAPABILITIES
        eis = served["client"].get_meta_data_engine_instances()
        assert "search_query" in eis._c.capabilities()


# -- the two packages on one wire ---------------------------------------------


PKGS = {"port": "predictionio_tpu_torch", "jax": "predictionio_tpu"}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _seeded_events(pkg, n=300, seed=3):
    """The same seeded events as either package's Event records (ids,
    times and properties fixed, so both stores hold identical rows)."""
    Ev = _mod(pkg, "data.event").Event
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 2, 1, tzinfo=UTC)
    out = []
    for k in range(n):
        if k % 17 == 0:
            out.append(Ev(event="$set", entity_type="user", entity_id=f"u{k % 9}",
                          properties={"tier": int(rng.integers(3))}, event_id=f"e{k:05d}",
                          event_time=t0 + dt.timedelta(seconds=k), tags=("s",), pr_id="p1",
                          creation_time=t0))
            continue
        out.append(Ev(event="rate" if k % 5 else "buy", entity_type="user",
                      entity_id=f"u{int(rng.integers(23))}", target_entity_type="item",
                      target_entity_id=f"i{int(rng.integers(13))}",
                      properties={"rating": float(rng.integers(1, 6)), "note": "zürich"},
                      event_time=t0 + dt.timedelta(seconds=k), event_id=f"e{k:05d}",
                      creation_time=t0 + dt.timedelta(seconds=2 * k)))
    return out


@pytest.fixture()
def pair_factory():
    """``make(client_pkg, server_pkg)`` → (client Storage, app id): a memory
    store of the server's package holding the seeded events behind that
    package's StorageServer, and a network client of the other; every
    server is stopped at the end."""
    started = []

    def make(client_pkg, server_pkg):
        name = "X" + uuid.uuid4().hex[:8].upper()
        reg = _mod(server_pkg, "data.storage.registry")
        backing = reg.Storage(env={
            f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": name,
        })
        app_id = backing.get_meta_data_apps().insert(
            _mod(server_pkg, "data.storage.base").App(0, "wire"))
        backing.get_l_events().insert_batch(_seeded_events(server_pkg), app_id)
        server = _mod(server_pkg, "data.storage.network").StorageServer(backing, secret="w")
        started.append((server, server_pkg, name))
        port = server.start("127.0.0.1", 0)
        client = _mod(client_pkg, "data.storage.registry").Storage(env={
            "PIO_STORAGE_SOURCES_NET_TYPE": "network",
            "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
            "PIO_STORAGE_SOURCES_NET_SECRET": "w",
            "PIO_STORAGE_SOURCES_NET_TIMEOUT": "30",
            "PIO_STORAGE_SOURCES_NET_CHUNK_ROWS": "64",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
        })
        return client, app_id

    try:
        yield make
    finally:
        for server, pkg, name in started:
            server.stop()
            _mod(pkg, "data.storage.memory").reset_store(name)


def _batch_rows(b):
    """An EventBatch as plain rows, comparable across packages."""
    return [
        (b.event_id[i], b.event[i], b.entity_type[i], b.entity_id[i],
         b.target_entity_type[i], b.target_entity_id[i], float(b.event_time[i]),
         json.dumps(dict(b.properties[i]), sort_keys=True), tuple(b.tags[i]), b.pr_id[i],
         float(b.creation_time[i]))
        for i in range(len(b))
    ]


def _inter_cols(inter):
    return (inter.user.tolist(), inter.item.tolist(), inter.rating.tolist(), inter.t.tolist(),
            [inter.user_map.inverse[i] for i in range(len(inter.user_map))],
            [inter.item_map.inverse[i] for i in range(len(inter.item_map))])




class TestWireAcrossPackages:
    @pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
    def test_event_batch_npz_decodes_in_the_other_package(self, writer, reader):
        wb = _mod(writer, "data.batch").EventBatch.from_events(_seeded_events(writer, n=60))
        data = _mod(writer, "data.storage.network").batch_to_npz(wb)
        back = _mod(reader, "data.storage.network").batch_from_npz(data)
        assert _batch_rows(back) == _batch_rows(wb)
        # and re-encoded by the reader, the bytes decode to the same rows again
        again = _mod(writer, "data.storage.network").batch_from_npz(
            _mod(reader, "data.storage.network").batch_to_npz(back))
        assert _batch_rows(again) == _batch_rows(wb)

    @pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
    def test_interactions_npz_decodes_in_the_other_package(self, writer, reader):
        wb = _mod(writer, "data.batch").EventBatch.from_events(_seeded_events(writer, n=80))
        inter = wb.filter_events(["rate"]).interactions(rating_key="rating")
        data = _mod(writer, "data.storage.network").interactions_to_npz(inter)
        back = _mod(reader, "data.storage.network").interactions_from_npz(data)
        assert _inter_cols(back) == _inter_cols(inter)
        assert back.rating.dtype == np.float32 and back.user.dtype == np.int32

    def test_capabilities_are_the_same_list(self):
        assert (_mod("port", "data.storage.network").SERVER_CAPABILITIES
                == _mod("jax", "data.storage.network").SERVER_CAPABILITIES)


class TestClientsAcrossPackages:
    """A port client against the JAX server, and a JAX client against the
    port's, answer as each package's own pair does."""

    @pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
    def test_find_scans_and_interactions_equal_the_own_pair(
            self, pair_factory, client_pkg, server_pkg):
        cross, app_id = pair_factory(client_pkg, server_pkg)
        own, own_app = pair_factory(client_pkg, client_pkg)
        assert app_id == own_app
        cl, ol = cross.get_l_events(), own.get_l_events()
        rows = lambda evs: [json.dumps(e.to_dict(), sort_keys=True) for e in evs]  # noqa: E731
        assert rows(cl.find(app_id)) == rows(ol.find(app_id)) and len(cl.find(app_id)) == 300
        for kw in ({"entity_id": "u3"}, {"event_names": ["buy"], "reversed": True, "limit": 7},
                   {"target_entity_type": "None"}):
            assert rows(cl.find(app_id, **kw)) == rows(ol.find(app_id, **kw)), kw
        cp, op = cross.get_p_events(), own.get_p_events()
        # the framed bulk pull (64 rows a frame) and the single-body wire
        assert _batch_rows(cp.find(app_id)) == _batch_rows(op.find(app_id))
        cp._c.chunk_rows = 0
        assert _batch_rows(cp.find(app_id)) == _batch_rows(op.find(app_id))
        for key in ("row", "entity", "target"):
            parts = [cp.find(app_id, shard=(i, 3), shard_key=key) for i in range(3)]
            assert [_batch_rows(p) for p in parts] == [
                _batch_rows(op.find(app_id, shard=(i, 3), shard_key=key)) for i in range(3)], key
            assert sum(len(p) for p in parts) == 300
        kw = dict(entity_type="user", event_names=["rate"], target_entity_type="item",
                  rating_key="rating")
        assert _inter_cols(cp.find_interactions(app_id, **kw)) == _inter_cols(
            op.find_interactions(app_id, **kw))
        assert _inter_cols(cp.find_interactions(app_id, shard=(1, 2), shard_key="entity", **kw)) \
            == _inter_cols(op.find_interactions(app_id, shard=(1, 2), shard_key="entity", **kw))
        # search and the instance queries travel the same routes
        assert rows(cl.search(app_id, "ZÜRICH", limit=5)) == rows(ol.search(app_id, "zürich", limit=5))

    @pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
    def test_writes_land_for_the_other_package(self, pair_factory, client_pkg, server_pkg):
        cross, app_id = pair_factory(client_pkg, server_pkg)
        pe = cross.get_p_events()
        extra = _seeded_events(client_pkg, n=40, seed=9)
        extra = [e.with_id("w" + e.event_id) for e in extra]
        pe.write(extra, app_id)
        assert len(pe.find(app_id)) == 340
        pe.delete([e.event_id for e in extra[:10]], app_id)
        assert len(pe.find(app_id)) == 330
        models = cross.get_model_data_models()
        models.insert(_mod(client_pkg, "data.storage.base").Model(id="m x/1", models=b"\x00blob"))
        assert models.get("m x/1").models == b"\x00blob"
        assert cross.get_meta_data_sequences().gen_next("c") == 1
