"""The port's crash safety against the JAX package's: the fast-ack WAL, kill -9
at the ingest crash sites, and the buffered event server's drain.

Mirrors ``tests/test_durability.py``'s ``TestWAL``, ``TestKill9`` (the WAL
and ingest sites) and ``TestDrain`` on ``predictionio_tpu_torch``, and adds
a cross-package replay: a WAL segment either package wrote replays in the
other, record for record, and the event it holds lands in the other's
storage with its pinned id.

The kill -9 tests run each incarnation as a child ``python -c`` that dies at
a compiled-in ``crash:*`` site with ``os._exit(137)``; every child has its
own timeout, and the children import no jax.
"""

import datetime as dt
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
import uuid

import pytest

from predictionio_tpu.data.api import ingest_buffer as jax_ingest
from predictionio_tpu.data.api.wal import WriteAheadLog as JaxWAL
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu_torch.data.api import ingest_buffer as port_ingest
from predictionio_tpu_torch.data.api.wal import WriteAheadLog
from predictionio_tpu_torch.data.event import Event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRASH_RC = 137  # faults.CRASH_EXIT_CODE: 128 + SIGKILL
# every child blocks jax and the JAX package: the port stands alone
NO_JAX = "import sys; sys.modules['jax'] = None; sys.modules['predictionio_tpu'] = None\n"
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def call(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


# -- WAL unit suite ----------------------------------------------------------


class TestWAL:
    def test_append_replay_roundtrip(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        payloads = [f"rec-{i}".encode() for i in range(7)]
        for p in payloads:
            w.append(p)
        w.close()

        w2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w2.replay() == payloads
        assert w2.stats()["replayed"] == 7
        # reclaim drops the replayed segments; a third incarnation sees none
        w2.reclaim_replayed()
        w2.close()
        w3 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w3.replay() == []
        w3.close()

    def test_commit_reclaims_sealed_segments(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off", segment_max_bytes=64)
        seqs = [w.append(b"x" * 40) for _ in range(6)]
        assert w.stats()["rotations"] >= 2
        assert w.stats()["segments"] >= 3
        for s in seqs:
            w.commit(s)
        st = w.stats()
        assert st["reclaimed_segments"] >= 2
        assert st["segments"] <= 1  # only the append head may remain
        assert w.depth() == 0
        w.close()

    def test_checksum_rejects_corrupt_record(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        for i in range(3):
            w.append(f"solid-{i}".encode())
        w.close()
        seg = next((tmp_path / "wal").glob("wal-*.log"))
        raw = bytearray(seg.read_bytes())
        raw[-1] ^= 0xFF  # the LAST record's crc now mismatches
        seg.write_bytes(bytes(raw))

        w2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w2.replay() == [b"solid-0", b"solid-1"]
        assert w2.stats()["truncated_tails"] == 1
        assert seg.stat().st_size < len(raw)
        w2.close()

    def test_torn_tail_truncated(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        for i in range(4):
            w.append(f"whole-{i}".encode())
        w.close()
        seg = next((tmp_path / "wal").glob("wal-*.log"))
        good_size = seg.stat().st_size
        with open(seg, "ab") as f:  # a length prefix, half its payload
            f.write(b"\x40\x00\x00\x00\x99\x99")

        w2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w2.replay() == [f"whole-{i}".encode() for i in range(4)]
        assert w2.stats()["truncated_tails"] == 1
        assert seg.stat().st_size == good_size
        w2.close()

    def test_insane_length_prefix_ends_segment(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        w.append(b"ok")
        w.close()
        seg = next((tmp_path / "wal").glob("wal-*.log"))
        with open(seg, "ab") as f:
            f.write((2**31 - 1).to_bytes(4, "little") + b"\0\0\0\0" + b"junk")
        w2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w2.replay() == [b"ok"]
        w2.close()

    def test_bad_fsync_policy_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            WriteAheadLog(str(tmp_path / "wal"), fsync="sometimes")

    def test_new_appends_never_touch_leftover_segments(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        w.append(b"old")
        # no close(): a crash leaves the segment behind
        w2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        w2.append(b"new")
        assert w2.replay() == [b"old"]  # only pre-existing segments replay
        names = sorted(p.name for p in (tmp_path / "wal").glob("wal-*.log"))
        assert len(names) == 2
        w2.close()
        w.close()


# -- the two packages' WAL segments ------------------------------------------


def _events(cls, n):
    return [cls(event="rate", entity_type="user", entity_id=f"u{i}",
                target_entity_type="item", target_entity_id=f"i{i % 3}",
                properties={"rating": float(i % 5 + 1)}, event_id=f"wal-ev-{i:03d}",
                event_time=T0 + dt.timedelta(seconds=i), creation_time=T0)
            for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_segment_either_package_wrote_replays_in_the_other(tmp_path, writer):
    """Segments and records are byte for byte alike: the records one
    package journals (``wal_encode`` of the same events, the same frames)
    replay and decode in the other to the same events."""
    wal_dir = str(tmp_path / "wal")
    jax_recs = [jax_ingest.wal_encode(e, 1, c) for e, c in zip(_events(JaxEvent, 6), [None, 3] * 3)]
    port_recs = [port_ingest.wal_encode(e, 1, c) for e, c in zip(_events(Event, 6), [None, 3] * 3)]
    assert jax_recs == port_recs
    wcls, rcls, decode = ((JaxWAL, WriteAheadLog, port_ingest.wal_decode) if writer == "jax"
                          else (WriteAheadLog, JaxWAL, jax_ingest.wal_decode))
    w = wcls(wal_dir, fsync="off")
    for rec in jax_recs:
        w.append(rec)
    w.close()
    seg_bytes = {p.name: p.read_bytes() for p in (tmp_path / "wal").glob("wal-*.log")}
    r = rcls(wal_dir, fsync="off")
    got = r.replay()
    assert got == jax_recs
    decoded = [decode(p) for p in got]
    assert [(e.event_id, e.entity_id, e.properties["rating"], a, c) for e, a, c in decoded] == [
        (f"wal-ev-{i:03d}", f"u{i}", float(i % 5 + 1), 1, [None, 3][i % 2]) for i in range(6)]
    r.close()
    # the other writer's segment for the same records is the same file
    other = str(tmp_path / "wal2")
    w2 = rcls(other, fsync="off")
    for rec in jax_recs:
        w2.append(rec)
    w2.close()
    assert {p.name: p.read_bytes() for p in (tmp_path / "wal2").glob("wal-*.log")} == seg_bytes


def test_a_jax_written_wal_replays_into_the_port_event_server(tmp_path):
    """A fast-mode JAX event server's journal, left behind by a crash,
    replays into the port's event server at its start: every acked id in
    the port's storage, the segments reclaimed."""
    from predictionio_tpu_torch.data.api.event_server import EventServer
    from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage

    wal_dir = str(tmp_path / "wal")
    w = JaxWAL(wal_dir, fsync="always")
    for e in _events(JaxEvent, 5):
        w.append(jax_ingest.wal_encode(e, 1, None))
    # no close: the JAX server died with its records uncommitted
    name = "DUR" + uuid.uuid4().hex[:8].upper()
    storage = Storage(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
                           f"PIO_STORAGE_SOURCES_{name}_PATH": str(tmp_path / "port.db")})
    es = EventServer(storage=storage, ingest_mode="fast", wal_dir=wal_dir, telemetry=False)
    try:
        assert es.wal_replayed == 5
        ids = sorted(e.event_id for e in storage.get_l_events().find(1))
        assert ids == [f"wal-ev-{i:03d}" for i in range(5)]
    finally:
        es.stop()
        port_sqlite.close_all_dbs()
    assert WriteAheadLog(wal_dir, fsync="off").replay() == []


# -- kill-9 chaos (subprocess) -----------------------------------------------


@pytest.fixture()
def chaos_env(tmp_path):
    """One sqlite file and WAL directory shared by a dying child and the
    fresh child that verifies it."""
    src = "CHAOS"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PIO_FAULT_SPEC", "PIO_INGEST_BUFFER", "PIO_STREAMING")}
    env.update({
        "PYTHONPATH": ROOT,
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "sqlite",
        f"PIO_STORAGE_SOURCES_{src}_PATH": str(tmp_path / "events.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
        "PIO_WAL_DIR": str(tmp_path / "wal"),
        "CHAOS_ACKED_FILE": str(tmp_path / "acked.txt"),
    })
    return env


def run_py(code, env, timeout=60):
    return subprocess.run([sys.executable, "-c", NO_JAX + code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


VERIFY_EVENTS = """
import json, os
from predictionio_tpu_torch.data.api.event_server import EventServer
from predictionio_tpu_torch.data.storage.registry import Storage

storage = Storage()
es = EventServer(storage=storage, ingest_mode="fast",
                 wal_dir=os.environ["PIO_WAL_DIR"], telemetry=False)
app_id = int(os.environ.get("CHAOS_APP_ID", "1"))
ids = sorted(e.event_id for e in storage.get_l_events().find(app_id))
print(json.dumps({"replayed": es.wal_replayed, "ids": ids}))
es.stop()
"""


def _acked(env):
    with open(env["CHAOS_ACKED_FILE"]) as f:
        return [line for line in f.read().splitlines() if line]


@pytest.mark.chaos
class TestKill9:
    def test_fast_acked_events_survive_kill9(self, chaos_env):
        """No fast-acked (202) event is lost across kill -9 at
        ``crash:ingest:before_flush``: acks out, storage never written, the
        WAL replays them into the next incarnation."""
        env = dict(chaos_env)
        env["PIO_FAULT_SPEC"] = "site=crash:ingest:before_flush,kind=crash,times=1"
        crash = run_py("""
import os
from predictionio_tpu_torch.data.api.ingest_buffer import IngestBuffer
from predictionio_tpu_torch.data.api.wal import WriteAheadLog
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage

le = Storage().get_l_events()
le.init(1)
wal = WriteAheadLog(os.environ["PIO_WAL_DIR"], fsync="always")
buf = IngestBuffer(le, flush_ms=60000.0, durable_ack=False, wal=wal)
ack_log = open(os.environ["CHAOS_ACKED_FILE"], "a")
for i in range(40):
    e = Event(event="rate", entity_type="user", entity_id=f"u{i}",
              target_entity_type="item", target_entity_id=f"i{i % 7}",
              properties={"rating": 1.0}, event_id=f"fastack-{i:03d}")
    buf.submit(e, 1)  # journaled (fsync) before this returns: acked
    ack_log.write(e.event_id + "\\n")
    ack_log.flush()
    os.fsync(ack_log.fileno())
buf.close(timeout=10.0)  # the first flush fires the crash site
""", env)
        assert crash.returncode == CRASH_RC, crash.stderr[-2000:]
        acked = _acked(env)
        assert len(acked) == 40

        verify = run_py(VERIFY_EVENTS, chaos_env)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert out["replayed"] >= 40
        assert set(acked) <= set(out["ids"])  # zero acked-event loss

    def test_durable_acked_events_survive_kill9(self, chaos_env):
        """No durable-acked (201) event is lost across kill -9: flush 1
        commits and acks, flush 2 dies at ``crash:ingest:before_flush``
        (``after=1``); sqlite's own commit is the durability."""
        env = dict(chaos_env)
        env["PIO_FAULT_SPEC"] = "site=crash:ingest:before_flush,kind=crash,times=1,after=1"
        crash = run_py("""
import os, time
from predictionio_tpu_torch.data.api.ingest_buffer import IngestBuffer
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage

le = Storage().get_l_events()
le.init(1)
buf = IngestBuffer(le, flush_ms=20.0, durable_ack=True)

def ev(i):
    return Event(event="rate", entity_type="user", entity_id=f"u{i}",
                 target_entity_type="item", target_entity_id=f"i{i % 7}",
                 properties={"rating": 1.0}, event_id=f"durable-{i:03d}")

tickets = [buf.submit(ev(i), 1) for i in range(10)]
ack_log = open(os.environ["CHAOS_ACKED_FILE"], "a")
for t in tickets:
    assert t.wait(10.0) and t.error is None
    ack_log.write(t.event_id + "\\n")
ack_log.flush(); os.fsync(ack_log.fileno())
for i in range(10, 20):
    buf.submit(ev(i), 1)
time.sleep(20)  # the crash arrives from the flusher thread
""", env)
        assert crash.returncode == CRASH_RC, crash.stderr[-2000:]
        acked = _acked(env)
        assert len(acked) == 10

        verify = run_py(VERIFY_EVENTS, chaos_env)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert set(acked) <= set(out["ids"])

    def test_crash_after_the_write_before_the_commit_duplicates_nothing(self, chaos_env):
        """kill -9 at ``crash:ingest:before_flush_commit``: the rows are on
        storage but the journal still holds them; the replay rewrites the
        same ids, so every acked event is there exactly once."""
        env = dict(chaos_env)
        env["PIO_FAULT_SPEC"] = "site=crash:ingest:before_flush_commit,kind=crash,times=1"
        crash = run_py("""
import os
from predictionio_tpu_torch.data.api.ingest_buffer import IngestBuffer
from predictionio_tpu_torch.data.api.wal import WriteAheadLog
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage

le = Storage().get_l_events()
le.init(1)
wal = WriteAheadLog(os.environ["PIO_WAL_DIR"], fsync="always")
buf = IngestBuffer(le, flush_ms=60000.0, durable_ack=False, wal=wal)
ack_log = open(os.environ["CHAOS_ACKED_FILE"], "a")
for i in range(12):
    e = Event(event="rate", entity_type="user", entity_id=f"u{i}",
              target_entity_type="item", target_entity_id="i1",
              properties={"rating": 2.0}, event_id=f"commit-{i:03d}")
    buf.submit(e, 1)
    ack_log.write(e.event_id + "\\n")
ack_log.flush(); os.fsync(ack_log.fileno())
buf.close(timeout=10.0)
""", env)
        assert crash.returncode == CRASH_RC, crash.stderr[-2000:]
        acked = _acked(env)
        verify = run_py(VERIFY_EVENTS, chaos_env)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert out["replayed"] == 12
        assert sorted(out["ids"]) == sorted(acked)  # once each, none lost

    def test_sigterm_drains_event_server_clean_exit(self, chaos_env):
        """SIGTERM → drain: buffered events flushed, WAL reclaimed, rc 0."""
        proc = subprocess.Popen(
            [sys.executable, "-c", NO_JAX + """
import os, sys, time
from predictionio_tpu_torch.data.api.event_server import EventServer
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools.cli import _install_drain_handler

storage = Storage()
app_id = storage.get_meta_data_apps().insert(App(0, "sigapp"))
storage.get_meta_data_access_keys().insert(AccessKey("sigkey", app_id, []))
es = EventServer(storage=storage, ingest_mode="fast",
                 wal_dir=os.environ["PIO_WAL_DIR"], telemetry=False)
port = es.start("127.0.0.1", 0)
_install_drain_handler(es)
print(port, app_id, flush=True)
while True:
    time.sleep(0.1)
"""],
            env=chaos_env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            port, app_id = (int(x) for x in proc.stdout.readline().split())
            base = f"http://127.0.0.1:{port}"
            for i in range(5):
                status, body, _ = call("POST", base + "/events.json?accessKey=sigkey", {
                    "event": "rate", "entityType": "user", "entityId": f"sig{i}",
                    "targetEntityType": "item", "targetEntityId": "i1",
                    "eventId": f"sigterm-{i}", "properties": {"rating": 2.0},
                })
                assert status == 202, (status, body)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=15)
            assert rc == 0, proc.stderr.read()[-2000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

        venv = dict(chaos_env)
        venv["CHAOS_APP_ID"] = str(app_id)
        verify = run_py(VERIFY_EVENTS, venv)
        assert verify.returncode == 0, verify.stderr[-2000:]
        out = json.loads(verify.stdout.strip().splitlines()[-1])
        assert out["replayed"] == 0  # drained, committed and reclaimed
        assert {f"sigterm-{i}" for i in range(5)} <= set(out["ids"])


# -- graceful drain (in-process) ---------------------------------------------


@pytest.fixture()
def sqlite_env(tmp_path):
    from predictionio_tpu_torch.data.storage.sqlite import close_db

    src = "D" + uuid.uuid4().hex[:8].upper()
    env = {
        f"PIO_STORAGE_SOURCES_{src}_TYPE": "sqlite",
        f"PIO_STORAGE_SOURCES_{src}_PATH": str(tmp_path / "events.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": src,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": src,
    }
    yield env
    close_db(str(tmp_path / "events.sqlite"))


class TestDrain:
    def test_event_server_drain_flushes_and_sheds(self, sqlite_env, tmp_path):
        from predictionio_tpu_torch.data.api.event_server import EventServer
        from predictionio_tpu_torch.data.storage.base import AccessKey, App
        from predictionio_tpu_torch.data.storage.registry import Storage

        storage = Storage(env=sqlite_env)
        app_id = storage.get_meta_data_apps().insert(App(0, "drainapp"))
        storage.get_meta_data_access_keys().insert(AccessKey("drainkey", app_id, []))
        es = EventServer(storage=storage, ingest_mode="fast", wal_dir=str(tmp_path / "wal"),
                         telemetry=False, ingest_flush_ms=50.0)
        base = f"http://127.0.0.1:{es.start('127.0.0.1', 0)}"
        try:
            status, body, _ = call("GET", base + "/readyz")
            assert status == 200 and body["status"] == "ready"
            for i in range(8):
                status, body, _ = call("POST", base + "/events.json?accessKey=drainkey", {
                    "event": "rate", "entityType": "user", "entityId": f"d{i}",
                    "targetEntityType": "item", "targetEntityId": "i1",
                    "eventId": f"drain-{i}", "properties": {"rating": 3.0},
                })
                assert status == 202

            # draining: readyz flips, new writes shed with Retry-After
            es._draining = True
            status, body, _ = call("GET", base + "/readyz")
            assert status == 503 and body["status"] == "draining"
            status, body, hdrs = call("POST", base + "/events.json", {
                "event": "rate", "entityType": "user", "entityId": "late",
            })
            assert status == 503 and "Retry-After" in hdrs
            status, body, _ = call("POST", base + "/batch/events.json", [])
            assert status == 503

            assert es.drain() is True
            assert es._drain_counts["drains"] == 1
            assert es._drain_counts["abandoned_events"] == 0
        finally:
            es.stop()

        ids = {e.event_id for e in storage.get_l_events().find(app_id)}
        assert {f"drain-{i}" for i in range(8)} <= ids
        w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
        assert w.replay() == []  # fully reclaimed
        w.close()

    def test_event_server_stop_route_drains(self, sqlite_env, tmp_path):
        from predictionio_tpu_torch.data.api.event_server import EventServer
        from predictionio_tpu_torch.data.storage.registry import Storage

        es = EventServer(storage=Storage(env=sqlite_env), ingest_mode="fast",
                         wal_dir=str(tmp_path / "wal"), telemetry=False)
        base = f"http://127.0.0.1:{es.start('127.0.0.1', 0)}"
        status, body, _ = call("POST", base + "/stop")
        assert status == 202 and "drain" in body["message"]
        deadline = time.time() + 10
        while time.time() < deadline and not es._stopped:
            time.sleep(0.05)
        assert es._stopped
        assert es._drain_counts["drains"] == 1
