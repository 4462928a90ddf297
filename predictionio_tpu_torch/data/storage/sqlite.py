"""SQLite storage driver (``PIO_STORAGE_SOURCES_*_TYPE=sqlite``), the
zero-config default store.

Counterpart of ``predictionio_tpu/data/storage/sqlite.py`` (parity: the
reference's ``storage/jdbc/`` driver), with the same schema, so one
``pio.db`` opens in either package: events, apps, access keys, channels,
engine and evaluation instances, models and sequences, filter predicates pushed into SQL
(``JDBCPEvents.find``). One file-backed database per source, WAL mode so
the event server's writers and the trainer's bulk reader coexist.

The sharded bulk read (``PEvents.find(shard=(index, count), shard_key=...)``)
pushes the JAX package's sqlite predicate into SQL over the same crc32
``pio_crc32`` function, so one file gives the same event ids to a process of
either package. Not ported yet, and raising an error that names the ROADMAP
item that brings it: free-text ``search`` (item 14).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import secrets
import sqlite3
import threading
from typing import Iterable, Optional

from predictionio_tpu_torch.data.batch import EventBatch
from predictionio_tpu_torch.data.event import DataMap, Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.utils.fs import pio_base_dir

# identical to the JAX package's schema, evaluation_instances included
_SCHEMA = """
CREATE TABLE IF NOT EXISTS events (
  id TEXT NOT NULL, app_id INTEGER NOT NULL, channel_id INTEGER NOT NULL,
  event TEXT NOT NULL, entity_type TEXT NOT NULL, entity_id TEXT NOT NULL,
  target_entity_type TEXT, target_entity_id TEXT,
  properties TEXT NOT NULL, event_time REAL NOT NULL,
  tags TEXT NOT NULL, pr_id TEXT, creation_time REAL NOT NULL,
  PRIMARY KEY (id, app_id, channel_id));
CREATE INDEX IF NOT EXISTS idx_events_scan
  ON events (app_id, channel_id, event_time);
CREATE INDEX IF NOT EXISTS idx_events_entity
  ON events (app_id, channel_id, entity_type, entity_id);
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL,
  description TEXT);
CREATE TABLE IF NOT EXISTS access_keys (
  key TEXT PRIMARY KEY, app_id INTEGER NOT NULL, events TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL,
  app_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS engine_instances (
  id TEXT PRIMARY KEY, status TEXT, start_time REAL, end_time REAL,
  engine_id TEXT, engine_version TEXT, engine_variant TEXT,
  engine_factory TEXT, batch TEXT, env TEXT, mesh_conf TEXT,
  data_source_params TEXT, preparator_params TEXT, algorithms_params TEXT,
  serving_params TEXT);
CREATE TABLE IF NOT EXISTS evaluation_instances (
  id TEXT PRIMARY KEY, status TEXT, start_time REAL, end_time REAL,
  evaluation_class TEXT, engine_params_generator_class TEXT, batch TEXT,
  env TEXT, mesh_conf TEXT, evaluator_results TEXT,
  evaluator_results_html TEXT, evaluator_results_json TEXT);
CREATE TABLE IF NOT EXISTS models (id TEXT PRIMARY KEY, models BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS sequences (
  name TEXT PRIMARY KEY, value INTEGER NOT NULL);
"""

_CONNS: dict[str, "_Db"] = {}
_CONNS_LOCK = threading.Lock()


def _open(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(path, check_same_thread=False)
    if path != ":memory:":
        conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute("PRAGMA busy_timeout=5000")
    return conn


def _cache_key(path: str) -> str:
    return os.path.abspath(path) if path != ":memory:" else ":memory:"


class _Db:
    """One database file: a shared reader connection under a Python lock,
    and a separate writer connection for event ingest."""

    def __init__(self, path: str):
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.key = _cache_key(path)
        self.conn = _open(path)
        self.lock = threading.RLock()
        # an insert's commit (the fsync) contends on SQLite's WAL locks,
        # not on the Python lock every reader DAO shares
        self._writer: Optional[sqlite3.Connection] = None
        self._writer_lock = threading.RLock()
        with self.lock:
            self.conn.executescript(_SCHEMA)
            # free-text containment with Python case folding (SQLite's LIKE
            # folds ASCII only); the JAX package's search pushdown calls it
            self.conn.create_function(
                "pio_contains", 2,
                lambda hay, needle: (
                    int(needle in hay.lower()) if hay is not None else 0
                ),
                deterministic=True,
            )
            # user_version 0 → 1: rows of older builds stored properties
            # with \uXXXX escapes; re-encode them as the UTF-8 new writes use
            if self.conn.execute("PRAGMA user_version").fetchone()[0] < 1:
                escaped = self.conn.execute(
                    "SELECT rowid, properties FROM events "
                    "WHERE instr(properties, ?) > 0",
                    ("\\u",),
                ).fetchall()
                for rid, props in escaped:
                    self.conn.execute(
                        "UPDATE events SET properties = ? WHERE rowid = ?",
                        (json.dumps(json.loads(props), ensure_ascii=False), rid),
                    )
                self.conn.execute("PRAGMA user_version = 1")
            self.conn.commit()

    def events_writer(self) -> tuple[sqlite3.Connection, threading.RLock]:
        """(conn, lock) for event-ingest writes: a dedicated WAL writer for
        a file, the shared pair for ``:memory:`` (one database a
        connection)."""
        if self.path == ":memory:":
            return self.conn, self.lock
        with self._writer_lock:
            if self._writer is None:
                self._writer = _open(self.path)
        return self._writer, self._writer_lock

    def close_writer(self) -> None:
        with self._writer_lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None

    def checkpoint(self) -> None:
        """TRUNCATE-checkpoint the WAL so a restarted process opens a
        settled database; best-effort (a live reader may hold it back)."""
        if self.path == ":memory:":
            return
        try:
            with self.lock:
                self.conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        except sqlite3.Error:
            pass

    def close(self) -> None:
        self.close_writer()
        self.checkpoint()
        with self.lock:
            self.conn.close()


def get_db(path: str) -> _Db:
    key = _cache_key(path)
    with _CONNS_LOCK:
        if key not in _CONNS:
            _CONNS[key] = _Db(path)
        return _CONNS[key]


def close_db(path_or_db) -> None:
    """Close and evict one cached connection (all DAOs sharing it go stale)."""
    if isinstance(path_or_db, _Db):
        key, want = path_or_db.key, path_or_db
    else:
        key, want = _cache_key(path_or_db), None
    with _CONNS_LOCK:
        db = _CONNS.get(key)
        if db is None or (want is not None and db is not want):
            db = want  # a stale handle: close it, leave the live cache alone
        else:
            _CONNS.pop(key)
    if db is not None:
        db.close()


def close_all_dbs() -> None:
    with _CONNS_LOCK:
        dbs = list(_CONNS.values())
        _CONNS.clear()
    for db in dbs:
        db.close()


def _default_path(source_name: str) -> str:
    return os.path.join(pio_base_dir(), f"{source_name.lower()}.sqlite")


class _SqliteDAO:
    def __init__(self, source_name: str = "default", path: Optional[str] = None, **_):
        self._db = get_db(path or _default_path(source_name))

    @property
    def conn(self):
        return self._db.conn

    @property
    def lock(self):
        return self._db.lock

    def _write(self, sql: str, params=()) -> int:
        """One statement and its commit under the shared lock; rows changed."""
        with self.lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
        return cur.rowcount

    def _one(self, sql: str, params=()):
        with self.lock:
            return self.conn.execute(sql, params).fetchone()

    def _all(self, sql: str, params=()) -> list:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()


def _chan(channel_id: Optional[int]) -> int:
    return 0 if channel_id is None else channel_id


def _ts(d: _dt.datetime) -> float:
    """Epoch seconds; naive datetimes are interpreted as UTC (never local)."""
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return d.timestamp()


def _dt_from(ts: float) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ts, tz=_dt.timezone.utc)


_INSERT_EVENT_SQL = "INSERT OR REPLACE INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"


def _event_row(event: Event, eid: str, app_id: int, channel_id: Optional[int]) -> tuple:
    return (
        eid,
        app_id,
        _chan(channel_id),
        event.event,
        event.entity_type,
        event.entity_id,
        event.target_entity_type,
        event.target_entity_id,
        json.dumps(event.properties.to_dict(), ensure_ascii=False),
        _ts(event.event_time),
        json.dumps(list(event.tags)),
        event.pr_id,
        _ts(event.creation_time),
    )


def _row_to_event(r) -> Event:
    return Event(
        event=r[3],
        entity_type=r[4],
        entity_id=r[5],
        target_entity_type=r[6],
        target_entity_id=r[7],
        properties=DataMap(json.loads(r[8])),
        event_time=_dt_from(r[9]),
        tags=tuple(json.loads(r[10])),
        pr_id=r[11],
        event_id=r[0],
        creation_time=_dt_from(r[12]),
    )


def _event_where(
    app_id,
    channel_id,
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=None,
    target_entity_id=None,
):
    """The SQL predicate of a filtered scan (parity: JDBCPEvents.find)."""
    clauses = ["app_id = ?", "channel_id = ?"]
    params: list = [app_id, _chan(channel_id)]
    if start_time is not None:
        clauses.append("event_time >= ?")
        params.append(_ts(start_time))
    if until_time is not None:
        clauses.append("event_time < ?")
        params.append(_ts(until_time))
    for col, val in (("entity_type", entity_type), ("entity_id", entity_id)):
        if val is not None:
            clauses.append(f"{col} = ?")
            params.append(val)
    if event_names is not None:
        if len(event_names) == 0:
            clauses.append("1 = 0")  # an empty IN-list matches nothing
        else:
            clauses.append(f"event IN ({','.join('?' * len(event_names))})")
            params.extend(event_names)
    # the string "None" filters for events WITHOUT a target
    for col, val in (
        ("target_entity_type", target_entity_type),
        ("target_entity_id", target_entity_id),
    ):
        if val == "None":
            clauses.append(f"{col} IS NULL")
        elif val is not None:
            clauses.append(f"{col} = ?")
            params.append(val)
    return " AND ".join(clauses), params


_EVENT_KEY = "WHERE id = ? AND app_id = ? AND channel_id = ?"


class SqliteLEvents(_SqliteDAO, base.LEvents):
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return True  # one table for every namespace: nothing to create

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._write(
            "DELETE FROM events WHERE app_id = ? AND channel_id = ?",
            (app_id, _chan(channel_id)),
        )
        return True

    def close(self) -> None:
        # the shared connection belongs to the module cache; the ingest
        # writer is this DAO's (it reopens on next use)
        self._db.close_writer()
        self._db.checkpoint()

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events, app_id, channel_id=None):
        # rows are serialized before the lock (a bad event fails the batch
        # with nothing written); one executemany and one commit a batch
        ids, rows = [], []
        for event in events:
            eid = event.event_id or new_event_id()
            ids.append(eid)
            rows.append(_event_row(event, eid, app_id, channel_id))
        if not rows:
            return ids
        conn, lock = self._db.events_writer()
        with lock:
            conn.executemany(_INSERT_EVENT_SQL, rows)
            conn.commit()
        return ids

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None):
        r = self._one(f"SELECT * FROM events {_EVENT_KEY}", (event_id, app_id, _chan(channel_id)))
        return _row_to_event(r) if r else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self._write(
            f"DELETE FROM events {_EVENT_KEY}", (event_id, app_id, _chan(channel_id))
        ) > 0

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        where, params = _event_where(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )
        order = "DESC" if reversed else "ASC"
        # one entity's rows (a serving-time history or seen-set read) come
        # from the entity index; left to itself sqlite walks the time index
        # over the whole app to honour ORDER BY (~70 ms at 130,000 events)
        table = "events INDEXED BY idx_events_entity" if entity_id is not None else "events"
        sql = (f"SELECT * FROM {table} WHERE {where} "
               f"ORDER BY event_time {order}, creation_time {order}")
        if limit is not None and limit >= 0:
            sql += f" LIMIT {int(limit)}"
        return [_row_to_event(r) for r in self._all(sql, params)]

    def search(self, app_id, text, channel_id=None, limit=None, **filters):
        raise NotImplementedError(
            "free-text event search is not ported to predictionio_tpu_torch "
            "yet (ROADMAP §1 item 14)"
        )


class SqlitePEvents(_SqliteDAO, base.PEvents):
    def __init__(self, source_name: str = "default", path: Optional[str] = None, **kw):
        super().__init__(source_name=source_name, path=path, **kw)
        self._l = SqliteLEvents(source_name=source_name, path=path, **kw)

    def find(self, app_id, channel_id=None, shard=None, shard_key="row",
             **filters) -> EventBatch:
        if shard is None or int(shard[1]) <= 1:
            return EventBatch.from_events(self._l.find(app_id, channel_id, **filters))
        # the sharded bulk read: the partition predicate runs in SQL next to
        # the data, so each process materializes only its 1/count (parity:
        # Spark JDBC partitioned reads, JDBCPEvents.scala:35-119)
        index, count = int(shard[0]), int(shard[1])
        where, params = _event_where(
            app_id, channel_id, filters.get("start_time"), filters.get("until_time"),
            filters.get("entity_type"), filters.get("entity_id"), filters.get("event_names"),
            filters.get("target_entity_type"), filters.get("target_entity_id"),
        )
        if shard_key in ("entity", "target"):
            # the shared entity hash (base.PEvents.shard_hash) as a SQL
            # function; registering it again on a shared connection is a no-op
            with self.lock:
                self.conn.create_function(
                    "pio_crc32", 1,
                    lambda v: base.PEvents.shard_hash(v) if v is not None else 0,
                    deterministic=True,
                )
        # rowid-modulo row rule: disjoint and covering
        pred = base.PEvents.shard_sql_predicate(shard_key, "(rowid % ?) = ?")
        sql = (f"SELECT * FROM events WHERE {where} AND {pred} "
               "ORDER BY event_time ASC, creation_time ASC")
        rows = self._all(sql, (*params, count, index))
        return EventBatch.from_events([_row_to_event(r) for r in rows])

    def write(self, events: Iterable[Event], app_id: int, channel_id=None) -> None:
        self._l.batch_insert(list(events), app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int, channel_id=None) -> None:
        with self.lock:
            self.conn.executemany(
                f"DELETE FROM events {_EVENT_KEY}",
                [(eid, app_id, _chan(channel_id)) for eid in event_ids],
            )
            self.conn.commit()


class SqliteModels(_SqliteDAO, base.Models):
    def insert(self, model: base.Model) -> None:
        self._write("INSERT OR REPLACE INTO models VALUES (?, ?)", (model.id, model.models))

    def get(self, model_id: str):
        r = self._one("SELECT id, models FROM models WHERE id = ?", (model_id,))
        return base.Model(r[0], r[1]) if r else None

    def delete(self, model_id: str) -> None:
        self._write("DELETE FROM models WHERE id = ?", (model_id,))


class SqliteSequences(_SqliteDAO, base.Sequences):
    """Atomic named counters (parity: ESSequences.scala): INSERT OR IGNORE,
    UPDATE and SELECT in one transaction (no ``RETURNING``, which needs
    SQLite ≥ 3.35). The lock serializes threads, the transaction other
    processes on the file."""

    def gen_next(self, name: str) -> int:
        with self.lock:
            self.conn.execute(
                "INSERT OR IGNORE INTO sequences (name, value) VALUES (?, 0)", (name,)
            )
            self.conn.execute(
                "UPDATE sequences SET value = value + 1 WHERE name = ?", (name,)
            )
            row = self.conn.execute(
                "SELECT value FROM sequences WHERE name = ?", (name,)
            ).fetchone()
            self.conn.commit()
        return int(row[0])


class SqliteApps(_SqliteDAO, base.Apps):
    _SELECT = "SELECT id, name, description FROM apps"

    def insert(self, app: base.App):
        with self.lock:
            try:
                if app.id > 0:
                    cur = self.conn.execute(
                        "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                        (app.id, app.name, app.description),
                    )
                else:
                    cur = self.conn.execute(
                        "INSERT INTO apps (name, description) VALUES (?,?)",
                        (app.name, app.description),
                    )
                self.conn.commit()
                return cur.lastrowid if app.id <= 0 else app.id
            except sqlite3.IntegrityError:
                return None

    def get(self, app_id: int):
        r = self._one(f"{self._SELECT} WHERE id = ?", (app_id,))
        return base.App(*r) if r else None

    def get_by_name(self, name: str):
        r = self._one(f"{self._SELECT} WHERE name = ?", (name,))
        return base.App(*r) if r else None

    def get_all(self):
        return [base.App(*r) for r in self._all(f"{self._SELECT} ORDER BY id")]

    def update(self, app: base.App) -> bool:
        return self._write(
            "UPDATE apps SET name = ?, description = ? WHERE id = ?",
            (app.name, app.description, app.id),
        ) > 0

    def delete(self, app_id: int) -> bool:
        return self._write("DELETE FROM apps WHERE id = ?", (app_id,)) > 0


class SqliteAccessKeys(_SqliteDAO, base.AccessKeys):
    def insert(self, access_key: base.AccessKey):
        key = access_key.key or self.generate_key()
        with self.lock:
            try:
                self.conn.execute(
                    "INSERT INTO access_keys VALUES (?,?,?)",
                    (key, access_key.app_id, json.dumps(list(access_key.events))),
                )
                self.conn.commit()
                return key
            except sqlite3.IntegrityError:
                return None

    @staticmethod
    def _row(r):
        return base.AccessKey(r[0], r[1], json.loads(r[2]))

    def get(self, key: str):
        r = self._one("SELECT * FROM access_keys WHERE key = ?", (key,))
        return self._row(r) if r else None

    def get_all(self):
        return [self._row(r) for r in self._all("SELECT * FROM access_keys")]

    def get_by_app_id(self, app_id: int):
        return [self._row(r) for r in
                self._all("SELECT * FROM access_keys WHERE app_id = ?", (app_id,))]

    def update(self, access_key: base.AccessKey) -> bool:
        return self._write(
            "UPDATE access_keys SET app_id = ?, events = ? WHERE key = ?",
            (access_key.app_id, json.dumps(list(access_key.events)), access_key.key),
        ) > 0

    def delete(self, key: str) -> bool:
        return self._write("DELETE FROM access_keys WHERE key = ?", (key,)) > 0


class SqliteChannels(_SqliteDAO, base.Channels):
    _SELECT = "SELECT id, name, app_id FROM channels"

    def insert(self, channel: base.Channel):
        if not base.Channel.is_valid_name(channel.name):
            return None
        with self.lock:
            try:
                if channel.id > 0:
                    self.conn.execute(
                        "INSERT INTO channels (id, name, app_id) VALUES (?,?,?)",
                        (channel.id, channel.name, channel.app_id),
                    )
                    self.conn.commit()
                    return channel.id
                cur = self.conn.execute(
                    "INSERT INTO channels (name, app_id) VALUES (?,?)",
                    (channel.name, channel.app_id),
                )
                self.conn.commit()
                return cur.lastrowid
            except sqlite3.IntegrityError:
                return None

    def get(self, channel_id: int):
        r = self._one(f"{self._SELECT} WHERE id = ?", (channel_id,))
        return base.Channel(*r) if r else None

    def get_by_app_id(self, app_id: int):
        return [base.Channel(*r) for r in self._all(f"{self._SELECT} WHERE app_id = ?", (app_id,))]

    def delete(self, channel_id: int) -> bool:
        return self._write("DELETE FROM channels WHERE id = ?", (channel_id,)) > 0


class SqliteEngineInstances(_SqliteDAO, base.EngineInstances):
    _COLS = (
        "id, status, start_time, end_time, engine_id, engine_version, "
        "engine_variant, engine_factory, batch, env, mesh_conf, "
        "data_source_params, preparator_params, algorithms_params, serving_params"
    )

    @staticmethod
    def _row(r) -> base.EngineInstance:
        return base.EngineInstance(
            id=r[0],
            status=r[1],
            start_time=_dt_from(r[2]),
            end_time=_dt_from(r[3]),
            engine_id=r[4],
            engine_version=r[5],
            engine_variant=r[6],
            engine_factory=r[7],
            batch=r[8],
            env=json.loads(r[9]),
            mesh_conf=json.loads(r[10]),
            data_source_params=r[11],
            preparator_params=r[12],
            algorithms_params=r[13],
            serving_params=r[14],
        )

    @staticmethod
    def _vals(i: base.EngineInstance) -> tuple:
        return (
            i.id,
            i.status,
            _ts(i.start_time),
            _ts(i.end_time),
            i.engine_id,
            i.engine_version,
            i.engine_variant,
            i.engine_factory,
            i.batch,
            json.dumps(i.env),
            json.dumps(i.mesh_conf),
            i.data_source_params,
            i.preparator_params,
            i.algorithms_params,
            i.serving_params,
        )

    def insert(self, instance: base.EngineInstance) -> str:
        instance.id = instance.id or secrets.token_hex(8)
        self._write(
            f"INSERT OR REPLACE INTO engine_instances VALUES ({','.join('?' * 15)})",
            self._vals(instance),
        )
        return instance.id

    def get(self, instance_id: str):
        r = self._one(f"SELECT {self._COLS} FROM engine_instances WHERE id = ?", (instance_id,))
        return self._row(r) if r else None

    def get_all(self):
        return [self._row(r) for r in self._all(f"SELECT {self._COLS} FROM engine_instances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._all(
            f"SELECT {self._COLS} FROM engine_instances WHERE status = ? AND "
            "engine_id = ? AND engine_version = ? AND engine_variant = ? "
            "ORDER BY start_time DESC",
            (self.STATUS_COMPLETED, engine_id, engine_version, engine_variant),
        )
        return [self._row(r) for r in rows]

    def update(self, instance: base.EngineInstance) -> bool:
        return self._write(
            "UPDATE engine_instances SET status=?, start_time=?, end_time=?, "
            "engine_id=?, engine_version=?, engine_variant=?, engine_factory=?, "
            "batch=?, env=?, mesh_conf=?, data_source_params=?, "
            "preparator_params=?, algorithms_params=?, serving_params=? "
            "WHERE id=?",
            self._vals(instance)[1:] + (instance.id,),
        ) > 0

    def delete(self, instance_id: str) -> bool:
        return self._write("DELETE FROM engine_instances WHERE id = ?", (instance_id,)) > 0


class SqliteEvaluationInstances(_SqliteDAO, base.EvaluationInstances):
    """The ``evaluation_instances`` table (the JAX package's schema and
    column order, ``predictionio_tpu/data/storage/sqlite.py:894``)."""

    _COLS = (
        "id, status, start_time, end_time, evaluation_class, "
        "engine_params_generator_class, batch, env, mesh_conf, "
        "evaluator_results, evaluator_results_html, evaluator_results_json"
    )

    @staticmethod
    def _row(r) -> base.EvaluationInstance:
        return base.EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=_dt_from(r[2]),
            end_time=_dt_from(r[3]),
            evaluation_class=r[4],
            engine_params_generator_class=r[5],
            batch=r[6],
            env=json.loads(r[7]),
            mesh_conf=json.loads(r[8]),
            evaluator_results=r[9],
            evaluator_results_html=r[10],
            evaluator_results_json=r[11],
        )

    @staticmethod
    def _vals(i: base.EvaluationInstance) -> tuple:
        return (
            i.id,
            i.status,
            _ts(i.start_time),
            _ts(i.end_time),
            i.evaluation_class,
            i.engine_params_generator_class,
            i.batch,
            json.dumps(i.env),
            json.dumps(i.mesh_conf),
            i.evaluator_results,
            i.evaluator_results_html,
            i.evaluator_results_json,
        )

    def insert(self, instance: base.EvaluationInstance) -> str:
        instance.id = instance.id or secrets.token_hex(8)
        self._write(
            f"INSERT OR REPLACE INTO evaluation_instances VALUES ({','.join('?' * 12)})",
            self._vals(instance),
        )
        return instance.id

    def get(self, instance_id: str):
        r = self._one(
            f"SELECT {self._COLS} FROM evaluation_instances WHERE id = ?", (instance_id,))
        return self._row(r) if r else None

    def get_all(self):
        return [self._row(r) for r in self._all(f"SELECT {self._COLS} FROM evaluation_instances")]

    def get_completed(self):
        rows = self._all(
            f"SELECT {self._COLS} FROM evaluation_instances WHERE status = ? "
            "ORDER BY start_time DESC",
            (self.STATUS_COMPLETED,),
        )
        return [self._row(r) for r in rows]

    def update(self, instance: base.EvaluationInstance) -> bool:
        return self._write(
            "UPDATE evaluation_instances SET status=?, start_time=?, end_time=?, "
            "evaluation_class=?, engine_params_generator_class=?, batch=?, env=?, "
            "mesh_conf=?, evaluator_results=?, evaluator_results_html=?, "
            "evaluator_results_json=? WHERE id=?",
            self._vals(instance)[1:] + (instance.id,),
        ) > 0

    def delete(self, instance_id: str) -> bool:
        return self._write(
            "DELETE FROM evaluation_instances WHERE id = ?", (instance_id,)) > 0
