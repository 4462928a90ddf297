"""SQL-queryable event views (parity: ``data/view/DataView.scala``).

Counterpart of ``predictionio_tpu/data/view.py``: ``create`` (conversion,
time range, the cache key ``_conversion_hash``, the auto-cache rule),
``sql`` and ``events_sql``. Host-only code with no work for the card;
pandas is imported inside each function, as in the JAX module, so a
machine without pandas imports this module and gets ImportError naming
pandas only when it calls one. The cache stays pandas' own
``to_parquet``/``read_parquet``.

The reference's ``DataView.create`` turns an app's events into a Spark SQL
DataFrame via a user conversion function, caching the materialized view as a
parquet file under ``$PIO_FS_BASEDIR/view`` keyed by a hash of the time range,
a user ``version`` tag, and the conversion class
(``DataView.scala:56-110``).  The deprecated ``LBatchView``/``PBatchView``
layer is intentionally not reproduced (deprecated since 0.9.2 upstream).

Here the view is a pandas DataFrame (the notebook surface — pypio's
``find_events`` returns the same shape) and the SQL engine is sqlite, which
ships with CPython: :func:`sql` loads one or more DataFrames into an
in-memory sqlite database and runs arbitrary SQL against them.  The card is
for training/serving math; ad-hoc relational queries over event logs are a
host-side concern, so a host SQL engine is the idiomatic seat for them.

Usage::

    from predictionio_tpu_torch.data import view

    df = view.create("myapp", conversion=lambda e: {
        "user": e.entity_id, "item": e.target_entity_id,
        "rating": e.properties.get("rating"),
    } if e.event == "rate" else None)

    top = view.sql(
        "SELECT item, COUNT(*) AS n FROM rates GROUP BY item ORDER BY n DESC",
        rates=df)

    # or one-shot over the default flat event columns:
    view.events_sql("myapp", "SELECT event, COUNT(*) FROM events GROUP BY 1")
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import sqlite3
from typing import Any, Callable, Mapping, Optional

from predictionio_tpu_torch.data.event import Event, utcnow
from predictionio_tpu_torch.utils.fs import pio_base_dir

logger = logging.getLogger(__name__)

Conversion = Callable[[Event], Optional[Mapping[str, Any]]]


_DEFAULT_COLUMNS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "creationTime",
)


def _default_conversion(e: Event) -> Mapping[str, Any]:
    """Flat, SQL-friendly row: scalar columns + properties as JSON text."""
    return {
        "eventId": e.event_id,
        "event": e.event,
        "entityType": e.entity_type,
        "entityId": e.entity_id,
        "targetEntityType": e.target_entity_type,
        "targetEntityId": e.target_entity_id,
        "properties": json.dumps(e.properties.to_dict(), sort_keys=True),
        "eventTime": e.event_time.timestamp(),
        "creationTime": e.creation_time.timestamp(),
    }


def _conversion_hash(conversion: Optional[Conversion]) -> str:
    """Stable-ish fingerprint of the conversion function.

    Plays the role of the serialVersionUID in the reference's cache key
    (``DataView.scala:77-79``); ``version`` remains the user's explicit
    escape hatch when the body changes in ways the fingerprint misses
    (e.g. a closed-over global).
    """
    if conversion is None:
        return "default"
    code = getattr(conversion, "__code__", None)
    if code is None:  # builtins / callables: name is the best we can do
        return getattr(conversion, "__qualname__", repr(conversion))
    h = hashlib.sha1()

    def feed(c) -> None:
        h.update(c.co_code)
        # names matter: `e.entity_id` vs `e.target_entity_id` differ only
        # in co_names, not co_code
        for names in (c.co_names, c.co_varnames, c.co_freevars):
            h.update("\0".join(names).encode())
        for const in c.co_consts:
            if hasattr(const, "co_code"):  # nested lambda/comprehension:
                feed(const)  # repr() would embed a memory address
            else:
                h.update(repr(const).encode())

    feed(code)
    return h.hexdigest()[:16]


def create(
    app_name: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    conversion: Optional[Conversion] = None,
    name: str = "",
    version: str = "",
    cache: Optional[bool] = None,
):
    """Materialize an app's events as a DataFrame view.

    ``conversion`` maps each :class:`Event` to a row mapping (``None`` drops
    the event), like the reference's ``conversionFunction``; by default
    events become flat columns with properties as a JSON text column.

    ``cache``: ``True`` reads/writes a parquet copy under
    ``$PIO_FS_BASEDIR/view`` keyed like the reference
    (time-range + version + conversion fingerprint).  ``None`` (auto)
    caches only when ``until_time`` is pinned — an unbounded view is a
    different result every call, so caching it would either be stale or,
    as in the reference (which keys on ``DateTime.now()``), never hit.
    """
    import pandas as pd

    from predictionio_tpu_torch.data.store import PEventStore

    # normalize tz-naive bounds to UTC: comparing naive against the tz-aware
    # utcnow() below would raise a bare TypeError mid-call otherwise
    if start_time is not None and start_time.tzinfo is None:
        start_time = start_time.replace(tzinfo=_dt.timezone.utc)
    if until_time is not None and until_time.tzinfo is None:
        until_time = until_time.replace(tzinfo=_dt.timezone.utc)
    begin = start_time or _dt.datetime.fromtimestamp(0, _dt.timezone.utc)
    end = until_time or utcnow()  # fix the current time (DataView.scala:73-76)
    if cache is None:
        # only a CLOSED window is immutable; a future until_time still
        # admits new events, so freezing it at first call would drop them
        cache = until_time is not None and until_time <= utcnow()

    cache_path = None
    if cache:
        key = hashlib.sha1(
            f"{channel_name or ''}-{begin.isoformat()}-{end.isoformat()}-"
            f"{version}-{_conversion_hash(conversion)}".encode()
        ).hexdigest()[:20]
        view_dir = os.path.join(pio_base_dir(), "view")
        cache_path = os.path.join(view_dir, f"{name or 'view'}-{app_name}-{key}.parquet")
        if os.path.exists(cache_path):
            try:
                return pd.read_parquet(cache_path)
            except Exception as exc:  # corrupt cache: rebuild
                logger.warning("view cache %s unreadable (%s); rebuilding", cache_path, exc)

    batch = PEventStore.find(
        app_name,
        channel_name=channel_name,
        start_time=start_time,
        until_time=end,
    )
    conv = conversion or _default_conversion
    rows = []
    for event in batch:
        row = conv(event)
        if row is not None:
            rows.append(dict(row))
    if not rows and conversion is None:
        # zero events must still yield a well-formed (SQL-loadable) view
        df = pd.DataFrame(columns=list(_DEFAULT_COLUMNS))
    else:
        df = pd.DataFrame(rows)

    if cache_path is not None:
        try:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            df.to_parquet(cache_path)
        except Exception as exc:  # pyarrow missing etc.: view still works
            logger.info("view cache write skipped (%s)", exc)
    return df


def sql(query: str, views: Optional[Mapping[str, Any]] = None, **named_views):
    """Run SQL over DataFrame views (parity role: Spark SQL over DataView).

    Each keyword (or ``views`` entry) becomes a table in an in-memory
    sqlite database; returns the result as a DataFrame.
    """
    import pandas as pd

    if views is not None and not hasattr(views, "items"):
        raise TypeError(
            "views must be a mapping of {table_name: DataFrame}; to query a "
            "table named 'views' pass it via the views mapping: "
            "sql(query, {'views': df})"
        )
    if isinstance(views, pd.DataFrame):
        raise TypeError(
            "a bare DataFrame was passed as `views`; pass {'views': df} to "
            "name a table 'views', or use a different keyword"
        )
    tables = dict(views or {})
    tables.update(named_views)
    if not tables:
        raise ValueError("sql() needs at least one named view")
    conn = sqlite3.connect(":memory:")
    try:
        for table_name, df in tables.items():
            if df.shape[1] == 0:
                raise ValueError(
                    f"view {table_name!r} has no columns (empty conversion "
                    "view?) — sqlite cannot create a column-less table"
                )
            df.to_sql(table_name, conn, index=False)
        return pd.read_sql_query(query, conn)
    finally:
        conn.close()


def events_sql(
    app_name: str,
    query: str,
    table: str = "events",
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
):
    """One-shot SQL over an app's default flat event view."""
    df = create(
        app_name,
        channel_name=channel_name,
        start_time=start_time,
        until_time=until_time,
    )
    return sql(query, {table: df})
