"""Event export/import as JSON-lines files.

Copy of ``predictionio_tpu/tools/export_import.py`` for the port; the
multi-process split runs over the port's ``parallel/distributed.py``.

Parity: ``tools/.../export/EventsToFile.scala`` and
``imprt/FileToEvents.scala`` (the ``pio export`` / ``pio import`` verbs) —
one Event JSON per line, the reference's interchange format.
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage


def _channel_id(storage: Storage, app_id: int, channel: Optional[str]) -> Optional[int]:
    if channel is None:
        return None
    match = [
        c
        for c in storage.get_meta_data_channels().get_by_app_id(app_id)
        if c.name == channel
    ]
    if not match:
        raise ValueError(f"channel {channel!r} not found for app {app_id}")
    return match[0].id


def export_events(
    storage: Storage, app_id: int, output_path: str, channel: Optional[str] = None
) -> tuple[int, str]:
    """Stream the columnar bulk read out as JSON lines (rows built lazily).

    Multi-host (``pio launch -- export``): the reference's export is a
    Spark job writing ``part-NNNNN`` files; here each process pulls its
    1/N of the rows with row-keyed DAO shard pushdown and writes
    ``<output>.part-<i>`` — N hosts each scan and serialize 1/N.
    Returns (rows written by THIS process, the path it wrote).
    """
    from predictionio_tpu_torch.parallel import distributed

    channel_id = _channel_id(storage, app_id, channel)
    pid, n_procs = distributed.process_slot()
    shard = (pid, n_procs) if n_procs > 1 else None
    # the FALLIBLE scan runs before output hygiene: a failed export must
    # leave the previous good export files untouched
    batch = storage.get_p_events().find(
        app_id, channel_id=channel_id, shard=shard
    )
    # part-file path + stale-output hygiene: the shared distributed-writer
    # contract (see distributed.shard_output_path)
    _, _, output_path = distributed.shard_output_path(output_path)
    n = 0
    with open(output_path, "w") as f:
        for e in batch:  # EventBatch materializes one row at a time
            f.write(e.to_json() + "\n")
            n += 1
    return n, output_path


IMPORT_CHUNK = 10_000


def import_events(
    storage: Storage, app_id: int, input_path: str, channel: Optional[str] = None
) -> int:
    """Chunked inserts: bounded memory however large the file is.

    Multi-host (``pio launch -- import``): the reference's FileToEvents is
    a Spark job too — each process here inserts the lines with
    ``line_index % N == process_index`` (events carry their eventIds, so
    the split is exact and re-imports stay idempotent). Point the storage
    at a shared backend (`network` driver or a shared filesystem) and N
    hosts ingest concurrently.
    """
    from predictionio_tpu_torch.parallel import distributed

    pid, n_procs = distributed.process_slot()
    channel_id = _channel_id(storage, app_id, channel)
    le = storage.get_l_events()
    le.init(app_id, channel_id)
    n = 0
    chunk: list[Event] = []
    with open(input_path) as f:
        for line_no, line in enumerate(f):
            if n_procs > 1 and line_no % n_procs != pid:
                continue
            line = line.strip()
            if not line:
                continue
            chunk.append(Event.from_json(line))
            if len(chunk) >= IMPORT_CHUNK:
                le.batch_insert(chunk, app_id, channel_id)
                n += len(chunk)
                chunk = []
    if chunk:
        le.batch_insert(chunk, app_id, channel_id)
        n += len(chunk)
    return n
