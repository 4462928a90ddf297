"""The 1/N sharded training read of a launch, with global id spaces.

Counterpart of ``predictionio_tpu/parallel/ingest.py`` (SURVEY.md §7's
"BiMap at scale"). Each process of a launch reads 1/N of the event store
with the DAO shard pushdown (``PEvents.find_interactions(shard=(p, N),
shard_key=...)``, parity ``JDBCPEvents.scala:35-119``), and the processes
rendezvous their small (entity → count) tables through the model-data
repository: the storage layer doubles as the control plane, the role the
Spark application's collect plays.

Two read passes per process (2/N of the rows in all):

* **user pass** (``shard_key="entity"``): every rating of a user whose
  ``crc32(user_id) % N == p``, complete per-user row sets;
* **item pass** (``shard_key="target"``): the same keyed by item.

The hash-partitioned rendezvous (:func:`exchange_entity_tables`) gives
every process an identical global BiMap and degree vector: entities are
scattered to an owner by ``crc32(entity) % N``, each owner sorts and
republishes its 1/N slice, and global ids are assigned partition-major
(the owner's slice offset + the rank within the bytes-sorted slice). The
polling only reads (``Models.get``); each process writes its own blobs.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import time
import zlib
from typing import Optional, Union

import numpy as np

from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import base as storage_base
from predictionio_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)

_BLOB_PREFIX = "__pio_shardmap__"


@dataclasses.dataclass
class ShardedInteractions:
    """One host's view of a sharded training read.

    Rows carry GLOBAL entity ids (valid across hosts); ``user_rows`` holds
    the complete rating sets of this host's users, ``item_rows`` of its
    items. ``user_counts``/``item_counts`` are global degree vectors
    aligned with the global maps — identical on every host.
    """

    user_rows: Interactions
    item_rows: Interactions
    user_map: BiMap
    item_map: BiMap
    user_counts: np.ndarray
    item_counts: np.ndarray
    process_index: int
    num_processes: int
    # host-independent dataset digest (sum of per-host row digests, exchanged
    # with the count tables): ties checkpoints to the actual triples — equal
    # degree histograms with different ratings/pairings must NOT match
    dataset_digest: int = 0
    # invoked by the trainer on the coordinator after the final collective:
    # removes the rendezvous blobs this read left in the model repo
    cleanup: Optional[object] = None

    @property
    def n_users(self) -> int:
        return len(self.user_map)

    @property
    def n_items(self) -> int:
        return len(self.item_map)

    def __len__(self) -> int:
        # GLOBAL rating count (sanity checks gate on "no data", which must
        # reflect the whole dataset, not this host's slice)
        return int(self.user_counts.sum())


def _encode_cols(names: np.ndarray, counts: np.ndarray, digest: int) -> bytes:
    """Binary columnar table blob: fixed-width UTF-8 names + int64 counts.

    ~10× smaller than the former per-entity JSON dict and decoded as two
    array reads instead of O(entities) parse work — the wire format of
    the rendezvous (npz, the same container ``network.py`` frames).
    """
    bio = io.BytesIO()
    np.savez(
        bio, names=names, counts=np.asarray(counts, np.int64),
        digest=np.int64(digest),
    )
    return bio.getvalue()


def _decode_cols(buf: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    with np.load(io.BytesIO(buf), allow_pickle=False) as z:
        return z["names"], z["counts"], int(z["digest"])


def _poll_get(models, blob_id: str, deadline: float, poll: float, what: str):
    while True:
        m = models.get(blob_id)
        if m is not None:
            return m.models
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"shard-map exchange: {what} never appeared (worker dead "
                "or storage not shared across hosts?)"
            )
        time.sleep(poll)


def _reject_trailing_nul(keys) -> None:
    # fixed-width numpy string arrays cannot represent a trailing NUL
    # (numpy strips it), which would silently merge 'x' and 'x\0' into one
    # global id — fail loudly instead of corrupting the vocab
    nul = lambda s: s.endswith(b"\0" if isinstance(s, bytes) else "\0")  # noqa: E731
    if any(nul(s) for s in keys):
        raise ValueError(
            "entity ids ending in a NUL byte cannot ride the columnar "
            "vocab exchange (numpy fixed-width strings drop trailing NULs)"
        )


def _to_name_count_arrays(
    local_counts: Union[dict, tuple],
) -> tuple[np.ndarray, np.ndarray]:
    """Accept a (entity → count) dict or a ``(names, counts)`` array pair;
    return UTF-8 byte names + int64 counts. Array-pair names may be any
    string dtype (object arrays — e.g. ``pd.factorize`` output — are
    coerced); trailing-NUL ids are rejected loudly (see
    :func:`_reject_trailing_nul`; an array pair built with a 'U' dtype has
    already lost them to numpy's own stripping)."""
    if isinstance(local_counts, dict):
        _reject_trailing_nul(local_counts)
        names = np.array(list(local_counts), dtype="U") if local_counts \
            else np.empty(0, "U1")
        counts = np.fromiter(
            local_counts.values(), np.int64, len(local_counts)
        )
    else:
        names, counts = local_counts
        if not isinstance(names, np.ndarray):
            # np.asarray of a str list strips trailing NULs BEFORE any
            # check could see them — guard the Python values first
            names = list(names)
            _reject_trailing_nul(names)
            names = np.asarray(names)
        counts = np.asarray(counts, np.int64)
        if names.dtype.kind == "O":
            _reject_trailing_nul(names.tolist())
            names = names.astype("U")
    if names.dtype.kind == "U":
        names = (
            np.char.encode(names, "utf-8")
            if len(names) else np.empty(0, "S1")
        )
    return names, counts


def exchange_entity_tables(
    storage,
    key: str,
    local_counts: Union[dict, tuple],
    process_index: int,
    num_processes: int,
    timeout: float = 300.0,
    poll: float = 0.2,
    local_digest: int = 0,
) -> tuple[BiMap, np.ndarray, int]:
    """Hash-partitioned vocab rendezvous; returns the global merge.

    SURVEY §7 "BiMap at scale": no host ever publishes, fetches, or SORTS
    more than O(entities/N) strings per blob. Three phases through the
    model-data repository (the storage layer is the control plane, the
    role the Spark application's collect plays — parity
    ``JDBCPEvents.scala:35-119`` partitioned reads):

    1. **scatter** — host ``p`` splits its local (entity → count) table by
       ``crc32(entity) % N`` (the DAO ``shard_hash`` contract, so the
       pass-keyed entities land on their OWN host's bucket and cross
       traffic is only the opposite-side tables) and publishes one binary
       column blob per destination partition.
    2. **merge** — host ``q`` collects the N buckets of ITS partition,
       sums duplicate counts, sorts its 1/N slice once, and republishes it
       with the partition's digest total.
    3. **assemble** — every host concatenates the N pre-sorted slices
       partition-major; global id = slice offset + rank within slice.
       Identical on every host, no global sort anywhere.

    ``key`` MUST be launch-scoped (``pio launch`` exports a fresh
    PIO_RUN_ID per invocation; when re-running ``--hosts`` rendered
    commands, regenerate the id) so a crashed earlier run's blobs can
    never be merged into a fresh run. ``local_digest`` rides along and
    returns summed (mod 2⁴⁸) — a host-independent digest of the actual
    rows for checkpoint fingerprints. ``local_counts`` may be a dict or a
    ``(names, counts)`` array pair (the array form skips building an
    O(entities) Python dict on the publish side).
    """
    models = storage.get_model_data_models()
    names, counts = _to_name_count_arrays(local_counts)
    # crc32 over the UTF-8 bytes ≡ PEvents.shard_hash (base.py:263-271) on
    # the decoded string — the SAME assignment as the DAO shard pushdown,
    # so a pass-keyed entity's bucket is its own host (pinned by
    # test_partition_function_matches_dao_shard_hash)
    part = (
        np.fromiter(
            (zlib.crc32(b) % num_processes for b in names.tolist()),
            np.int64, len(names),
        )
        if len(names)
        else np.empty(0, np.int64)
    )
    deadline = time.monotonic() + timeout
    # 1. scatter: one bucket per destination partition
    for q in range(num_processes):
        m = part == q
        models.insert(
            storage_base.Model(
                f"{_BLOB_PREFIX}{key}_s{process_index}to{q}",
                _encode_cols(names[m], counts[m], local_digest),
            )
        )
    # 2. merge MY partition's buckets (1/N of the global vocab)
    q = process_index
    bufs = [
        _decode_cols(
            _poll_get(
                models, f"{_BLOB_PREFIX}{key}_s{p}to{q}", deadline, poll,
                f"bucket {p}→{q}/{num_processes} for {key!r}",
            )
        )
        for p in range(num_processes)
    ]
    digest = sum(b[2] for b in bufs) % (1 << 48)
    nm = [b[0] for b in bufs if len(b[0])]
    if nm:
        width = max(a.dtype.itemsize for a in nm)
        cat = np.concatenate([a.astype(f"S{width}") for a in nm])
        cnt = np.concatenate([b[1] for b in bufs if len(b[0])])
        uniq, inv = np.unique(cat, return_inverse=True)
        slice_counts = np.zeros(len(uniq), np.int64)
        np.add.at(slice_counts, inv, cnt)
    else:
        uniq = np.empty(0, "S1")
        slice_counts = np.empty(0, np.int64)
    models.insert(
        storage_base.Model(
            f"{_BLOB_PREFIX}{key}_m{q}",
            _encode_cols(uniq, slice_counts, digest),
        )
    )
    # 3. assemble: pre-sorted slices concatenate partition-major
    fwd: dict = {}
    count_parts = []
    total_digest = 0
    offset = 0
    for r in range(num_processes):
        snames, scounts, sdigest = _decode_cols(
            _poll_get(
                models, f"{_BLOB_PREFIX}{key}_m{r}", deadline, poll,
                f"merged slice {r}/{num_processes} for {key!r}",
            )
        )
        if r == 0:
            # every owner computed the same Σ per-host digest; read one
            total_digest = sdigest
        dec = np.char.decode(snames, "utf-8") if len(snames) else snames
        fwd.update(zip(dec.tolist(), range(offset, offset + len(dec))))
        offset += len(dec)
        count_parts.append(scounts)
    bimap = BiMap(fwd)
    counts_vec = (
        np.concatenate(count_parts) if count_parts else np.empty(0, np.int64)
    )
    return bimap, counts_vec, total_digest


def cleanup_exchange(storage, key: str, num_processes: int) -> None:
    """Best-effort removal of one exchange's blobs."""
    models = storage.get_model_data_models()
    for p in range(num_processes):
        ids = [f"{_BLOB_PREFIX}{key}_m{p}"] + [
            f"{_BLOB_PREFIX}{key}_s{p}to{q}" for q in range(num_processes)
        ]
        for blob_id in ids:
            try:
                models.delete(blob_id)
            except Exception:  # pragma: no cover - cleanup must never fail
                pass


def cleanup_exchange_keys(storage, run_key: str, num_processes: int) -> None:
    """Remove ALL rendezvous blobs a sharded read left in the model repo.

    The trainer invokes this through ``ShardedInteractions.cleanup`` on the
    coordinator after its final collective — by then every host has long
    finished its exchange (their training steps are collectives too), so
    no poller can still need the blobs.
    """
    for suffix in ("_user", "_item", "_digest"):
        cleanup_exchange(storage, run_key + suffix, num_processes)


def _translate(inter: Interactions, user_map: BiMap, item_map: BiMap):
    """Re-express local dictionary codes in the global id space."""

    def lut(local_map: BiMap, global_map: BiMap) -> np.ndarray:
        inv = local_map.inverse
        return np.array(
            [global_map[inv[i]] for i in range(len(local_map))], np.int32
        )

    u = lut(inter.user_map, user_map)[inter.user] if len(inter.user) else inter.user
    i = lut(inter.item_map, item_map)[inter.item] if len(inter.item) else inter.item
    return Interactions(
        user=u.astype(np.int32),
        item=i.astype(np.int32),
        rating=inter.rating,
        t=inter.t,
        user_map=user_map,
        item_map=item_map,
    )


def _count_table(
    codes: np.ndarray, id_map: BiMap
) -> tuple[np.ndarray, np.ndarray]:
    """(names, counts) column pair for the exchange — no per-entity dict."""
    counts = np.bincount(codes, minlength=len(id_map))
    inv = id_map.inverse
    name_list = [inv[i] for i in range(len(id_map))]
    _reject_trailing_nul(name_list)
    names = np.array(name_list, dtype="U")
    return names, counts.astype(np.int64)


def template_interactions(
    app_name: str,
    channel_name: Optional[str] = None,
    parts: Optional[list] = None,
    item_pass: bool = True,
    force_local: bool = False,
    **find_kwargs,
):
    """The datasource entry point templates share: a plain
    ``PEventStore.find_interactions`` single-host, or the 1/N sharded read
    under an active multi-host launch. Returns ``Interactions`` or
    ``ShardedInteractions`` accordingly; the trainers dispatch on the
    type. ``force_local`` keeps the full read even under a launch (e.g.
    ``read_eval``'s row-level fold split needs every row on every host).
    """
    from predictionio_tpu_torch.data import store as store_mod

    if not force_local and distributed.process_slot()[1] > 1:
        app_id, channel_id = store_mod.resolve_app(app_name, channel_name)
        return read_sharded_interactions(
            store_mod.get_storage(),
            app_id,
            channel_id=channel_id,
            parts=parts,
            item_pass=item_pass,
            **find_kwargs,
        )
    if parts is not None:
        return _merge_part_reads(
            lambda p: store_mod.PEventStore.find_interactions(
                app_name, channel_name=channel_name, **p
            ),
            parts,
        )
    return store_mod.PEventStore.find_interactions(
        app_name, channel_name=channel_name, **find_kwargs
    )


def _merge_part_reads(read_fn, part_kwargs: list):
    """Read one Interactions per filter dict, drop empties, merge the rest
    into shared id maps (one policy for BOTH the sharded passes and the
    single-host template reads — keep them from drifting)."""
    from predictionio_tpu_torch.data.batch import merge_interactions

    reads = [read_fn(p) for p in part_kwargs]
    reads = [r for r in reads if len(r.rating)] or reads[:1]
    return reads[0] if len(reads) == 1 else merge_interactions(reads)


def _resolve_rendezvous(run_key, process_index, num_processes):
    pid = (
        process_index
        if process_index is not None
        else distributed.process_index()
    )
    n = (
        num_processes
        if num_processes is not None
        else distributed.num_processes()
    )
    key = run_key or distributed.run_id()
    if key is None:
        raise RuntimeError(
            "sharded ingest needs a launch-scoped run id: launch workers "
            "via `pio launch` (exports PIO_RUN_ID) or pass run_key="
        )
    return pid, n, key


def read_sharded_event_batch(
    storage,
    app_id: int,
    run_key: Optional[str] = None,
    process_index: Optional[int] = None,
    num_processes: Optional[int] = None,
    channel_id: Optional[int] = None,
    **find_kwargs,
):
    """1/N entity-keyed EventBatch read + globally-merged id tables.

    The multi-event variant of :func:`read_sharded_interactions` for
    consumers that split one scan per event type themselves (the Universal
    Recommender's shared-id-space read). Returns
    ``(batch, user_map, item_map, cleanup)`` — the batch holds THIS host's
    users' complete events, the maps are identical on every host, and
    ``cleanup`` (coordinator, post-train) removes the rendezvous blobs.
    """
    from collections import Counter

    pid, n, key = _resolve_rendezvous(run_key, process_index, num_processes)
    batch = storage.get_p_events().find(
        app_id, channel_id=channel_id, shard=(pid, n), shard_key="entity",
        **find_kwargs,
    )
    user_map, _, _ = exchange_entity_tables(
        storage, key + "_buser", dict(Counter(batch.entity_id)), pid, n
    )
    item_map, _, _ = exchange_entity_tables(
        storage, key + "_bitem",
        dict(Counter(t for t in batch.target_entity_id if t is not None)),
        pid, n,
    )

    def cleanup():
        for suffix in ("_buser", "_bitem"):
            cleanup_exchange(storage, key + suffix, n)

    logger.info(
        "sharded batch ingest p%d/%d: %d rows, %d users, %d items",
        pid, n, len(batch), len(user_map), len(item_map),
    )
    return batch, user_map, item_map, cleanup


def read_sharded_interactions(
    storage,
    app_id: int,
    run_key: Optional[str] = None,
    process_index: Optional[int] = None,
    num_processes: Optional[int] = None,
    channel_id: Optional[int] = None,
    parts: Optional[list] = None,
    item_pass: bool = True,
    **find_kwargs,
) -> ShardedInteractions:
    """The 1/N-per-host training read (two entity-keyed passes + exchange).

    ``find_kwargs`` are the usual ``find_interactions`` filters
    (entity_type, event_names, target_entity_type, rating_key, ...).
    ``parts`` instead passes SEVERAL filter dicts whose results merge
    row-wise before the exchange — the rate+buy multi-read the templates
    perform, still at 1/N rows per pass. ``item_pass=False`` skips the
    target-keyed scan for consumers that only need per-user rows (the
    sequence models): the global item table derives exactly from the
    user pass (every row appears in exactly one host's user pass), so
    ingest halves to one 1/N scan per host and ``item_rows`` is empty.
    """
    pid, n, key = _resolve_rendezvous(run_key, process_index, num_processes)
    pe = storage.get_p_events()
    part_kwargs = parts if parts is not None else [find_kwargs]

    def read_pass(shard_key: str) -> Interactions:
        return _merge_part_reads(
            lambda p: pe.find_interactions(
                app_id, channel_id=channel_id, shard=(pid, n),
                shard_key=shard_key, **p,
            ),
            part_kwargs,
        )

    upass = read_pass("entity")
    ipass = read_pass("target") if item_pass else None
    # the user pass holds ALL rows of my users (counts complete); same for
    # the item pass by items — so the merged tables are exact global
    # degrees. Without an item pass, per-host item histograms from the
    # user pass merge to the same exact global table (disjoint row cover).
    user_map, user_counts, _ = exchange_entity_tables(
        storage, key + "_user", _count_table(upass.user, upass.user_map),
        pid, n,
    )
    item_map, item_counts, _ = exchange_entity_tables(
        storage, key + "_item",
        _count_table(
            (ipass if item_pass else upass).item,
            (ipass if item_pass else upass).item_map,
        ),
        pid, n,
    )
    n_ipass = len(ipass.rating) if item_pass else 0
    logger.info(
        "sharded ingest p%d/%d: %d user-pass + %d item-pass rows of "
        "%d global ratings (%.1f%%)",
        pid, n, len(upass.rating), n_ipass, int(user_counts.sum()),
        100.0 * (len(upass.rating) + n_ipass)
        / max(1, 2 * int(user_counts.sum())),
    )
    user_rows = _translate(upass, user_map, item_map)
    item_rows = (
        _translate(ipass, user_map, item_map)
        if item_pass
        else Interactions(
            user=np.empty(0, np.int32), item=np.empty(0, np.int32),
            rating=np.empty(0, np.float32), t=np.empty(0, np.float64),
            user_map=user_map, item_map=item_map,
        )
    )
    # host-independent row digest for checkpoint fingerprints: one
    # vectorized sha1 over THIS host's translated rows (global ids are
    # layout-stable and the DAO scan order is deterministic), summed
    # across hosts through a digest exchange. Sensitive to pairings,
    # rating values AND event times (sequence models order by t) — equal
    # degree histograms must not collide.
    from predictionio_tpu_torch.core.checkpoint import dataset_digest

    local_digest = (
        dataset_digest(
            user_rows.user, user_rows.item, user_rows.rating, user_rows.t
        )
        if len(user_rows.rating)
        else 0
    )
    _, _, row_digest = exchange_entity_tables(
        storage, key + "_digest", {}, pid, n, local_digest=local_digest
    )
    return ShardedInteractions(
        user_rows=user_rows,
        item_rows=item_rows,
        user_map=user_map,
        item_map=item_map,
        user_counts=user_counts,
        item_counts=item_counts,
        process_index=pid,
        num_processes=n,
        dataset_digest=row_digest,
        cleanup=lambda: cleanup_exchange_keys(storage, key, n),
    )
