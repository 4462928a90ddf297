"""Sharded serving: the ShardingPlan declared at publish, its device
layout, and the per-shard accounting of live traffic.

Counterpart of ``predictionio_tpu/serving/sharding.py``. A
:class:`ShardingPlan` (shard count, item→shard assignment, per-shard byte
budget, host groups, a content fingerprint) is declared at publish
(:func:`plan_from_env`, the ``PIO_SHARD_*`` knobs; :func:`build_plan` with
its ``popularity``, ``round_robin`` and ``contiguous`` strategies), sealed
beside the factors (:func:`save_plan`, :func:`load_plan`) and laid out by
:func:`build_layout` as equal padded blocks whose real slots are ascending
by global id. The fast path (``serving/fastpath.py``) scores each block
with the score kernel and merges the per-shard leaderboards in the two-key
order, so the answers equal the replicated path's bit for bit.
:class:`ShardAccounting` counts what each shard's items win. IVF retrieval
(``ops/ivf.py``) declares its k-means clusters as the "shards" of a plan
with strategy ``"ivf"`` (:func:`plan_from_assignment`). A plan's
:meth:`ShardingPlan.to_payload` bytes equal the JAX package's for the same
plan, and each package reads the other's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

STRATEGIES = ("popularity", "round_robin", "contiguous")

# payload bytes per merged leaderboard slot: f32 value + i32 global index
MERGE_SLOT_BYTES = 8

# global-index sentinel for padded leaderboard slots: larger than any real
# item id, so an all-NEG_INF tie still sorts real items ahead of padding
PAD_SENTINEL = np.int32(2**31 - 1)

_PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Item→shard partition declared at publish time.

    ``assignment[i]`` is the shard owning global item ``i``; ``load_share``
    is the expected per-shard traffic fraction under the weights the plan
    was balanced with; ``capacity_budget_bytes`` the per-shard budget the
    count came from (None when given explicitly); ``host_groups`` the pod
    dimension of the JAX package's multi-host layout (1 on one card).
    """

    n_shards: int
    assignment: np.ndarray  # (n_items,) int32
    strategy: str
    load_share: np.ndarray  # (n_shards,) float64, sums to 1
    capacity_budget_bytes: Optional[int] = None
    host_groups: int = 1

    @property
    def n_items(self) -> int:
        return int(self.assignment.shape[0])

    def shard_items(self, shard: int) -> np.ndarray:
        """Global item ids on ``shard``, ascending (the on-device order)."""
        return np.flatnonzero(self.assignment == shard).astype(np.int32)

    def shard_sizes(self) -> np.ndarray:
        return np.bincount(self.assignment, minlength=self.n_shards)

    @property
    def shards_per_group(self) -> int:
        return self.n_shards // max(1, self.host_groups)

    def group_of_shard(self, shard: int) -> int:
        """Host group owning ``shard`` (contiguous blocks of
        ``shards_per_group``)."""
        return int(shard) // self.shards_per_group

    def group_of_item(self, item: int) -> int:
        """Host group owning global item ``item``."""
        return self.group_of_shard(int(self.assignment[int(item)]))

    @property
    def fingerprint(self) -> str:
        """Content hash over the partition itself, the plan's identity (the
        host-group dimension is hashed only when it is non-trivial)."""
        h = hashlib.sha256()
        h.update(f"{_PLAN_VERSION}:{self.n_shards}:{self.strategy}:".encode())
        h.update(np.ascontiguousarray(self.assignment, np.int32).tobytes())
        if self.host_groups > 1:
            h.update(f":hg{self.host_groups}".encode())
        return h.hexdigest()[:16]

    def validate(self, n_items: Optional[int] = None) -> None:
        a = self.assignment
        if a.ndim != 1 or (n_items is not None and a.shape[0] != n_items):
            raise ValueError(f"assignment shape {a.shape} does not cover {n_items} items")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if a.size and (a.min() < 0 or a.max() >= self.n_shards):
            raise ValueError("assignment references shards outside the plan")
        sizes = self.shard_sizes()
        if a.size and (sizes == 0).any():
            raise ValueError(f"plan leaves shards empty: {np.flatnonzero(sizes == 0).tolist()}")
        if self.host_groups < 1:
            raise ValueError(f"host_groups must be >= 1, got {self.host_groups}")
        if self.n_shards % self.host_groups:
            raise ValueError(
                f"host_groups={self.host_groups} must divide n_shards={self.n_shards} "
                "(equal host rows)"
            )

    def to_payload(self) -> bytes:
        return pickle.dumps(
            {
                "version": _PLAN_VERSION,
                "n_shards": self.n_shards,
                "strategy": self.strategy,
                "assignment": np.ascontiguousarray(self.assignment, np.int32),
                "load_share": np.ascontiguousarray(self.load_share, np.float64),
                "capacity_budget_bytes": self.capacity_budget_bytes,
                "host_groups": self.host_groups,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardingPlan":
        d = pickle.loads(payload)
        plan = cls(
            n_shards=int(d["n_shards"]),
            assignment=np.asarray(d["assignment"], np.int32),
            strategy=str(d["strategy"]),
            load_share=np.asarray(d["load_share"], np.float64),
            capacity_budget_bytes=d.get("capacity_budget_bytes"),
            host_groups=int(d.get("host_groups", 1)),
        )
        plan.validate()
        return plan

    def describe(self) -> dict:
        """JSON-friendly summary for the CLI and stats."""
        sizes = self.shard_sizes()
        return {
            "n_shards": self.n_shards,
            "n_items": self.n_items,
            "strategy": self.strategy,
            "fingerprint": self.fingerprint,
            "capacity_budget_bytes": self.capacity_budget_bytes,
            "items_per_shard": sizes.tolist(),
            "load_share": [round(float(x), 6) for x in self.load_share],
            "host_groups": self.host_groups,
            "shards_per_group": self.shards_per_group,
        }


def shard_count_for_budget(n_items: int, bytes_per_item: float, budget_bytes: int) -> int:
    """Smallest shard count whose per-shard resident bytes fit ``budget``."""
    if budget_bytes <= 0:
        raise ValueError("per-shard HBM budget must be positive")
    total = float(n_items) * float(bytes_per_item)
    return max(1, int(np.ceil(total / float(budget_bytes))))


def build_plan(
    n_items: int,
    n_shards: Optional[int] = None,
    *,
    weights: Optional[np.ndarray] = None,
    strategy: str = "popularity",
    capacity_budget_bytes: Optional[int] = None,
    bytes_per_item: Optional[float] = None,
    host_groups: int = 1,
) -> ShardingPlan:
    """Build a plan by explicit shard count or per-shard byte budget.

    ``weights`` are per-item expected-traffic weights (any non-negative
    signal); ``popularity`` runs greedy LPT over them under an item-count cap
    of ``ceil(n_items / n_shards)``, heaviest first and ties by ascending id;
    ``round_robin`` and ``contiguous`` ignore them for the assignment but
    record the load shares they give. A budget-derived count rounds up to
    fill every host row. The same inputs give the JAX package's plan, byte
    for byte.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if n_items < 1:
        raise ValueError("cannot shard an empty catalog")
    if n_shards is None:
        if capacity_budget_bytes is None or bytes_per_item is None:
            raise ValueError("need n_shards, or capacity_budget_bytes + bytes_per_item")
        n_shards = shard_count_for_budget(n_items, bytes_per_item, capacity_budget_bytes)
        if host_groups > 1 and n_shards % host_groups:
            rounded = n_shards + host_groups - n_shards % host_groups
            if rounded > n_items >= n_shards:
                raise ValueError(
                    f"host_groups={host_groups} (PIO_POD_HOST_GROUPS) cannot be filled "
                    f"from this catalog: the budget-derived shard count {n_shards} rounds "
                    f"up to {rounded} > n_items={n_items} — lower PIO_POD_HOST_GROUPS or "
                    "raise the budget"
                )
            n_shards = rounded
    n_shards = int(n_shards)
    if host_groups > 1 and n_shards % host_groups:
        raise ValueError(
            f"host_groups={host_groups} (PIO_POD_HOST_GROUPS) must divide "
            f"n_shards={n_shards}: pod host rows must be equal"
        )
    if not 1 <= n_shards <= n_items:
        raise ValueError(f"n_shards={n_shards} outside [1, n_items={n_items}]")
    if weights is None:
        w = np.ones(n_items, np.float64)
    else:
        w = np.asarray(weights, np.float64).reshape(-1)
        if w.shape[0] != n_items:
            raise ValueError(f"weights cover {w.shape[0]} items, catalog has {n_items}")
        if (w < 0).any():
            raise ValueError("weights must be non-negative")

    assignment = np.empty(n_items, np.int32)
    if strategy == "round_robin":
        assignment[:] = np.arange(n_items, dtype=np.int32) % n_shards
    elif strategy == "contiguous":
        cap = int(np.ceil(n_items / n_shards))
        assignment[:] = np.minimum(
            np.arange(n_items, dtype=np.int64) // cap, n_shards - 1
        ).astype(np.int32)
    else:
        assignment[:] = _lpt_assignment(w, n_shards, int(np.ceil(n_items / n_shards)))

    per_shard = np.zeros(n_shards, np.float64)
    np.add.at(per_shard, assignment, w)
    total = per_shard.sum()
    load_share = per_shard / total if total > 0 else np.full(n_shards, 1.0 / n_shards)
    plan = ShardingPlan(
        n_shards=n_shards, assignment=assignment, strategy=strategy,
        load_share=load_share, capacity_budget_bytes=capacity_budget_bytes,
        host_groups=int(host_groups),
    )
    plan.validate(n_items)
    return plan


def _lpt_assignment(w: np.ndarray, n_shards: int, cap: int) -> np.ndarray:
    """Greedy LPT under an item-count cap: items heaviest first (ties by
    ascending id) go to the open shard of least load (ties to the lowest
    shard), as the JAX package's loop does. A heap keyed by (load, shard)
    over the open shards makes it O(n log S) rather than O(n·S): the
    ML-25M catalog's 59,047 items take ~0.1 s, not ~1 s."""
    import heapq

    order = np.lexsort((np.arange(len(w)), -w))
    out = np.empty(len(w), np.int32)
    heap = [(0.0, s) for s in range(n_shards)]
    counts = np.zeros(n_shards, np.int64)
    for i in order.tolist():
        load, s = heapq.heappop(heap)
        out[i] = s
        counts[s] += 1
        if counts[s] < cap:
            # the same float64 sum the JAX loop forms, load[s] += w[i]
            heapq.heappush(heap, (load + float(w[i]), s))
    return out


def plan_from_assignment(
    assignment: np.ndarray,
    *,
    weights: Optional[np.ndarray] = None,
    strategy: str = "contiguous",
) -> ShardingPlan:
    """A plan from an explicit item→shard assignment (the IVF coarse
    quantizer's clusters). ``strategy`` names the producer; the shard count
    is the assignment's, which must leave no shard empty."""
    assignment = np.ascontiguousarray(assignment, np.int32)
    if assignment.ndim != 1 or assignment.size == 0:
        raise ValueError("assignment must be a non-empty 1-D item→shard map")
    n_items = int(assignment.shape[0])
    n_shards = int(assignment.max()) + 1
    if weights is None:
        w = np.ones(n_items, np.float64)
    else:
        w = np.asarray(weights, np.float64).reshape(-1)
        if w.shape[0] != n_items:
            raise ValueError(f"weights cover {w.shape[0]} items, catalog has {n_items}")
    per_shard = np.zeros(n_shards, np.float64)
    np.add.at(per_shard, assignment, w)
    total = per_shard.sum()
    load_share = per_shard / total if total > 0 else np.full(n_shards, 1.0 / n_shards)
    plan = ShardingPlan(
        n_shards=n_shards, assignment=assignment, strategy=strategy, load_share=load_share,
    )
    plan.validate(n_items)
    return plan


def plan_from_env(
    n_items: int,
    weights: Optional[np.ndarray] = None,
    bytes_per_item: Optional[float] = None,
) -> Optional[ShardingPlan]:
    """The publish-time plan from the ``PIO_SHARD_*`` knobs.

    None when neither ``PIO_SHARD_COUNT`` nor ``PIO_SHARD_HBM_BUDGET`` is
    set: the model publishes unsharded. ``PIO_SHARD_STRATEGY`` (default
    ``popularity``) and ``PIO_POD_HOST_GROUPS`` (default 1) shape it.
    """
    count = os.environ.get("PIO_SHARD_COUNT", "")
    budget = os.environ.get("PIO_SHARD_HBM_BUDGET", "")
    strategy = (os.environ.get("PIO_SHARD_STRATEGY") or "popularity").strip().lower()
    host_groups = os.environ.get("PIO_POD_HOST_GROUPS", "")
    if not count.strip() and not budget.strip():
        return None
    return build_plan(
        n_items,
        n_shards=int(count) if count.strip() else None,
        weights=weights,
        strategy=strategy,
        capacity_budget_bytes=int(budget) if budget.strip() else None,
        bytes_per_item=bytes_per_item,
        host_groups=int(host_groups) if host_groups.strip() else 1,
    )


def save_plan(path: str, plan: ShardingPlan) -> None:
    """Seal the plan into ``path`` through the checksum envelope (atomic
    tmp + rename, as ``quant.blob``)."""
    from predictionio_tpu_torch.core import persistence as _persistence

    _persistence.seal_blob_file(path, plan.to_payload())


def load_plan(path: str) -> ShardingPlan:
    """Open a sealed plan; raises ``ModelIntegrityError`` on a torn blob,
    ``OSError`` when missing (callers serve replicated)."""
    from predictionio_tpu_torch.core import persistence as _persistence

    return ShardingPlan.from_payload(_persistence.open_blob_file(path))


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Host arrays realizing a plan as equal-size blocks.

    ``perm`` is ``(n_shards, cap_pad)`` of global item ids (−1 on padded
    slots); every block's real slots are ascending by global id, ahead of
    its padding, so a slot's order within a block is its global id's.
    """

    n_shards: int
    cap_pad: int
    perm: np.ndarray  # (n_shards, cap_pad) int64, -1 = padding

    @property
    def gid(self) -> np.ndarray:
        """Flat (n_shards·cap_pad,) global ids; PAD_SENTINEL on padding."""
        g = np.where(self.perm >= 0, self.perm, PAD_SENTINEL)
        return g.reshape(-1).astype(np.int32)

    @property
    def pad_mask(self) -> np.ndarray:
        """Flat bool mask, True on padded (never-winning) slots."""
        return (self.perm < 0).reshape(-1)

    def take_rows(self, rows: np.ndarray, fill=0) -> np.ndarray:
        """Gather ``rows[global_id]`` into the layout, ``fill`` on pads."""
        rows = np.asarray(rows)
        flat = self.perm.reshape(-1)
        out = rows[np.clip(flat, 0, None)].copy()
        out[flat < 0] = fill
        return out


def build_layout(plan: ShardingPlan, pad_to) -> ShardLayout:
    """Realize ``plan`` as equal padded blocks; ``pad_to`` maps the largest
    block's item count to the common padded capacity."""
    sizes = plan.shard_sizes()
    cap_pad = int(pad_to(int(sizes.max())))
    perm = np.full((plan.n_shards, cap_pad), -1, np.int64)
    for s in range(plan.n_shards):
        ids = plan.shard_items(s)  # ascending: the tie-order invariant
        perm[s, : len(ids)] = ids
    return ShardLayout(n_shards=plan.n_shards, cap_pad=cap_pad, perm=perm)


class ShardAccounting:
    """Per-shard counters fed by the fast path's dispatches.

    A dispatch launches every shard's kernel, so a shard's busy time is not
    observed apart; what is counted per shard is its result load, the top-k
    slots its items win. ``snapshot`` attributes the measured busy fraction
    across shards by that share (an attributed quantity, as in the JAX
    package). ``note`` runs on request threads and ``snapshot`` on the
    scrape thread, under one lock.
    """

    def __init__(self, plan: ShardingPlan, local_k: int, merged_k: Optional[int] = None):
        self.plan = plan
        self._assign = plan.assignment
        self.local_k = int(local_k)
        # width of each per-host leaderboard of the pod layout's second tier
        # (None: the flat merge has no second tier)
        self.merged_k = int(merged_k) if merged_k is not None else None
        self._lock = threading.Lock()
        n = plan.n_shards
        self.queries_routed = np.zeros(n, np.int64)
        self.result_wins = np.zeros(n, np.int64)
        self.merge_bytes = 0.0
        self.merge_seconds = 0.0
        self.pod_merge_bytes = 0.0
        self.pod_merge_seconds = 0.0
        self.pod_dispatches = 0

    def note(self, winner_ids: np.ndarray, batch_rows: int, device_seconds: float,
             dispatch_bytes: float) -> None:
        """Charge one dispatch: the winners' (B, k) global ids, rung B."""
        ids = np.asarray(winner_ids).reshape(-1)
        ids = ids[(ids >= 0) & (ids < self._assign.shape[0])]
        # the S leaderboards of (B, local_k) slots gathered to the merge
        mb = float(self.plan.n_shards) * float(batch_rows) * float(self.local_k) * MERGE_SLOT_BYTES
        pod_mb = 0.0
        if self.plan.host_groups > 1 and self.merged_k is not None:
            pod_mb = (float(self.plan.host_groups) * float(batch_rows) * float(self.merged_k)
                      * MERGE_SLOT_BYTES)
        with self._lock:
            if len(ids):
                np.add.at(self.result_wins, self._assign[ids.astype(np.int64)], 1)
            self.queries_routed += int(batch_rows)
            self.merge_bytes += mb
            if dispatch_bytes > 0:
                self.merge_seconds += float(device_seconds) * min(1.0, mb / float(dispatch_bytes))
            if pod_mb > 0:
                self.pod_merge_bytes += pod_mb
                self.pod_dispatches += 1
                if dispatch_bytes > 0:
                    self.pod_merge_seconds += float(device_seconds) * min(
                        1.0, pod_mb / float(dispatch_bytes))

    def snapshot(self, busy_fraction: Optional[float], resident_bytes_per_shard: list) -> dict:
        n = self.plan.n_shards
        with self._lock:
            wins = self.result_wins.astype(np.float64)
            routed = self.queries_routed.tolist()
            raw_wins = self.result_wins.tolist()
            merge_bytes, merge_seconds = self.merge_bytes, self.merge_seconds
            pod_merge_bytes, pod_merge_seconds = self.pod_merge_bytes, self.pod_merge_seconds
            pod_dispatches = self.pod_dispatches
        total = wins.sum()
        # no traffic yet: the plan's expected shares
        share = wins / total if total > 0 else np.asarray(self.plan.load_share, np.float64)
        busy = (
            [round(float(busy_fraction) * n * float(s), 6) for s in share]
            if busy_fraction is not None else None
        )
        return {
            "plan": self.plan.describe(),
            "local_k": self.local_k,
            "queries_routed": routed,
            "result_wins": raw_wins,
            "result_share": [round(float(s), 6) for s in share],
            "busy_fraction": busy,
            "resident_bytes": resident_bytes_per_shard,
            "merge_bytes": merge_bytes,
            "merge_seconds": round(merge_seconds, 6),
            "pod_merge_bytes": pod_merge_bytes,
            "pod_merge_seconds": round(pod_merge_seconds, 6),
            "pod_dispatches": pod_dispatches,
        }
