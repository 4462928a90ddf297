"""The item partition and its device layout: the plan IVF retrieval is
built from.

Counterpart of ``predictionio_tpu/serving/sharding.py``, its plan and
layout only: :data:`PAD_SENTINEL` (``:52``), :class:`ShardingPlan`
(``:58-195``), :func:`plan_from_assignment` (``:319-363``),
:class:`ShardLayout` and :func:`build_layout` (``:422-478``). IVF
retrieval (``ops/ivf.py``) declares its k-means clusters as the "shards"
of a plan with strategy ``"ivf"``, and the fast path lays the item factors
out in the plan's blocks. A plan's :meth:`ShardingPlan.to_payload` bytes
equal the JAX package's for the same plan, and each package reads the
other's.

Sharded serving itself (``build_plan``, ``plan_from_env``, the budget
rule, ``save_plan``/``load_plan``, ``ShardAccounting`` and the sharded
placement) comes with ROADMAP §1 item 10.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from typing import Optional

import numpy as np

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
