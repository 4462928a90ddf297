"""IVF coarse retrieval: prune the serving scan instead of speeding it up.

Counterpart of ``predictionio_tpu/ops/ivf.py``, whole. Exact serving scores
the whole catalog for every query. This module adds the inverted-file first
stage: a k-means coarse partition of the ITEM factors, trained at publish,
so serving scores the query against ``nlist`` centroids, picks the best
``nprobe`` clusters and runs the score kernel (``csrc/score_topk.cu``, its
probe-table mode) over only those clusters' item blocks.

The partition is a :class:`~predictionio_tpu_torch.serving.sharding.
ShardingPlan` with strategy ``"ivf"``, so ``build_layout`` gives one
padded block a cluster whose real slots ascend by global item id: the
order that makes the cross-probe merge (value descending, global id
ascending) equal to the exact path's answer whenever every cluster is
probed.

k-means runs in host numpy, as in the JAX package, once per publish and
off the serving path, so the centroids, the assignment and the fingerprint
equal the JAX package's bit for bit from the same factors and seed.

Publish follows the sealed envelope: the index seals into ``ivf.blob``
(``core/persistence.py``), publish is gated on recall@10 against the exact
ranking (``PIO_IVF_MIN_RECALL``, with a refusal receipt in the manifest,
parallel to ``PIO_QUANT_MIN_OVERLAP``), and deploy degrades to exact on a
missing, torn or fingerprint-mismatched blob. ``PIO_RETRIEVAL=exact`` is
the one-variable rollback.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
from typing import Optional

import numpy as np

from predictionio_tpu_torch.serving import sharding as _sharding

logger = logging.getLogger(__name__)

_INDEX_VERSION = 1

RETRIEVAL_BACKENDS = ("exact", "ivf", "auto")


def resolve_retrieval(
    requested: Optional[str] = None, *, index=None
) -> str:
    """Resolve the retrieval path: ``"exact"`` or ``"ivf"``.

    ``requested`` overrides ``PIO_RETRIEVAL`` (default ``auto``).
    ``auto`` serves IVF only when the model actually carries a usable
    :class:`IVFIndex` — a model published without one (or whose
    ``ivf.blob`` failed to load) serves exact, so the approximate path is
    an optimization, never a point of failure.  An explicit ``ivf``
    without an index is a configuration error (the same contract as
    ``PIO_SERVING_SHARDING=sharded`` without a plan); an explicit
    ``exact`` is the rollback switch and always wins.
    """
    req = (
        requested or os.environ.get("PIO_RETRIEVAL") or "auto"
    ).strip().lower()
    if req not in RETRIEVAL_BACKENDS:
        raise ValueError(
            f"PIO_RETRIEVAL must be one of {RETRIEVAL_BACKENDS}, got {req!r}"
        )
    if req == "exact":
        return "exact"
    if req == "ivf":
        if index is None:
            raise ValueError(
                "PIO_RETRIEVAL=ivf requires an IVF index declared at "
                "publish (PIO_IVF_NLIST)"
            )
        return "ivf"
    return "ivf" if index is not None else "exact"


def default_nprobe(nlist: int) -> int:
    """The computed ``PIO_IVF_NPROBE`` default: ``max(1, nlist // 8)``.

    An eighth of the lists keeps the analytic scan fraction well under
    the bench gate's 0.2 while leaving recall headroom on clustered
    catalogs; operators tune the ratio per catalog via ``PIO_IVF_NPROBE``.
    """
    return max(1, int(nlist) // 8)


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """Trained coarse quantizer + cluster partition, declared at publish.

    ``centroids`` are the k-means cell centers in factor space (always
    fp32 — the centroid scoring matmul is tiny, (B, rank)×(rank, nlist));
    ``plan`` is the item→cluster partition as a ShardingPlan (strategy
    ``"ivf"``), which is what the serving layout, the fingerprint, and
    the sealed-blob round trip are built from.  ``nprobe`` is the
    publish-time default probe count; deploy may override it via
    ``PIO_IVF_NPROBE``.  The recall fields are the publish gate's receipt
    (None before the gate runs).
    """

    centroids: np.ndarray  # (nlist, rank) float32
    plan: _sharding.ShardingPlan
    nprobe: int
    recall_at_publish: Optional[float] = None
    recall_threshold: Optional[float] = None
    recall_k: Optional[int] = None

    @property
    def nlist(self) -> int:
        return self.plan.n_shards

    @property
    def n_items(self) -> int:
        return self.plan.n_items

    @property
    def fingerprint(self) -> str:
        """Content hash over centroids + partition — the index identity.

        Deliberately EXCLUDES ``nprobe`` and the recall receipt: those
        are serving-time tunables/audit data, and retuning them must not
        read as a new index generation.
        """
        h = hashlib.sha256()
        h.update(f"{_INDEX_VERSION}:".encode())
        h.update(
            np.ascontiguousarray(self.centroids, np.float32).tobytes()
        )
        h.update(self.plan.fingerprint.encode())
        return h.hexdigest()[:16]

    def validate(self, n_items: Optional[int] = None) -> None:
        c = np.asarray(self.centroids)
        if c.ndim != 2 or c.shape[0] != self.plan.n_shards:
            raise ValueError(
                f"centroids shape {c.shape} does not match "
                f"{self.plan.n_shards} clusters"
            )
        if not 1 <= int(self.nprobe) <= self.plan.n_shards:
            raise ValueError(
                f"nprobe={self.nprobe} outside [1, nlist={self.plan.n_shards}]"
            )
        self.plan.validate(n_items)

    def to_payload(self) -> bytes:
        return pickle.dumps(
            {
                "version": _INDEX_VERSION,
                "centroids": np.ascontiguousarray(
                    self.centroids, np.float32
                ),
                "plan": self.plan.to_payload(),
                "nprobe": int(self.nprobe),
                "recall_at_publish": self.recall_at_publish,
                "recall_threshold": self.recall_threshold,
                "recall_k": self.recall_k,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )

    @classmethod
    def from_payload(cls, payload: bytes) -> "IVFIndex":
        d = pickle.loads(payload)
        index = cls(
            centroids=np.asarray(d["centroids"], np.float32),
            plan=_sharding.ShardingPlan.from_payload(d["plan"]),
            nprobe=int(d["nprobe"]),
            recall_at_publish=d.get("recall_at_publish"),
            recall_threshold=d.get("recall_threshold"),
            recall_k=d.get("recall_k"),
        )
        index.validate()
        return index

    def describe(self) -> dict:
        """JSON-friendly summary for the ``pio ivf`` CLI and stats."""
        sizes = self.plan.shard_sizes()
        return {
            "nlist": self.nlist,
            "nprobe": int(self.nprobe),
            "n_items": self.n_items,
            "rank": int(np.asarray(self.centroids).shape[1]),
            "fingerprint": self.fingerprint,
            "items_per_cluster_min": int(sizes.min()),
            "items_per_cluster_max": int(sizes.max()),
            "recall_at_publish": self.recall_at_publish,
            "recall_threshold": self.recall_threshold,
            "recall_k": self.recall_k,
        }


def train_kmeans(
    item_factors: np.ndarray,
    nlist: int,
    *,
    iters: int = 25,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic k-means++-seeded Lloyd over item factors, balanced.

    Host numpy throughout — this runs once per publish, off the serving
    path.  After Lloyd converges, the FINAL assignment is re-done under a
    per-cluster capacity cap of ``ceil(2·n/nlist)`` (items claimed
    nearest-first, spilling to their next-nearest open cluster), so one
    runaway cluster can never make the serving-time per-probe block — and
    with it the padded scan cost of EVERY probe — balloon.  Empty
    clusters are dropped and ids compacted.  Returns
    ``(centroids (nlist', rank) f32, assignment (n,) int32)``.
    """
    V = np.asarray(item_factors, np.float32)
    n, rank = V.shape
    if n < 1:
        raise ValueError("cannot build an IVF partition over an empty catalog")
    nlist = int(nlist)
    if not 1 <= nlist <= n:
        raise ValueError(f"nlist={nlist} outside [1, n_items={n}]")
    rng = np.random.default_rng(seed)
    # k-means++ seeding (D^2 sampling): random-row init routinely drops
    # two seeds inside one tight cluster and none in another, and Lloyd
    # cannot undo the resulting merge — the merged cell then sets
    # ``cap_pad`` and with it the padded scan cost of EVERY probe
    centroids = np.empty((nlist, rank), np.float32)
    centroids[0] = V[int(rng.integers(n))]
    d2 = ((V - centroids[0]) ** 2).sum(axis=1, dtype=np.float64)
    for c in range(1, nlist):
        total = float(d2.sum())
        if total <= 0.0:  # catalog has < nlist distinct rows
            centroids[c:] = V[rng.choice(n, size=nlist - c)]
            break
        centroids[c] = V[int(rng.choice(n, p=d2 / total))]
        d2 = np.minimum(
            d2, ((V - centroids[c]) ** 2).sum(axis=1, dtype=np.float64)
        )
    v_sq = (V * V).sum(axis=1)
    cap = int(np.ceil(2.0 * n / nlist))
    for _ in range(max(1, int(iters))):
        # ||v - c||^2 = ||v||^2 - 2 v·c + ||c||^2; argmin drops ||v||^2
        d = (
            (centroids * centroids).sum(axis=1)[None, :]
            - 2.0 * (V @ centroids.T)
        )
        assign = np.argmin(d, axis=1)
        counts = np.bincount(assign, minlength=nlist)
        moved = False
        for c in range(nlist):
            if counts[c]:
                centroids[c] = V[assign == c].mean(axis=0)
        # split pass: the LARGEST cell sets the padded block size of
        # EVERY probe (blocks stride at cap_pad = max cell), and plain
        # Lloyd cannot un-merge two clusters sharing a centroid — it
        # would have to cross empty space.  Donate the smallest cells'
        # centroids to each oversized cell's farthest member and let the
        # next sweep re-partition; splitting a genuinely big cluster
        # across two cells costs nothing at query time (both centroids
        # rank high for its queries), while a 2x cell taxes every scan.
        hi = int(np.ceil(1.25 * n / nlist))
        reseeded = set()
        big = [int(c) for c in np.argsort(-counts) if counts[c] > hi]
        smalls = (
            int(c) for c in np.argsort(counts, kind="stable")
            if counts[c] <= hi // 2
        )
        for cbig, csml in zip(big, smalls):
            members = np.flatnonzero(assign == cbig)
            far = members[int(np.argmax(d[members, cbig] + v_sq[members]))]
            centroids[csml] = V[far]
            reseeded.add(csml)
            moved = True
        for c in range(nlist):
            if counts[c] == 0 and c not in reseeded:
                # reseed a leftover empty cell on the globally worst-served
                # point — keeps nlist cells alive while Lloyd runs
                far = int(np.argmax(d[np.arange(n), assign] + v_sq))
                centroids[c] = V[far]
                moved = True
        if not moved and np.array_equal(
            assign, np.argmin(
                (centroids * centroids).sum(axis=1)[None, :]
                - 2.0 * (V @ centroids.T),
                axis=1,
            )
        ):
            break
    # balanced final assignment: nearest-first under the same 2x cap
    d = (
        (centroids * centroids).sum(axis=1)[None, :]
        - 2.0 * (V @ centroids.T)
    )
    pref = np.argsort(d, axis=1, kind="stable")
    order = np.argsort(d[np.arange(n), pref[:, 0]], kind="stable")
    counts = np.zeros(nlist, np.int64)
    assignment = np.empty(n, np.int32)
    for i in order:
        for c in pref[i]:
            if counts[c] < cap:
                assignment[i] = c
                counts[c] += 1
                break
    # drop empty cells (ShardingPlan.validate rejects empty shards)
    live = np.flatnonzero(counts > 0)
    remap = np.full(nlist, -1, np.int64)
    remap[live] = np.arange(len(live))
    assignment = remap[assignment].astype(np.int32)
    return centroids[live], assignment


def build_index(
    item_factors: np.ndarray,
    nlist: int,
    nprobe: Optional[int] = None,
    *,
    iters: int = 25,
    seed: int = 0,
) -> IVFIndex:
    """Train the coarse quantizer and wrap it as an :class:`IVFIndex`."""
    centroids, assignment = train_kmeans(
        item_factors, nlist, iters=iters, seed=seed
    )
    plan = _sharding.plan_from_assignment(
        assignment,
        weights=np.linalg.norm(np.asarray(item_factors, np.float32), axis=1),
        strategy="ivf",
    )
    nlist_live = plan.n_shards
    if nprobe is None:
        nprobe = default_nprobe(nlist_live)
    nprobe = max(1, min(int(nprobe), nlist_live))
    index = IVFIndex(centroids=centroids, plan=plan, nprobe=nprobe)
    index.validate(np.asarray(item_factors).shape[0])
    return index


def index_from_env(item_factors: np.ndarray) -> Optional[IVFIndex]:
    """Publish-time index declaration from the PIO_IVF_* knobs.

    Returns None when ``PIO_IVF_NLIST`` is unset — the model publishes
    exact-only and every existing caller is untouched (the same opt-in
    contract as ``plan_from_env``).
    """
    nlist = os.environ.get("PIO_IVF_NLIST", "")
    if not nlist.strip():
        return None
    nprobe = os.environ.get("PIO_IVF_NPROBE", "")
    return build_index(
        item_factors,
        int(nlist),
        nprobe=int(nprobe) if nprobe.strip() else None,
    )


def measure_recall(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    index: IVFIndex,
    *,
    k: int = 10,
    sample: int = 256,
    nprobe: Optional[int] = None,
) -> float:
    """Mean recall@k of IVF vs exact ranking — the publish gate metric.

    For an evenly-spaced deterministic user sample (the same sampling as
    :func:`core.evaluation.quantized_topk_overlap`), probes each query's
    top-``nprobe`` clusters by centroid inner product — the b=1 serving
    path — and compares the pruned top-k against the exact full-scan
    top-k via :func:`core.evaluation.recall_at_k`.  Host numpy, fp32
    factors: this measures the PARTITION's recall loss in isolation
    (quantization error is gated separately by the quant publish gate).
    """
    from predictionio_tpu_torch.core.evaluation import recall_at_k

    U = np.asarray(user_factors, np.float32)
    V = np.asarray(item_factors, np.float32)
    n_users, n_items = U.shape[0], V.shape[0]
    k = min(int(k), n_items)
    n = min(max(1, int(sample)), n_users)
    users = np.unique(
        np.linspace(0, n_users - 1, n).round().astype(np.int64)
    )
    nprobe = int(nprobe) if nprobe is not None else int(index.nprobe)
    nprobe = max(1, min(nprobe, index.nlist))
    assign = index.plan.assignment
    C = np.asarray(index.centroids, np.float32)
    scores = U[users] @ V.T  # (S, n_items)
    exact = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    probes = np.argpartition(
        -(U[users] @ C.T), nprobe - 1, axis=1
    )[:, :nprobe]
    approx = np.full((len(users), k), -1, np.int64)  # -1 = padding
    for row in range(len(users)):
        cand = np.flatnonzero(np.isin(assign, probes[row]))
        kk = min(k, len(cand))
        top = cand[np.argpartition(-scores[row, cand], kk - 1)[:kk]]
        approx[row, :kk] = top
    return recall_at_k(exact, approx, k)


def gate_index(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    index: IVFIndex,
    threshold: float,
    *,
    sample: int = 256,
) -> tuple[Optional[IVFIndex], dict]:
    """The recall publish gate: :func:`measure_recall` at k = min(10,
    n_items) against ``threshold``. Returns the index stamped with its
    recall (``None`` when refused) and the manifest's ``ivf`` record, a
    refusal receipt or the sealed index's summary. Publish and ``pio ivf
    rebuild`` both go through it, so their records cannot drift apart."""
    k = min(10, int(np.shape(item_factors)[0]))
    recall = measure_recall(user_factors, item_factors, index, k=k, sample=sample)
    if recall < threshold:
        return None, {"nlist": 0, "refused": index.nlist, "recall": recall,
                      "threshold": threshold, "k": k}
    index = dataclasses.replace(
        index, recall_at_publish=recall, recall_threshold=threshold, recall_k=k
    )
    return index, {"nlist": index.nlist, "nprobe": index.nprobe, "recall": recall,
                   "threshold": threshold, "k": k, "fingerprint": index.fingerprint}


def save_index(path: str, index: IVFIndex) -> None:
    """Seal the index into ``path`` through the checksum envelope
    (atomic tmp+rename — the same publish guarantee as ``quant.blob``)."""
    from predictionio_tpu_torch.core import persistence as _persistence

    _persistence.seal_blob_file(path, index.to_payload())


def load_index(path: str) -> IVFIndex:
    """Open a sealed index; raises ``ModelIntegrityError`` on a torn blob,
    ``OSError`` when missing — callers degrade to exact retrieval."""
    from predictionio_tpu_torch.core import persistence as _persistence

    return IVFIndex.from_payload(_persistence.open_blob_file(path))
