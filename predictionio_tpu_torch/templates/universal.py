"""Universal-Recommender engine template: CCO over multiple event types.

Counterpart of ``predictionio_tpu/templates/universal.py`` (the Universal
Recommender workload of BASELINE.md: "CCO multi-event, MovieLens-25M"): one
PRIMARY event (e.g. ``buy``) plus secondary indicator events (``view``,
``like``, …). Per indicator, a CROSS-occurrence matrix between the primary
event and that indicator is computed on the context's device (``C_t =
A_primaryᵀ A_t`` over the shared user axis, int8 products with exact
counts, :mod:`predictionio_tpu_torch.models.cooccurrence`), LLR-rescored
over the user population, and truncated to top-N correlated items per row.
Past ``DENSE_ITEM_LIMIT`` items the matrix is never held: column blocks of
indicator items are scored and cut to their top-N one at a time.

At query time the user's RECENT history per event type is read live from the
event store; each history item votes through its indicator's correlated-item
rows and votes are summed — so new events shift recommendations without
retraining (the reference UR's Elasticsearch-query-time behavior). Queries
are answered on the host, as the JAX package answers them. Under ``pio
launch`` each process reads its users' events in one 1/N scan
(``parallel/ingest.read_sharded_event_batch``), counts on its own users and
sums the counts across processes (``distributed.host_sum``) before scoring.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.models.cooccurrence import (
    DENSE_ITEM_LIMIT,
    _USER_BLOCK,
    block_incidence,
    cross_occurrence_matrix,
    cross_occurrence_topn,
    distinct_item_counts,
    llr_cross_scores,
    pad_to_multiple,
)
from predictionio_tpu_torch.ops.topk import topk_two_key

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Query:
    user: str
    num: int = 10
    blackList: Optional[list[str]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: list[ItemScore]


@dataclasses.dataclass
class TrainingData(SanityCheck):
    per_event: dict  # event name → Interactions (shared user/item maps)
    user_map: BiMap
    item_map: BiMap
    primary_event: str
    # under a launch per_event holds this process's users' rows (global
    # ids); n_hosts > 1 switches the trainer to per-process counts summed
    # across processes
    n_hosts: int = 1
    global_primary_rows: int = 0  # Σ processes (sanity sees the whole set)
    cleanup: Optional[object] = None  # removes the rendezvous blobs

    def sanity_check(self):
        primary = self.per_event.get(self.primary_event)
        local = 0 if primary is None else len(primary)
        if max(local, self.global_primary_rows) == 0:
            raise ValueError(
                f"no {self.primary_event!r} (primary) events found; check appName"
            )


@dataclasses.dataclass
class URDataSourceParams(Params):
    appName: str = "default"
    eventNames: tuple = ("buy", "view")  # first is the primary event


class URDataSource(DataSource):
    params_cls = URDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        from predictionio_tpu_torch.parallel import distributed

        if distributed.process_slot()[1] > 1:
            return self._read_training_sharded()
        # one store scan for ALL event types, split per name afterwards
        batch = PEventStore.find(
            self.params.appName,
            entity_type="user",
            event_names=list(self.params.eventNames),
            target_entity_type="item",
        )
        # shared id spaces across ALL event types
        user_map = BiMap.string_int(batch.entity_id)
        item_map = BiMap.string_int(
            t for t in batch.target_entity_id if t is not None
        )
        per_event = {
            name: batch.filter_events([name]).interactions(
                user_map=user_map, item_map=item_map
            )
            for name in self.params.eventNames
        }
        return TrainingData(
            per_event=per_event,
            user_map=user_map,
            item_map=item_map,
            primary_event=self.params.eventNames[0],
        )

    def _read_training_sharded(self) -> TrainingData:
        """Under a launch: ONE entity-keyed 1/N scan covers every event type
        (this process's users' whole histories); the global id spaces come
        from the model-repository exchange (``parallel/ingest.py``)."""
        from predictionio_tpu_torch.data.store import get_storage, resolve_app
        from predictionio_tpu_torch.parallel import distributed
        from predictionio_tpu_torch.parallel.ingest import read_sharded_event_batch

        app_id, channel_id = resolve_app(self.params.appName)
        batch, user_map, item_map, cleanup = read_sharded_event_batch(
            get_storage(), app_id, channel_id=channel_id, entity_type="user",
            event_names=list(self.params.eventNames), target_entity_type="item",
        )
        per_event = {
            name: batch.filter_events([name]).interactions(user_map=user_map, item_map=item_map)
            for name in self.params.eventNames
        }
        primary = per_event[self.params.eventNames[0]]
        return TrainingData(
            per_event=per_event,
            user_map=user_map,
            item_map=item_map,
            primary_event=self.params.eventNames[0],
            n_hosts=distributed.num_processes(),
            global_primary_rows=int(distributed.host_sum(np.array([len(primary)]))[0]),
            cleanup=cleanup,
        )


@dataclasses.dataclass
class URAlgorithmParams(Params):
    appName: str = "default"
    maxCorrelatorsPerItem: int = 50  # top-N per indicator row (UR default)
    maxQueryEvents: int = 100  # history depth read per event type at query


@dataclasses.dataclass
class URModel:
    # event name → (top_items (n_items, N) int32, top_scores (n_items, N) f32)
    indicators: dict
    item_map: BiMap
    primary_event: str


class URAlgorithm(Algorithm):
    params_cls = URAlgorithmParams

    # shared threshold with models.cooccurrence (the dense items×items
    # matrix would be ~14 GB at MovieLens-25M's 59k items)
    DENSE_ITEM_LIMIT = DENSE_ITEM_LIMIT

    def train(self, ctx, pd: TrainingData) -> URModel:
        from predictionio_tpu_torch.parallel import distributed

        sharded = pd.n_hosts > 1
        primary = pd.per_event[pd.primary_event]
        n_items = len(pd.item_map)
        n_users = len(pd.user_map)  # global observed users (the LLR total)
        per_event = pd.per_event
        host_reduce = None
        n_axis_users = n_users
        if sharded:
            # the processes' users are disjoint: each compacts its users to
            # a dense local range (C is a sum over users), one axis shared
            # by every event type, and the counts are summed across processes
            local_users = np.unique(np.concatenate(
                [i.user for i in per_event.values() if len(i)] or [np.empty(0, np.int32)]))
            lut = np.zeros(max(n_users, 1), np.int64)
            lut[local_users] = np.arange(len(local_users))
            per_event = {
                name: dataclasses.replace(
                    inter, user=lut[inter.user.astype(np.int64)].astype(np.int32))
                for name, inter in per_event.items()
            }
            primary = per_event[pd.primary_event]
            n_axis_users = max(len(local_users), 1)
            host_reduce = distributed.host_sum
        n_users_pad = pad_to_multiple(n_axis_users, _USER_BLOCK)
        # block the primary side ONCE; reused for every indicator product
        primary_blocked = block_incidence(primary, n_users_pad)
        # LLR marginals = DISTINCT-user counts, matching binarized incidence
        primary_counts_np = distinct_item_counts(primary, n_items)
        if sharded:
            primary_counts_np = host_reduce(primary_counts_np)
        k = min(self.params.maxCorrelatorsPerItem, n_items)
        blocked_mode = n_items > self.DENSE_ITEM_LIMIT
        # the dense path's marginals on the card (the blocked path pads and
        # uploads its own copy inside cross_occurrence_topn)
        primary_counts = (
            None if blocked_mode else torch.from_numpy(primary_counts_np).to(ctx.device)
        )
        indicators = {}
        for name, inter in per_event.items():
            # one reduced vector answers "any events at all?" and gives the
            # marginals; the primary's is the one above
            if sharded and name == pd.primary_event:
                counts_t_np = primary_counts_np
            else:
                counts_t_np = distinct_item_counts(inter, n_items)
                if sharded:
                    counts_t_np = host_reduce(counts_t_np)
            if counts_t_np.sum() == 0:
                logger.warning("indicator %s has no events; skipped", name)
                continue
            if blocked_mode:
                indicators[name] = cross_occurrence_topn(
                    ctx, primary_blocked, inter, n_items, n_items,
                    n_users=n_axis_users, k=k, use_llr=True,
                    primary_counts=primary_counts_np,
                    exclude_diagonal=(name == pd.primary_event),
                    secondary_counts=counts_t_np,
                    host_reduce=host_reduce,
                    llr_total=float(n_users),
                )
                continue
            C = cross_occurrence_matrix(
                ctx, primary_blocked, inter, n_items, n_items,
                n_users_pad=n_users_pad, host_reduce=host_reduce,
            )
            counts_t = torch.from_numpy(counts_t_np).to(ctx.device)
            llr = llr_cross_scores(C, primary_counts, counts_t, n_users)
            if name == pd.primary_event:
                llr = llr - torch.diag(torch.diagonal(llr))  # self-pairs excluded
            vals, idx = topk_two_key(llr.T, k)  # row per INDICATOR item
            indicators[name] = (
                idx.cpu().numpy().astype(np.int32),
                vals.cpu().numpy().astype(np.float32),
            )
        if sharded and pd.cleanup is not None and distributed.should_write_storage():
            pd.cleanup()
        return URModel(
            indicators=indicators,
            item_map=pd.item_map,
            primary_event=pd.primary_event,
        )

    def _history(self, user: str, event_name: str) -> list[str]:
        try:
            events = LEventStore.find_by_entity(
                self.params.appName,
                entity_type="user",
                entity_id=user,
                event_names=[event_name],
                target_entity_type="item",
                limit=self.params.maxQueryEvents,
                latest=True,
            )
            return [e.target_entity_id for e in events if e.target_entity_id]
        except Exception:
            logger.exception("history lookup failed (%s, %s)", user, event_name)
            return []

    def predict(self, model: URModel, query: Query) -> PredictedResult:
        scores: dict[int, float] = defaultdict(float)
        primary_seen: set[int] = set()
        for event_name, (top_items, top_scores) in model.indicators.items():
            for item_id in self._history(query.user, event_name):
                j = model.item_map.get(item_id)
                if j is None:
                    continue
                if event_name == model.primary_event:
                    primary_seen.add(int(j))
                for corr, s in zip(top_items[j], top_scores[j]):
                    if s > 0:
                        scores[int(corr)] += float(s)
        # UR default: only the PRIMARY event's items are blacklisted — a
        # viewed-but-never-bought item remains recommendable
        for j in primary_seen:
            scores.pop(j, None)
        if query.blackList:
            for item_id in query.blackList:
                j = model.item_map.get(item_id)
                if j is not None:
                    scores.pop(int(j), None)
        top = sorted(scores.items(), key=lambda kv: -kv[1])[: query.num]
        inv = model.item_map.inverse
        return PredictedResult(
            itemScores=[ItemScore(inv[j], s) for j, s in top]
        )


class UniversalRecommenderEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=URDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={"ur": URAlgorithm},
            serving_cls=FirstServing,
            query_cls=Query,
        )
