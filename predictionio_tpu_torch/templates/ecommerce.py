"""E-commerce recommendation template: implicit ALS + live business rules.

Counterpart of ``predictionio_tpu/templates/ecommerce.py`` (parity:
``examples/scala-parallel-ecommercerecommendation/``,
``ECommAlgorithm.scala:85-560``). Training runs implicit ALS on the
context's device (the training kernel on the card); queries are answered
on the host with numpy over the model's arrays, as the JAX package answers
them. Under ``pio launch`` the read is the 1/N sharded one and the popular
count sums the processes' histograms (``distributed.host_sum``).

* train (``:91``): implicit ALS over view(+buy) events, plus
  ``trainDefault`` (``:211``) — popular-interaction counts as the fallback
  ranking for users unknown to the factor model.
* predict (``:244``): business rules applied at serving time —
  ``whiteList``/``blackList``/category filters, ``unseenOnly`` backed by a
  **live** ``LEventStore.findByEntity`` read of the user's seen events
  (``:332-360``), and the "unavailableItems" constraint entity read live per
  query (the reference caches it the same way per request).
* adjust-score variant: ``weightedItems`` groups
  (``adjust-score/ECommAlgorithm.scala:57-60,259-281`` WeightGroup —
  per-item multipliers applied before ranking), plus a category-level
  ``boostCategories`` hook.
* train-with-rate-event variant: ``ratingKey`` datasource param reads
  graded events as the implicit-confidence weight.

Deliberate deviation from the reference: serving-time lookups go through an
in-process TTL cache with async refresh (``serving/event_cache.py``), so
steady-state filtered queries make ZERO storage round-trips — new events
become visible within ``cacheRefreshSeconds`` (default 5) instead of
immediately. Set ``cacheRefreshSeconds: 0`` for the reference's
read-storage-every-query semantics.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    IdentityPreparator,
    FirstServing,
    Params,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.models.als import ALSConfig, ALSModel, train_als

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Query:
    user: str
    num: int = 10
    categories: Optional[list[str]] = None
    whiteList: Optional[list[str]] = None
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
    interactions: Interactions
    item_categories: dict

    def sanity_check(self):
        if len(self.interactions) == 0:
            raise ValueError("No interaction events found; check appName.")


PreparedData = TrainingData


@dataclasses.dataclass
class ECommDataSourceParams(Params):
    appName: str = "default"
    eventNames: tuple = ("view", "buy")
    # train-with-rate-event variant: read this property as the interaction
    # weight (e.g. eventNames=["rate"], ratingKey="rating"), so graded
    # events feed the implicit-ALS confidence instead of weight-1 views
    ratingKey: Optional[str] = None


class ECommDataSource(DataSource):
    params_cls = ECommDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        from predictionio_tpu_torch.parallel.ingest import template_interactions

        # one process: a plain columnar read; under a launch the 1/N
        # entity-keyed sharded read (the ALS trainer dispatches on type)
        inter = template_interactions(
            self.params.appName,
            entity_type="user",
            event_names=list(self.params.eventNames),
            target_entity_type="item",
            rating_key=self.params.ratingKey,
        )
        props = PEventStore.aggregate_properties(self.params.appName, "item")
        item_categories = {
            item_id: set(pm.get("categories") or []) for item_id, pm in props.items()
        }
        return TrainingData(interactions=inter, item_categories=item_categories)



@dataclasses.dataclass
class ECommAlgorithmParams(Params):
    appName: str = "default"
    unseenOnly: bool = False
    seenEvents: tuple = ("view", "buy")
    rank: int = 10
    numIterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    boostCategories: Optional[dict] = None  # category → multiplier
    # adjust-score variant (ECommAlgorithm.scala WeightGroup): groups of
    # item ids with a weight multiplied into their scores before ranking,
    # e.g. [{"items": ["i1", "i2"], "weight": 2.0}]
    weightedItems: Optional[list] = None
    # serving-time event cache (SURVEY.md §7): seen-sets and constraint
    # entities are served from an in-process TTL cache with async refresh,
    # so steady-state filtered queries make zero storage round-trips. New
    # events appear within this many seconds; 0 reads storage every query
    # (the reference's behavior, ECommAlgorithm.scala:332-360).
    cacheRefreshSeconds: float = 5.0

    json_aliases = {"lambda": "reg"}


@dataclasses.dataclass
class ECommModel:
    als: ALSModel
    popular: np.ndarray  # (n_items,) interaction counts (trainDefault)
    item_categories: dict


class ECommAlgorithm(Algorithm):
    params_cls = ECommAlgorithmParams

    def train(self, ctx, pd: PreparedData) -> ECommModel:
        p = self.params
        als = train_als(
            ctx,
            pd.interactions,
            ALSConfig(
                rank=p.rank,
                iterations=p.numIterations,
                reg=p.reg,
                implicit=True,
                alpha=p.alpha,
                seed=3 if p.seed is None else p.seed,
            ),
        )
        # trainDefault (ECommAlgorithm.scala:211): popular-count fallback.
        # Under a launch the processes' item histograms of their users' rows
        # sum exactly (each rating counted once, on its user's process)
        from predictionio_tpu_torch.parallel.ingest import ShardedInteractions

        if isinstance(pd.interactions, ShardedInteractions):
            from predictionio_tpu_torch.parallel import distributed

            popular = distributed.host_sum(
                np.bincount(pd.interactions.user_rows.item, minlength=len(als.item_map))
            ).astype(np.float32)
        else:
            popular = np.bincount(
                pd.interactions.item, minlength=len(als.item_map)
            ).astype(np.float32)
        return ECommModel(
            als=als, popular=popular, item_categories=pd.item_categories
        )

    # -- live lookups (parity: predict-time LEventStore reads :332-360),
    # served through the in-process TTL cache so steady-state queries make
    # zero storage round-trips (SURVEY.md §7) ------------------------------
    # guards lazy cache creation: predict runs on multiple server threads,
    # and an unguarded check-then-set would orphan one thread's cache (its
    # in-flight dedup and stats silently lost)
    _cache_init_lock = threading.Lock()

    @property
    def _cache(self):
        cache = getattr(self, "_event_cache", None)
        if cache is None:
            with self._cache_init_lock:
                cache = getattr(self, "_event_cache", None)
                if cache is None:
                    from predictionio_tpu_torch.serving.event_cache import (
                        ServingEventCache,
                    )

                    cache = ServingEventCache(
                        refresh_interval=self.params.cacheRefreshSeconds
                    )
                    self._event_cache = cache
        return cache

    def _seen_items(self, user: str) -> set:
        if self.params.cacheRefreshSeconds > 0:
            from predictionio_tpu_torch.serving.result_cache import INVALIDATIONS

            # event-driven invalidation: a new event for this user bumps
            # their generation, so the seen-set reloads synchronously on
            # the next query instead of one refresh interval later
            return self._cache.get(
                ("seen", user),
                lambda: self._load_seen(user),
                token=INVALIDATIONS.token((user,)),
            )
        return self._load_seen(user)

    def _load_seen(self, user: str) -> set:
        try:
            events = LEventStore.find_by_entity(
                self.params.appName,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seenEvents),
                target_entity_type="item",
                limit=-1,
            )
            return {e.target_entity_id for e in events if e.target_entity_id}
        except Exception:
            logger.exception("seen-items lookup failed; continuing without")
            return set()

    def _unavailable_items(self) -> set:
        if self.params.cacheRefreshSeconds > 0:
            from predictionio_tpu_torch.serving.result_cache import INVALIDATIONS

            # the constraint entity is written via $set, which bumps the
            # GLOBAL generation — captured here through the token
            return self._cache.get(
                ("constraint", "unavailableItems"),
                self._load_unavailable,
                token=INVALIDATIONS.token(("unavailableItems",)),
            )
        return self._load_unavailable()

    def _load_unavailable(self) -> set:
        try:
            events = LEventStore.find_by_entity(
                self.params.appName,
                entity_type="constraint",
                entity_id="unavailableItems",
                event_names=["$set"],
                limit=1,
                latest=True,
            )
            if events:
                return set(events[0].properties.get("items") or [])
        except Exception:
            logger.exception("unavailable-items lookup failed; continuing without")
        return set()

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        item_map = model.als.item_map
        user_idx = model.als.user_map.get(query.user)
        if user_idx is not None:
            scores = model.als.user_factors[user_idx] @ model.als.item_factors.T
        else:
            # unknown user → popularity fallback (predictDefault parity)
            logger.info("user %s unknown; serving popular items", query.user)
            scores = model.popular.copy()

        # boosts/weights rescale BEFORE ranking (adjust-score semantics:
        # ECommAlgorithm.scala:259-281 multiplies the dot product by the
        # item's weight group before topN)
        boosts = self.params.boostCategories or {}
        if boosts:
            scores = scores.copy()
            inv_all = item_map.inverse
            for idx in range(len(scores)):
                for c in model.item_categories.get(inv_all[idx], ()):
                    if c in boosts:
                        scores[idx] *= float(boosts[c])
        if self.params.weightedItems:
            weights = np.ones(len(scores), np.float32)
            for group in self.params.weightedItems:
                w = float(group.get("weight", 1.0))
                idx = item_map.to_index_array(list(group.get("items") or []))
                weights[idx[idx >= 0]] = w
            scores = scores * weights

        excluded: set = set()
        if query.blackList:
            excluded |= set(query.blackList)
        excluded |= self._unavailable_items()
        if self.params.unseenOnly:
            excluded |= self._seen_items(query.user)

        white = set(query.whiteList) if query.whiteList else None
        cats = set(query.categories) if query.categories else None

        inv = item_map.inverse

        def accept(idx: int) -> Optional[ItemScore]:
            item_id = inv[idx]
            if item_id in excluded:
                return None
            if white is not None and item_id not in white:
                return None
            if cats is not None and not (
                model.item_categories.get(item_id, set()) & cats
            ):
                return None
            return ItemScore(item_id, float(scores[idx]))

        # top-m argpartition, widening ×4 while filters reject candidates —
        # a full catalog argsort is O(n log n) and at UR catalog scale the
        # sort (not the scoring) dominates per-query latency. Each pass
        # rescans its own sorted prefix (ties may order differently between
        # partitions, so passes don't share state).
        n = len(scores)
        if n == 0:
            return PredictedResult(itemScores=[])
        m = min(max(query.num * 4, 16), n)
        while True:
            top = np.argpartition(-scores, m - 1)[:m]
            top = top[np.argsort(-scores[top])]
            results = []
            for idx in top:
                s = accept(int(idx))
                if s is not None:
                    results.append(s)
                    if len(results) >= query.num:
                        return PredictedResult(itemScores=results)
            if m >= n:
                return PredictedResult(itemScores=results)
            m = min(m * 4, n)


class ECommerceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=ECommDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={"ecomm": ECommAlgorithm},
            serving_cls=FirstServing,
            query_cls=Query,
        )
