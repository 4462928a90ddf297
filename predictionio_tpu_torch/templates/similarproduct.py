"""Similar-product engine template: implicit ALS + co-occurrence, multi-algo.

Counterpart of ``predictionio_tpu/templates/similarproduct.py`` (parity:
``examples/scala-parallel-similarproduct/``, the multi-events-multi-algos
variant, which subsumes the others). Training runs on the context's device:
ALS through :func:`~predictionio_tpu_torch.models.als.train_als` (implicit,
the training kernel on the card), co-occurrence through
:func:`~predictionio_tpu_torch.models.cooccurrence.train_cooccurrence`.
Queries are answered on the host with numpy over the model's arrays, as the
JAX package answers them.

* DataSource reads ``view`` events (train-with-rate-event folds in rated
  views via a params switch).
* :class:`SimilarALSAlgorithm` — implicit ALS (``ALS.trainImplicit``,
  reference ``ALSAlgorithm.scala:121``); similarity = cosine between item
  factors; a multi-item query averages similarities
  (``ALSAlgorithm.scala:61-200``).
* :class:`SimilarCooccurrenceAlgorithm` — top-N co-occurrence
  (``CooccurrenceAlgorithm.scala:45-140``), LLR-scored optionally (CCO/UR).
* :class:`SumServing` — queries fan out to all algorithms and scores are
  merged per item (reference Serving sums multi-algo results).
* Query supports num, categories (via item ``$set`` properties), whiteList,
  blackList; query items themselves are excluded like the reference.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    IdentityPreparator,
    Params,
    Serving,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.models.als import ALSConfig, ALSModel, train_als
from predictionio_tpu_torch.models.cooccurrence import CooccurrenceModel, train_cooccurrence

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Query:
    items: list[str] = dataclasses.field(default_factory=list)
    num: int = 10
    categories: Optional[list[str]] = None
    whiteList: Optional[list[str]] = None
    blackList: Optional[list[str]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float
    # populated when the algorithm's returnProperties param is set — the
    # item's aggregated $set properties travel with the score
    # (return-item-properties variant: ALSAlgorithm.scala:192-196 returns
    # title/date/categories; here the full property map is returned)
    properties: Optional[dict] = None


@dataclasses.dataclass
class PredictedResult:
    itemScores: list[ItemScore]


@dataclasses.dataclass
class TrainingData(SanityCheck):
    interactions: Interactions
    item_categories: dict  # item id → set of category strings
    item_properties: dict = dataclasses.field(default_factory=dict)

    def sanity_check(self):
        if len(self.interactions) == 0:
            raise ValueError("No view events found; check appName.")


PreparedData = TrainingData


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = "default"
    eventNames: tuple = ("view",)
    ratingKey: Optional[str] = None  # train-with-rate-event variant


class SimilarProductDataSource(DataSource):
    params_cls = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        # one card reads every row (the JAX package's multi-host 1/N read
        # comes with ROADMAP §1 item 10)
        inter = PEventStore.find_interactions(
            self.params.appName,
            entity_type="user",
            event_names=list(self.params.eventNames),
            target_entity_type="item",
            rating_key=self.params.ratingKey,
        )
        props = PEventStore.aggregate_properties(self.params.appName, "item")
        item_categories = {
            item_id: set(pm.get("categories") or [])
            for item_id, pm in props.items()
        }
        return TrainingData(
            interactions=inter,
            item_categories=item_categories,
            # plain dicts: these travel into ItemScore.properties and out
            # through the query server's JSON encoder
            item_properties={
                item_id: pm.to_dict() for item_id, pm in props.items()
            },
        )



def _make_item_score(
    item_properties: dict, return_props: bool, item_id: str, score: float
) -> ItemScore:
    """One policy for attaching properties to scores (return-item-properties)."""
    if not return_props:
        return ItemScore(item_id, score)
    return ItemScore(item_id, score, properties=item_properties.get(item_id) or {})


def _apply_filters(
    model_item_map,
    item_categories: dict,
    query: Query,
    scores: dict[int, float],
) -> dict[int, float]:
    """categories / whiteList / blackList / exclude-query-items filters."""
    exclude = set()
    for it in query.items:
        idx = model_item_map.get(it)
        if idx is not None:
            exclude.add(idx)
    if query.blackList:
        for it in query.blackList:
            idx = model_item_map.get(it)
            if idx is not None:
                exclude.add(idx)
    white = None
    if query.whiteList:
        white = {
            model_item_map[it] for it in query.whiteList if it in model_item_map
        }
    cats = set(query.categories) if query.categories else None
    inv = model_item_map.inverse
    out = {}
    for idx, score in scores.items():
        if idx in exclude:
            continue
        if white is not None and idx not in white:
            continue
        if cats is not None:
            item_id = inv[idx]
            if not (item_categories.get(item_id, set()) & cats):
                continue
        out[idx] = score
    return out


@dataclasses.dataclass
class SimilarALSParams(Params):
    rank: int = 10
    numIterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # return-item-properties variant: attach each item's aggregated $set
    # properties to its ItemScore
    returnProperties: bool = False

    json_aliases = {"lambda": "reg"}


@dataclasses.dataclass
class SimilarALSModel:
    als: ALSModel
    norm_factors: np.ndarray  # L2-normalized item factors
    item_categories: dict
    item_properties: dict = dataclasses.field(default_factory=dict)


class SimilarALSAlgorithm(Algorithm):
    params_cls = SimilarALSParams

    def train(self, ctx, pd: PreparedData) -> SimilarALSModel:
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
        norms = np.linalg.norm(als.item_factors, axis=1, keepdims=True)
        norm_factors = als.item_factors / np.maximum(norms, 1e-9)
        return SimilarALSModel(
            als=als,
            norm_factors=norm_factors,
            item_categories=pd.item_categories,
            item_properties=pd.item_properties if self.params.returnProperties else {},
        )

    def _item_score(self, model, item_id: str, score: float) -> ItemScore:
        return _make_item_score(
            model.item_properties, self.params.returnProperties, item_id, score
        )

    def batch_predict(self, model: SimilarALSModel, queries):
        """One matmul for a whole evaluation batch of filter-free queries."""
        simple, fallback = [], []
        for i, q in queries:
            idxs = [
                model.als.item_map[it] for it in q.items if it in model.als.item_map
            ]
            if idxs and not (q.blackList or q.whiteList or q.categories):
                simple.append((i, idxs, q))
            else:
                fallback.append((i, q))
        by_index = dict(super().batch_predict(model, fallback)) if fallback else {}
        if simple:
            n_items = model.norm_factors.shape[0]
            Q = np.stack(
                [model.norm_factors[idxs].mean(axis=0) for _, idxs, _ in simple]
            )
            sims = Q @ model.norm_factors.T  # (B, n_items)
            for row, (i, idxs, q) in enumerate(simple):
                s = sims[row].copy()
                s[np.asarray(idxs)] = -np.inf
                k = min(q.num, n_items)
                top = np.argpartition(-s, k - 1)[:k]
                top = top[np.argsort(-s[top])]
                inv = model.als.item_map.inverse
                by_index[i] = PredictedResult(
                    itemScores=[
                        self._item_score(model, inv[int(j)], float(s[j]))
                        for j in top
                        if np.isfinite(s[j])
                    ]
                )
        return list(by_index.items())

    def predict(self, model: SimilarALSModel, query: Query) -> PredictedResult:
        item_map = model.als.item_map
        idxs = [item_map[it] for it in query.items if it in item_map]
        if not idxs:
            logger.info("no query item known to the model; empty result")
            return PredictedResult(itemScores=[])
        # mean cosine similarity against all items (one matvec), then
        # vectorized masking + argpartition — no per-item Python objects
        q = model.norm_factors[idxs].mean(axis=0)
        sims = model.norm_factors @ q
        n_items = len(sims)
        drop = np.zeros(n_items, bool)
        drop[idxs] = True  # query items themselves excluded
        if query.blackList:
            bl = item_map.to_index_array(query.blackList)
            drop[bl[bl >= 0]] = True
        if query.whiteList:
            wl = item_map.to_index_array(query.whiteList)
            keep = np.zeros(n_items, bool)
            keep[wl[wl >= 0]] = True
            drop |= ~keep
        if query.categories:
            cats = set(query.categories)
            inv = item_map.inverse
            cat_ok = np.fromiter(
                (
                    bool(model.item_categories.get(inv[i], set()) & cats)
                    for i in range(n_items)
                ),
                dtype=bool,
                count=n_items,
            )
            drop |= ~cat_ok
        sims = np.where(drop, -np.inf, sims)
        k = min(query.num, n_items)
        top = np.argpartition(-sims, k - 1)[:k]
        top = top[np.argsort(-sims[top])]
        inv = item_map.inverse
        return PredictedResult(
            itemScores=[
                self._item_score(model, inv[int(i)], float(sims[i]))
                for i in top
                if np.isfinite(sims[i])
            ]
        )


@dataclasses.dataclass
class CooccurrenceParams(Params):
    n: int = 20  # top-N co-occurring items kept per item
    llr: bool = False  # LLR rescoring (CCO / Universal Recommender mode)
    returnProperties: bool = False  # return-item-properties variant


@dataclasses.dataclass
class SimilarCooccurrenceModel:
    cooccurrence: CooccurrenceModel
    item_categories: dict
    item_properties: dict = dataclasses.field(default_factory=dict)


class SimilarCooccurrenceAlgorithm(Algorithm):
    params_cls = CooccurrenceParams

    def train(self, ctx, pd: PreparedData) -> SimilarCooccurrenceModel:
        model = train_cooccurrence(
            ctx, pd.interactions, n=self.params.n, use_llr=self.params.llr
        )
        return SimilarCooccurrenceModel(
            cooccurrence=model,
            item_categories=pd.item_categories,
            item_properties=pd.item_properties if self.params.returnProperties else {},
        )

    def predict(self, model: SimilarCooccurrenceModel, query: Query) -> PredictedResult:
        co = model.cooccurrence
        scores: dict[int, float] = defaultdict(float)
        for it in query.items:
            idx = co.item_map.get(it)
            if idx is None:
                continue
            sim_idx, sim_scores = co.similar(int(idx), self.params.n)
            for j, s in zip(sim_idx, sim_scores):
                scores[int(j)] += float(s)
        scores = _apply_filters(co.item_map, model.item_categories, query, scores)
        top = sorted(scores.items(), key=lambda kv: -kv[1])[: query.num]
        inv = co.item_map.inverse
        return PredictedResult(
            itemScores=[
                _make_item_score(
                    model.item_properties,
                    self.params.returnProperties,
                    inv[i],
                    s,
                )
                for i, s in top
            ]
        )


class SumServing(Serving):
    """Merge multi-algorithm results by summing per-item scores.

    Parity: multi-events-multi-algos Serving (standardizes & combines).
    """

    def serve(self, query: Query, predictions: Sequence[PredictedResult]):
        combined: dict[str, float] = defaultdict(float)
        props: dict[str, dict] = {}
        for pred in predictions:
            for s in pred.itemScores:
                combined[s.item] += s.score
                if s.properties is not None:
                    props.setdefault(s.item, s.properties)
        top = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(
            itemScores=[
                ItemScore(item, score, properties=props.get(item))
                for item, score in top
            ]
        )


class SimilarProductEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=SimilarProductDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={
                "als": SimilarALSAlgorithm,
                "cooccurrence": SimilarCooccurrenceAlgorithm,
            },
            serving_cls=SumServing,
            query_cls=Query,
        )
