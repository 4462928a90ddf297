"""Recommendation engine template: explicit ALS served from the card.

Counterpart of ``predictionio_tpu/templates/recommendation.py`` (parity:
``examples/scala-parallel-recommendation/``), serving half: the query and
result types, ``ALSAlgorithm``'s deploy and predict methods
(``load_serializable_model``, ``warmup``, ``serving_stats``,
``batch_predict``, ``predict``), the file-filter serving variant and the
engine factory.

The DataSource, the Preparator and ``ALSAlgorithm.train`` come with the
training slice. Their params classes are here already, so engine.json and
EngineInstance rows written for the JAX package bind unchanged; calling
them raises an error that says training is not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    Params,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import ALSModel, ALSScorer

logger = logging.getLogger(__name__)

_NOT_PORTED = (
    "training is not ported to predictionio_tpu_torch yet (it comes with "
    "the training slice); train with predictionio_tpu"
)


# -- data types -------------------------------------------------------------


@dataclasses.dataclass
class Query:
    user: str
    num: int = 10
    blackList: Optional[list[str]] = None
    whiteList: Optional[list[str]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: list[ItemScore]


# -- DataSource / Preparator (training slice) -------------------------------


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = "default"
    evalParams: Optional[dict] = None
    eventWindow: Optional[dict] = None
    eventRatings: Optional[dict] = None


class RecommendationDataSource(DataSource):
    params_cls = DataSourceParams

    def read_training(self, ctx):
        raise NotImplementedError(_NOT_PORTED)


@dataclasses.dataclass
class PreparatorParams(Params):
    filepath: Optional[str] = None


class ExcludeItemsPreparator(Preparator):
    params_cls = PreparatorParams

    def prepare(self, ctx, td):
        raise NotImplementedError(_NOT_PORTED)


# -- Serving (customize-serving variant) ------------------------------------


@dataclasses.dataclass
class ServingParams(Params):
    # file of disabled item ids, re-read per query so ops can flip products
    # off without redeploying (parity: customize-serving Serving.scala:33-42)
    filepath: Optional[str] = None


class FileFilterServing(Serving):
    """FirstServing plus a per-query disabled-items file filter."""

    params_cls = ServingParams

    def serve(self, query: Query, predictions) -> PredictedResult:
        result = predictions[0]
        path = getattr(self.params, "filepath", None)
        if not path:
            return result
        try:
            with open(path) as f:
                disabled = {line.strip() for line in f if line.strip()}
        except OSError:
            # ops edits this file on a live deployment; a briefly-missing
            # file degrades to unfiltered serving, not an error per query
            logger.exception("disabled-items file unreadable; serving unfiltered")
            return result
        return PredictedResult(
            itemScores=[s for s in result.itemScores if s.item not in disabled]
        )


# -- Algorithm --------------------------------------------------------------


@dataclasses.dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 20
    # reference engine.json uses "lambda"; Python reserves it
    reg: float = 0.01
    implicitPrefs: bool = False
    alpha: float = 1.0
    seed: Optional[int] = None
    checkpointDir: Optional[str] = None
    checkpointInterval: int = 5
    persistMode: str = "auto"

    json_aliases = {"lambda": "reg"}


class ALSAlgorithm(Algorithm):
    """Explicit ALS served from device-resident factors."""

    params_cls = ALSAlgorithmParams

    def __init__(self, params=None):
        super().__init__(params)
        self._scorers: dict[int, ALSScorer] = {}

    def train(self, ctx, pd) -> ALSModel:
        raise NotImplementedError(_NOT_PORTED)

    def load_serializable_model(self, ctx, blob) -> ALSModel:
        """Bind the deploy device to the scorer (called by prepare_deploy)."""
        model = blob
        self._scorers[id(model)] = ALSScorer(ctx, model)
        return model

    def _scorer(self, model: ALSModel) -> ALSScorer:
        scorer = self._scorers.get(id(model))
        if scorer is None:
            scorer = ALSScorer(DeviceContext.create(), model)
            self._scorers[id(model)] = scorer
        return scorer

    def warmup(self, model: ALSModel) -> None:
        """Deploy/reload-time warm-up of the bucketed fast path (QueryServer
        calls this for batching deployments): the kernel builds and every
        rung launches once before the first request."""
        self._scorer(model).enable_fastpath()

    def serving_stats(self, model: ALSModel) -> Optional[dict]:
        """Fast-path counters for ``GET /`` stats (None until warm-up)."""
        scorer = self._scorers.get(id(model))
        return scorer.fastpath_stats() if scorer is not None else None

    def batch_predict(self, model: ALSModel, queries):
        """Filter-free known-user queries score in ONE device pass; the rest
        fall back to per-query predict."""
        simple, fallback = [], []
        for i, q in queries:
            u = model.user_map.get(q.user)
            if u is not None and not q.blackList and not q.whiteList:
                simple.append((i, int(u), q.num))
            else:
                fallback.append((i, q))
        by_index = dict(super().batch_predict(model, fallback)) if fallback else {}
        if simple:
            # width from the batched queries only: a fallback query's num
            # must not push the batch off the fast path
            num = max(n for _, _, n in simple)
            idx, scores = self._scorer(model).recommend_batch(
                np.asarray([u for _, u, _ in simple]), num
            )
            inv = model.item_map.inverse
            for row, (i, _, n) in enumerate(simple):
                # only slots above -1e29 carry meaning (excluded/padded
                # items score -1e30)
                by_index[i] = PredictedResult(
                    itemScores=[
                        ItemScore(item=inv[int(j)], score=float(s))
                        for j, s in zip(idx[row][:n], scores[row][:n])
                        if s > -1e29
                    ]
                )
        return list(by_index.items())

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        user_idx = model.user_map.get(query.user)
        if user_idx is None:
            logger.info("no prediction for unknown user %s", query.user)
            return PredictedResult(itemScores=[])
        exclude = None
        if query.blackList:
            exclude = model.item_map.to_index_array(query.blackList)
            exclude = exclude[exclude >= 0]
        candidates = None
        if query.whiteList:
            candidates = model.item_map.to_index_array(query.whiteList)
            candidates = candidates[candidates >= 0]
            if len(candidates) == 0:
                return PredictedResult(itemScores=[])
        idx, scores = self._scorer(model).recommend(
            int(user_idx), query.num, exclude_items=exclude, candidate_items=candidates
        )
        inv = model.item_map.inverse
        return PredictedResult(
            itemScores=[
                ItemScore(item=inv[int(i)], score=float(s))
                for i, s in zip(idx, scores)
            ]
        )


# -- Engine factory ---------------------------------------------------------


class RecommendationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=RecommendationDataSource,
            preparator_cls=ExcludeItemsPreparator,
            algorithm_cls_map={"als": ALSAlgorithm},
            serving_cls=FileFilterServing,
            query_cls=Query,
        )
