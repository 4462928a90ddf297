"""Similar-user engine template: who to follow, from follow events.

Counterpart of ``predictionio_tpu/templates/similaruser.py`` (parity:
``examples/scala-parallel-similarproduct/recommended-user/``, the
reference's user-to-user variant of the similar-product engine). Training
runs implicit ALS on the context's device (the training kernel on the
card); queries are answered on the host with numpy, as the JAX package
answers them.

* DataSource reads ``user follow user`` events
  (``DataSource.scala:56-80``); no ``$set`` user events are required —
  the id space comes from the follow graph itself (the rid-user-set-event
  simplification applied to this variant).
* :class:`SimilarUserALSAlgorithm` — implicit ALS over the
  follower × followed matrix (``ALSAlgorithm.scala:112-123``
  ``ALS.trainImplicit`` with weight 1 per follow); a query's users are
  looked up on the *followed* factor side and similarity is the SUM of
  cosines against each query user (``ALSAlgorithm.scala:156-165``),
  keeping only positive scores.
* Query supports ``num``, ``whiteList``, ``blackList``; query users are
  themselves excluded (``isCandidateSimilarUser``).
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
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.models.als import ALSConfig, ALSModel, train_als

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Query:
    users: list[str] = dataclasses.field(default_factory=list)
    num: int = 10
    whiteList: Optional[list[str]] = None
    blackList: Optional[list[str]] = None


@dataclasses.dataclass
class SimilarUserScore:
    user: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    similarUserScores: list[SimilarUserScore]


@dataclasses.dataclass
class TrainingData(SanityCheck):
    follows: Interactions  # follower × followed, weight 1 per follow

    def sanity_check(self):
        if len(self.follows) == 0:
            raise ValueError("No follow events found; check appName.")


PreparedData = TrainingData


@dataclasses.dataclass
class SimilarUserDataSourceParams(Params):
    appName: str = "default"
    eventNames: tuple = ("follow",)


class SimilarUserDataSource(DataSource):
    params_cls = SimilarUserDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        from predictionio_tpu_torch.parallel.ingest import template_interactions

        # one process: a plain columnar read; under a launch the 1/N
        # entity-keyed sharded read (the trainers dispatch on type)
        follows = template_interactions(
            self.params.appName,
            entity_type="user",
            event_names=list(self.params.eventNames),
            target_entity_type="user",
            default_rating=1.0,
        )
        return TrainingData(follows=follows)


@dataclasses.dataclass
class SimilarUserALSParams(Params):
    rank: int = 10
    numIterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None

    json_aliases = {"lambda": "reg"}


@dataclasses.dataclass
class SimilarUserModel:
    als: ALSModel
    norm_factors: np.ndarray  # L2-normalized followed-user factors


class SimilarUserALSAlgorithm(Algorithm):
    params_cls = SimilarUserALSParams

    def train(self, ctx, pd: PreparedData) -> SimilarUserModel:
        p = self.params
        als = train_als(
            ctx,
            pd.follows,
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
        return SimilarUserModel(
            als=als, norm_factors=als.item_factors / np.maximum(norms, 1e-9)
        )

    def predict(self, model: SimilarUserModel, query: Query) -> PredictedResult:
        # the followed side of the matrix is the recommendable id space
        followed_map = model.als.item_map
        idxs = [followed_map[u] for u in query.users if u in followed_map]
        if not idxs:
            logger.info("no factor vector for any query user; empty result")
            return PredictedResult(similarUserScores=[])
        # SUM of cosines against each query user (reference sums, not means)
        q = model.norm_factors[idxs].sum(axis=0)
        sims = model.norm_factors @ q
        n = len(sims)
        drop = np.zeros(n, bool)
        drop[idxs] = True  # query users are not their own recommendations
        if query.blackList:
            bl = followed_map.to_index_array(query.blackList)
            drop[bl[bl >= 0]] = True
        if query.whiteList:
            wl = followed_map.to_index_array(query.whiteList)
            keep = np.zeros(n, bool)
            keep[wl[wl >= 0]] = True
            drop |= ~keep
        drop |= sims <= 0  # reference keeps only positive similarity
        sims = np.where(drop, -np.inf, sims)
        k = min(query.num, n)
        top = np.argpartition(-sims, k - 1)[:k]
        top = top[np.argsort(-sims[top])]
        inv = followed_map.inverse
        return PredictedResult(
            similarUserScores=[
                SimilarUserScore(inv[int(i)], float(sims[i]))
                for i in top
                if np.isfinite(sims[i])
            ]
        )


class SimilarUserEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=SimilarUserDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={"als": SimilarUserALSAlgorithm},
            serving_cls=FirstServing,
            query_cls=Query,
        )
