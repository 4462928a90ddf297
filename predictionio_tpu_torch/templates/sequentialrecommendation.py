"""Sequential-recommendation template: next-item prediction over histories.

Counterpart of ``predictionio_tpu/templates/sequentialrecommendation.py``:
at query time the user's recent history is read live from the event store
(``LEventStore.find_by_entity``, newest first, up to ``max_len`` events),
and :meth:`~predictionio_tpu_torch.models.sequential.SASRecModel.recommend`
ranks the next item through the causal transformer on the card.

Training (``SASRecAlgorithm.train``, reached from ``core.workflow.run_train``)
reads the app's interactions through :class:`SequentialDataSource` and runs
``models.sequential.train_sasrec`` on the context's device: on the card at
a ``maxLen`` of 256 or more (a multiple of 128) every layer's attention
runs the flash kernels, forward and backward. Deploy binds the model's
weights to the deploy device once (``load_serializable_model``); with
``batching=True`` the base ``batch_predict`` loops over
:meth:`SASRecAlgorithm.predict`, as in the JAX package. A model trained by
the JAX package can still be carried across with
``models.sequential.sasrec_params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

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
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.models.sequential import (
    SASRecConfig,
    SASRecModel,
    train_sasrec,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Query:
    user: str
    num: int = 10


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

    def sanity_check(self):
        if len(self.interactions) == 0:
            raise ValueError("No interaction events found; check appName.")


@dataclasses.dataclass
class SeqDataSourceParams(Params):
    appName: str = "default"
    eventNames: tuple = ("view", "buy", "rate")


class SequentialDataSource(DataSource):
    params_cls = SeqDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        # the single-host read of the JAX package's template_interactions
        return TrainingData(
            interactions=store.PEventStore.find_interactions(
                self.params.appName,
                entity_type="user",
                event_names=list(self.params.eventNames),
                target_entity_type="item",
            )
        )


@dataclasses.dataclass
class SASRecParams(Params):
    appName: str = "default"
    eventNames: tuple = ("view", "buy", "rate")
    dModel: int = 32
    numLayers: int = 2
    numHeads: int = 2
    maxLen: int = 32
    epochs: int = 50
    batchSize: int = 128
    lr: float = 0.005
    seed: int = 0
    numExperts: int = 0
    expertCapacity: float = 1.25
    moeAuxWeight: float = 0.01
    seqParallel: bool = False
    checkpointDir: Optional[str] = None
    checkpointInterval: int = 10


class SASRecAlgorithm(Algorithm):
    params_cls = SASRecParams

    def train(self, ctx, pd: TrainingData) -> SASRecModel:
        p = self.params
        return train_sasrec(
            ctx,
            pd.interactions,
            SASRecConfig(
                d_model=p.dModel,
                n_layers=p.numLayers,
                n_heads=p.numHeads,
                max_len=p.maxLen,
                epochs=p.epochs,
                batch_size=p.batchSize,
                lr=p.lr,
                seed=p.seed,
                n_experts=p.numExperts,
                expert_capacity=p.expertCapacity,
                moe_aux_weight=p.moeAuxWeight,
                seq_parallel=p.seqParallel,
                checkpoint_dir=p.checkpointDir,
                checkpoint_interval=p.checkpointInterval,
            ),
        )

    def load_serializable_model(self, ctx, blob: SASRecModel) -> SASRecModel:
        """Place the weights on the deploy device once (prepare_deploy)."""
        blob.bind(ctx.device)
        return blob

    def _history(self, user: str, limit: int) -> list[str]:
        """Live recent-items lookup, oldest→newest (serving-time read)."""
        try:
            events = store.LEventStore.find_by_entity(
                self.params.appName,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.eventNames),
                target_entity_type="item",
                limit=limit,
                latest=True,
            )
        except Exception:
            logger.exception("history lookup failed for %s", user)
            return []
        return [
            e.target_entity_id for e in reversed(events) if e.target_entity_id
        ]

    def predict(self, model: SASRecModel, query: Query) -> PredictedResult:
        history = self._history(query.user, model.config.max_len)
        items, scores = model.recommend(history, query.num)
        return PredictedResult(
            itemScores=[
                ItemScore(i, float(s)) for i, s in zip(items, scores)
            ]
        )


class SequentialRecommendationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=SequentialDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={"sasrec": SASRecAlgorithm},
            serving_cls=FirstServing,
            query_cls=Query,
        )
