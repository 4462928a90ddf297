"""Recommendation engine template: ALS trained and served on the card.

Counterpart of ``predictionio_tpu/templates/recommendation.py`` (parity:
``examples/scala-parallel-recommendation/``): the DataSource reads ``rate``
(graded) and ``buy`` (weight 4.0) events, or the ``eventRatings`` mapping,
and splits them into k folds for evaluation (``read_eval``);
:class:`ExcludeItemsPreparator` drops file-listed items;
``ALSAlgorithm.train`` runs :func:`~predictionio_tpu_torch.models.als.
train_als` (the dense solver through the training kernel, or, under
``PIO_ALS_SOLVER=segment``, the segment solver through the gather kernel)
and its deploy and predict
methods serve through the score kernel; :class:`FileFilterServing` filters
a per-query disabled-items file. ``persistMode: "checkpoint"`` publishes a
:class:`~predictionio_tpu_torch.models.als.CheckpointedALSModel` (and with
it the quantized variant behind its gate). :class:`PrecisionAtK`,
:class:`NDCGAtK`, :class:`MAPAtK` and :class:`RecommendationEvaluation`
are what ``pio eval`` runs. A set ``eventWindow`` compacts the event store
before the read (``core/self_cleaning.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
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
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.core.evaluation import EngineParamsGenerator, Evaluation
from predictionio_tpu_torch.core.metrics import OptionAverageMetric
from predictionio_tpu_torch.core.persistence import RETRAIN
from predictionio_tpu_torch.core.self_cleaning import SelfCleaningDataSource
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.batch import Interactions, merge_interactions
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSModel,
    ALSScorer,
    CheckpointedALSModel,
    train_als,
)

logger = logging.getLogger(__name__)


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


@dataclasses.dataclass
class TrainingData(SanityCheck):
    interactions: Interactions

    def sanity_check(self):
        if len(self.interactions) == 0:
            raise ValueError("No rating events found; check appName/eventNames.")


PreparedData = TrainingData


# -- DataSource -------------------------------------------------------------


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = "default"
    evalParams: Optional[dict] = None  # {"kFold": 5, "queryNum": 10}
    # SelfCleaningDataSource hook: {"duration": "30 days",
    # "removeDuplicates": true, "compressProperties": true}
    eventWindow: Optional[dict] = None
    # event name → fixed rating value, replacing the default rate+buy read
    # (reading-custom-events: like→4.0/dislike→1.0; train-with-view-event:
    # {"view": 1.0} with implicitPrefs on the algorithm)
    eventRatings: Optional[dict] = None


def _merge_part_reads(read_fn, part_kwargs: list) -> Interactions:
    """Read one Interactions per filter dict, drop empties, merge the rest
    into shared id maps (``parallel/ingest.py:389-397``)."""
    reads = [read_fn(p) for p in part_kwargs]
    reads = [r for r in reads if len(r.rating)] or reads[:1]
    return reads[0] if len(reads) == 1 else merge_interactions(reads)


class RecommendationDataSource(SelfCleaningDataSource, DataSource):
    params_cls = DataSourceParams

    BUY_WEIGHT = 4.0  # parity: buy events count as rating 4.0

    def _part_filters(self) -> list[dict]:
        """The per-event-type read specs (rate+buy default, or the
        eventRatings custom mapping)."""
        if self.params.eventRatings:
            return [
                dict(
                    entity_type="user",
                    event_names=[name],
                    target_entity_type="item",
                    default_rating=float(value),
                )
                for name, value in self.params.eventRatings.items()
            ]
        return [
            dict(
                entity_type="user",
                event_names=["rate"],
                target_entity_type="item",
                rating_key="rating",
                default_rating=self.BUY_WEIGHT,
            ),
            dict(
                entity_type="user",
                event_names=["buy"],
                target_entity_type="item",
                default_rating=self.BUY_WEIGHT,
            ),
        ]

    def read_training(self, ctx) -> TrainingData:
        self.clean_persisted_events()  # no-op without an eventWindow param
        # one columnar read per event type, merged into shared id maps
        return TrainingData(
            _merge_part_reads(
                lambda p: store.PEventStore.find_interactions(self.params.appName, **p),
                self._part_filters(),
            )
        )

    def read_eval(self, ctx):
        """k-fold split (parity: DataSource.scala:83 readEval kFold): row i
        is held out in fold i % kFold; each held-out user becomes one query
        whose actual is its held-out items."""
        ep = self.params.evalParams or {}
        k_fold = int(ep.get("kFold", 3))
        query_num = int(ep.get("queryNum", 10))
        inter = _merge_part_reads(
            lambda p: store.PEventStore.find_interactions(self.params.appName, **p),
            self._part_filters(),
        )
        fold_of = np.arange(len(inter)) % k_fold
        inv_u, inv_i = inter.user_map.inverse, inter.item_map.inverse
        folds = []
        for f in range(k_fold):
            train_sel = fold_of != f
            td = TrainingData(inter.subset(train_sel))
            # group held-out items per user in one sorted pass
            tu, ti = inter.user[~train_sel], inter.item[~train_sel]
            order = np.argsort(tu, kind="stable")
            tu, ti = tu[order], ti[order]
            qa = []
            if len(tu):
                bounds = np.flatnonzero(np.diff(tu)) + 1
                for us, items in zip(np.split(tu, bounds), np.split(ti, bounds)):
                    qa.append((
                        Query(user=inv_u[int(us[0])], num=query_num),
                        [inv_i[int(i)] for i in items],  # actual: held out
                    ))
            folds.append((td, qa))
        return folds


# -- Preparator (customize-data-prep variant) -------------------------------


@dataclasses.dataclass
class PreparatorParams(Params):
    # file of item ids (one per line) to drop from training; None → identity
    # (parity: customize-data-prep Preparator.scala:38-44)
    filepath: Optional[str] = None


class ExcludeItemsPreparator(Preparator):
    """Drop file-listed items from training data before the algorithm; with
    ``filepath=None`` this is the identity."""

    params_cls = PreparatorParams

    def prepare(self, ctx, td: TrainingData) -> TrainingData:
        # getattr: a caller-constructed EngineParams may carry EmptyParams
        path = getattr(self.params, "filepath", None)
        if not path:
            return td
        with open(path) as f:
            no_train = {line.strip() for line in f if line.strip()}
        if not no_train:
            return td
        inter = td.interactions
        drop_idx = inter.item_map.to_index_array(sorted(no_train))
        # drop_items compacts the item id space: a filtered item must be
        # unrecommendable, not a zero-factor candidate still in the map
        return TrainingData(inter.drop_items(drop_idx[drop_idx >= 0]))


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
    # mid-training checkpoint/resume (reference knob: ALS
    # setCheckpointInterval, ALSAlgorithm.scala:85; here it persists progress)
    checkpointDir: Optional[str] = None
    checkpointInterval: int = 5
    # deploy-time persistence mode (the reference's three modes):
    #   auto       — pickled blob in MODELDATA (default)
    #   checkpoint — PersistentModel manifest + sealed factor store
    #   retrain    — retrain on deploy (Unit-model mode)
    persistMode: str = "auto"

    json_aliases = {"lambda": "reg"}


class ALSAlgorithm(Algorithm):
    """Explicit/implicit ALS trained on the card, served from device-resident
    factors."""

    params_cls = ALSAlgorithmParams

    VALID_PERSIST_MODES = ("auto", "checkpoint", "retrain")

    def __init__(self, params=None):
        super().__init__(params)
        self._scorers: dict[int, ALSScorer] = {}

    def _config(self) -> ALSConfig:
        p = self.params
        if p.persistMode not in self.VALID_PERSIST_MODES:
            raise ValueError(
                f"persistMode {p.persistMode!r} not in {self.VALID_PERSIST_MODES}"
            )
        return ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.reg,
            implicit=p.implicitPrefs,
            alpha=p.alpha,
            seed=3 if p.seed is None else p.seed,
            checkpoint_dir=p.checkpointDir,
            checkpoint_interval=p.checkpointInterval,
        )

    def train(self, ctx, pd: PreparedData) -> ALSModel:
        if self.params.numIterations > 30:
            logger.warning(
                "numIterations %d > 30 (reference guardrail: "
                "ALSAlgorithm.scala:44-50)", self.params.numIterations,
            )
        model = train_als(ctx, pd.interactions, self._config())
        if self.params.persistMode == "checkpoint":
            model = CheckpointedALSModel(
                model.user_factors, model.item_factors,
                model.user_map, model.item_map, model.config,
                sharding_plan=model.sharding_plan,
            )
        self._scorers[id(model)] = ALSScorer(ctx, model)
        return model

    def make_serializable_model(self, model):
        if self.params.persistMode == "retrain":
            return RETRAIN
        return super().make_serializable_model(model)

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

    def apply_delta_rows(self, model: ALSModel, user_idx, user_rows, item_idx=None,
                         item_rows=None) -> Optional[dict]:
        """A streaming delta's rows into the card's scorers of ``model``
        (the query server's apply; the JAX server looks for a ``_fastpath``
        on the algorithm, which this template does not have)."""
        scorer = self._scorers.get(id(model))
        if scorer is None:
            return None
        return scorer.apply_delta_rows(user_idx, user_rows, item_idx, item_rows)

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


# -- Evaluation (parity: examples/.../Evaluation.scala Precision@K) ----------


class PrecisionAtK(OptionAverageMetric):
    """Fraction of top-k recommendations that are in the held-out actuals.

    Users with no recommendations score None and are excluded, matching the
    reference's OptionAverageMetric usage.
    """

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_one(self, query, prediction, actual) -> Optional[float]:
        if not prediction.itemScores:
            return None
        top = [s.item for s in prediction.itemScores[: self.k]]
        positives = set(actual)
        if not top or not positives:
            return None
        # tp / min(k, |positives|) — reference formula (Evaluation.scala)
        tp = sum(1 for it in top if it in positives)
        return tp / min(self.k, len(positives))


class NDCGAtK(OptionAverageMetric):
    """Normalized discounted cumulative gain over the top-k ranking: gain 1
    for each held-out actual, ideal DCG over min(k, |positives|)."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"NDCG@{self.k}"

    def calculate_one(self, query, prediction, actual) -> Optional[float]:
        top = [s.item for s in prediction.itemScores[: self.k]]
        positives = set(actual)
        if not top or not positives:
            return None
        dcg = sum(1.0 / math.log2(i + 2) for i, it in enumerate(top) if it in positives)
        ideal = sum(1.0 / math.log2(i + 2) for i in range(min(self.k, len(positives))))
        return dcg / ideal


class MAPAtK(OptionAverageMetric):
    """Mean average precision at k (average of precision at each hit rank)."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"MAP@{self.k}"

    def calculate_one(self, query, prediction, actual) -> Optional[float]:
        top = [s.item for s in prediction.itemScores[: self.k]]
        positives = set(actual)
        if not top or not positives:
            return None
        hits = 0
        precision_sum = 0.0
        for i, it in enumerate(top):
            if it in positives:
                hits += 1
                precision_sum += hits / (i + 1)
        return precision_sum / min(self.k, len(positives))


_METRICS = {"precision": PrecisionAtK, "ndcg": NDCGAtK, "map": MAPAtK}


class RecommendationEvaluation(Evaluation, EngineParamsGenerator):
    """Grid over ALS rank (parity: Evaluation.scala + ParamsList): kFold 3,
    5 iterations a candidate. ``metric`` selects the tuning objective
    ("precision", "ndcg", "map"); the other two report beside it."""

    def __init__(self, app_name: str = "default", ranks=(4, 8), k: int = 10,
                 metric: str = "precision"):
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {sorted(_METRICS)}, got {metric!r}")
        self.engine = RecommendationEngine.apply()
        self.metric = _METRICS[metric](k=k)
        self.metrics = [cls(k=k) for name, cls in _METRICS.items() if name != metric]
        self.engine_params_list = [
            self.engine.params_from_variant({
                "datasource": {"params": {
                    "appName": app_name, "evalParams": {"kFold": 3, "queryNum": k}}},
                "algorithms": [{"name": "als", "params": {"rank": r, "numIterations": 5}}],
            })
            for r in ranks
        ]


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
