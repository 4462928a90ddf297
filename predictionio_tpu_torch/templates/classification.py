"""Classification engine template: NaiveBayes + RandomForest over properties.

Counterpart of ``predictionio_tpu/templates/classification.py`` (parity:
``examples/scala-parallel-classification/``, both variants folded in). The
class statistics and the trees are computed on the context's device
(``models/naive_bayes.py``, ``models/random_forest.py``); a query is
answered on the host, as the JAX package answers it.

* DataSource reads entity properties via ``aggregate_properties`` — numeric
  feature attributes + a label attribute (base template reads ``attr0-2`` +
  ``plan``; the reading-custom-properties variant renames them — here both
  are just params).
* NaiveBayesAlgorithm (MLlib ``NaiveBayes.train`` parity →
  :func:`train_multinomial_nb`) and RandomForestAlgorithm (add-algorithm
  variant parity → :func:`train_random_forest`), co-registered so a variant
  can select either or both.
* Query carries the feature values; PredictedResult carries the label.
"""

from __future__ import annotations

import dataclasses
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
from predictionio_tpu_torch.core.evaluation import EngineParamsGenerator, Evaluation
from predictionio_tpu_torch.core.metrics import AverageMetric
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.models.naive_bayes import MultinomialNBModel, train_multinomial_nb
from predictionio_tpu_torch.models.random_forest import (
    RandomForestModel,
    RFConfig,
    train_random_forest,
)


@dataclasses.dataclass
class Query:
    features: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PredictedResult:
    label: str


@dataclasses.dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # (N, F)
    labels: list[str]

    def sanity_check(self):
        if len(self.labels) == 0:
            raise ValueError("No labeled entities found; check appName/attributes.")


PreparedData = TrainingData


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = "default"
    entityType: str = "user"
    attributes: tuple = ("attr0", "attr1", "attr2")
    labelAttribute: str = "plan"
    evalK: Optional[int] = None  # k-fold for read_eval


class ClassificationDataSource(DataSource):
    params_cls = DataSourceParams

    def _read(self) -> TrainingData:
        props = PEventStore.aggregate_properties(
            self.params.appName,
            self.params.entityType,
            required=list(self.params.attributes) + [self.params.labelAttribute],
        )
        features = []
        labels = []
        for entity_id, pm in props.items():
            features.append([pm.get_double(a) for a in self.params.attributes])
            labels.append(str(pm.require(self.params.labelAttribute)))
        return TrainingData(
            features=np.asarray(features, np.float32).reshape(
                len(labels), len(self.params.attributes)
            ),
            labels=labels,
        )

    def read_training(self, ctx) -> TrainingData:
        return self._read()

    def read_eval(self, ctx):
        td = self._read()
        k = self.params.evalK or 3
        n = len(td.labels)
        fold_of = np.arange(n) % k
        folds = []
        for f in range(k):
            tr = fold_of != f
            te = ~tr
            folds.append(
                (
                    TrainingData(td.features[tr], [l for l, m in zip(td.labels, tr) if m]),
                    [
                        (Query(features=list(map(float, td.features[i]))), td.labels[i])
                        for i in np.nonzero(te)[0]
                    ],
                )
            )
        return folds



@dataclasses.dataclass
class NaiveBayesParams(Params):
    # json alias keeps reference engine.json ({"lambda": 1.0}) loading
    smoothing: float = 1.0

    json_aliases = {"lambda": "smoothing"}


class NaiveBayesAlgorithm(Algorithm):
    params_cls = NaiveBayesParams

    def train(self, ctx, pd: PreparedData) -> MultinomialNBModel:
        return train_multinomial_nb(
            ctx, pd.features, pd.labels, smoothing=self.params.smoothing
        )

    def predict(self, model: MultinomialNBModel, query: Query) -> PredictedResult:
        return PredictedResult(
            label=model.predict(np.asarray(query.features, np.float32))
        )


@dataclasses.dataclass
class RandomForestParams(Params):
    numTrees: int = 10
    maxDepth: int = 5
    numBins: int = 32
    featureFraction: float = 1.0
    seed: int = 0


class RandomForestAlgorithm(Algorithm):
    params_cls = RandomForestParams

    def train(self, ctx, pd: PreparedData) -> RandomForestModel:
        return train_random_forest(
            ctx,
            pd.features,
            pd.labels,
            RFConfig(
                n_trees=self.params.numTrees,
                max_depth=self.params.maxDepth,
                n_bins=self.params.numBins,
                feature_fraction=self.params.featureFraction,
                seed=self.params.seed,
            ),
        )

    def predict(self, model: RandomForestModel, query: Query) -> PredictedResult:
        return PredictedResult(
            label=model.predict(np.asarray(query.features, np.float32))
        )


class Accuracy(AverageMetric):
    """Parity: examples/.../PrecisionEvaluation.scala accuracy metric."""

    def calculate_one(self, query, prediction, actual) -> float:
        return 1.0 if prediction.label == actual else 0.0


class ClassificationEvaluation(Evaluation, EngineParamsGenerator):
    def __init__(self, app_name: str = "default", smoothing_grid=(0.5, 1.0, 5.0)):
        self.engine = ClassificationEngine.apply()
        self.metric = Accuracy()
        self.engine_params_list = [
            self.engine.params_from_variant(
                {
                    "datasource": {"params": {"appName": app_name}},
                    "algorithms": [
                        {"name": "naive", "params": {"lambda": s}}
                    ],
                }
            )
            for s in smoothing_grid
        ]


class ClassificationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_cls=ClassificationDataSource,
            preparator_cls=IdentityPreparator,
            algorithm_cls_map={
                "naive": NaiveBayesAlgorithm,
                "randomforest": RandomForestAlgorithm,
            },
            serving_cls=FirstServing,
            query_cls=Query,
        )
