"""Engine: wires DASE components and owns train/eval execution.

Copy of ``predictionio_tpu/core/engine.py``.

Parity: ``controller/Engine.scala:82-829`` + ``EngineParams.scala:35`` +
``EngineFactory.scala:33``.  ``Engine.train`` mirrors ``Engine.object.train``
(``Engine.scala:623-710``): read → sanity-check → prepare → per-algorithm
train, with ``stop_after_read``/``stop_after_prepare`` debug interrupts
(``Engine.scala:664-688``).  ``Engine.eval`` mirrors ``Engine.object.eval``
(``Engine.scala:728-817``): per-fold train + batch predict + serving join.

``engine.json`` variants parse exactly like the reference
(``Engine.jValueToEngineParams``, ``Engine.scala:355-418``): the JSON params
of each component are bound to that component's declared ``Params`` dataclass
(Python dataclasses replace the json4s/Gson dual extractor,
``JsonExtractor.scala:59-79``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Generic, Optional, Sequence, Type, TypeVar

from predictionio_tpu_torch.core.controller import (
    Algorithm,
    DataSource,
    EmptyParams,
    Params,
    Preparator,
    SanityCheck,
    Serving,
)

logger = logging.getLogger(__name__)

Q = TypeVar("Q")
P = TypeVar("P")


class StopAfterReadInterruption(Exception):
    """Parity: Engine.scala:664 — debug interrupt after DataSource.read."""


class StopAfterPrepareInterruption(Exception):
    """Parity: Engine.scala:676 — debug interrupt after Preparator.prepare."""


def params_from_json(params_cls: Optional[Type[Params]], obj: Any) -> Params:
    """Bind a JSON object to a Params dataclass (JsonExtractor parity).

    Unknown keys are rejected so engine.json typos fail loudly, like the
    reference's typed extraction.
    """
    if params_cls is None:
        if obj:
            raise ValueError(
                f"params {sorted(obj)} supplied but the component declares no "
                "params_cls; remove them or declare a Params dataclass"
            )
        return EmptyParams()
    if obj is None:
        obj = {}
    if not dataclasses.is_dataclass(params_cls):
        raise TypeError(f"{params_cls} must be a dataclass Params")
    # json_aliases maps JSON keys that aren't valid Python identifiers
    # (e.g. the reference's "lambda") onto dataclass field names
    aliases = getattr(params_cls, "json_aliases", {})
    if aliases:
        obj = {aliases.get(k, k): v for k, v in obj.items()}
    names = {f.name for f in dataclasses.fields(params_cls)}
    unknown = set(obj) - names
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for {params_cls.__name__} "
            f"(accepted: {sorted(names)})"
        )
    return params_cls(**obj)


def params_to_json(params: Optional[Params]) -> dict:
    if params is None:
        return {}
    if dataclasses.is_dataclass(params):
        return dataclasses.asdict(params)
    return dict(params)  # type: ignore[arg-type]


@dataclasses.dataclass
class EngineParams:
    """One full pipeline configuration (parity: EngineParams.scala:35)."""

    data_source_params: Params = dataclasses.field(default_factory=EmptyParams)
    preparator_params: Params = dataclasses.field(default_factory=EmptyParams)
    algorithm_params_list: list[tuple[str, Params]] = dataclasses.field(
        default_factory=list
    )
    serving_params: Params = dataclasses.field(default_factory=EmptyParams)

    def to_json_strings(self) -> dict[str, str]:
        """Serialized form stored on EngineInstance rows."""
        return {
            "data_source_params": json.dumps(params_to_json(self.data_source_params)),
            "preparator_params": json.dumps(params_to_json(self.preparator_params)),
            "algorithms_params": json.dumps(
                [
                    {"name": n, "params": params_to_json(p)}
                    for n, p in self.algorithm_params_list
                ]
            ),
            "serving_params": json.dumps(params_to_json(self.serving_params)),
        }


class Engine(Generic[Q, P]):
    """Parity: controller/Engine.scala:82 (the DASE wiring object)."""

    def __init__(
        self,
        data_source_cls: Type[DataSource],
        preparator_cls: Type[Preparator],
        algorithm_cls_map: dict[str, Type[Algorithm]],
        serving_cls: Type[Serving],
        query_cls: Optional[type] = None,
    ):
        self.data_source_cls = data_source_cls
        self.preparator_cls = preparator_cls
        self.algorithm_cls_map = dict(algorithm_cls_map)
        self.serving_cls = serving_cls
        self.query_cls = query_cls

    # -- engine.json binding (Engine.jValueToEngineParams parity) ----------
    @staticmethod
    def _params_cls_of(component_cls) -> Optional[Type[Params]]:
        return getattr(component_cls, "params_cls", None)

    def params_from_variant(self, variant: dict) -> EngineParams:
        ds = params_from_json(
            self._params_cls_of(self.data_source_cls),
            (variant.get("datasource") or {}).get("params"),
        )
        prep = params_from_json(
            self._params_cls_of(self.preparator_cls),
            (variant.get("preparator") or {}).get("params"),
        )
        algo_list: list[tuple[str, Params]] = []
        for spec in variant.get("algorithms") or []:
            name = spec.get("name")
            if name not in self.algorithm_cls_map:
                raise ValueError(
                    f"algorithm {name!r} not registered in engine "
                    f"(available: {sorted(self.algorithm_cls_map)})"
                )
            algo_list.append(
                (
                    name,
                    params_from_json(
                        self._params_cls_of(self.algorithm_cls_map[name]),
                        spec.get("params"),
                    ),
                )
            )
        if not algo_list:
            # default: first registered algorithm with default params
            name = next(iter(self.algorithm_cls_map))
            algo_list = [
                (name, params_from_json(self._params_cls_of(self.algorithm_cls_map[name]), {}))
            ]
        serving = params_from_json(
            self._params_cls_of(self.serving_cls),
            (variant.get("serving") or {}).get("params"),
        )
        return EngineParams(ds, prep, algo_list, serving)

    def params_from_instance_strings(self, strings: dict[str, str]) -> EngineParams:
        """Rebuild EngineParams from EngineInstance rows (deploy path).

        Parity: ``Engine.engineInstanceToEngineParams`` (Engine.scala:420-490).
        """
        ds = params_from_json(
            self._params_cls_of(self.data_source_cls),
            json.loads(strings.get("data_source_params") or "{}"),
        )
        prep = params_from_json(
            self._params_cls_of(self.preparator_cls),
            json.loads(strings.get("preparator_params") or "{}"),
        )
        algo_list = []
        for spec in json.loads(strings.get("algorithms_params") or "[]"):
            name = spec["name"]
            algo_list.append(
                (
                    name,
                    params_from_json(
                        self._params_cls_of(self.algorithm_cls_map[name]),
                        spec.get("params"),
                    ),
                )
            )
        serving = params_from_json(
            self._params_cls_of(self.serving_cls),
            json.loads(strings.get("serving_params") or "{}"),
        )
        return EngineParams(ds, prep, algo_list, serving)

    # -- component instantiation (Doer.apply parity, AbstractDoer.scala:46) -
    def make_algorithms(self, engine_params: EngineParams) -> list[Algorithm]:
        return [
            self.algorithm_cls_map[name](params)
            for name, params in engine_params.algorithm_params_list
        ]

    def make_serving(self, engine_params: EngineParams) -> Serving:
        return self.serving_cls(engine_params.serving_params)

    # -- train (Engine.object.train parity, Engine.scala:623-710) ----------
    def prepare_data(
        self,
        ctx,
        engine_params: EngineParams,
        skip_sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
    ):
        """Read + prepare (the DS→Prep half of train)."""
        data_source = self.data_source_cls(engine_params.data_source_params)
        td = data_source.read_training(ctx)
        if not skip_sanity_check and isinstance(td, SanityCheck):
            logger.info("sanity-checking training data %s", type(td).__name__)
            td.sanity_check()
        if stop_after_read:
            raise StopAfterReadInterruption()
        preparator = self.preparator_cls(engine_params.preparator_params)
        pd = preparator.prepare(ctx, td)
        if not skip_sanity_check and isinstance(pd, SanityCheck):
            pd.sanity_check()
        if stop_after_prepare:
            raise StopAfterPrepareInterruption()
        return pd

    def train(
        self,
        ctx,
        engine_params: EngineParams,
        skip_sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
        algorithms: Optional[Sequence[Algorithm]] = None,
    ) -> list:
        pd = self.prepare_data(
            ctx,
            engine_params,
            skip_sanity_check=skip_sanity_check,
            stop_after_read=stop_after_read,
            stop_after_prepare=stop_after_prepare,
        )
        if algorithms is None:
            algorithms = self.make_algorithms(engine_params)
        models = []
        for algo in algorithms:
            model = algo.train(ctx, pd)
            if not skip_sanity_check and isinstance(model, SanityCheck):
                model.sanity_check()
            models.append(model)
        return models

    # -- eval (Engine.object.eval parity, Engine.scala:728-817) ------------
    def eval(
        self, ctx, engine_params: EngineParams
    ) -> list[tuple[Any, Sequence[tuple[Q, P, Any]]]]:
        """Per evaluation fold: (query, prediction, actual) triples.

        Returns [(fold_info, [(q, p, a), ...])] — the input MetricEvaluator
        scores (reference shape: RDD[(Q, P, A)] per fold).
        """
        data_source = self.data_source_cls(engine_params.data_source_params)
        folds = data_source.read_eval(ctx)
        preparator = self.preparator_cls(engine_params.preparator_params)
        serving = self.make_serving(engine_params)
        results = []
        for fold_idx, (td, qa_list) in enumerate(folds):
            pd = preparator.prepare(ctx, td)
            algorithms = self.make_algorithms(engine_params)
            models = [algo.train(ctx, pd) for algo in algorithms]
            supplemented = [
                (i, serving.supplement(q)) for i, (q, _) in enumerate(qa_list)
            ]
            # per-algorithm batch predict, then join per query index
            # (parity: algo.batchPredictBase + union/groupByKey,
            #  Engine.scala:781-794)
            per_algo: list[dict[int, P]] = []
            for algo, model in zip(algorithms, models):
                preds = algo.batch_predict(model, supplemented)
                per_algo.append(dict(preds))
            triples = []
            for i, (q, a) in enumerate(qa_list):
                predictions = [d[i] for d in per_algo if i in d]
                p = serving.serve(supplemented[i][1], predictions)
                triples.append((q, p, a))
            results.append((fold_idx, triples))
        return results


class EngineFactory:
    """Parity: EngineFactory.scala:33 — named constructor for an Engine.

    Subclasses override :meth:`apply`; the workflow resolves the factory by
    dotted path from ``engine.json``'s ``engineFactory`` field.
    """

    @classmethod
    def apply(cls) -> Engine:
        raise NotImplementedError
