"""Evaluation and hyperparameter tuning: grid search over EngineParams, and
the quantized publish gate's overlap.

Counterpart of ``predictionio_tpu/core/evaluation.py``. Parity:

* :func:`quantized_topk_overlap` — the ``PIO_QUANT_MIN_OVERLAP`` publish
  gate's metric, in host numpy as in the JAX package (``:38-80``), so both
  packages refuse the same generations;
* :func:`recall_at_k` — the ``PIO_IVF_MIN_RECALL`` publish gate's metric;
* :class:`Evaluation` — binds an engine to metric(s)
  (``controller/Evaluation.scala:34``);
* :class:`EngineParamsGenerator` — the candidate grid
  (``controller/EngineParamsGenerator.scala:30``);
* :class:`MetricEvaluator` — scores every candidate, tracks the best, renders
  a results summary and optional ``best.json``
  (``controller/MetricEvaluator.scala:116-263``);
* :func:`run_evaluation` — the workflow entry writing an EvaluationInstance
  (``workflow/CoreWorkflow.runEvaluation``, CoreWorkflow.scala:104-164);
* :class:`FastEvalCache` — memoizes DS/Prep/train stage results across
  candidates sharing a params prefix (``FastEvalEngine.scala:92-266``), so
  the data source's folds are read once for the whole grid.

Each candidate trains one model a fold on ``ctx.device`` (the training
kernel on the card) and scores the fold's queries through the algorithm's
``batch_predict`` (the score kernel, in chunks of the top rung). One card
is one process, so the coordinator-only writes of the JAX package's
multi-host runs have no counterpart. :func:`recall_at_k` is the IVF
publish gate's metric (``:82-118``), in host numpy like the overlap.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.core.engine import Engine, EngineParams, params_to_json
from predictionio_tpu_torch.core.metrics import Metric
from predictionio_tpu_torch.core.persistence import resolve_class
from predictionio_tpu_torch.data.storage.base import EvaluationInstance
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext

logger = logging.getLogger(__name__)
UTC = _dt.timezone.utc


def quantized_topk_overlap(
    user_factors,
    item_factors,
    user_q,
    user_scale,
    item_q,
    item_scale,
    k: int = 100,
    sample: int = 256,
) -> float:
    """Mean top-k overlap of quantized vs fp32 scoring — the publish gate.

    For an evenly-spaced deterministic sample of users, ranks the catalog
    with the fp32 factors and with the dequantized quantized variant
    (``ops/quantize.py``; bf16 as its uint16 bits, dequantized exactly), and
    returns the mean ``|topk ∩ topk_q| / k``
    over the sample.  A quantized generation whose overlap falls below
    ``PIO_QUANT_MIN_OVERLAP`` is refused at publish (``models/als.py``) —
    serving keeps the fp32 factors, so a lossy quantization can never
    silently change what users are recommended.  Host numpy throughout:
    this runs once per publish, off the serving path.
    """
    import numpy as np

    from predictionio_tpu_torch.ops.quantize import dequantize_factors

    U = np.asarray(user_factors, np.float32)
    V = np.asarray(item_factors, np.float32)
    n_users, n_items = U.shape[0], V.shape[0]
    k = min(k, n_items)
    n = min(max(1, sample), n_users)
    users = np.unique(
        np.linspace(0, n_users - 1, n).round().astype(np.int64)
    )
    Uq = dequantize_factors(user_q, user_scale)
    Vq = dequantize_factors(item_q, item_scale)
    ref = np.argpartition(-(U[users] @ V.T), k - 1, axis=1)[:, :k]
    quant = np.argpartition(-(Uq[users] @ Vq.T), k - 1, axis=1)[:, :k]
    overlaps = [
        len(np.intersect1d(r, q, assume_unique=True)) / k
        for r, q in zip(ref, quant)
    ]
    return float(np.mean(overlaps))


class EngineParamsGenerator:
    """Parity: EngineParamsGenerator.scala:30."""

    engine_params_list: list[EngineParams] = []


class Evaluation:
    """Parity: Evaluation.scala:34 — engine + metric(s) binding."""

    engine: Engine = None
    metric: Metric = None
    metrics: Optional[list[Metric]] = None  # optional extra columns

    @property
    def all_metrics(self) -> list[Metric]:
        extra = self.metrics or []
        return [self.metric] + [m for m in extra if m is not self.metric]



def recall_at_k(exact_idx, approx_idx, k: int) -> float:
    """Mean recall@k of an approximate ranking against the exact one.

    ``exact_idx``/``approx_idx`` are ``(rows, ≥k)`` integer id matrices.
    Per row, recall is ``|exact[:k] ∩ approx[:k]| / min(k, real exact
    ids)``: padding slots (negative ids, or ``PAD_SENTINEL``) are left out
    of both sides and the denominator shrinks with them. Set intersection
    makes the metric independent of tie order. The ``PIO_IVF_MIN_RECALL``
    publish gate's metric, parallel to :func:`quantized_topk_overlap`.
    """
    import numpy as np

    from predictionio_tpu_torch.serving.sharding import PAD_SENTINEL

    exact = np.atleast_2d(np.asarray(exact_idx, np.int64))[:, :k]
    approx = np.atleast_2d(np.asarray(approx_idx, np.int64))[:, :k]
    if exact.shape[0] != approx.shape[0]:
        raise ValueError(
            f"row mismatch: exact has {exact.shape[0]}, approx has {approx.shape[0]}"
        )
    recalls = []
    for e_row, a_row in zip(exact, approx):
        e = np.unique(e_row[(e_row >= 0) & (e_row < int(PAD_SENTINEL))])
        a = np.unique(a_row[(a_row >= 0) & (a_row < int(PAD_SENTINEL))])
        denom = min(int(k), len(e))
        if denom == 0:
            recalls.append(1.0)  # nothing retrievable, so nothing missed
            continue
        recalls.append(len(np.intersect1d(e, a, assume_unique=True)) / denom)
    return float(np.mean(recalls))

@dataclasses.dataclass
class MetricScores:
    score: float
    other_scores: list[float]
    engine_params: EngineParams


@dataclasses.dataclass
class EvaluationResult:
    instance_id: str
    best: MetricScores
    all_results: list[MetricScores]
    summary: str

    def to_json(self) -> str:
        def ep_json(ep: EngineParams) -> dict:
            return {
                "dataSourceParams": params_to_json(ep.data_source_params),
                "preparatorParams": params_to_json(ep.preparator_params),
                "algorithmParamsList": [
                    {"name": n, "params": params_to_json(p)}
                    for n, p in ep.algorithm_params_list
                ],
                "servingParams": params_to_json(ep.serving_params),
            }

        return json.dumps(
            {
                "bestScore": self.best.score,
                "bestEngineParams": ep_json(self.best.engine_params),
                "results": [
                    {"score": r.score, "engineParams": ep_json(r.engine_params)}
                    for r in self.all_results
                ],
            }
        )


class FastEvalCache:
    """Stage memoization across candidates (FastEvalEngine parity).

    Candidates sharing a params prefix (data source → preparator → algorithms)
    reuse read_eval folds and trained models instead of recomputing them.

    Memory is bounded by prefix-scoped eviction: when the full candidate list
    is known up front, each cache entry carries a refcount of the candidates
    still needing it, and :meth:`release` drops folds/prepared/model entries
    the moment no remaining candidate shares that prefix — so peak residency
    tracks *live* prefixes, not the whole grid.
    """

    def __init__(
        self,
        engine: Engine,
        ctx: DeviceContext,
        candidates: Optional[Sequence[EngineParams]] = None,
    ):
        self.engine = engine
        self.ctx = ctx
        self._folds: dict[str, list] = {}
        self._prepared: dict[str, list] = {}
        self._models: dict[str, list] = {}
        self._remaining: Optional[dict[str, dict[str, int]]] = None
        if candidates is not None:
            self._remaining = {"folds": {}, "prepared": {}, "models": {}}
            for ep in candidates:
                for level, key in zip(
                    ("folds", "prepared", "models"), self.candidate_keys(ep)
                ):
                    counts = self._remaining[level]
                    counts[key] = counts.get(key, 0) + 1

    @staticmethod
    def _key(*parts: Any) -> str:
        return json.dumps(parts, sort_keys=True, default=str)

    def candidate_keys(self, ep: EngineParams) -> tuple[str, str, str]:
        ds = params_to_json(ep.data_source_params)
        prep = params_to_json(ep.preparator_params)
        algos = [(n, params_to_json(p)) for n, p in ep.algorithm_params_list]
        return (
            self._key(ds),
            self._key(ds, prep),
            self._key(ds, prep, algos),
        )

    def release(self, ep: EngineParams) -> None:
        """Candidate finished: evict any prefix no remaining candidate shares."""
        if self._remaining is None:
            return
        stores = {
            "folds": self._folds,
            "prepared": self._prepared,
            "models": self._models,
        }
        for level, key in zip(
            ("folds", "prepared", "models"), self.candidate_keys(ep)
        ):
            counts = self._remaining[level]
            if key in counts:
                counts[key] -= 1
                if counts[key] <= 0:
                    del counts[key]
                    stores[level].pop(key, None)

    @property
    def entry_count(self) -> int:
        return len(self._folds) + len(self._prepared) + len(self._models)

    def folds(self, ds_params) -> list:
        key = self._key(params_to_json(ds_params))
        if key not in self._folds:
            ds = self.engine.data_source_cls(ds_params)
            self._folds[key] = list(ds.read_eval(self.ctx))
        return self._folds[key]

    def prepared(self, ds_params, prep_params) -> list:
        key = self._key(params_to_json(ds_params), params_to_json(prep_params))
        if key not in self._prepared:
            prep = self.engine.preparator_cls(prep_params)
            self._prepared[key] = [
                (prep.prepare(self.ctx, td), qa)
                for td, qa in self.folds(ds_params)
            ]
        return self._prepared[key]

    def models(self, ds_params, prep_params, algo_list) -> list:
        key = self._key(
            params_to_json(ds_params),
            params_to_json(prep_params),
            [(n, params_to_json(p)) for n, p in algo_list],
        )
        if key not in self._models:
            per_fold = []
            for pd, _ in self.prepared(ds_params, prep_params):
                algorithms = [
                    self.engine.algorithm_cls_map[n](p) for n, p in algo_list
                ]
                per_fold.append(
                    (algorithms, [a.train(self.ctx, pd) for a in algorithms])
                )
            self._models[key] = per_fold
        return self._models[key]


class MetricEvaluator:
    """Parity: MetricEvaluator.scala:116-263."""

    def __init__(self, metric: Metric, metrics: Optional[Sequence[Metric]] = None):
        self.metric = metric
        self.metrics = list(metrics or [])

    def evaluate_base(
        self,
        ctx: DeviceContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        output_path: Optional[str] = None,
    ) -> EvaluationResult:
        if not engine_params_list:
            raise ValueError("engine_params_list is empty; nothing to evaluate")
        cache = FastEvalCache(engine, ctx, candidates=engine_params_list)
        results: list[MetricScores] = []
        best: Optional[MetricScores] = None
        for i, ep in enumerate(engine_params_list):
            qpas = self._eval_candidate(cache, engine, ctx, ep)
            score = self.metric.calculate(ctx, qpas)
            others = [m.calculate(ctx, qpas) for m in self.metrics]
            cache.release(ep)
            ms = MetricScores(score, others, ep)
            results.append(ms)
            logger.info("candidate %d: %s = %s", i, self.metric.header, score)
            if best is None or self.metric.compare(score, best.score) > 0:
                best = ms
        result = EvaluationResult(
            instance_id="",
            best=best,
            all_results=results,
            summary=self._summary(results, best),
        )
        if output_path:
            # parity: MetricEvaluator.saveEngineJson best.json (:193)
            with open(output_path, "w") as f:
                f.write(result.to_json())
        return result

    def _eval_candidate(self, cache, engine, ctx, ep: EngineParams):
        serving = engine.make_serving(ep)
        per_fold = cache.models(
            ep.data_source_params, ep.preparator_params, ep.algorithm_params_list
        )
        folds = cache.folds(ep.data_source_params)
        qpas = []
        for fold_idx, ((algorithms, models), (_, qa_list)) in enumerate(
            zip(per_fold, folds)
        ):
            supplemented = [(i, serving.supplement(q)) for i, (q, _) in enumerate(qa_list)]
            per_algo = [
                dict(a.batch_predict(m, supplemented))
                for a, m in zip(algorithms, models)
            ]
            triples = []
            for i, (q, a) in enumerate(qa_list):
                preds = [d[i] for d in per_algo if i in d]
                triples.append((q, serving.serve(supplemented[i][1], preds), a))
            qpas.append((fold_idx, triples))
        return qpas

    def _summary(self, results, best) -> str:
        """Per-candidate metric columns + the best row, like the reference's
        MetricEvaluator printout (MetricEvaluator.scala:218-263)."""
        headers = [self.metric.header] + [m.header for m in self.metrics]
        widths = [max(len(h), 12) for h in headers]
        lines = [
            "[RESULT] Metric evaluation",
            f"  candidates: {len(results)}",
            f"  metric: {self.metric.header}",
            "  "
            + " | ".join(h.ljust(w) for h, w in zip(["#"] + headers, [3] + widths))
            + " | params",
        ]
        for i, r in enumerate(results):
            cells = [f"{r.score:.6g}"] + [f"{s:.6g}" for s in r.other_scores]
            mark = "*" if r is best else " "
            lines.append(
                f"  {mark}{i:<2} | "
                + " | ".join(c.ljust(w) for c, w in zip(cells, widths))
                + " | "
                + r.engine_params.to_json_strings()["algorithms_params"]
            )
        lines += [
            f"  best score: {best.score}",
            f"  best params: {best.engine_params.to_json_strings()['algorithms_params']}",
        ]
        return "\n".join(lines)


@dataclasses.dataclass
class RunEvaluationResult:
    instance_id: str
    best_score: float
    summary: str


def run_evaluation(
    evaluation_class: str,
    engine_params_generator_class: Optional[str] = None,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
    batch: str = "",
    output_path: Optional[str] = None,
) -> RunEvaluationResult:
    """Workflow entry (parity: CoreWorkflow.runEvaluation:104-164)."""
    storage = storage or Storage.instance()
    ctx = ctx or DeviceContext.create()
    evaluation: Evaluation = _instantiate(resolve_class(evaluation_class))
    generator_cls = engine_params_generator_class or evaluation_class
    generator: EngineParamsGenerator = _instantiate(resolve_class(generator_cls))
    if not generator.engine_params_list:
        raise ValueError(
            f"{generator_cls} has an empty engine_params_list; nothing to evaluate"
        )

    instances = storage.get_meta_data_evaluation_instances()
    now = _dt.datetime.now(tz=UTC)
    instance = EvaluationInstance(
        id="",
        status=instances.STATUS_INIT,
        start_time=now,
        end_time=now,
        evaluation_class=evaluation_class,
        engine_params_generator_class=generator_cls,
        batch=batch,
        mesh_conf=dict(ctx.conf),
    )
    instance_id = instances.insert(instance)
    instance.status = instances.STATUS_EVALUATING
    instances.update(instance)

    try:
        evaluator = MetricEvaluator(evaluation.metric, evaluation.metrics)
        result = evaluator.evaluate_base(
            ctx, evaluation.engine, generator.engine_params_list, output_path,
        )
    except BaseException:
        instance.status = instances.STATUS_ABORTED
        instance.end_time = _dt.datetime.now(tz=UTC)
        instances.update(instance)
        raise
    finally:
        from predictionio_tpu_torch.core.workflow import CleanupFunctions

        CleanupFunctions.run()
    result.instance_id = instance_id

    instance.status = instances.STATUS_COMPLETED
    instance.end_time = _dt.datetime.now(tz=UTC)
    instance.evaluator_results = result.summary
    instance.evaluator_results_html = (
        f"<html><body><pre>{result.summary}</pre></body></html>"
    )
    instance.evaluator_results_json = result.to_json()
    instances.update(instance)
    return RunEvaluationResult(
        instance_id=instance_id, best_score=result.best.score, summary=result.summary
    )


def _instantiate(obj):
    return obj() if isinstance(obj, type) else obj
