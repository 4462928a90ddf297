"""Composed retrieval→ranking pipelines with per-stage deadline budgets.

Low-latency prediction serving is a DATAFLOW, not one monolithic model
call (PAPERS.md: Cloudburst's serverless prediction-serving result):
a cheap high-recall retrieval stage prunes the catalog to a candidate
set, and an exact ranking stage scores only those candidates.  Counterpart
of ``predictionio_tpu/serving/pipeline.py``, composing the port's two
stages — IVF coarse retrieval (``ops/ivf.py``) and the ALS ranker's
candidate path, which on the card is one launch of the score kernel at
rung 1 under a candidate mask (``BucketedScorer.score_topk_filtered``):

* :class:`PipelineConfig` — the deployable artifact: an ordered list
  of :class:`StageSpec` (name, kind, per-stage share of the request
  deadline, params), published and loaded through the same sealed-blob
  checksum envelope as every model artifact (a torn pipeline config is
  REFUSED at load, and the server degrades to single-stage serving).
* :class:`PipelineEngine` — executes the stages under the ambient
  request deadline, split into per-stage budgets by
  ``budget_fraction``.  A ranking stage that overruns its budget (or
  fails) degrades to the RETRIEVAL-ONLY answer tagged
  ``degraded:true`` — coarse scores beat a blown end-to-end SLO.
  Every stage boundary is a fault-injection site
  (``server:pipeline:<stage>``), so chaos tests can starve one stage
  without touching the others.

The engine is generic over stage runners; :func:`build_recommendation_
stages` binds a config to a deployed ALS recommendation algorithm
(host IVF probe → candidate ranking on the card, or on the host).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Optional

from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.common.resilience import (
    Deadline,
    DeadlineExceeded,
    current_deadline,
    deadline_scope,
)
from predictionio_tpu_torch.core.persistence import open_blob_file, seal_blob_file
from predictionio_tpu_torch.utils.profiling import LatencyHistogram

logger = logging.getLogger(__name__)

STAGE_KINDS = ("retrieval", "ranking")

_CONFIG_VERSION = 1


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage declaration.  ``budget_fraction`` is this
    stage's share of the request's TOTAL deadline budget."""

    name: str
    kind: str
    budget_fraction: float = 0.5
    params: tuple = ()  # sorted (key, value) pairs — hashable, canonical

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "budgetFraction": self.budget_fraction,
            "params": dict(self.params),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StageSpec":
        return cls(
            name=str(d["name"]),
            kind=str(d["kind"]),
            budget_fraction=float(d.get("budgetFraction", 0.5)),
            params=tuple(sorted((d.get("params") or {}).items())),
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """A deployable pipeline: ordered stages + identity."""

    name: str
    stages: tuple[StageSpec, ...]

    def validate(self) -> None:
        if not self.name:
            raise ValueError("pipeline name must be non-empty")
        if not self.stages:
            raise ValueError(f"pipeline {self.name}: no stages")
        if self.stages[0].kind != "retrieval":
            raise ValueError(
                f"pipeline {self.name}: first stage must be retrieval "
                "(the degraded answer comes from it)"
            )
        seen = set()
        total = 0.0
        for st in self.stages:
            if st.kind not in STAGE_KINDS:
                raise ValueError(
                    f"pipeline {self.name}: stage {st.name!r} kind "
                    f"{st.kind!r} not in {STAGE_KINDS}"
                )
            if st.name in seen:
                raise ValueError(
                    f"pipeline {self.name}: duplicate stage {st.name!r}"
                )
            seen.add(st.name)
            if not 0.0 < st.budget_fraction <= 1.0:
                raise ValueError(
                    f"pipeline {self.name}: stage {st.name!r} "
                    f"budget_fraction {st.budget_fraction} outside (0, 1]"
                )
            total += st.budget_fraction
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"pipeline {self.name}: stage budget fractions sum to "
                f"{total:.3f} > 1 — the stages would overdraw the request "
                "deadline"
            )

    @property
    def fingerprint(self) -> str:
        """Content hash — the pipeline's deployed identity."""
        return hashlib.sha256(self.to_payload()).hexdigest()[:16]

    def to_payload(self) -> bytes:
        return json.dumps(
            {
                "version": _CONFIG_VERSION,
                "name": self.name,
                "stages": [st.to_dict() for st in self.stages],
            },
            sort_keys=True, separators=(",", ":"),
        ).encode()

    @classmethod
    def from_payload(cls, payload: bytes) -> "PipelineConfig":
        d = json.loads(payload.decode())
        config = cls(
            name=str(d["name"]),
            stages=tuple(StageSpec.from_dict(s) for s in d["stages"]),
        )
        config.validate()
        return config

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        config = cls(
            name=str(d.get("name") or "pipeline"),
            stages=tuple(StageSpec.from_dict(s) for s in d.get("stages", [])),
        )
        config.validate()
        return config

    def describe(self) -> dict:
        return {
            "name": self.name,
            "fingerprint": self.fingerprint,
            "stages": [st.to_dict() for st in self.stages],
        }


def save_pipeline(config: PipelineConfig, path: str) -> None:
    """Publish a pipeline as a sealed-blob artifact (tmp+fsync+rename,
    checksum envelope) — the same integrity contract as model blobs."""
    config.validate()
    seal_blob_file(path, config.to_payload())


def load_pipeline(path: str) -> PipelineConfig:
    """Load a sealed pipeline artifact; raises ``ModelIntegrityError``
    on a torn or forged blob (callers degrade to single-stage)."""
    return PipelineConfig.from_payload(open_blob_file(path))


def pipeline_from_env() -> Optional[PipelineConfig]:
    """``PIO_PIPELINE``: path to a sealed pipeline blob, or (dev/tests)
    the JSON config inline.  None when unset — single-stage serving,
    byte-identical to the pre-pipeline server."""
    raw = os.environ.get("PIO_PIPELINE", "").strip()
    if not raw:
        return None
    if raw.startswith("{"):
        return PipelineConfig.from_dict(json.loads(raw))
    return load_pipeline(raw)


class StageFault(Exception):
    """An injected ``server:pipeline:<stage>`` error fault."""


class _ShortCircuit(Exception):
    """A stage produced the final answer early (e.g. unknown user)."""

    def __init__(self, prediction: Any):
        self.prediction = prediction


def _fault_latency(act) -> None:
    # the injected stall IS the fault being modeled (a slow stage)
    if act.latency_s:
        time.sleep(act.latency_s)


class PipelineEngine:
    """Executes a bound pipeline as a dataflow under per-stage budgets.

    ``stages`` pairs each :class:`StageSpec` with a runner
    ``runner(ctx, deadline)`` that reads/writes the shared per-request
    ``ctx`` dict (``query`` in; retrieval sets ``candidates`` /
    ``cand_scores``; the final stage sets ``prediction``).
    ``degrade_fn(ctx)`` builds the retrieval-only answer when a later
    stage overruns or fails.
    """

    def __init__(
        self,
        config: PipelineConfig,
        stages: list[tuple[StageSpec, Callable]],
        degrade_fn: Callable[[dict], Any],
    ):
        config.validate()
        self.config = config
        self._stages = list(stages)
        self._degrade = degrade_fn
        import threading

        self._stats_lock = threading.Lock()
        self._stage_stats = {
            spec.name: {
                "runs": 0, "overruns": 0, "errors": 0, "faults": 0,
                "latency": LatencyHistogram(),
            }
            for spec, _ in self._stages
        }
        self._degraded_total = 0
        self._short_circuits = 0

    # entry point: named run_* so analysis/deadline.py scans it as a
    # serving entry that must forward budgets downstream
    def run_pipeline(
        self, query: Any, deadline: Optional[Deadline] = None
    ) -> tuple[Any, dict]:
        """Run every stage; returns ``(prediction, meta)`` where meta
        carries ``degraded`` and the stage that degraded (if any).

        The ambient request deadline is split by each stage's
        ``budget_fraction`` of the TOTAL budget remaining at entry; a
        non-retrieval stage that raises, exceeds its slice, or would
        start with no slice left degrades to the retrieval-only answer
        instead of blowing the end-to-end SLO.  Retrieval-stage
        failures re-raise: with no candidates there is nothing to
        degrade TO, and the server's own fallback chain takes over.
        """
        if deadline is None:
            deadline = current_deadline()
        total_ms = deadline.remaining_ms() if deadline is not None else None
        ctx: dict = {"query": query}
        prediction = None
        for spec, runner in self._stages:
            can_degrade = (
                spec.kind != "retrieval" and ctx.get("candidates") is not None
            )
            act = _faults.check(f"server:pipeline:{spec.name}")
            if act is not None:
                _fault_latency(act)
                if act.kind in ("error", "drop", "crash"):
                    self._note(spec.name, "faults")
                    if can_degrade:
                        return self._degrade_to_retrieval(ctx, spec.name)
                    raise StageFault(
                        f"injected fault at pipeline stage {spec.name}"
                    )
            sub = None
            if total_ms is not None:
                remaining = deadline.remaining_ms()
                if remaining <= 0.0:
                    if can_degrade:
                        return self._degrade_to_retrieval(ctx, spec.name)
                    raise DeadlineExceeded(
                        f"deadline exhausted before pipeline stage "
                        f"{spec.name}"
                    )
                sub = Deadline.after_ms(
                    max(1.0, min(total_ms * spec.budget_fraction, remaining))
                )
            t0 = time.perf_counter()
            try:
                with deadline_scope(sub if sub is not None else deadline):
                    runner(ctx, sub)
            except _ShortCircuit as sc:
                self._note(spec.name, "runs", time.perf_counter() - t0)
                with self._stats_lock:
                    self._short_circuits += 1
                return sc.prediction, {"degraded": False, "pipeline": True}
            except DeadlineExceeded:
                self._note(spec.name, "overruns")
                if can_degrade:
                    return self._degrade_to_retrieval(ctx, spec.name)
                raise
            except Exception:
                self._note(spec.name, "errors")
                if can_degrade:
                    return self._degrade_to_retrieval(ctx, spec.name)
                raise
            dt = time.perf_counter() - t0
            self._note(spec.name, "runs", dt)
            if sub is not None and sub.expired():
                # the stage FINISHED but past its slice: a late exact
                # answer still blows the end-to-end SLO, so the budget
                # verdict stands — serve the retrieval-only answer
                self._note(spec.name, "overruns")
                if can_degrade:
                    return self._degrade_to_retrieval(ctx, spec.name)
            prediction = ctx.get("prediction", prediction)
        return prediction, {"degraded": False, "pipeline": True}

    def _degrade_to_retrieval(self, ctx: dict, stage: str) -> tuple[Any, dict]:
        with self._stats_lock:
            self._degraded_total += 1
        return self._degrade(ctx), {
            "degraded": True, "pipeline": True, "stage": stage,
        }

    def _note(self, stage: str, key: str, dt: Optional[float] = None) -> None:
        with self._stats_lock:
            entry = self._stage_stats[stage]
            if dt is not None:
                entry["latency"].observe(dt)
                entry["runs"] += 1
            else:
                entry[key] += 1

    def stats(self) -> dict:
        with self._stats_lock:
            stages = {}
            for spec, _ in self._stages:
                entry = self._stage_stats[spec.name]
                lat: LatencyHistogram = entry["latency"]
                stages[spec.name] = {
                    "kind": spec.kind,
                    "budget_fraction": spec.budget_fraction,
                    "runs": entry["runs"],
                    "overruns": entry["overruns"],
                    "errors": entry["errors"],
                    "faults": entry["faults"],
                    "p50_ms": round(lat.quantile(0.50), 3),
                    "p99_ms": round(lat.quantile(0.99), 3),
                }
            return {
                "name": self.config.name,
                "fingerprint": self.config.fingerprint,
                "degraded_total": self._degraded_total,
                "short_circuits": self._short_circuits,
                "stages": stages,
            }


# -- recommendation binding --------------------------------------------------
def _ivf_candidates(index, q, n: int):
    """Host-side coarse probe: score the (tiny) centroid matrix, take
    clusters best-first, and pool their members until ``n`` candidates.
    Coarse scores are the owning cluster's centroid score — enough to
    order a degraded answer, deliberately NOT the exact dot (that is
    the ranking stage's job)."""
    import numpy as np

    cscores = np.asarray(index.centroids, np.float32) @ np.asarray(
        q, np.float32
    )
    order = np.argsort(-cscores)
    cand: list = []
    coarse: list = []
    for c in order:
        members = index.plan.shard_items(int(c))
        cand.append(members)
        coarse.append(np.full(len(members), cscores[int(c)], np.float32))
        if sum(len(m) for m in cand) >= n:
            break
    idx = np.concatenate(cand) if cand else np.zeros(0, np.int32)
    sc = np.concatenate(coarse) if coarse else np.zeros(0, np.float32)
    if len(idx) > n:
        idx, sc = idx[:n], sc[:n]
    return idx, sc


def build_recommendation_stages(
    config: PipelineConfig, algo: Any, model: Any
) -> Optional[PipelineEngine]:
    """Bind a pipeline config to a deployed recommendation algorithm.

    Needs the ALS surface: ``model.user_map``/``item_map`` (entity id
    maps), host ``user_factors``, and the algorithm's scorer with the
    fused candidate-ranking path.  Returns None when the deployment
    lacks those hooks — the caller serves single-stage as before.
    Retrieval prefers the model's published IVF index (host centroid
    probe); without one it falls back to a host scan that still feeds
    the fused ranker a bounded candidate set.
    """
    import numpy as np

    user_map = getattr(model, "user_map", None)
    item_map = getattr(model, "item_map", None)
    factors = getattr(model, "user_factors", None)
    item_factors = getattr(model, "item_factors", None)
    scorer_fn = getattr(algo, "_scorer", None)
    if any(
        x is None
        for x in (user_map, item_map, factors, item_factors, scorer_fn)
    ):
        return None
    from predictionio_tpu_torch.templates.recommendation import (
        ItemScore, PredictedResult,
    )

    ivf = getattr(model, "ivf_index", None)
    inv_items = item_map.inverse

    def _result(idx, scores, num: int) -> PredictedResult:
        order = np.argsort(-np.asarray(scores))[:num]
        return PredictedResult(
            itemScores=[
                ItemScore(item=inv_items[int(idx[i])], score=float(scores[i]))
                for i in order
            ]
        )

    def stage_retrieval(ctx: dict, deadline) -> None:
        query = ctx["query"]
        uidx = user_map.get(query.user)
        if uidx is None:
            # nothing to retrieve for an unknown user: final answer now
            raise _ShortCircuit(PredictedResult(itemScores=[]))
        spec: StageSpec = ctx["__spec__"]
        n = int(spec.param("candidates", max(64, 8 * int(query.num))))
        q = np.asarray(factors[int(uidx)], np.float32)
        if ivf is not None:
            idx, coarse = _ivf_candidates(ivf, q, n)
        else:
            # host scan fallback: exact dots, truncated — the ranking
            # stage still runs the exclusions and the top-k
            scores = np.asarray(item_factors, np.float32) @ q
            idx = np.argpartition(-scores, min(n, len(scores) - 1))[:n]
            coarse = scores[idx]
        exclude = None
        if getattr(query, "blackList", None):
            excl = item_map.to_index_array(query.blackList)
            exclude = excl[excl >= 0]
            keep = ~np.isin(idx, exclude)
            idx, coarse = idx[keep], coarse[keep]
        if getattr(query, "whiteList", None):
            white = item_map.to_index_array(query.whiteList)
            keep = np.isin(idx, white[white >= 0])
            idx, coarse = idx[keep], coarse[keep]
        ctx["user_idx"] = int(uidx)
        ctx["candidates"] = idx.astype(np.int32)
        ctx["cand_scores"] = coarse
        ctx["exclude"] = exclude

    def stage_ranking(ctx: dict, deadline) -> None:
        query = ctx["query"]
        cand = ctx["candidates"]
        if len(cand) == 0:
            ctx["prediction"] = PredictedResult(itemScores=[])
            return
        scorer = scorer_fn(model)
        # on a deployment whose fast path is built on the card, one kernel
        # launch at rung 1 under the candidate mask (the JAX package ranks
        # on the host below ALSScorer.HOST_THRESHOLD)
        idx, scores = scorer.recommend(
            ctx["user_idx"], int(query.num),
            exclude_items=ctx.get("exclude"), candidate_items=cand,
            prefer_card=True,
        )
        ctx["prediction"] = PredictedResult(
            itemScores=[
                ItemScore(item=inv_items[int(i)], score=float(s))
                for i, s in zip(idx, scores)
            ]
        )

    def degrade_fn(ctx: dict):
        # retrieval-only answer: coarse scores, tagged degraded upstream
        query = ctx["query"]
        return _result(ctx["candidates"], ctx["cand_scores"], int(query.num))

    runners = {"retrieval": stage_retrieval, "ranking": stage_ranking}
    stages = []
    for spec in config.stages:
        runner = runners[spec.kind]

        def bound(ctx, deadline, _spec=spec, _runner=runner):
            ctx["__spec__"] = _spec
            _runner(ctx, deadline)

        stages.append((spec, bound))
    return PipelineEngine(config, stages, degrade_fn)


def build_pipeline_engine(
    config: Optional[PipelineConfig], algorithms: list, models: list
) -> Optional[PipelineEngine]:
    """Bind ``config`` against the first deployed algorithm exposing
    the recommendation surface; None when no stage binding is possible
    (the server keeps single-stage serving)."""
    if config is None:
        return None
    for algo, model in zip(algorithms, models):
        try:
            engine = build_recommendation_stages(config, algo, model)
        except Exception:
            logger.exception(
                "pipeline %s failed to bind against %s",
                config.name, type(algo).__name__,
            )
            continue
        if engine is not None:
            return engine
    return None
