"""Metric hierarchy for evaluation/tuning.

Copy of ``predictionio_tpu/core/metrics.py`` (the port imports nothing of
the JAX package). Parity: ``core/.../controller/Metric.scala:39-269`` — Metric base with
``calculate``, plus the statistics subclasses: :class:`AverageMetric` (:99),
:class:`OptionAverageMetric` (:124, None scores excluded),
:class:`StdevMetric` (:151), :class:`SumMetric` (:205),
:class:`ZeroMetric` (:234).  ``compare`` defaults to larger-is-better.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Optional, Sequence

# one fold's scored data: [(query, prediction, actual)]
QPA = Sequence[tuple[Any, Any, Any]]


class Metric(abc.ABC):
    """Parity: Metric.scala:39."""

    @abc.abstractmethod
    def calculate(self, ctx, qpas: list[tuple[Any, QPA]]) -> float:
        """Score across all evaluation folds."""

    def compare(self, r0: float, r1: float) -> int:
        """>0 if r0 is better (larger-is-better by default)."""
        return (r0 > r1) - (r0 < r1)

    @property
    def header(self) -> str:
        return type(self).__name__


class AverageMetric(Metric):
    """Mean of per-(q,p,a) scores across all folds (Metric.scala:99)."""

    @abc.abstractmethod
    def calculate_one(self, query, prediction, actual) -> float: ...

    def calculate(self, ctx, qpas) -> float:
        scores = [
            self.calculate_one(q, p, a) for _, triples in qpas for q, p, a in triples
        ]
        if not scores:
            return float("nan")
        return sum(scores) / len(scores)


class OptionAverageMetric(Metric):
    """Mean of the non-None scores only (Metric.scala:124)."""

    @abc.abstractmethod
    def calculate_one(self, query, prediction, actual) -> Optional[float]: ...

    def calculate(self, ctx, qpas) -> float:
        scores = [
            s
            for _, triples in qpas
            for q, p, a in triples
            if (s := self.calculate_one(q, p, a)) is not None
        ]
        if not scores:
            return float("nan")
        return sum(scores) / len(scores)


class StdevMetric(Metric):
    """Population stdev of per-row scores (Metric.scala:151)."""

    @abc.abstractmethod
    def calculate_one(self, query, prediction, actual) -> float: ...

    def calculate(self, ctx, qpas) -> float:
        scores = [
            self.calculate_one(q, p, a) for _, triples in qpas for q, p, a in triples
        ]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class SumMetric(Metric):
    """Sum of per-row scores (Metric.scala:205)."""

    @abc.abstractmethod
    def calculate_one(self, query, prediction, actual) -> float: ...

    def calculate(self, ctx, qpas) -> float:
        return float(
            sum(self.calculate_one(q, p, a) for _, triples in qpas for q, p, a in triples)
        )


class ZeroMetric(Metric):
    """Always 0 (Metric.scala:234) — placeholder for unscored evaluations."""

    def calculate(self, ctx, qpas) -> float:
        return 0.0
