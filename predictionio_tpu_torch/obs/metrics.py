"""Lock-cheap metrics registry with Prometheus + JSON exposition.

Counterpart of ``predictionio_tpu/obs/metrics.py``, whole.

Three instrument kinds — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` (log buckets) — each optionally labeled.  A labeled
instrument is a family; ``labels(v1, v2)`` returns the per-series child,
which callers should cache on the hot path (one dict hit + one short lock
otherwise).  Cardinality is bounded per family: past
``PIO_METRICS_MAX_SERIES`` distinct label sets, new ones collapse into a
single ``__overflow__`` series instead of growing memory without limit.

Existing components keep their own locking and expose themselves through
*collectors* — callbacks returning :class:`Family` snapshots at scrape
time (see :mod:`~predictionio_tpu_torch.obs.bridges`) — so migration onto the
registry never adds a second lock to a hot loop.

Exposition: :meth:`MetricsRegistry.render_prometheus` (text format 0.0.4,
``# HELP``/``# TYPE`` + cumulative ``le`` buckets) and
:meth:`~MetricsRegistry.render_json`.  :func:`parse_prometheus` is the
strict inverse used by the round-trip tests and ``pio loadtest``'s
scraper.
"""

from __future__ import annotations

import math
import os
import re
import threading
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

OVERFLOW_LABEL = "__overflow__"


def _max_series_default() -> int:
    return int(os.environ.get("PIO_METRICS_MAX_SERIES", "512"))


def log_buckets(start: float, factor: float, count: int) -> tuple:
    """Geometric bucket ladder: ``start * factor**i`` for ``count`` rungs."""
    return tuple(start * factor ** i for i in range(count))


# ~8 µs .. ~16 s in octaves: wide enough for an HTTP request that waits
# on a cold storage call, fine enough to see a 2-vs-3 ms serving shift —
# and a sub-millisecond `device_compute` dispatch no longer collapses
# into the bottom rung (the old 0.5 ms floor put ALL device times there).
# The rungs above 0.5 ms are unchanged from the original ladder.
DEFAULT_LATENCY_BUCKETS = log_buckets(0.0005 / 2**6, 2.0, 22)


def format_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Sequence[tuple]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in labels
    )
    return "{" + inner + "}"


class Family:
    """One metric family snapshot: what a collector hands the renderer.

    ``samples`` is a list of ``(suffix, labels, value)`` where ``suffix``
    is appended to the family name (``"_bucket"``, ``"_sum"``, ``"_count"``
    for histograms; ``""`` otherwise) and ``labels`` is a tuple of
    ``(name, value)`` pairs in exposition order.
    """

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str, samples: list):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples = samples


class _Child:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: tuple):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self._buckets)
        for j, bound in enumerate(self._buckets):
            if v <= bound:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> tuple:
        with self._lock:
            return list(self._counts), self._sum, self._count


class _MetricFamily:
    """Shared family machinery: label validation, children, overflow cap."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        max_series: Optional[int] = None,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = (
            max_series if max_series is not None else _max_series_default()
        )
        self._lock = threading.Lock()
        self._children: dict = {}
        self._default = None  # unlabeled child, created lazily

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_series:
                    # cardinality cap: every novel label set past the cap
                    # shares ONE overflow series — memory stays bounded
                    # and the overflow is visible in the exposition
                    key = (OVERFLOW_LABEL,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is not None:
                        return child
                child = self._new_child()
                self._children[key] = child
        return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        child = self._default
        if child is None:
            with self._lock:
                child = self._default
                if child is None:
                    child = self._default = self._new_child()
        return child

    def _sample_items(self) -> list:
        with self._lock:
            items = list(self._children.items())
            if self._default is not None:
                items.append(((), self._default))
        return items

    def collect(self) -> Family:
        samples = []
        for key, child in self._sample_items():
            labels = tuple(zip(self.labelnames, key))
            samples.append(("", labels, child.value))
        return Family(self.name, self.kind, self.help, samples)


class Counter(_MetricFamily):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class Gauge(_MetricFamily):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
        max_series: Optional[int] = None,
    ):
        super().__init__(name, help, labelnames, max_series)
        b = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def collect(self) -> Family:
        samples = []
        for key, child in self._sample_items():
            labels = tuple(zip(self.labelnames, key))
            counts, total, count = child.snapshot()
            acc = 0
            for bound, c in zip(self.buckets, counts):
                acc += c
                samples.append(
                    ("_bucket", labels + (("le", format_value(bound)),), acc)
                )
            samples.append(("_bucket", labels + (("le", "+Inf"),), count))
            samples.append(("_sum", labels, total))
            samples.append(("_count", labels, count))
        return Family(self.name, self.kind, self.help, samples)


class _CallbackGauge:
    kind = "gauge"

    def __init__(self, name: str, help: str, fn: Callable[[], float]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.help = help
        self.fn = fn

    def collect(self) -> Family:
        try:
            v = float(self.fn())
        except Exception:
            v = float("nan")
        return Family(self.name, "gauge", self.help, [("", (), v)])


class MetricsRegistry:
    """Per-server metric namespace: instruments + collectors → exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._collectors: list = []

    def _register(self, name: str, factory):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                return existing
            metric = factory()
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        m = self._register(name, lambda: Counter(name, help, labelnames))
        if not isinstance(m, Counter):
            raise ValueError(f"{name} already registered as {m.kind}")
        return m

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        m = self._register(name, lambda: Gauge(name, help, labelnames))
        if not isinstance(m, Gauge):
            raise ValueError(f"{name} already registered as {m.kind}")
        return m

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        m = self._register(
            name, lambda: Histogram(name, help, labelnames, buckets)
        )
        if not isinstance(m, Histogram):
            raise ValueError(f"{name} already registered as {m.kind}")
        return m

    def gauge_fn(
        self, name: str, help: str, fn: Callable[[], float]
    ) -> None:
        """A gauge computed at scrape time (uptime, queue depth, …)."""
        self._register(name, lambda: _CallbackGauge(name, help, fn))

    def register_collector(
        self, fn: Callable[[], Iterable[Family]]
    ) -> None:
        """Bridge hook: ``fn()`` returns Family snapshots at scrape time.

        This is how pre-existing components (batcher stats dicts, breaker
        state, ingest buffer) join the exposition without re-homing their
        counters or taking a second lock per event.
        """
        with self._lock:
            self._collectors.append(fn)

    # -- exposition ----------------------------------------------------------
    def collect(self) -> list:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        families = [m.collect() for m in metrics]
        for fn in collectors:
            try:
                families.extend(fn())
            except Exception:
                # a broken bridge must never take /metrics down with it
                continue
        return families

    def render_prometheus(self) -> str:
        out = []
        for fam in sorted(self.collect(), key=lambda f: f.name):
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape_help(fam.help)}\n")
            out.append(f"# TYPE {fam.name} {fam.kind}\n")
            for suffix, labels, value in fam.samples:
                out.append(
                    f"{fam.name}{suffix}{_label_str(labels)} "
                    f"{format_value(value)}\n"
                )
        return "".join(out)

    def render_json(self) -> dict:
        metrics = []
        for fam in sorted(self.collect(), key=lambda f: f.name):
            metrics.append(
                {
                    "name": fam.name,
                    "type": fam.kind,
                    "help": fam.help,
                    "samples": [
                        {
                            "name": fam.name + suffix,
                            "labels": dict(labels),
                            "value": None if value != value else value,
                        }
                        for suffix, labels, value in fam.samples
                    ],
                }
            )
        return {"metrics": metrics}


def _escape_help(h: str) -> str:
    return h.replace("\\", "\\\\").replace("\n", "\\n")


# -- parser (round-trip tests + loadtest scraping) ---------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"       # metric name
    r"(?:\{(.*)\})?"                      # optional label body
    r" "
    r"(NaN|[+-]Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"
    r"(?: [0-9]+)?$"                      # optional timestamp
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)'
)


def _parse_value(s: str) -> float:
    if s == "NaN":
        return float("nan")
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def _unescape_label(v: str) -> str:
    return (
        v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def parse_prometheus(text: str) -> dict:
    """Strict parse of text-format exposition.

    Returns ``{(name, ((label, value), ...)): value}`` with labels sorted,
    raising :class:`ValueError` on any malformed line — the round-trip
    test leans on that strictness.
    """
    series: dict = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        name, label_body, value = m.group(1), m.group(2), m.group(3)
        labels = []
        if label_body:
            pos = 0
            while pos < len(label_body):
                pm = _LABEL_PAIR_RE.match(label_body, pos)
                if pm is None:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {label_body!r}"
                    )
                labels.append((pm.group(1), _unescape_label(pm.group(2))))
                pos = pm.end()
        key = (name, tuple(sorted(labels)))
        if key in series:
            raise ValueError(f"line {lineno}: duplicate series {key}")
        series[key] = _parse_value(value)
    return series
