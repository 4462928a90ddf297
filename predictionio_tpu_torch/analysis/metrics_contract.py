"""Metric-contract analyzer: the ``pio_*`` catalog can't drift.

``docs/observability.md`` is the operator contract for every metric the
servers expose: dashboards and alerts are built from its tables.  A
family registered in code but missing from the catalog is an invisible
signal; a catalog row for a family nothing registers is a dead alert; a
type mismatch (counter documented as gauge) silently breaks ``rate()``.

Registration sites recognised (the repo's actual idioms):

* ``reg.counter/gauge/histogram/gauge_fn("pio_...", ...)`` on a
  :class:`MetricsRegistry`;
* ``Family("pio_...", kind, ...)`` / the ``_fam``/``F`` aliases used by
  collector closures in ``obs/bridges.py`` and the servers;
* ``bridge_error_counters(reg, "pio_x", ...)`` (counter) and
  ``bridge_latency_histogram(reg, "pio_x", ...)`` (histogram);
* ``bridge_resilience(..., prefix="pio_x")`` which expands to the five
  resilience series per prefix.

Wildcard catalog rows (``pio_batcher_*``, type "mixed") cover a family
by prefix.  Label sets are checked against the cardinality conventions:
per-entity labels (user/item/request ids) would explode the series cap
(``PIO_METRICS_MAX_SERIES``) and are flagged.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rel_in, rule,
)

R_UNDOCUMENTED = rule(
    "metric-undocumented", "error",
    "pio_* metric registered in code but absent from the catalog",
    "a signal nobody can discover: dashboards and alerts are built "
    "from docs/observability.md, not from grepping code",
)
R_TYPE_MISMATCH = rule(
    "metric-type-mismatch", "error",
    "metric kind differs between registration and catalog",
    "a counter documented as gauge (or vice versa) silently breaks "
    "rate()/delta() queries built on the doc",
)
R_DEAD_DOC = rule(
    "metric-dead-doc", "warning",
    "metric documented but registered nowhere",
    "catalog rows for series that never exist produce permanently-"
    "empty dashboards and dead alerts",
)
R_CARDINALITY = rule(
    "metric-label-cardinality", "error",
    "per-entity label on a metric family",
    "user/item/request-id labels mint a series per entity and blow "
    "through PIO_METRICS_MAX_SERIES, evicting real series",
)
R_NAMING = rule(
    "metric-naming", "warning",
    "metric name violates the kind-suffix convention",
    "_total means counter to every PromQL consumer; a gauge named "
    "_total invites rate() on a non-monotonic series",
)

_REG_METHODS = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram", "gauge_fn": "gauge"}
_FAMILY_CTORS = {"Family", "_fam", "F"}
_BRIDGE_KINDS = {"bridge_error_counters": "counter",
                 "bridge_latency_histogram": "histogram"}
_RESILIENCE_SUFFIXES = (
    ("_retries_total", "counter"),
    ("_retry_budget_tokens", "gauge"),
    ("_breaker_state", "gauge"),
    ("_breaker_consecutive_failures", "gauge"),
    ("_breaker_opens_total", "counter"),
)
_RESILIENCE_DEFAULT_PREFIX = "pio_storage_client"
_HIGH_CARD_LABELS = {
    "user", "item", "entity", "entity_id", "user_id", "item_id",
    "request_id", "query", "uid", "uuid", "event_id", "trace_id", "key",
}
_MAX_LABELS = 4

# catalog rows annotate label sets inline: `pio_x_total{method,path}`
_DOC_NAME_RE = re.compile(r"`(pio_[a-z0-9_]+\*?)(?:\{[^}`]*\})?`")


class _Reg:
    def __init__(self, name: str, kind: str, rel: str, line: int,
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.kind = kind
        self.rel = rel
        self.line = line
        self.labels = labels


def _label_names(node: Optional[ast.expr]) -> tuple[str, ...]:
    """Literal label keys from a labels tuple/list or a samples literal
    of ``(suffix, ((k, v), ...), value)`` triples."""
    out: list[str] = []
    if node is None:
        return ()
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            elif isinstance(elt, (ast.Tuple, ast.List)):
                # samples form: dig for the (k, v) label pairs
                for pair in elt.elts:
                    if isinstance(pair, (ast.Tuple, ast.List)) and \
                            len(pair.elts) == 2 and isinstance(
                                pair.elts[0], ast.Constant):
                        out.append(str(pair.elts[0].value))
    return tuple(dict.fromkeys(out))


def collect_registrations(mod: Module) -> list[_Reg]:
    regs: list[_Reg] = []
    if mod.tree is None:
        return regs
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        short = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        arg0 = node.args[0] if node.args else None
        name = arg0.value if isinstance(arg0, ast.Constant) and \
            isinstance(arg0.value, str) else None
        if short in _REG_METHODS and name and name.startswith("pio_"):
            labels = _label_names(
                node.args[2] if len(node.args) > 2 else
                next((kw.value for kw in node.keywords
                      if kw.arg == "labels"), None)
            )
            regs.append(_Reg(name, _REG_METHODS[short], mod.rel,
                             node.lineno, labels))
        elif short in _FAMILY_CTORS and name and name.startswith("pio_"):
            kind_node = node.args[1] if len(node.args) > 1 else None
            kind = kind_node.value if isinstance(kind_node, ast.Constant) \
                else "untyped"
            labels = _label_names(
                node.args[3] if len(node.args) > 3 else
                next((kw.value for kw in node.keywords
                      if kw.arg == "samples"), None)
            )
            regs.append(_Reg(name, str(kind), mod.rel, node.lineno,
                             labels))
        elif short in _BRIDGE_KINDS:
            bridge_name = None
            for a in node.args[1:2]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    bridge_name = a.value
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    bridge_name = kw.value.value
            if bridge_name and bridge_name.startswith("pio_"):
                regs.append(_Reg(bridge_name, _BRIDGE_KINDS[short],
                                 mod.rel, node.lineno))
        elif short == "bridge_resilience":
            prefix = _RESILIENCE_DEFAULT_PREFIX
            for kw in node.keywords:
                if kw.arg == "prefix" and isinstance(kw.value, ast.Constant):
                    prefix = kw.value.value
            for suffix, kind in _RESILIENCE_SUFFIXES:
                regs.append(_Reg(prefix + suffix, kind, mod.rel,
                                 node.lineno))
    return regs


def doc_catalog(index: RepoIndex) -> tuple[dict[str, tuple[str, str, int]],
                                           list[str]]:
    """(exact name → (type, doc rel, line), wildcard prefixes) from the
    observability catalog tables."""
    exact: dict[str, tuple[str, str, int]] = {}
    prefixes: list[str] = []
    for rel, text in index.docs.items():
        if "observability" not in rel:
            continue
        for i, line in enumerate(text.splitlines(), start=1):
            if not line.lstrip().startswith("|"):
                continue
            # split on table pipes only — label values escape theirs
            # as \| (e.g. {outcome=hit\|miss})
            cells = [c.strip() for c in
                     re.split(r"(?<!\\)\|", line.strip().strip("|"))]
            names = _DOC_NAME_RE.findall(cells[0]) if cells else []
            if not names:
                continue
            mtype = cells[1].strip("`").lower() if len(cells) > 1 else ""
            for n in names:
                if n.endswith("*"):
                    prefixes.append(n[:-1])
                elif n not in exact:
                    exact[n] = (mtype, rel, i)
    return exact, prefixes


@analyzer("metrics")
def analyze(index: RepoIndex):
    regs: list[_Reg] = []
    for mod in index.modules:
        if not rel_in(mod.rel, "obs", "serving", "data/api"):
            continue
        regs.extend(collect_registrations(mod))
    exact, prefixes = doc_catalog(index)
    out: list[Finding] = []
    seen: dict[str, _Reg] = {}
    for r in regs:
        if r.name not in seen:
            seen[r.name] = r
    for name in sorted(seen):
        r = seen[name]
        doc = exact.get(name)
        covered = doc is not None or any(
            name.startswith(p) for p in prefixes
        )
        if not covered:
            out.append(finding(
                R_UNDOCUMENTED, r.rel, r.line,
                f"{name} ({r.kind}) is registered here but missing "
                "from the docs/observability.md catalog",
                symbol=name,
            ))
        elif doc is not None and doc[0] not in {"mixed", ""} and \
                r.kind != "untyped" and doc[0] != r.kind:
            out.append(finding(
                R_TYPE_MISMATCH, r.rel, r.line,
                f"{name} is a {r.kind} in code but documented as "
                f"{doc[0]!r} at {doc[1]}:{doc[2]}",
                symbol=name,
            ))
        bad_labels = [l for l in r.labels if l in _HIGH_CARD_LABELS]
        if bad_labels:
            out.append(finding(
                R_CARDINALITY, r.rel, r.line,
                f"{name} labels {bad_labels} mint one series per "
                "entity; aggregate before labeling",
                symbol=name,
            ))
        elif len(r.labels) > _MAX_LABELS:
            out.append(finding(
                R_CARDINALITY, r.rel, r.line,
                f"{name} carries {len(r.labels)} labels "
                f"{list(r.labels)}; cap is {_MAX_LABELS}",
                symbol=name, severity="warning",
            ))
        if name.endswith("_total") and r.kind == "gauge":
            out.append(finding(
                R_NAMING, r.rel, r.line,
                f"{name} is a gauge named like a counter (_total); "
                "rename or make it monotonic",
                symbol=name,
            ))
        elif r.kind == "counter" and not name.endswith("_total"):
            out.append(finding(
                R_NAMING, r.rel, r.line,
                f"counter {name} should end in _total",
                symbol=name,
            ))
    reg_names = set(seen)
    for name in sorted(exact):
        if name in reg_names:
            continue
        if any(name.startswith(p) for p in prefixes):
            continue  # exemplar of a wildcard family, likely dynamic
        mtype, rel, line = exact[name]
        out.append(finding(
            R_DEAD_DOC, rel, line,
            f"{name} is in the catalog but registered nowhere under "
            "obs//serving//data/api",
            symbol=name,
        ))
    extras = {
        "metrics": {
            "count": len(seen),
            "documented": sum(
                1 for n in seen
                if n in exact or any(n.startswith(p) for p in prefixes)
            ),
        }
    }
    return out, extras

from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("metrics", R_UNDOCUMENTED.id, R_TYPE_MISMATCH.id, R_DEAD_DOC.id,
           R_CARDINALITY.id, R_NAMING.id)
