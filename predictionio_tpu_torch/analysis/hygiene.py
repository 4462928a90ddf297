"""Hygiene rules migrated from the original ``tests/test_lint.py``.

Same contracts, one engine: unused imports, parse health, no ad-hoc
module-level counters outside ``obs/``, no ad-hoc caches outside
``serving/``.  The grandfather lists move here with the rules so there
is exactly one allowlist per contract, shared by the CLI and the tests.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rel_in, rule,
)

R_SYNTAX = rule(
    "hygiene-syntax", "error",
    "module fails to parse",
    "a file that does not parse is invisible to every other analyzer "
    "and to import",
)
R_UNUSED_IMPORT = rule(
    "hygiene-unused-import", "error",
    "imported name is never used",
    "dead imports hide real dependencies and slow cold start",
)
R_COUNTER = rule(
    "hygiene-module-counter", "error",
    "ad-hoc module-level counter outside obs/",
    "aggregates in module globals are invisible to /metrics; register "
    "them on the server's MetricsRegistry (predictionio_tpu_torch/obs)",
)
R_CACHE_RULE = rule(
    "hygiene-adhoc-cache", "error",
    "ad-hoc cache outside serving/",
    "a per-module cache has no invalidation hook, no obs bridge, and "
    "no TTL backstop; serving/result_cache.py and serving/"
    "event_cache.py exist so stale-answer bugs have one home",
)

# Legacy module-level counters that predate the obs registry,
# grandfathered as "path:target". EMPTY since the obs registry — every global
# counter found after that point is a regression.
COUNTER_ALLOWLIST: set[str] = set()

_COUNTERISH_CALLS = {"Counter", "ErrorCounters", "defaultdict"}
_COUNTERISH_NAMES = ("_count", "_counts", "_counter", "_counters", "_stats")

# Caching that predates the serving cache layer, grandfathered as
# "path:name". These are the JAX package's (``hygiene.py:55-59``) in the
# port's tree: the kernels' launch plans, keyed by static shapes and the
# card's SM count, hold no data, so event-driven invalidation doesn't apply.
CACHE_ALLOWLIST = {
    "predictionio_tpu_torch/ops/flash_attention.py:split_plan",
    "predictionio_tpu_torch/ops/flash_attention.py:dq_plan",
    "predictionio_tpu_torch/ops/flash_attention.py:_sm_count",
    # per-response Date header memo, rebuilt every second; not a data cache
    "predictionio_tpu_torch/common/http.py:_DATE_CACHE",
}

_CACHE_DECORATORS = {"lru_cache", "cache", "cached_property"}


def unused_imports(mod: Module) -> list[Finding]:
    if mod.tree is None:
        return []
    imported: dict[str, int] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[(a.asname or a.name).split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(mod.tree):
        n = node
        while isinstance(n, ast.Attribute):
            n = n.value
        if isinstance(n, ast.Name):
            used.add(n.id)
    in_all = set()
    for node in ast.walk(mod.tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets
            )
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant):
                    in_all.add(elt.value)
    return [
        finding(
            R_UNUSED_IMPORT, mod, lineno,
            f"unused import {name!r}", symbol=name,
        )
        for name, lineno in imported.items()
        if name not in used and name not in in_all
    ]


def module_level_counters(mod: Module) -> list[Finding]:
    """Module-level assignments that smell like an ad-hoc metrics store:
    ``X = Counter()`` / ``ErrorCounters()`` / ``defaultdict(int|float)``,
    or an UPPER_CASE dict/list global whose name says counter/stats."""
    if mod.tree is None:
        return []
    out: list[Finding] = []
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            continue
        smells = None
        if isinstance(value, ast.Call):
            fn = value.func
            callee = (
                fn.attr if isinstance(fn, ast.Attribute)
                else getattr(fn, "id", "")
            )
            if callee in _COUNTERISH_CALLS:
                smells = f"{callee}(...)"
        if smells is None and isinstance(value, (ast.Dict, ast.List)):
            if any(
                n.isupper() and n.lower().endswith(_COUNTERISH_NAMES)
                for n in names
            ):
                smells = "counter-named global"
        if smells is None:
            continue
        for n in names:
            if f"{mod.rel}:{n}" in COUNTER_ALLOWLIST:
                continue
            out.append(finding(
                R_COUNTER, mod, node.lineno,
                f"module-level counter {n!r} ({smells}) — register it "
                "on the server's MetricsRegistry (predictionio_tpu_torch/obs) "
                "instead",
                symbol=n,
            ))
    return out


def _decorator_name(dec: ast.expr) -> str:
    # @lru_cache, @functools.lru_cache, @lru_cache(maxsize=N) all resolve
    # to the bare callee name
    if isinstance(dec, ast.Call):
        dec = dec.func
    if isinstance(dec, ast.Attribute):
        return dec.attr
    return getattr(dec, "id", "")


def adhoc_caches(mod: Module) -> list[Finding]:
    """Module-level caching outside the serving cache layer: memoizing
    decorators (``functools.lru_cache``/``cache``) and module-level
    globals whose name says cache (``X_CACHE = {...}``, ``_cache = {}``).
    Instance attributes are out of scope — they die with their owner."""
    if mod.tree is None:
        return []
    out: list[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                name = _decorator_name(dec)
                if name in _CACHE_DECORATORS and name != "cached_property":
                    if f"{mod.rel}:{node.name}" in CACHE_ALLOWLIST:
                        continue
                    out.append(finding(
                        R_CACHE_RULE, mod, node.lineno,
                        f"@{name} on {node.name!r} — per-module caches "
                        "belong in predictionio_tpu_torch/serving "
                        "(result_cache/event_cache: invalidation + obs "
                        "+ TTL), not in ad-hoc memoizers",
                        symbol=node.name,
                    ))
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if not t.id.lower().rstrip("s").endswith("cache"):
                continue
            if f"{mod.rel}:{t.id}" in CACHE_ALLOWLIST:
                continue
            out.append(finding(
                R_CACHE_RULE, mod, node.lineno,
                f"module-level cache global {t.id!r} — use "
                "serving/result_cache.py or serving/event_cache.py "
                "(they carry invalidation, obs bridging, and a TTL "
                "backstop)",
                symbol=t.id,
            ))
    return out


@analyzer("hygiene")
def analyze(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.modules:
        if mod.parse_error is not None:
            out.append(finding(
                R_SYNTAX, mod, mod.parse_error.lineno or 1,
                f"syntax error: {mod.parse_error.msg}",
            ))
            continue
        out.extend(unused_imports(mod))
        if not rel_in(mod.rel, "obs"):
            out.extend(module_level_counters(mod))
        if not rel_in(mod.rel, "serving"):
            out.extend(adhoc_caches(mod))
    return out

from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("hygiene", R_SYNTAX.id, R_UNUSED_IMPORT.id, R_COUNTER.id,
           R_CACHE_RULE.id)
