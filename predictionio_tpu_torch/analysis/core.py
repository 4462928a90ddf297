"""Shared framework for the port's ``pio analyze``.

Counterpart of ``predictionio_tpu/analysis/core.py`` (parity role: the
reference gated every build on scalastyle, ``tests/unit.sh:30-35``), with
the port's scan roots (``predictionio_tpu_torch/`` and ``chip_smoke.py``)
and its own baseline file.

One engine, one finding model, one suppression mechanism:

* :class:`Finding` — severity, rule id, ``file:line``, message, and a
  line-independent ``key`` so baselines survive unrelated edits.
* :class:`RepoIndex` — a per-module parse cache shared by every
  analyzer (each source file is read and ``ast.parse``\\ d exactly once
  per run), plus the doc/bin text the contract analyzers diff against.
* Inline suppressions — ``# pio: ignore[rule-id]`` on the flagged line
  (or alone on the line above) waives that rule there; a bare
  ``# pio: ignore`` waives every rule on the line.  Suppressions are
  counted, never silent.
* Baseline — a JSON file of finding keys that are acknowledged debt;
  baselined findings don't gate but are still counted so the diff of
  the baseline file IS the regression record.

Analyzers register with :func:`analyzer`; rules declare themselves with
:func:`rule` so ``pio analyze --list-rules`` and ``docs/analysis.md``
can't drift from the code.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

SEVERITIES = ("error", "warning", "info")

# python sources scanned when the root is a full checkout; a root without
# these (the test fixtures) is scanned wholesale instead
PY_ROOTS = ("predictionio_tpu_torch",)
PY_TOP_FILES = ("chip_smoke.py",)
SKIP_DIR_PREFIXES = ("__", ".")

_SUPPRESS_RE = re.compile(
    r"#\s*pio:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?"
)


@dataclass(frozen=True)
class Rule:
    """One checkable contract: id, default severity, and rationale."""

    id: str
    severity: str
    summary: str
    rationale: str = ""


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    # stable anchor (attr/knob/metric/function name): the baseline key
    # must survive line-number churn from unrelated edits
    symbol: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}" if self.symbol \
            else f"{self.rule}:{self.path}:{self.line}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] "
            f"{self.severity}: {self.message}"
        )

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "symbol": self.symbol,
            "key": self.key,
        }


class Module:
    """One parsed source file; the parse is cached for every analyzer."""

    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(
                self.source, filename=path
            )
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        self._parents: Optional[dict[ast.AST, ast.AST]] = None
        self._suppressions: Optional[dict[int, Optional[set[str]]]] = None

    def parents(self) -> dict[ast.AST, ast.AST]:
        """child → parent map over the whole tree (cached)."""
        if self._parents is None:
            p: dict[ast.AST, ast.AST] = {}
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    for child in ast.iter_child_nodes(node):
                        p[child] = node
            self._parents = p
        return self._parents

    def suppressions(self) -> dict[int, Optional[set[str]]]:
        """line → waived rule ids (None = every rule), cached.

        A suppression comment alone on a line covers the next line, so
        long flagged statements keep their comment readable.
        """
        if self._suppressions is None:
            out: dict[int, Optional[set[str]]] = {}
            for i, text in enumerate(self.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if not m:
                    continue
                rules = (
                    {r.strip() for r in m.group(1).split(",") if r.strip()}
                    if m.group(1) else None
                )
                line = i
                if text.lstrip().startswith("#"):
                    line = i + 1  # standalone comment covers the next line
                if line in out:
                    if out[line] is None or rules is None:
                        out[line] = None
                    else:
                        out[line] |= rules
                else:
                    out[line] = rules
            self._suppressions = out
        return self._suppressions

    def suppressed(self, line: int, rule_id: str) -> bool:
        rules = self.suppressions().get(line, ...)
        if rules is ...:
            return False
        return rules is None or rule_id in rules


class RepoIndex:
    """The shared analysis context: parsed modules + docs + bin scripts.

    ``root`` is a checkout (package + tools + docs) or a test fixture
    directory; fixtures without the package layout are scanned in full
    so analyzer tests can feed minimal trees.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: list[Module] = []
        self._by_rel: dict[str, Module] = {}
        for path in self._iter_py():
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            m = Module(path, rel)
            self.modules.append(m)
            self._by_rel[rel] = m
        self.docs: dict[str, str] = {}  # rel → text
        docs_dir = os.path.join(self.root, "docs")
        if os.path.isdir(docs_dir):
            for f in sorted(os.listdir(docs_dir)):
                if f.endswith(".md"):
                    with open(os.path.join(docs_dir, f),
                              encoding="utf-8") as fh:
                        self.docs[f"docs/{f}"] = fh.read()
        readme = os.path.join(self.root, "README.md")
        if os.path.isfile(readme):
            with open(readme, encoding="utf-8") as fh:
                self.docs["README.md"] = fh.read()
        self.bin_texts: dict[str, str] = {}
        bin_dir = os.path.join(self.root, "bin")
        if os.path.isdir(bin_dir):
            for f in sorted(os.listdir(bin_dir)):
                p = os.path.join(bin_dir, f)
                if os.path.isfile(p):
                    try:
                        with open(p, encoding="utf-8") as fh:
                            self.bin_texts[f"bin/{f}"] = fh.read()
                    except UnicodeDecodeError:
                        pass
        # shell scripts under tools/ are knob readers too (ci_analyze.sh)
        tools_dir = os.path.join(self.root, "tools")
        if os.path.isdir(tools_dir):
            for f in sorted(os.listdir(tools_dir)):
                if f.endswith(".sh"):
                    with open(os.path.join(tools_dir, f),
                              encoding="utf-8") as fh:
                        self.bin_texts[f"tools/{f}"] = fh.read()

    def _iter_py(self) -> Iterable[str]:
        roots = [
            os.path.join(self.root, d)
            for d in PY_ROOTS
            if os.path.isdir(os.path.join(self.root, d))
        ]
        if roots:
            for f in PY_TOP_FILES:
                p = os.path.join(self.root, f)
                if os.path.isfile(p):
                    yield p
        else:
            roots = [self.root]  # fixture layout: scan everything
        for base in roots:
            for dirpath, dirnames, files in os.walk(base):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(SKIP_DIR_PREFIXES)
                    and d != "tests"
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)

    def module(self, rel: str) -> Optional[Module]:
        return self._by_rel.get(rel)


def rel_in(rel: str, *parts: str) -> bool:
    """True when ``rel`` lives under any of the given subtrees, whether
    the root is the real checkout (``predictionio_tpu_torch/obs/...``) or a
    test fixture (``obs/...``)."""
    return any(rel.startswith(p + "/") or f"/{p}/" in rel for p in parts)


# -- rule + analyzer registries ----------------------------------------------

RULES: dict[str, Rule] = {}
ANALYZERS: dict[str, Callable[[RepoIndex], list[Finding]]] = {}
# analyzer name → rule ids it owns (for --analyzers selection + docs)
ANALYZER_RULES: dict[str, list[str]] = {}
_current_analyzer: Optional[str] = None


def rule(id: str, severity: str, summary: str, rationale: str = "") -> Rule:
    """Declare a rule; call at import time next to its analyzer."""
    assert severity in SEVERITIES, severity
    r = Rule(id, severity, summary, rationale)
    RULES[id] = r
    if _current_analyzer is not None:
        ANALYZER_RULES.setdefault(_current_analyzer, []).append(id)
    return r


def analyzer(name: str):
    """Register ``fn(index) -> list[Finding]`` under ``name``."""

    def deco(fn: Callable[[RepoIndex], list[Finding]]):
        ANALYZERS[name] = fn
        ANALYZER_RULES.setdefault(name, [])
        return fn

    return deco


def owns_rules(name: str, *rule_ids: str) -> None:
    """Attach rule ids declared at module scope to an analyzer name."""
    ANALYZER_RULES.setdefault(name, []).extend(rule_ids)


def finding(
    rules: Rule | str,
    module_or_path,
    line: int,
    message: str,
    symbol: str = "",
    severity: Optional[str] = None,
) -> Finding:
    r = RULES[rules] if isinstance(rules, str) else rules
    path = (
        module_or_path.rel
        if isinstance(module_or_path, Module) else str(module_or_path)
    )
    return Finding(
        rule=r.id,
        severity=severity or r.severity,
        path=path,
        line=line,
        message=message,
        symbol=symbol,
    )


# -- baseline -----------------------------------------------------------------

BASELINE_NAME = ".pio-torch-analysis-baseline.json"

R_BASELINE_STALE = rule(
    "baseline-stale", "warning",
    "baseline entry no longer resolves to an existing rule/file/symbol",
    "a stale key is acknowledged debt that was already paid (or renamed "
    "out from under its key); prune it with --prune-baseline so the "
    "baseline diff stays an honest regression record",
)

_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def stale_baseline_keys(
    keys: Iterable[str], idx: "RepoIndex"
) -> list[tuple[str, str]]:
    """Baseline keys that can no longer resolve → ``(key, reason)``.

    A key is ``rule:path:symbol`` (or ``rule:path:line``).  It is stale
    when the rule id is unknown, the path no longer exists, or — for
    symbol-anchored keys — an identifier in the symbol no longer appears
    anywhere in the file's source.  Line-anchored keys are only checked
    for rule and path (line churn is exactly what symbols exist to
    absorb, so a surviving line key proves nothing either way).
    """
    out: list[tuple[str, str]] = []
    for key in sorted(set(keys)):
        parts = key.split(":", 2)
        if len(parts) != 3:
            out.append((key, "malformed key"))
            continue
        rule_id, path, symbol = parts
        if rule_id not in RULES:
            out.append((key, f"unknown rule {rule_id!r}"))
            continue
        mod = idx.module(path)
        if mod is None:
            if not os.path.isfile(os.path.join(idx.root, path)):
                out.append((key, f"file {path!r} no longer exists"))
            continue  # non-module file that still exists: can't check more
        if symbol.isdigit() or not symbol:
            continue  # line-anchored: rule+path are all we can verify
        idents = _IDENT_RE.findall(symbol)
        missing = [i for i in idents if i not in mod.source]
        if missing:
            out.append((
                key,
                f"symbol {symbol!r} not found in {path}"
                f" (missing {', '.join(missing)})",
            ))
    return out


def prune_baseline(path: str, idx: "RepoIndex") -> list[str]:
    """Drop stale keys from the baseline file; returns the removed keys."""
    keys = load_baseline(path)
    stale = {k for k, _ in stale_baseline_keys(keys, idx)}
    if not stale:
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    data["findings"] = sorted(set(keys) - stale)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return sorted(stale)


def load_baseline(path: str) -> set[str]:
    """Baseline file → set of acknowledged finding keys (missing = empty)."""
    if not os.path.isfile(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != 1:
        raise ValueError(f"unsupported baseline format in {path}")
    keys = data.get("findings", [])
    if not all(isinstance(k, str) for k in keys):
        raise ValueError(f"baseline keys must be strings in {path}")
    return set(keys)


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    data = {
        "version": 1,
        "comment": (
            "Acknowledged pre-existing findings; `pio analyze "
            "--write-baseline` regenerates. Diffs of this file are the "
            "regression record — shrink it, don't grow it."
        ),
        "findings": sorted({f.key for f in findings}),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


# -- run ----------------------------------------------------------------------

@dataclass
class Report:
    root: str
    analyzers: list[str]
    findings: list[Finding]  # active: not suppressed, not baselined
    suppressed: int = 0
    baselined: int = 0
    extras: dict = field(default_factory=dict)  # knob registry etc.

    @property
    def counts(self) -> dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        return c

    @property
    def errors(self) -> int:
        return self.counts["error"]

    @property
    def by_analyzer(self) -> dict[str, dict[str, int]]:
        """severity counts per analyzer (rule ownership via the registry;
        framework findings like baseline-stale land under 'framework')."""
        owner = {
            rid: name
            for name, rids in ANALYZER_RULES.items() for rid in rids
        }
        out: dict[str, dict[str, int]] = {
            name: {s: 0 for s in SEVERITIES} for name in self.analyzers
        }
        for f in self.findings:
            name = owner.get(f.rule, "framework")
            out.setdefault(name, {s: 0 for s in SEVERITIES})
            out[name][f.severity] += 1
        return out

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "root": self.root,
            "analyzers": self.analyzers,
            "counts": self.counts,
            "by_analyzer": self.by_analyzer,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "findings": [f.to_dict() for f in self.findings],
            **self.extras,
        }

    def render(self) -> str:
        lines = [f.render() for f in sorted(
            self.findings, key=lambda f: (f.path, f.line, f.rule)
        )]
        c = self.counts
        lines.append(
            f"{c['error']} error(s), {c['warning']} warning(s), "
            f"{c['info']} info; {self.suppressed} suppressed, "
            f"{self.baselined} baselined"
        )
        return "\n".join(lines)


_SARIF_LEVELS = {"error": "error", "warning": "warning", "info": "note"}


def to_sarif(report: Report) -> dict:
    """Report → SARIF 2.1.0 (one run, one result per active finding).

    ``partialFingerprints.pioKey`` carries the baseline key so SARIF
    consumers dedupe across line churn the same way the baseline does.
    """
    rule_ids = sorted({f.rule for f in report.findings} & set(RULES))
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "pio-analyze",
                "informationUri": "docs/analysis.md",
                "rules": [
                    {
                        "id": rid,
                        "shortDescription": {"text": RULES[rid].summary},
                        "fullDescription": {
                            "text": RULES[rid].rationale
                            or RULES[rid].summary
                        },
                        "defaultConfiguration": {
                            "level": _SARIF_LEVELS[RULES[rid].severity],
                        },
                    }
                    for rid in rule_ids
                ],
            }},
            "results": [
                {
                    "ruleId": f.rule,
                    "level": _SARIF_LEVELS.get(f.severity, "note"),
                    "message": {"text": f.message},
                    "partialFingerprints": {"pioKey": f.key},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {"startLine": max(1, f.line)},
                        },
                    }],
                }
                for f in report.findings
            ],
        }],
    }


def run(
    root: str,
    analyzers: Optional[Iterable[str]] = None,
    baseline_path: Optional[str] = None,
    changed_only: Optional[set[str]] = None,
    index: Optional[RepoIndex] = None,
) -> Report:
    """Run the selected analyzers over ``root`` and fold in suppressions
    and the baseline.  ``changed_only`` (repo-relative paths) scopes the
    REPORT, not the parse — cross-file contracts still see the whole
    repo, only findings outside the changed set are dropped."""
    # import-for-effect: the package __init__ registers every analyzer
    import importlib
    importlib.import_module("predictionio_tpu_torch.analysis")

    idx = index if index is not None else RepoIndex(root)
    names = list(analyzers) if analyzers else sorted(ANALYZERS)
    unknown = [n for n in names if n not in ANALYZERS]
    if unknown:
        raise ValueError(
            f"unknown analyzer(s) {unknown}; have {sorted(ANALYZERS)}"
        )
    bpath = (
        baseline_path
        if baseline_path is not None
        else os.path.join(idx.root, BASELINE_NAME)
    )
    baseline = load_baseline(bpath)
    raw: list[Finding] = []
    extras: dict = {}
    for name in names:
        out = ANALYZERS[name](idx)
        if isinstance(out, tuple):  # (findings, extras) analyzers
            fs, ex = out
            extras.update(ex)
            raw.extend(fs)
        else:
            raw.extend(out)
    active: list[Finding] = []
    suppressed = baselined = 0
    for f in raw:
        mod = idx.module(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            suppressed += 1
            continue
        if f.key in baseline:
            baselined += 1
            continue
        if changed_only is not None and f.path not in changed_only:
            continue
        active.append(f)
    # stale baseline keys are reported (warning), never silently dropped
    bl_rel = (
        os.path.relpath(bpath, idx.root).replace(os.sep, "/")
        if baseline else BASELINE_NAME
    )
    for key, reason in stale_baseline_keys(baseline, idx):
        f = Finding(
            rule=R_BASELINE_STALE.id,
            severity=R_BASELINE_STALE.severity,
            path=bl_rel,
            line=1,
            message=f"stale baseline entry {key!r}: {reason}; run "
                    "`pio analyze --prune-baseline` to drop it",
            symbol=key,
        )
        if changed_only is None or f.path in changed_only:
            active.append(f)
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(
        root=idx.root,
        analyzers=names,
        findings=active,
        suppressed=suppressed,
        baselined=baselined,
        extras=extras,
    )
