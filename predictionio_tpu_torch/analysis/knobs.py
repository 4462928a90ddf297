"""Knob-registry analyzer: every ``PIO_*`` env read, with receipts.

Operators tune this platform entirely through ``PIO_*`` environment
variables, and the only discovery surface is ``docs/operations.md`` (+
``docs/observability.md`` for the telemetry knobs).  A knob that code
reads but docs don't mention is invisible; a knob docs promise but code
ignores is a lie; a default that differs between code and docs (or
between two read sites) means the doc'd behaviour isn't the shipped
behaviour.

The analyzer extracts every read — ``os.environ.get``/``[]``/
``os.getenv``/``setdefault`` plus the repo's ``_env_num``/``_env_flag``
helpers — with its literal default and parse type (from the helper's
cast arg or an enclosing ``int()``/``float()`` call).  Dynamic families
built with f-strings (``PIO_STORAGE_SOURCES_<N>_TYPE``) are recorded as
prefix patterns and matched against the docs' own prefix mentions
(``PIO_STORAGE_SOURCES_``).  Shell scripts under ``bin/`` and
``tools/*.sh`` count as readers so shell-only knobs (``PIO_PID_DIR``,
``PIO_ANALYZE_FULL``) aren't "dead".

The machine-readable registry rides in the JSON report under
``knobs`` — the doc tables and this registry must agree exactly.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rule,
)

R_UNDOCUMENTED = rule(
    "knob-undocumented", "error",
    "PIO_* knob read in code but absent from the docs",
    "an undocumented knob is untunable in production and rots into "
    "load-bearing folklore",
)
R_DEAD_DOC = rule(
    "knob-dead-doc", "warning",
    "PIO_* knob documented but read nowhere in code or bin/",
    "docs promising a knob that does nothing sends operators on a "
    "goose chase",
)
R_DEFAULT_MISMATCH = rule(
    "knob-default-mismatch", "error",
    "documented default differs from the code default",
    "the doc'd behaviour is not the shipped behaviour; ops runbooks "
    "built on the doc value are wrong",
)
R_INCONSISTENT = rule(
    "knob-inconsistent-default", "error",
    "same knob read with different defaults at different sites",
    "two sites disagreeing about the default means behaviour depends "
    "on which code path reads first",
)

_ENV_HELPERS = {"_env_num", "env_num", "_env_flag", "env_flag"}
_TOKEN_RE = re.compile(r"PIO_[A-Z][A-Z0-9_]*")
# doc table row: | `PIO_X` | default | meaning |
_TABLE_ROW_RE = re.compile(
    r"^\s*\|\s*`(PIO_[A-Z][A-Z0-9_]*)`\s*\|\s*([^|]*)\|"
)


def _dotted(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _literal(node: Optional[ast.expr]):
    if isinstance(node, ast.Constant):
        return node.value
    return None


def _joined_prefix(node: ast.expr) -> Optional[str]:
    """Leading literal of an f-string: ``f"PIO_STORAGE_{n}_TYPE"`` →
    ``PIO_STORAGE_``."""
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str) \
                and head.value.startswith("PIO_"):
            return head.value
    return None


class _Read:
    def __init__(self, name, rel, line, default, type_):
        self.name = name
        self.rel = rel
        self.line = line
        self.default = default  # literal or None when dynamic/absent
        self.has_default = default is not ...
        self.type = type_


def _enclosing_cast(node: ast.AST, parents: dict) -> Optional[str]:
    p = parents.get(node)
    # hop over `int(os.environ.get(...) or 64)`-style glue
    while isinstance(p, (ast.BoolOp, ast.BinOp, ast.IfExp)):
        node, p = p, parents.get(p)
    if isinstance(p, ast.Call) and p.func is not node:
        name = getattr(p.func, "id", "")
        if name in {"int", "float", "bool", "str"}:
            return name
    return None


def collect_reads(mod: Module) -> tuple[list[_Read], set[str]]:
    """(concrete reads, family prefixes) for one module."""
    reads: list[_Read] = []
    families: set[str] = set()
    if mod.tree is None:
        return reads, families
    parents = mod.parents()
    for node in ast.walk(mod.tree):
        # f-string knob families anywhere in the module
        prefix = _joined_prefix(node) if isinstance(node, ast.JoinedStr) \
            else None
        if prefix:
            families.add(prefix)
            continue
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            if "environ" in _dotted(node.value):
                key = _literal(node.slice)
                if isinstance(key, str) and key.startswith("PIO_"):
                    reads.append(_Read(key, mod.rel, node.lineno, ..., None))
            continue
        if not isinstance(node, ast.Call):
            continue
        fname = _dotted(node.func)
        short = fname.rsplit(".", 1)[-1]
        arg0 = node.args[0] if node.args else None
        key = _literal(arg0)
        is_env_get = (
            short in {"get", "setdefault"} and "environ" in fname
        ) or fname in {"os.getenv", "getenv"}
        if is_env_get:
            if isinstance(key, str) and key.startswith("PIO_"):
                default = (
                    _literal(node.args[1]) if len(node.args) > 1 else
                    (... if len(node.args) == 1 else None)
                )
                if len(node.args) > 1 and not isinstance(
                    node.args[1], ast.Constant
                ):
                    default = None  # computed default: present, unknown
                reads.append(_Read(
                    key, mod.rel, node.lineno, default,
                    _enclosing_cast(node, parents),
                ))
            elif arg0 is not None and _joined_prefix(arg0):
                families.add(_joined_prefix(arg0))
        elif short in _ENV_HELPERS and isinstance(key, str) and \
                key.startswith("PIO_"):
            default = _literal(node.args[1]) if len(node.args) > 1 else ...
            if len(node.args) > 1 and not isinstance(
                node.args[1], ast.Constant
            ):
                default = None
            if "flag" in short:
                type_ = "bool"
                if default is ...:
                    default = False
            else:
                type_ = (
                    getattr(node.args[2], "id", "num")
                    if len(node.args) > 2 else "num"
                )
            reads.append(_Read(key, mod.rel, node.lineno, default, type_))
    return reads, families


def _norm_default(val) -> Optional[str]:
    """Normalize a default for code↔doc comparison: numbers compare
    numerically, booleans as 1/0, strings case-insensitively."""
    if val is None or val is ...:
        return None
    if isinstance(val, bool):
        return "1" if val else "0"
    if isinstance(val, (int, float)):
        f = float(val)
        return str(int(f)) if f.is_integer() else repr(f)
    s = str(val).strip().strip("`")
    if s in {"", "unset", "(unset)", "none", "off", "-", "—"}:
        return None
    try:
        f = float(s)
        return str(int(f)) if f.is_integer() else repr(f)
    except ValueError:
        return s.lower()


def doc_tokens(index: RepoIndex) -> tuple[set[str], set[str], dict[str, tuple[str, str, int]]]:
    """(concrete doc'd knobs, doc'd prefixes, table defaults).

    Table defaults map knob → (default cell, doc rel, line) from
    ``| `PIO_X` | default | ...`` rows.
    """
    concrete: set[str] = set()
    prefixes: set[str] = set()
    defaults: dict[str, tuple[str, str, int]] = {}
    for rel, text in index.docs.items():
        for tok in _TOKEN_RE.findall(text):
            if tok.endswith("_"):
                prefixes.add(tok)
            else:
                concrete.add(tok)
        for i, line in enumerate(text.splitlines(), start=1):
            m = _TABLE_ROW_RE.match(line)
            if m and m.group(1) not in defaults:
                defaults[m.group(1)] = (m.group(2).strip(), rel, i)
    return concrete, prefixes, defaults


@analyzer("knobs")
def analyze(index: RepoIndex):
    reads: list[_Read] = []
    families: set[str] = set()
    for mod in index.modules:
        r, f = collect_reads(mod)
        reads.extend(r)
        families |= f
    by_name: dict[str, list[_Read]] = {}
    for r in reads:
        by_name.setdefault(r.name, []).append(r)
    doc_concrete, doc_prefixes, doc_defaults = doc_tokens(index)
    shell_tokens = {
        tok
        for text in index.bin_texts.values()
        for tok in _TOKEN_RE.findall(text)
    }

    out: list[Finding] = []
    registry = []
    documented_count = 0
    for name in sorted(by_name):
        sites = by_name[name]
        first = min(sites, key=lambda s: (s.rel, s.line))
        lit_defaults = {
            _norm_default(s.default)
            for s in sites
            if s.default is not ... and s.default is not None
        }
        documented = name in doc_concrete or any(
            name.startswith(p) for p in doc_prefixes
        )
        if documented:
            documented_count += 1
        else:
            out.append(finding(
                R_UNDOCUMENTED, index.module(first.rel) or first.rel,
                first.line,
                f"{name} is read here but documented nowhere under "
                "docs/; add it to the ops knob tables or delete the "
                "read",
                symbol=name,
            ))
        if len(lit_defaults) > 1:
            out.append(finding(
                R_INCONSISTENT, index.module(first.rel) or first.rel,
                first.line,
                f"{name} has {len(sites)} read sites with differing "
                f"defaults {sorted(lit_defaults)}; hoist one default",
                symbol=name,
            ))
        doc_def = doc_defaults.get(name)
        if doc_def is not None and len(lit_defaults) == 1:
            code_norm = next(iter(lit_defaults))
            doc_norm = _norm_default(doc_def[0])
            if doc_norm is not None and code_norm is not None and \
                    doc_norm != code_norm:
                out.append(finding(
                    R_DEFAULT_MISMATCH,
                    index.module(first.rel) or first.rel, first.line,
                    f"{name} defaults to {code_norm} in code but "
                    f"{doc_def[0]!r} in {doc_def[1]}:{doc_def[2]}",
                    symbol=name,
                ))
        types = {s.type for s in sites if s.type}
        registry.append({
            "name": name,
            "default": None if first.default in (..., None)
            else first.default,
            "type": sorted(types)[0] if types else "str",
            "documented": documented,
            "sites": [f"{s.rel}:{s.line}" for s in sites],
        })

    # docs promising knobs nothing reads
    code_names = set(by_name)
    for name in sorted(doc_concrete):
        if name in code_names or name in shell_tokens:
            continue
        if any(name.startswith(p) for p in families):
            continue  # member of a dynamically-built family
        # locate the first doc mention for the finding position
        where, line_no = "docs", 1
        for rel, text in index.docs.items():
            for i, line in enumerate(text.splitlines(), start=1):
                if name in line:
                    where, line_no = rel, i
                    break
            if where != "docs":
                break
        out.append(finding(
            R_DEAD_DOC, where, line_no,
            f"{name} is documented but read nowhere in code or bin/; "
            "delete the doc row or wire the knob",
            symbol=name,
        ))
    extras = {
        "knobs": {
            "count": len(registry),
            "documented": documented_count,
            "families": sorted(families),
            "entries": registry,
        }
    }
    return out, extras

from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("knobs", R_UNDOCUMENTED.id, R_DEAD_DOC.id, R_DEFAULT_MISMATCH.id,
           R_INCONSISTENT.id)
