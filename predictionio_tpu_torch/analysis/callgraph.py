"""Whole-repo interprocedural call graph + per-function lock summaries.

The per-module analyzers reason one module at a time with lexical
``with``-held sets, while the failure classes that matter in a concurrent
distributed system span call chains (router → breaker → metrics
bridge).  This module gives every analyzer the shared interprocedural
substrate:

* **Call graph** over the existing :class:`RepoIndex` parse cache.
  Resolution covers the idioms the codebase actually uses (the same
  ones ``hotpath.py`` chases inside one module):

  - module-level functions called by name, directly or through
    ``import m`` / ``from m import f [as g]`` (absolute and relative);
  - methods via ``self.m()`` / ``cls.m()`` with an MRO walk over
    repo-resolved base classes;
  - methods on attributes via *self-type inference* on class bodies
    (``self.breaker = CircuitBreaker(...)`` ⇒ ``self.breaker.allow()``
    resolves to ``CircuitBreaker.allow``), on annotated parameters, and
    on locally-constructed instances (``b = Batcher(); b.submit()``);
  - ``functools.partial(f, ...)`` and bare function references escaping
    as thread targets / callbacks (``Thread(target=self._loop)``,
    ``on_retry=self._note_retry``) — recorded as *ref* edges, treated
    as potential calls by reachability;
  - constructor calls (``Foo()`` ⇒ edge to ``Foo.__init__``).

  Anything else — getattr dispatch, dict-of-functions tables, values
  returned from factories — degrades to an **unknown callee**: the call
  site is counted but claims no edge.  Unknown callees make the graph
  *under*-approximate reachability; analyzers built on it must treat
  "reachable" as evidence and "unreachable" as absence of evidence,
  never proof.

* **Lock summaries**: per function, the set of locks acquired (both the
  ``with self._lock:`` form and explicit ``acquire()``/``release()``
  pairs, e.g. try/finally), and the set of locks *held* at every call
  site.  Lock identity is static — ``<rel>::<Class>.<attr>`` for
  instance locks, ``<rel>::<name>`` for module-level locks — so two
  instances of one class share a token.  That collapses per-instance
  hierarchies (a parent/child pair locking each other reads as a
  self-edge, which ``lockorder`` ignores); the miss is documented in
  docs/analysis.md rather than papered over with false cycles.

The graph is built once per :class:`RepoIndex` and cached on it, so
``lockorder``/``deadline``/``collective`` and the bench artifact all
share one build.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from predictionio_tpu_torch.analysis.core import Module, RepoIndex

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# threading.local() and queue types are concurrency-safe containers, not
# locks — never lock tokens even when their attr name says "lock"
_NOT_LOCKS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
              "deque", "Event", "local"}


def lockish_attr(attr: str, known_locks: set[str]) -> bool:
    """The repo's lock-attr heuristic (shared with races.py): discovered
    ctors plus the naming convention for base-class locks."""
    return attr in known_locks or "lock" in attr or attr in {"_cv", "_busy"}


def _ctor_name(value: ast.expr) -> str:
    if isinstance(value, ast.Call):
        f = value.func
        return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    return ""


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# -- acquire()/release() intervals --------------------------------------------


@dataclass(frozen=True)
class LockInterval:
    """One explicit ``x.acquire()`` … ``x.release()`` span (by line)."""

    token: str
    start: int  # acquire line
    end: int    # release line (or function end when unmatched)

    def covers(self, line: int) -> bool:
        return self.start < line <= self.end


def acquire_intervals(
    fn: ast.AST,
    token_for: "callable",
    end_line: int,
) -> list[LockInterval]:
    """Explicit-pair lock spans inside ``fn``.

    ``token_for(expr)`` maps the receiver of ``.acquire()`` to a lock
    token (or None when it isn't lock-shaped).  The i-th ``acquire`` on
    a token pairs with the i-th ``release`` *after* it, which covers the
    try/finally idiom::

        self._lock.acquire()
        try: ...
        finally: self._lock.release()

    An unmatched ``acquire`` holds to the end of the function (the
    conservative reading: the lock never visibly comes back).
    """
    events: dict[str, list[tuple[int, str]]] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("acquire", "release")):
            continue
        token = token_for(node.func.value)
        if token is None:
            continue
        events.setdefault(token, []).append((node.lineno, node.func.attr))
    out: list[LockInterval] = []
    for token, evs in events.items():
        evs.sort()
        open_lines: list[int] = []
        for line, kind in evs:
            if kind == "acquire":
                open_lines.append(line)
            elif open_lines:
                out.append(LockInterval(token, open_lines.pop(0), line))
            # release with no prior acquire: caller-held handoff, ignore
        for line in open_lines:
            out.append(LockInterval(token, line, end_line))
    return out


# -- graph data model ----------------------------------------------------------


@dataclass
class CallSite:
    line: int
    callees: tuple[str, ...]  # resolved node quals (empty = unknown)
    held: frozenset[str]      # lock tokens held at the call
    kind: str = "call"        # "call" | "ref" (callback/thread target)


@dataclass
class Acquire:
    token: str
    line: int
    held: frozenset[str]  # locks already held when this one is taken
    via: str              # "with" | "acquire"


@dataclass
class FuncNode:
    qual: str  # "<rel>::Class.method" / "<rel>::fn" / "<rel>::outer.inner"
    rel: str
    name: str  # bare name
    cls: Optional[str]
    line: int
    params: list[str] = field(default_factory=list)
    calls: list[CallSite] = field(default_factory=list)
    acquires: list[Acquire] = field(default_factory=list)
    ast_node: Optional[ast.AST] = field(default=None, repr=False)


@dataclass
class _ClassSym:
    rel: str
    name: str
    bases: list[ast.expr]
    methods: dict[str, str] = field(default_factory=dict)  # name → qual
    attr_types: dict[str, str] = field(default_factory=dict)  # attr → cls key
    lock_attrs: set[str] = field(default_factory=set)

    @property
    def key(self) -> str:
        return f"{self.rel}::{self.name}"


class CallGraph:
    """The built graph: nodes, resolved edges, and resolution stats."""

    def __init__(self) -> None:
        self.nodes: dict[str, FuncNode] = {}
        self.classes: dict[str, _ClassSym] = {}  # key → sym
        self.total_sites = 0
        self.resolved_sites = 0

    # -- queries --------------------------------------------------------------

    def edges(self) -> list[tuple[str, str, int, str]]:
        """(caller, callee, line, kind) for every resolved edge."""
        out = []
        for n in self.nodes.values():
            for site in n.calls:
                for c in site.callees:
                    out.append((n.qual, c, site.line, site.kind))
        return out

    def successors(self, qual: str) -> set[str]:
        n = self.nodes.get(qual)
        if n is None:
            return set()
        return {c for site in n.calls for c in site.callees}

    def reachable(self, roots: set[str]) -> set[str]:
        seen: set[str] = set()
        stack = [r for r in roots if r in self.nodes]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.successors(cur) - seen)
        return seen

    def stats(self) -> dict:
        n_edges = sum(
            len(site.callees) for n in self.nodes.values()
            for site in n.calls
        )
        return {
            "nodes": len(self.nodes),
            "edges": n_edges,
            "call_sites": self.total_sites,
            "resolved_sites": self.resolved_sites,
            "resolution_rate": (
                round(self.resolved_sites / self.total_sites, 4)
                if self.total_sites else None
            ),
        }


# -- builder -------------------------------------------------------------------


class _ModuleSyms:
    """Per-module name environment: imports, functions, classes, consts."""

    def __init__(self, mod: Module):
        self.mod = mod
        # alias → dotted module ("np" → "numpy")
        self.import_mods: dict[str, str] = {}
        # alias → (dotted module, attr) for `from m import a [as b]`
        self.import_names: dict[str, tuple[str, str]] = {}
        self.functions: dict[str, str] = {}  # name → qual
        self.classes: dict[str, _ClassSym] = {}  # name → sym
        self.str_consts: dict[str, str] = {}  # NAME → "literal"

    def package(self) -> str:
        """Dotted package containing this module (for relative imports)."""
        parts = self.mod.rel[:-3].split("/")  # strip .py
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts[:-1]) if parts else ""


def _resolve_relative(pkg: str, level: int, module: Optional[str]) -> str:
    parts = pkg.split(".") if pkg else []
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    if module:
        parts += module.split(".")
    return ".".join(parts)


def _module_rel(index: RepoIndex, dotted: str) -> Optional[str]:
    base = dotted.replace(".", "/")
    for rel in (base + ".py", base + "/__init__.py"):
        if index.module(rel) is not None:
            return rel
    return None


def _collect_module_syms(mod: Module) -> _ModuleSyms:
    syms = _ModuleSyms(mod)
    if mod.tree is None:
        return syms
    pkg = syms.package()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                syms.import_mods[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
                if a.asname is None:
                    # `import a.b.c` binds `a`, but calls are `a.b.c.f()`;
                    # record the full dotted name under its head too
                    syms.import_mods.setdefault(a.name, a.name)
        elif isinstance(node, ast.ImportFrom):
            target = _resolve_relative(pkg, node.level, node.module) \
                if node.level else (node.module or "")
            for a in node.names:
                syms.import_names[a.asname or a.name] = (target, a.name)
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            syms.functions[node.name] = f"{mod.rel}::{node.name}"
        elif isinstance(node, ast.ClassDef):
            sym = _ClassSym(rel=mod.rel, name=node.name, bases=node.bases)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    sym.methods[item.name] = \
                        f"{mod.rel}::{node.name}.{item.name}"
            syms.classes[node.name] = sym
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            syms.str_consts[node.targets[0].id] = node.value.value
    return syms


class _Builder:
    def __init__(self, index: RepoIndex):
        self.index = index
        self.graph = CallGraph()
        self.syms: dict[str, _ModuleSyms] = {}

    # -- name resolution ------------------------------------------------------

    def _class_by_name(
        self, syms: _ModuleSyms, name: str
    ) -> Optional[_ClassSym]:
        if name in syms.classes:
            return syms.classes[name]
        imp = syms.import_names.get(name)
        if imp is not None:
            target_rel = _module_rel(self.index, imp[0])
            if target_rel is not None and target_rel in self.syms:
                tsyms = self.syms[target_rel]
                if imp[1] in tsyms.classes:
                    return tsyms.classes[imp[1]]
                # re-export chase, one hop (package __init__ pattern)
                reimp = tsyms.import_names.get(imp[1])
                if reimp is not None:
                    rel2 = _module_rel(self.index, reimp[0])
                    if rel2 is not None and rel2 in self.syms and \
                            reimp[1] in self.syms[rel2].classes:
                        return self.syms[rel2].classes[reimp[1]]
        return None

    def _class_of_expr(
        self, syms: _ModuleSyms, node: ast.expr
    ) -> Optional[_ClassSym]:
        """Class named by an annotation/ctor expression, if repo-local."""
        if isinstance(node, ast.Name):
            return self._class_by_name(syms, node.id)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return self._class_by_name(syms, node.value)
        if isinstance(node, ast.Attribute):
            # mod.Class
            base = node.value
            if isinstance(base, ast.Name) and base.id in syms.import_mods:
                rel = _module_rel(self.index, syms.import_mods[base.id])
                if rel is not None and rel in self.syms:
                    return self.syms[rel].classes.get(node.attr)
        if isinstance(node, ast.Subscript):
            # Optional[T] / list[T]: try the inner name
            return self._class_of_expr(syms, node.slice)
        return None

    def _mro(self, sym: _ClassSym) -> list[_ClassSym]:
        """Breadth-first base-class chain, repo-resolved, cycle-guarded."""
        out, queue, seen = [], [sym], {sym.key}
        while queue:
            cur = queue.pop(0)
            out.append(cur)
            cur_syms = self.syms.get(cur.rel)
            if cur_syms is None:
                continue
            for b in cur.bases:
                bsym = self._class_of_expr(cur_syms, b)
                if bsym is not None and bsym.key not in seen:
                    seen.add(bsym.key)
                    queue.append(bsym)
        return out

    def _method(self, sym: _ClassSym, name: str) -> Optional[str]:
        for c in self._mro(sym):
            if name in c.methods:
                return c.methods[name]
        return None

    def _function(self, syms: _ModuleSyms, name: str) -> Optional[str]:
        if name in syms.functions:
            return syms.functions[name]
        imp = syms.import_names.get(name)
        if imp is not None:
            rel = _module_rel(self.index, imp[0])
            if rel is not None and rel in self.syms:
                tsyms = self.syms[rel]
                if imp[1] in tsyms.functions:
                    return tsyms.functions[imp[1]]
                reimp = tsyms.import_names.get(imp[1])
                if reimp is not None:
                    rel2 = _module_rel(self.index, reimp[0])
                    if rel2 is not None and rel2 in self.syms and \
                            reimp[1] in self.syms[rel2].functions:
                        return self.syms[rel2].functions[reimp[1]]
        return None

    # -- per-class attr-type inference ----------------------------------------

    def _infer_attr_types(self) -> None:
        for rel, syms in self.syms.items():
            for csym in syms.classes.values():
                mod = self.index.module(rel)
                if mod is None or mod.tree is None:
                    continue
                cls_node = next(
                    (n for n in ast.walk(mod.tree)
                     if isinstance(n, ast.ClassDef) and n.name == csym.name),
                    None,
                )
                if cls_node is None:
                    continue
                for node in ast.walk(cls_node):
                    attr, ann = None, None
                    if isinstance(node, ast.Assign) and node.targets:
                        attr = _is_self_attr(node.targets[0])
                        ann = node.value
                    elif isinstance(node, ast.AnnAssign):
                        attr = _is_self_attr(node.target)
                        ann = node.annotation
                    if attr is None or ann is None:
                        continue
                    ctor = _ctor_name(ann) if isinstance(ann, ast.Call) \
                        else ""
                    if ctor in _LOCK_CTORS:
                        csym.lock_attrs.add(attr)
                        continue
                    target = (
                        ann.func if isinstance(ann, ast.Call) else ann
                    )
                    tsym = self._class_of_expr(syms, target)
                    if tsym is not None:
                        csym.attr_types.setdefault(attr, tsym.key)

    # -- lock tokens ----------------------------------------------------------

    def _module_locks(self, syms: _ModuleSyms) -> set[str]:
        mod = syms.mod
        out: set[str] = set()
        if mod.tree is None:
            return out
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            _ctor_name(node.value) in _LOCK_CTORS:
                        out.add(t.id)
        return out

    def _lock_token(
        self,
        expr: ast.expr,
        syms: _ModuleSyms,
        cls: Optional[_ClassSym],
        module_locks: set[str],
    ) -> Optional[str]:
        """Lock token for a with-item / acquire receiver, or None."""
        attr = _is_self_attr(expr)
        if attr is not None and cls is not None:
            known = set()
            for c in self._mro(cls):
                known |= c.lock_attrs
            if not lockish_attr(attr, known):
                return None
            # token on the class that DECLARES the lock, so a base-class
            # lock shared by siblings is one token, not one per subclass
            for c in self._mro(cls):
                if attr in c.lock_attrs:
                    return f"{c.rel}::{c.name}.{attr}"
            return f"{cls.rel}::{cls.name}.{attr}"
        if isinstance(expr, ast.Name):
            if expr.id in module_locks or (
                "lock" in expr.id.lower()
                and (expr.id in syms.import_names or expr.id in module_locks)
            ):
                return f"{syms.mod.rel}::{expr.id}"
        return None

    # -- function body pass ---------------------------------------------------

    def _walk_functions(self, mod: Module):
        """Yield (fn_node, qual, cls_sym, bare_name) for every def."""
        if mod.tree is None:
            return
        syms = self.syms[mod.rel]

        def visit(body, prefix: str, cls: Optional[_ClassSym]):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{mod.rel}::{prefix}{node.name}"
                    yield node, qual, cls, node.name
                    yield from visit(
                        node.body, f"{prefix}{node.name}.", cls
                    )
                elif isinstance(node, ast.ClassDef):
                    csym = syms.classes.get(node.name) if not prefix else None
                    inner_prefix = f"{prefix}{node.name}."
                    yield from visit(node.body, inner_prefix, csym)
                elif hasattr(node, "body") and not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Lambda)
                ):
                    # compound statements at module/class level (if/try
                    # guarding defs — the version-shim idiom)
                    for attr_name in ("body", "orelse", "finalbody",
                                      "handlers"):
                        sub = getattr(node, attr_name, None) or []
                        for item in sub:
                            if isinstance(item, ast.ExceptHandler):
                                yield from visit(item.body, prefix, cls)
                            elif isinstance(item, ast.stmt):
                                yield from visit([item], prefix, cls)

        yield from visit(mod.tree.body, "", None)

    def build(self) -> CallGraph:
        for mod in self.index.modules:
            self.syms[mod.rel] = _collect_module_syms(mod)
        self._infer_attr_types()
        # register all nodes first so edge resolution can target them
        for mod in self.index.modules:
            for fn, qual, cls, name in self._walk_functions(mod):
                params = [a.arg for a in (
                    fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
                )]
                self.graph.nodes[qual] = FuncNode(
                    qual=qual, rel=mod.rel, name=name,
                    cls=cls.name if cls else None,
                    line=fn.lineno, params=params, ast_node=fn,
                )
        for name, sym in (
            (s.name, s) for m in self.syms.values()
            for s in m.classes.values()
        ):
            self.graph.classes[sym.key] = sym
        for mod in self.index.modules:
            self._build_module_edges(mod)
        return self.graph

    def _build_module_edges(self, mod: Module) -> None:
        syms = self.syms[mod.rel]
        module_locks = self._module_locks(syms)
        parents = mod.parents()
        fns = [
            (fn, qual, cls)
            for fn, qual, cls, _ in self._walk_functions(mod)
        ]
        fn_nodes = {id(fn): qual for fn, qual, _ in fns}

        for fn, qual, cls in fns:
            node = self.graph.nodes[qual]
            local_defs = {
                n.name: f"{qual}.{n.name}"
                for n in ast.iter_child_nodes(fn)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            # local instance types: v = ClassName(...), plus annotations
            local_types: dict[str, str] = {}
            for p in fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs:
                if p.annotation is not None:
                    tsym = self._class_of_expr(syms, p.annotation)
                    if tsym is not None:
                        local_types[p.arg] = tsym.key
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name) and \
                        isinstance(n.value, ast.Call):
                    tsym = self._class_of_expr(syms, n.value.func)
                    if tsym is not None:
                        local_types[n.targets[0].id] = tsym.key

            end_line = max(
                (getattr(n, "end_lineno", None)
                 or getattr(n, "lineno", 0) for n in ast.walk(fn)),
                default=fn.lineno,
            )
            token_for = lambda e: self._lock_token(  # noqa: E731
                e, syms, cls, module_locks
            )
            intervals = acquire_intervals(fn, token_for, end_line)

            def held_at(n: ast.AST) -> frozenset[str]:
                held: set[str] = set()
                p = parents.get(n)
                while p is not None and p is not fn:
                    if isinstance(p, ast.With):
                        for item in p.items:
                            tok = token_for(item.context_expr)
                            if tok is not None:
                                held.add(tok)
                    if isinstance(
                        p, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        break  # nested def: its body runs later
                    p = parents.get(p)
                for iv in intervals:
                    if iv.covers(n.lineno):
                        held.add(iv.token)
                # repo convention (wal.py): `*_locked` helpers run with
                # the instance `_lock` already held by their caller
                if node.name.endswith("_locked") and cls is not None:
                    tok = self._lock_token(
                        ast.Attribute(
                            value=ast.Name(id="self", ctx=ast.Load()),
                            attr="_lock", ctx=ast.Load(),
                        ),
                        syms, cls, module_locks,
                    )
                    if tok is not None:
                        held.add(tok)
                return frozenset(held)

            def in_nested_def(n: ast.AST) -> bool:
                p = parents.get(n)
                while p is not None and p is not fn:
                    if isinstance(
                        p, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and id(p) in fn_nodes:
                        return True
                    p = parents.get(p)
                return False

            # acquires: with-statements + explicit pairs
            for n in ast.walk(fn):
                if in_nested_def(n):
                    continue
                if isinstance(n, ast.With):
                    for item in n.items:
                        tok = token_for(item.context_expr)
                        if tok is not None:
                            node.acquires.append(Acquire(
                                token=tok, line=n.lineno,
                                held=held_at(n), via="with",
                            ))
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "acquire":
                    tok = token_for(n.func.value)
                    if tok is not None:
                        node.acquires.append(Acquire(
                            token=tok, line=n.lineno,
                            held=held_at(n) - {tok}, via="acquire",
                        ))

            # call + ref edges
            for n in ast.walk(fn):
                if not isinstance(n, ast.Call) or in_nested_def(n):
                    continue
                held = held_at(n)
                callees = self._resolve_call(
                    n, syms, cls, local_defs, local_types, qual
                )
                self.graph.total_sites += 1
                if callees:
                    self.graph.resolved_sites += 1
                node.calls.append(CallSite(
                    line=n.lineno, callees=tuple(sorted(callees)),
                    held=held, kind="call",
                ))
                # bare function references passed as arguments become
                # potential calls on some other thread/callback
                for arg in list(n.args) + [kw.value for kw in n.keywords]:
                    refs = self._resolve_ref(
                        arg, syms, cls, local_defs, local_types
                    )
                    if refs:
                        node.calls.append(CallSite(
                            line=n.lineno, callees=tuple(sorted(refs)),
                            held=held, kind="ref",
                        ))

    def _resolve_call(
        self,
        call: ast.Call,
        syms: _ModuleSyms,
        cls: Optional[_ClassSym],
        local_defs: dict[str, str],
        local_types: dict[str, str],
        caller_qual: str,
    ) -> set[str]:
        f = call.func
        out: set[str] = set()
        if isinstance(f, ast.Name):
            if f.id in local_defs:
                out.add(local_defs[f.id])
            else:
                q = self._function(syms, f.id)
                if q is not None:
                    out.add(q)
                else:
                    csym = self._class_by_name(syms, f.id)
                    if csym is not None:
                        init = self._method(csym, "__init__")
                        if init is not None:
                            out.add(init)
        elif isinstance(f, ast.Attribute):
            recv = f.value
            # self.m() / cls.m()
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                    and cls is not None:
                q = self._method(cls, f.attr)
                if q is not None:
                    out.add(q)
            # self.attr.m() via inferred attr type
            elif (attr := _is_self_attr(recv)) is not None \
                    and cls is not None:
                for c in self._mro(cls):
                    tkey = c.attr_types.get(attr)
                    if tkey is not None and tkey in self.graph.classes:
                        q = self._method(self.graph.classes[tkey], f.attr)
                        if q is not None:
                            out.add(q)
                        break
            elif isinstance(recv, ast.Name):
                if recv.id in local_types:
                    tkey = local_types[recv.id]
                    if tkey in self.graph.classes:
                        q = self._method(self.graph.classes[tkey], f.attr)
                        if q is not None:
                            out.add(q)
                elif recv.id in syms.import_mods:
                    rel = _module_rel(self.index, syms.import_mods[recv.id])
                    if rel is not None and rel in self.syms:
                        tsyms = self.syms[rel]
                        if f.attr in tsyms.functions:
                            out.add(tsyms.functions[f.attr])
                else:
                    ksym = self._class_by_name(syms, recv.id)
                    if ksym is not None:  # ClassName.method(obj, ...)
                        q = self._method(ksym, f.attr)
                        if q is not None:
                            out.add(q)
            elif isinstance(recv, ast.Attribute):
                # pkg.mod.f(): resolve dotted module receivers
                dotted = _dotted_name(recv)
                if dotted is not None:
                    rel = _module_rel(self.index, dotted)
                    if rel is not None and rel in self.syms and \
                            f.attr in self.syms[rel].functions:
                        out.add(self.syms[rel].functions[f.attr])
        return out

    def _resolve_ref(
        self,
        expr: ast.expr,
        syms: _ModuleSyms,
        cls: Optional[_ClassSym],
        local_defs: dict[str, str],
        local_types: dict[str, str],
    ) -> set[str]:
        """Function references escaping as arguments (callbacks, thread
        targets, ``partial(f, ...)``)."""
        if isinstance(expr, ast.Call):
            fname = (
                expr.func.attr if isinstance(expr.func, ast.Attribute)
                else getattr(expr.func, "id", "")
            )
            if fname == "partial" and expr.args:
                return self._resolve_ref(
                    expr.args[0], syms, cls, local_defs, local_types
                )
            return set()
        if isinstance(expr, ast.Name):
            if expr.id in local_defs:
                return {local_defs[expr.id]}
            q = self._function(syms, expr.id)
            return {q} if q is not None else set()
        attr = _is_self_attr(expr)
        if attr is not None and cls is not None:
            q = self._method(cls, attr)
            return {q} if q is not None else set()
        return set()


def _dotted_name(node: ast.expr) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- cached accessor -----------------------------------------------------------


def get(index: RepoIndex) -> CallGraph:
    """The call graph for ``index``, built once and cached on it."""
    cached = getattr(index, "_pio_callgraph", None)
    if cached is None:
        cached = _Builder(index).build()
        index._pio_callgraph = cached  # type: ignore[attr-defined]
    return cached
