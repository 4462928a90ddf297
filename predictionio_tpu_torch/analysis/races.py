"""Lock-discipline race detector for the threaded serving stack.

The platform runs real threads: the micro-batcher worker, the ingest
write-behind flusher, WAL group-commit, HTTP handler threads, and
signal handlers.  Any ``self.*`` or module-global mutable state touched
from two of those without a common lock is a data race waiting for
load.

The rule is seeded with the repo's own locking conventions
(``result_cache.py``/``ingest_buffer.py``): a *lock attribute* is
anything assigned ``threading.Lock()``/``RLock()``/``Condition()``, and
a write is *guarded* when it sits lexically inside ``with self.<lock>:``.

Per class we build:

* write sites (attr assign / augassign / subscript store on ``self.X``)
  with the lexical lock set held at each site — ``__init__`` writes are
  exempt (construction precedes sharing);
* read sites, because a single-writer/multi-reader attr is still racy;
* thread entry points: public methods, ``__call__``, closures defined
  inside methods (registered as HTTP routes/callbacks), and private
  methods that *escape* as bare references (``target=self._loop``,
  ``on_retry=self._note_retry``, ``signal.signal(..., self._on_term)``);
* an intra-class call graph (``self.m()`` edges) to propagate entry
  reachability.

A write site is flagged when its attribute is touched from ≥2 entry
points and the sites don't share a common lock: **error** for
read-modify-write (``+=``, ``d[k] = v`` — lost updates under the GIL),
**warning** for plain rebinding (atomic under the GIL but unordered).
Known thread-safe containers (``queue.Queue``, ``deque``,
``threading.Event``) and the lock attrs themselves are excluded.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from predictionio_tpu_torch.analysis.callgraph import acquire_intervals
from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rel_in, rule,
)

R_UNGUARDED_RMW = rule(
    "race-unguarded-rmw", "error",
    "read-modify-write on shared state with no common lock",
    "`self.x += 1` from two threads loses updates; take the owning "
    "lock or move the counter behind one",
)
R_UNGUARDED_REBIND = rule(
    "race-unguarded-rebind", "warning",
    "unlocked rebind of shared state reachable from ≥2 threads",
    "atomic under the GIL but unordered: readers may see stale or "
    "mid-sequence values; guard it or document why staleness is fine",
)
R_GLOBAL_WRITE = rule(
    "race-global-write", "warning",
    "module-global mutated from function scope in threaded code",
    "module globals are shared across every server thread; prefer "
    "instance state under a lock, or suppress with a rationale when "
    "the race is benign by design",
)

# concurrency scope: the packages where multiple threads actually run
SCOPE = ("serving", "data/api", "obs", "common")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_SAFE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
               "deque", "Event", "local"}


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


@dataclass
class _Site:
    attr: str
    line: int
    rmw: bool  # augassign / subscript store
    locks: frozenset[str]
    entry: str  # method or closure this site executes under


@dataclass
class _ClassInfo:
    name: str
    lock_attrs: set[str] = field(default_factory=set)
    safe_attrs: set[str] = field(default_factory=set)
    writes: list[_Site] = field(default_factory=list)
    # attr → entry names that read it
    reads: dict[str, set[str]] = field(default_factory=dict)
    calls: dict[str, set[str]] = field(default_factory=dict)  # m → callees
    entries: set[str] = field(default_factory=set)
    methods: set[str] = field(default_factory=set)


def _lockish(attr: str, lock_attrs: set[str]) -> bool:
    # discovered ctors, plus the naming convention — a lock assigned in
    # a BASE class (`_Child._lock`) is invisible to per-class ctor
    # discovery but its name still says what it is
    return attr in lock_attrs or "lock" in attr or attr in {"_cv", "_busy"}


def _locks_held(node: ast.AST, stop: ast.AST, parents: dict,
                lock_attrs: set[str]) -> frozenset[str]:
    held: set[str] = set()
    p = parents.get(node)
    while p is not None and p is not stop:
        if isinstance(p, ast.With):
            for item in p.items:
                attr = _is_self_attr(item.context_expr)
                if attr and _lockish(attr, lock_attrs):
                    held.add(attr)
        p = parents.get(p)
    return frozenset(held)


def _collect_class(mod: Module, cls: ast.ClassDef) -> _ClassInfo:
    parents = mod.parents()
    info = _ClassInfo(name=cls.name)
    methods = [
        n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    info.methods = {m.name for m in methods}

    # pass 1: lock/safe attr discovery anywhere in the class
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = _is_self_attr(t)
                    if not attr:
                        continue
                    ctor = _ctor_name(node.value)
                    if ctor in _LOCK_CTORS:
                        info.lock_attrs.add(attr)
                    elif ctor in _SAFE_CTORS:
                        info.safe_attrs.add(attr)

    # pass 2: per-method sites, reads, call edges, escaping refs
    for m in methods:
        nested_classes = {
            n for n in ast.walk(m) if isinstance(n, ast.ClassDef)
        }
        closures = {
            n for n in ast.walk(m)
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            )
            and n is not m
        }

        def in_nested_class(node: ast.AST) -> bool:
            p = parents.get(node)
            while p is not None and p is not m:
                if p in nested_classes:
                    return True
                p = parents.get(p)
            return False

        def entry_for(node: ast.AST) -> str:
            p = parents.get(node)
            while p is not None and p is not m:
                if p in closures:
                    # a closure/lambda runs on whatever thread invokes
                    # the callback it became — its own entry point
                    name = f"{m.name}.{getattr(p, 'name', '<lambda>')}"
                    info.entries.add(name)
                    return name
                p = parents.get(p)
            return m.name

        # repo convention (wal.py): a `*_locked` helper documents that
        # its caller already holds self._lock
        caller_held = (
            frozenset({"_lock"}) if m.name.endswith("_locked")
            else frozenset()
        )

        # explicit acquire()/release() pairs (try/finally idiom) guard
        # the lines between them just like a `with` block does
        fn_end = max(
            (getattr(n, "end_lineno", None)
             or getattr(n, "lineno", 0) for n in ast.walk(m)),
            default=m.lineno,
        )

        def _acq_token(expr: ast.expr, _locks=info.lock_attrs):
            attr = _is_self_attr(expr)
            return attr if attr and _lockish(attr, _locks) else None

        intervals = acquire_intervals(m, _acq_token, fn_end)

        def explicit_held(line: int) -> frozenset[str]:
            return frozenset(
                iv.token for iv in intervals if iv.covers(line)
            )

        for node in ast.walk(m):
            if in_nested_class(node):
                continue  # a class defined in a method is its own scope
            entry = entry_for(node)
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    attr = _is_self_attr(t)
                    rmw = False
                    if attr is None and isinstance(t, ast.Subscript):
                        attr = _is_self_attr(t.value)
                        rmw = True  # container store = read-modify-write
                    if attr is None:
                        continue
                    info.writes.append(_Site(
                        attr=attr, line=node.lineno, rmw=rmw,
                        locks=_locks_held(node, m, parents,
                                          info.lock_attrs) | caller_held
                        | explicit_held(node.lineno),
                        entry=entry,
                    ))
            elif isinstance(node, ast.AugAssign):
                t = node.target
                attr = _is_self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = _is_self_attr(t.value)
                if attr is not None:
                    info.writes.append(_Site(
                        attr=attr, line=node.lineno, rmw=True,
                        locks=_locks_held(node, m, parents,
                                          info.lock_attrs) | caller_held
                        | explicit_held(node.lineno),
                        entry=entry,
                    ))
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                attr = _is_self_attr(node)
                if attr is None:
                    continue
                p = parents.get(node)
                if isinstance(p, ast.Call) and p.func is node:
                    if attr in info.methods:
                        # self.m() — intra-class call edge
                        info.calls.setdefault(entry, set()).add(attr)
                    continue
                if attr in info.methods:
                    # bare `self._m` reference escaping as a callback /
                    # Thread target / signal handler → entry point
                    info.entries.add(attr)
                else:
                    info.reads.setdefault(attr, set()).add(entry)

    for m in methods:
        name = m.name
        if name == "__init__" or (
            name.startswith("__") and name.endswith("__")
            and name != "__call__"
        ):
            continue
        if not name.startswith("_") or name == "__call__":
            info.entries.add(name)
    return info


def _reachable_entries(info: _ClassInfo) -> dict[str, set[str]]:
    """method/closure name → entry points that can reach it."""
    reach: dict[str, set[str]] = {}
    for entry in info.entries:
        seen: set[str] = set()
        stack = [entry]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(info.calls.get(cur, ()))
        for name in seen:
            reach.setdefault(name, set()).add(entry)
    return reach


def _per_connection(cls: ast.ClassDef) -> bool:
    """stdlib http.server hands each connection its own handler
    instance, so ``self.*`` on a RequestHandler subclass is
    thread-local by construction."""
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            getattr(base, "id", "")
        if "RequestHandler" in name:
            return True
    return False


def _check_class(mod: Module, cls: ast.ClassDef) -> list[Finding]:
    if _per_connection(cls):
        return []
    info = _collect_class(mod, cls)
    reach = _reachable_entries(info)
    out: list[Finding] = []
    by_attr: dict[str, list[_Site]] = {}
    for s in info.writes:
        if s.entry == "__init__" or s.entry.startswith("__init__."):
            continue  # construction precedes sharing
        if s.attr in info.lock_attrs or s.attr in info.safe_attrs:
            continue
        if s.attr.endswith("_lock"):
            continue
        by_attr.setdefault(s.attr, []).append(s)
    for attr, sites in sorted(by_attr.items()):
        touching: set[str] = set()
        for s in sites:
            touching |= reach.get(s.entry, {s.entry} if s.entry in
                                  info.entries else set())
        for entry in info.reads.get(attr, ()):
            touching |= reach.get(entry, {entry} if entry in
                                  info.entries else set())
        touching.discard("__init__")
        if len(touching) < 2:
            continue
        common = None
        for s in sites:
            common = s.locks if common is None else common & s.locks
        if common:
            continue  # every write under one shared lock
        unguarded = [s for s in sites if not s.locks]
        flag_sites = unguarded or sites
        worst = flag_sites[0]
        for s in flag_sites:
            if s.rmw and not worst.rmw:
                worst = s
        r = R_UNGUARDED_RMW if worst.rmw else R_UNGUARDED_REBIND
        how = (
            "read-modify-write" if worst.rmw else "rebound"
        )
        locked_note = (
            "" if unguarded
            else " (sites hold locks, but no single lock covers them all)"
        )
        out.append(finding(
            r, mod, worst.line,
            f"{cls.name}.{attr} is {how} without a lock but reachable "
            f"from {len(touching)} thread entry points "
            f"({', '.join(sorted(touching)[:4])}){locked_note}",
            symbol=f"{cls.name}.{attr}",
        ))
    return out


def _check_globals(mod: Module) -> list[Finding]:
    """Module-global mutation from function scope (``global X`` rebind or
    stores into a module-level mutable) in threaded modules."""
    if mod.tree is None:
        return []
    parents = mod.parents()
    module_names = set()
    module_locks = set()
    for node in mod.tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            module_names.add(t.id)
            if node.value is not None and \
                    _ctor_name(node.value) in _LOCK_CTORS:
                module_locks.add(t.id)

    def under_module_lock(node: ast.AST) -> bool:
        p = parents.get(node)
        while p is not None:
            if isinstance(p, ast.With):
                for item in p.items:
                    if isinstance(item.context_expr, ast.Name) and \
                            item.context_expr.id in module_locks:
                        return True
            p = parents.get(p)
        return False
    out: list[Finding] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared = {
            n
            for node in ast.walk(fn)
            if isinstance(node, ast.Global)
            for n in node.names
        }
        if not declared:
            continue
        for node in ast.walk(fn):
            rmw = False
            names: list[tuple[str, int]] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in declared:
                        names.append((t.id, node.lineno))
                    elif isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name
                    ) and t.value.id in declared:
                        names.append((t.value.id, node.lineno))
                        rmw = True
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if isinstance(t, ast.Name) and t.id in declared:
                    names.append((t.id, node.lineno))
                    rmw = True
            for name, line in names:
                if name not in module_names:
                    continue
                if under_module_lock(node):
                    continue  # `with _module_lock:` guards the write
                sev = "error" if rmw else None
                out.append(finding(
                    R_GLOBAL_WRITE, mod, line,
                    f"module global {name!r} "
                    f"{'read-modify-written' if rmw else 'rebound'} in "
                    f"{fn.name!r}; every server thread shares it",
                    symbol=name,
                    severity=sev,
                ))
    return out


@analyzer("races")
def analyze(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.modules:
        if mod.tree is None or not rel_in(mod.rel, *SCOPE):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(_check_class(mod, node))
        out.extend(_check_globals(mod))
    return out

from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("races", R_UNGUARDED_RMW.id, R_UNGUARDED_REBIND.id,
           R_GLOBAL_WRITE.id)
