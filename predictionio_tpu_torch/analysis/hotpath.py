"""Hot-path hazard detector for the port: host syncs, device fences and
kernel builds in the request path.

The JAX package's hotpath (``predictionio_tpu/analysis/hotpath.py``)
guards traced code: jitted functions, and the Pallas kernels it finds by
``pallas_call``. The port traces nothing. Its kernels are the ``ops/*.py``
wrappers that call a ``lib.pio_*`` symbol through ``ctypes`` (found here by
that call), and a request runs eagerly, so each rule takes its CUDA/torch
form, under the same rule id:

* ``hotpath-host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()`` or
  ``.numpy()`` (or ``float()``/``int()``/``bool()``) on a device tensor in a
  request-path function, except the answer's one readback: the first
  statement of the function that reads a device value back is the answer
  and passes, every later one is a second host round trip. A value is a
  device tensor when it comes from a kernel wrapper, from a ``torch.*``
  call given ``device=``, or from ``.to(...)``/``.cuda()``, or is computed
  from one (values read back are host values).
* ``hotpath-block-sync`` — ``torch.cuda.synchronize`` or an ``Event``/
  ``Stream`` ``.synchronize()`` in ``serving/``, ``models/`` or ``ops/``
  outside warm-up: a fence in the request path stalls the batcher's worker
  for every queued launch, where a readback waits only for its own.
* ``hotpath-jit-in-request`` — a kernel build (``_build.load``,
  ``_build.library``, ``_build.build_all``, or a command naming ``nvcc``)
  in a function a request path can reach through the call graph
  (:mod:`callgraph`), paths through warm-up functions excluded: a build
  takes seconds of ``nvcc`` on the first query that needs it. The port's
  fast path builds its kernels at warm-up, so the lazy loaders carry a
  suppression that says so.
* ``hotpath-traced-branch`` and ``hotpath-traced-loop`` have no eager
  counterpart: a Python branch or loop on a tensor's value in eager code is
  one readback, which ``hotpath-host-sync`` already sees. They stay
  registered, at severity ``info``, and never fire.

Request-path functions are the JAX package's: names starting (after
underscores) with ``recommend``, ``score``, ``predict``, ``query``,
``handle``, ``serve``, ``submit``, ``dispatch``, ``lookup``, ``rank``,
``retrieve`` or ``probe``, in ``serving/``, ``models/`` and ``ops/``.
Warm-up is the JAX package's too: ``__init__``, ``main``, ``_compile`` and
names starting with ``warm``, ``build``, ``make``, ``bench``, ``compile`` or
``setup`` (underscored or not), or code under ``if
_tracing.active_traces():``.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rel_in, rule,
)

R_HOST_SYNC = rule(
    "hotpath-host-sync", "error",
    "device-tensor readback in a request path beyond the answer's one",
    ".item()/.tolist()/.cpu()/.numpy() (or float()/int()) on a CUDA tensor "
    "waits for every launch queued before it; a request path reads its "
    "answer back once",
)
R_TRACED_BRANCH = rule(
    "hotpath-traced-branch", "info",
    "(no eager counterpart: never fires in the port)",
    "the JAX rule flags a Python branch on a traced value inside jit; eager "
    "torch has no tracer, and a branch on a tensor's value is a readback, "
    "which hotpath-host-sync checks",
)
R_TRACED_LOOP = rule(
    "hotpath-traced-loop", "info",
    "(no eager counterpart: never fires in the port)",
    "the JAX rule flags a Python loop over a traced value inside jit; eager "
    "torch has no tracer, and a loop over a tensor's values is a readback "
    "each step, which hotpath-host-sync checks",
)
R_BLOCK_OUTSIDE_WARMUP = rule(
    "hotpath-block-sync", "error",
    "torch.cuda.synchronize / Event.synchronize outside warm-up",
    "a device-wide fence in the request path waits for every launch "
    "queued by every thread, which defeats micro-batching; fence only "
    "under tracing (active_traces()) or in warm-up",
)
R_JIT_IN_REQUEST = rule(
    "hotpath-jit-in-request", "error",
    "kernel build (nvcc) reachable from a request-path function",
    "a first-use nvcc build stalls a live query for seconds; build the "
    "kernels at warm-up (the fast path's construction) instead",
)

_SYNC_CASTS = {"float", "int", "bool", "complex"}
_READBACKS = {"item", "tolist", "cpu", "numpy"}
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "numel"}
_BUILD_CALLS = {"load", "library", "build_all"}
_WARMUP_NAMES = ("__init__", "_compile", "main")
_WARMUP_PREFIXES = ("warm", "_warm", "build", "_build", "make", "_make",
                    "bench", "_bench", "compile", "setup", "_setup")
_REQUEST_PREFIXES = ("recommend", "score", "predict", "query", "handle",
                     "serve", "submit", "dispatch", "lookup", "rank",
                     "retrieve", "probe")


def _is_request_name(name: str) -> bool:
    return name.lstrip("_").startswith(_REQUEST_PREFIXES)


def _is_warmup_name(name: str) -> bool:
    return (name in _WARMUP_NAMES or name.startswith(_WARMUP_PREFIXES)
            or "warmup" in name)


def _enclosing_functions(node: ast.AST, parents: dict) -> list[str]:
    names = []
    p = parents.get(node)
    while p is not None:
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.append(p.name)
        p = parents.get(p)
    return names


def _in_warmup_context(node: ast.AST, parents: dict) -> bool:
    if any(_is_warmup_name(n) for n in _enclosing_functions(node, parents)):
        return True
    # fenced behind the tracing sampler: `if _tracing.active_traces():`
    p = parents.get(node)
    while p is not None:
        if isinstance(p, ast.If):
            for n in ast.walk(p.test):
                if (isinstance(n, ast.Attribute) and n.attr == "active_traces") or (
                        isinstance(n, ast.Name) and n.id == "active_traces"):
                    return True
        p = parents.get(p)
    return False


def _attr(node: ast.expr) -> str:
    return node.attr if isinstance(node, ast.Attribute) else getattr(node, "id", "")


def kernel_wrappers(index: RepoIndex) -> set[str]:
    """Names of the functions that launch a kernel: those calling a
    ``<lib>.pio_*(...)`` symbol through ``ctypes`` (the port's form of the
    JAX package's ``pallas_call`` sites)."""
    out: set[str] = set()
    for mod in index.modules:
        if mod.tree is None:
            continue
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(fn):
                if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                        and n.func.attr.startswith("pio_")
                        and not n.func.attr.endswith(("_limits", "_error_string"))):
                    out.add(fn.name)
                    break
    return out


def _is_device_source(call: ast.Call, wrappers: set[str]) -> bool:
    """A call whose result lives on the device."""
    name = _attr(call.func)
    if name in wrappers or name in ("cuda",):
        return True
    if name == "to" and isinstance(call.func, ast.Attribute):
        return True
    if (isinstance(call.func, ast.Attribute) and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "torch"
            and any(kw.arg == "device" for kw in call.keywords)):
        return True
    return False


def _is_readback(call: ast.AST) -> bool:
    return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr in _READBACKS)


def _device_names_in(expr: ast.AST, device: set[str], parents: dict) -> Iterable[ast.Name]:
    """Device-tensor Name references in ``expr`` that still carry device
    values: not under a readback (its result is a host value), not read
    for metadata (``.shape``/``.dtype``/``len()``/``is None``)."""
    stack = [expr]
    while stack:
        n = stack.pop()
        if _is_readback(n):
            continue
        if isinstance(n, ast.Name) and n.id in device:
            p = parents.get(n)
            if isinstance(p, ast.Attribute) and p.attr in _SHAPE_ATTRS:
                continue
            if isinstance(p, ast.Call) and p.func is not n and getattr(
                    p.func, "id", "") in {"len", "isinstance", "type"}:
                continue
            if isinstance(p, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in p.ops):
                continue
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _has_device_source(expr: ast.AST, wrappers: set[str]) -> bool:
    stack = [expr]
    while stack:
        n = stack.pop()
        if _is_readback(n):
            continue
        if isinstance(n, ast.Call) and _is_device_source(n, wrappers):
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


def device_names(fn: ast.AST, wrappers: set[str], parents: dict,
                 seed: Optional[set[str]] = None) -> set[str]:
    """Names in ``fn`` bound to device tensors (two forward passes
    approximate a fixpoint over straight-line code)."""
    device = set(seed or ())
    for _ in range(2):
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            value = node.value
            if value is None:
                continue
            if not (_has_device_source(value, wrappers)
                    or any(_device_names_in(value, device, parents))):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        device.add(leaf.id)
    return device


def _statement_of(node: ast.AST, parents: dict) -> Optional[ast.AST]:
    """The innermost statement holding ``node``."""
    p = node
    while p is not None and not isinstance(p, ast.stmt):
        p = parents.get(p)
    return p


def readbacks(fn: ast.AST, wrappers: set[str], parents: dict,
              seed: Optional[set[str]] = None) -> list[tuple[ast.Call, str, set[str]]]:
    """(call, what, device names read) for each readback of a device value
    in ``fn``'s own body, in source order; ``what`` is the method or cast
    name."""
    device = device_names(fn, wrappers, parents, seed)
    nested = {n for n in ast.walk(fn)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not fn}

    def in_nested(node: ast.AST) -> bool:
        p = parents.get(node)
        while p is not None and p is not fn:
            if p in nested:
                return True
            p = parents.get(p)
        return False

    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or in_nested(node):
            continue
        if _is_readback(node):
            recv = node.func.value
            if _is_readback(recv):
                continue  # x.cpu().numpy(): one readback, counted at x.cpu()
            names = {n.id for n in _device_names_in(recv, device, parents)}
            if names or (isinstance(recv, ast.Call) and _has_device_source(recv, wrappers)):
                out.append((node, node.func.attr, names))
        elif getattr(node.func, "id", "") in _SYNC_CASTS:
            names = {n.id for a in node.args for n in _device_names_in(a, device, parents)}
            if names:
                out.append((node, node.func.id, names))
    out.sort(key=lambda t: (t[0].lineno, t[0].col_offset))
    return out


def _binding_statements(fn: ast.AST) -> dict[str, ast.AST]:
    """Name → the first statement in ``fn`` that binds it."""
    out: dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        if leaf.id not in out or node.lineno < out[leaf.id].lineno:
                            out[leaf.id] = node
    return out


def extra_readbacks(fn: ast.AST, wrappers: set[str], parents: dict,
                    seed: Optional[set[str]] = None) -> list[tuple[ast.Call, str]]:
    """The readbacks beyond the answer's one. The answer is what the first
    readback reads: every readback in its statement, and every readback of
    values bound by the same statement as its values (``vals, idx =
    kernel(...)`` read back as ``idx.cpu()`` then ``vals.cpu()``)."""
    found = readbacks(fn, wrappers, parents, seed)
    if not found:
        return []
    bound = _binding_statements(fn)
    first_call, _, first_names = found[0]
    first_stmt = _statement_of(first_call, parents)
    answer = {id(bound[n]) for n in first_names if n in bound}
    out = []
    for call, what, names in found:
        if _statement_of(call, parents) is first_stmt:
            continue
        if names and all(n in bound and id(bound[n]) in answer for n in names):
            continue
        out.append((call, what))
    return out


def _is_sync_call(node: ast.Call) -> bool:
    return isinstance(node.func, ast.Attribute) and node.func.attr == "synchronize"


def _module_aliases(mod: Module, module_name: str) -> set[str]:
    """Local names bound to ``module_name`` (``from pkg import _build``,
    ``import pkg._build as b``)."""
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == module_name:
                    out.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.rsplit(".", 1)[-1] == module_name and a.asname:
                    out.add(a.asname)
    return out


def _is_build_call(node: ast.Call, build_aliases: set[str]) -> bool:
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr in _BUILD_CALLS
            and isinstance(f.value, ast.Name) and f.value.id in build_aliases):
        return True
    if getattr(f, "id", "") == "_nvcc":
        return True
    for a in ast.walk(node):
        if isinstance(a, ast.Constant) and a.value == "nvcc" and _attr(f) in (
                "run", "Popen", "check_call", "check_output", "call"):
            return True
    return False


def _module_import_edges(index: RepoIndex, graph) -> dict[str, set[str]]:
    """Edges the call graph leaves unresolved: ``mod.f()`` where ``mod`` is
    bound by ``from pkg import mod`` (often inside the function: the port
    imports its kernel modules lazily). Caller qual → callee quals."""
    out: dict[str, set[str]] = {}
    mods: dict[str, dict[str, str]] = {}
    for q, node in graph.nodes.items():
        mod = index.module(node.rel)
        if mod is None or mod.tree is None or node.ast_node is None:
            continue
        if node.rel not in mods:
            aliases: dict[str, str] = {}
            for n in ast.walk(mod.tree):
                if isinstance(n, ast.ImportFrom) and n.module and not n.level:
                    for a in n.names:
                        base = f"{n.module}.{a.name}".replace(".", "/")
                        for rel in (base + ".py", base + "/__init__.py"):
                            if index.module(rel) is not None:
                                aliases[a.asname or a.name] = rel
            mods[node.rel] = aliases
        aliases = mods[node.rel]
        for n in ast.walk(node.ast_node):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in aliases):
                callee = f"{aliases[n.func.value.id]}::{n.func.attr}"
                if callee in graph.nodes:
                    out.setdefault(q, set()).add(callee)
    return out


def _request_reachable(index: RepoIndex) -> dict[str, str]:
    """Callgraph quals reachable from a request-path function (not through
    a warm-up function) → the request-path root's name."""
    from predictionio_tpu_torch.analysis import callgraph

    graph = callgraph.get(index)
    extra = _module_import_edges(index, graph)
    out: dict[str, str] = {}
    roots = [
        q for q, n in graph.nodes.items()
        if rel_in(n.rel, "serving", "models", "ops") and _is_request_name(n.name)
        and not _is_warmup_name(n.name)
    ]
    for root in sorted(roots):
        stack = [root]
        while stack:
            cur = stack.pop()
            if cur in out:
                continue
            node = graph.nodes.get(cur)
            if node is None or (cur != root and _is_warmup_name(node.name)):
                continue
            out[cur] = graph.nodes[root].name
            stack.extend((graph.successors(cur) | extra.get(cur, set())) - set(out))
    return out


@analyzer("hotpath")
def analyze(index: RepoIndex) -> list[Finding]:
    from predictionio_tpu_torch.analysis import callgraph

    out: list[Finding] = []
    wrappers = kernel_wrappers(index)
    reach = _request_reachable(index)
    graph = callgraph.get(index)
    qual_of = {id(n.ast_node): q for q, n in graph.nodes.items()}
    for mod in index.modules:
        if mod.tree is None or not rel_in(mod.rel, "serving", "models", "ops"):
            continue
        parents = mod.parents()
        build_aliases = _module_aliases(mod, "_build")
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _is_request_name(fn.name) and not _in_warmup_context(fn, parents) \
                    and not _is_warmup_name(fn.name):
                for call, what in extra_readbacks(fn, wrappers, parents):
                    out.append(finding(
                        R_HOST_SYNC, mod, call.lineno,
                        f"{what}() on a device tensor in request-path {fn.name!r} "
                        "after the answer's readback: one more host round trip",
                        symbol=f"{fn.name}.{what}",
                    ))
            root = reach.get(qual_of.get(id(fn), ""))
            if root is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _is_build_call(node, build_aliases) \
                        and _enclosing_functions(node, parents)[:1] == [fn.name]:
                    out.append(finding(
                        R_JIT_IN_REQUEST, mod, node.lineno,
                        f"kernel build in {fn.name!r}, reachable from request-path "
                        f"{root!r}: build at warm-up instead",
                        symbol=fn.name,
                    ))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _is_sync_call(node) \
                    and not _in_warmup_context(node, parents):
                encl = _enclosing_functions(node, parents)
                where = encl[0] if encl else "<module>"
                out.append(finding(
                    R_BLOCK_OUTSIDE_WARMUP, mod, node.lineno,
                    f"synchronize() in {where!r} outside warm-up; fence only "
                    "under active_traces() or in warm-up/build paths",
                    symbol=where,
                ))
    return out


from predictionio_tpu_torch.analysis.core import owns_rules  # noqa: E402

owns_rules("hotpath", R_HOST_SYNC.id, R_TRACED_BRANCH.id, R_TRACED_LOOP.id,
           R_BLOCK_OUTSIDE_WARMUP.id, R_JIT_IN_REQUEST.id)
