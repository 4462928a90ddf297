"""Mesh, kernel-binding and host-sync consistency checks for the port.

The JAX analyzer (``predictionio_tpu/analysis/collective.py``) checks three
contracts of traced TPU code: ``shard_map`` axis names, ``pallas_call``
index-map arity, and host syncs one call deep inside traced code. The port
runs none of those, so each takes the form its own contract has:

* **Mesh axis names** (``collective-mesh-axis``, ``collective-unknown-axis``).
  The port's ``MeshContext`` collectives take lists of blocks, not axis
  names; the names live where a mesh is shaped or read. A mesh shaped with
  an axes mapping (``make_mesh(axes=...)``, ``MeshContext.create(axes=...)``,
  ``_sub({...})``, ``_mesh_of(devs, {...})``) must use declared axes, and so
  must every axis a context is asked about (``axis_size``, ``submesh``'s
  ``axis``, ``place``'s spec). The declared axes are the string values of
  the module-level ``*_AXIS`` constants (``parallel/mesh.py``: ``data``,
  ``model``, ``host``). A misspelt axis is a ``KeyError`` at the first
  sharded call, on the card, long after CPU CI passed.
* **ctypes prototypes** (``collective-ctypes-prototype``, the port's form of
  the index-map arity rule). A kernel is a ``csrc/*.cu`` file, a host
  library a ``csrc/host/*.cpp`` one, whose ``extern "C"`` functions the
  ``ops/*.py`` wrappers (and ``native.py``) bind through ``ctypes``. Each ``<lib>.pio_*.argtypes = [...]`` list (``[p] * 10 +
  [i] * 8 + [p]`` is evaluated) must match the prototype of its symbol in
  count and in kind: pointer (``T*``, ``cudaStream_t``; ``c_void_p``,
  ``c_char_p``), int (``int``, ``long long``, ``int64_t``…; ``c_int``,
  ``c_longlong``…) or float (``float``, ``double``; ``c_float``,
  ``c_double``). A mismatch is silent memory corruption at the first
  launch: ctypes converts what it is told to.
* **Host syncs one call deep** (``collective-host-in-callee``): hotpath's
  readback check (a device tensor read back beyond the answer's one)
  applied to the repo-resolved callees of request-path functions, so a
  helper that reads a device value back is caught even though its own name
  is not a request path's.

The JAX package's ``collective-two-tier-axes`` has no counterpart: the
port's ``two_tier_merge_topk`` takes a ``host_groups`` count, not axis names,
and ``MeshContext.pod_submesh`` checks it when the plan is placed.

Every check is **resolution-gated**: axis names, argtypes lists and
prototypes are checked only when they statically resolve (string
constants, module constants chased through imports, local assignments,
lists of ``ctypes`` names). Anything dynamic is skipped, never guessed.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from predictionio_tpu_torch.analysis import callgraph
from predictionio_tpu_torch.analysis.core import (
    PY_ROOTS,
    Finding,
    Module,
    RepoIndex,
    analyzer,
    finding,
    rel_in,
    rule,
)
from predictionio_tpu_torch.analysis.hotpath import (
    _is_request_name,
    _is_warmup_name,
    extra_readbacks,
    kernel_wrappers,
)

R_MESH_AXIS = rule(
    "collective-mesh-axis",
    "error",
    "a mesh is shaped with an axis that is not a declared *_AXIS",
    "the mesh builds, and the first collective or axis_size over the "
    "declared name fails on the card, not in CPU CI",
)
R_UNKNOWN_AXIS = rule(
    "collective-unknown-axis",
    "error",
    "axis_size/submesh/place names an axis that is not a declared *_AXIS",
    "a misspelt axis is a KeyError at the first sharded call; the wrong "
    "declared axis is silently wrong sharding",
)
R_CTYPES_PROTO = rule(
    "collective-ctypes-prototype",
    "error",
    "ctypes argtypes disagree with the extern \"C\" prototype in count or kind",
    "ctypes converts each argument to the type it is told; a missing, extra "
    "or wrongly-kinded argument is memory corruption at the first launch, "
    "not an error",
)
R_HOST_IN_CALLEE = rule(
    "collective-host-in-callee",
    "error",
    "device-tensor readback in a callee of a request-path function, beyond "
    "its one",
    "the callee runs inside the request; a second .item()/.cpu() there is "
    "one more host round trip exactly as in the request function itself",
)


def _call_name(n: ast.Call) -> str:
    return (
        n.func.attr if isinstance(n.func, ast.Attribute)
        else getattr(n.func, "id", "")
    )


class _Consts:
    """String-constant resolution: locals in the enclosing function,
    module-level constants, and constants imported from other modules."""

    def __init__(self, index: RepoIndex, mod: Module):
        self.index = index
        self.mod = mod
        self.module_consts = self._module_consts(mod)
        self.imports: dict[str, tuple[str, str]] = {}
        if mod.tree is not None:
            pkg_parts = mod.rel[:-3].split("/")
            if pkg_parts and pkg_parts[-1] == "__init__":
                pkg_parts = pkg_parts[:-1]
            pkg = ".".join(pkg_parts[:-1])
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom):
                    target = node.module or ""
                    if node.level:
                        base = pkg.split(".") if pkg else []
                        if node.level > 1:
                            base = base[: len(base) - (node.level - 1)]
                        if node.module:
                            base += node.module.split(".")
                        target = ".".join(base)
                    for a in node.names:
                        self.imports[a.asname or a.name] = (target, a.name)

    @staticmethod
    def _module_consts(mod: Module) -> dict[str, str]:
        out: dict[str, str] = {}
        if mod.tree is None:
            return out
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                out[node.targets[0].id] = node.value.value
        return out

    def resolve(self, expr: ast.expr, local: dict[str, str]) -> Optional[str]:
        """expr → string constant, or None when not statically known."""
        if isinstance(expr, ast.Constant):
            return expr.value if isinstance(expr.value, str) else None
        if isinstance(expr, ast.Name):
            if expr.id in local:
                return local[expr.id]
            if expr.id in self.module_consts:
                return self.module_consts[expr.id]
            imp = self.imports.get(expr.id)
            if imp is not None:
                base = imp[0].replace(".", "/")
                for rel in (base + ".py", base + "/__init__.py"):
                    m = self.index.module(rel)
                    if m is not None:
                        return self._module_consts(m).get(imp[1])
        if isinstance(expr, ast.Attribute):
            # mod.CONST: one-module-hop resolution
            base = expr.value
            if isinstance(base, ast.Name):
                imp = self.imports.get(base.id)
                if imp is not None:
                    target = f"{imp[0]}.{imp[1]}" if imp[0] else imp[1]
                    p = target.replace(".", "/")
                    for rel in (p + ".py", p + "/__init__.py"):
                        m = self.index.module(rel)
                        if m is not None:
                            return self._module_consts(m).get(expr.attr)
        return None


def _local_str_assigns(fn: ast.AST) -> dict[str, str]:
    out: dict[str, str] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name) and \
                isinstance(n.value, ast.Constant) and \
                isinstance(n.value.value, str):
            out[n.targets[0].id] = n.value.value
    return out


def _enclosing_fn(node: ast.AST, parents: dict) -> Optional[ast.AST]:
    p = parents.get(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef)):
        p = parents.get(p)
    return p


# -- mesh axis names -----------------------------------------------------------


def declared_axes(index: RepoIndex) -> set[str]:
    """String values of module-level ``*_AXIS`` constants."""
    out: set[str] = set()
    for mod in index.modules:
        if mod.tree is None:
            continue
        for name, value in _Consts._module_consts(mod).items():
            if name.endswith("_AXIS"):
                out.add(value)
    return out


# mesh-shaping calls and the argument slot of their axes mapping
_MESH_SHAPERS = {"make_mesh": 0, "create": None, "_sub": 0, "_mesh_of": 1}


def _axes_mapping(call: ast.Call, cname: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "axes":
            return kw.value
    slot = _MESH_SHAPERS.get(cname)
    if slot is not None and len(call.args) > slot:
        return call.args[slot]
    return None


def _check_axes(index: RepoIndex, mod: Module, consts: _Consts,
                declared: set[str]) -> list[Finding]:
    out: list[Finding] = []
    if mod.tree is None or not declared:
        return out
    parents = mod.parents()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = _call_name(node)
        if cname not in _MESH_SHAPERS and cname not in ("axis_size", "submesh", "place"):
            continue
        encl = _enclosing_fn(node, parents) or mod.tree
        local = _local_str_assigns(encl)
        where = getattr(encl, "name", "<module>")
        if cname in _MESH_SHAPERS:
            mapping = _axes_mapping(node, cname)
            if isinstance(mapping, ast.Dict):
                for key in mapping.keys:
                    axis = consts.resolve(key, local) if key is not None else None
                    if axis is not None and axis not in declared:
                        out.append(finding(
                            R_MESH_AXIS, mod, node.lineno,
                            f"mesh shaped in {where!r} with axis {axis!r}, "
                            f"not one of the declared axes {sorted(declared)}",
                            symbol=f"{where}.{axis}",
                        ))
            continue
        names: list[ast.expr] = []
        if cname == "axis_size" and node.args:
            names = [node.args[0]]
        elif cname == "submesh":
            names = [kw.value for kw in node.keywords if kw.arg == "axis"]
            names += node.args[1:2]
        elif cname == "place" and isinstance(node.func, ast.Attribute):
            for spec in node.args[1:]:
                names += list(spec.elts) if isinstance(spec, ast.Tuple) else [spec]
        for expr in names:
            axis = consts.resolve(expr, local)
            if axis is not None and axis not in declared:
                out.append(finding(
                    R_UNKNOWN_AXIS, mod, node.lineno,
                    f"{cname}() in {where!r} names axis {axis!r}, not one of "
                    f"the declared axes {sorted(declared)}",
                    symbol=f"{where}.{axis}",
                ))
    return out


# -- ctypes argtypes vs the extern "C" prototypes -------------------------------

_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_wchar_p": "pointer",
    "POINTER": "pointer", "byref": "pointer",
    "c_int": "int", "c_uint": "int", "c_long": "int", "c_ulong": "int",
    "c_longlong": "int", "c_ulonglong": "int", "c_int8": "int",
    "c_int16": "int", "c_int32": "int", "c_int64": "int", "c_uint8": "int",
    "c_uint16": "int", "c_uint32": "int", "c_uint64": "int",
    "c_size_t": "int", "c_ssize_t": "int", "c_bool": "int", "c_short": "int",
    "c_ushort": "int", "c_byte": "int", "c_ubyte": "int", "c_char": "int",
    "c_float": "float", "c_double": "float", "c_longdouble": "float",
}
_EXTERN_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_FUNC_DEF = re.compile(r"\b(pio_\w+)\s*\(([^()]*)\)\s*\{")
_EXTERN_ONE = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(pio_\w+)\s*\(([^()]*)\)')


def _c_kind(param: str) -> str:
    p = re.sub(r"/\*.*?\*/", "", param).strip()
    if "*" in p or "cudaStream_t" in p or "[" in p:
        return "pointer"
    words = re.findall(r"[A-Za-z_]\w*", p)
    if "float" in words or "double" in words:
        return "float"
    return "int"


def _strip_comments(text: str) -> str:
    """Comments gone, and character literals (a JSON scanner's ``'{'``),
    which would unbalance the brace count of an ``extern "C"`` block."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"'(?:\\.|[^'\\])+'", "0", text)


def c_prototypes(text: str) -> dict[str, list[str]]:
    """``extern "C"`` functions of a CUDA source → their parameters' kinds
    (the ``pio_*`` definitions inside ``extern "C" { ... }`` blocks, and
    single ``extern "C"`` declarations)."""
    text = _strip_comments(text)
    out: dict[str, list[str]] = {}
    for m in _EXTERN_BLOCK.finditer(text):
        depth, i = 1, m.end()
        while i < len(text) and depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        block = text[m.end():i]
        for f in _FUNC_DEF.finditer(block):
            params = [p for p in f.group(2).split(",") if p.strip()]
            if len(params) == 1 and params[0].strip() == "void":
                params = []
            out[f.group(1)] = [_c_kind(p) for p in params]
    for f in _EXTERN_ONE.finditer(text):
        params = [p for p in f.group(2).split(",") if p.strip()]
        if len(params) == 1 and params[0].strip() == "void":
            params = []
        out.setdefault(f.group(1), [_c_kind(p) for p in params])
    return out


def cuda_sources(index: RepoIndex) -> dict[str, str]:
    """Repo-relative path → text of every ``.cu`` file, and every ``.cpp``
    host library, the index covers (the package roots of a checkout, or the
    whole fixture tree)."""
    roots = [os.path.join(index.root, d) for d in PY_ROOTS
             if os.path.isdir(os.path.join(index.root, d))] or [index.root]
    out: dict[str, str] = {}
    for base in roots:
        for dirpath, dirnames, files in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if not d.startswith((".", "__")))
            for f in sorted(files):
                if f.endswith((".cu", ".cpp")):
                    p = os.path.join(dirpath, f)
                    with open(p, encoding="utf-8") as fh:
                        out[os.path.relpath(p, index.root).replace(os.sep, "/")] = fh.read()
    return out


def _ctypes_kinds(expr: ast.expr, names: dict[str, ast.expr]) -> Optional[list[str]]:
    """An argtypes expression → its kinds, or None when it does not resolve
    (lists of ctypes names, ``list * int``, ``list + list``)."""
    if isinstance(expr, (ast.List, ast.Tuple)):
        out = []
        for e in expr.elts:
            k = _ctypes_kinds(e, names)
            if k is None or len(k) != 1:
                return None
            out += k
        return out
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        a, b = _ctypes_kinds(expr.left, names), _ctypes_kinds(expr.right, names)
        return None if a is None or b is None else a + b
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for seq, n in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                k = _ctypes_kinds(seq, names)
                return None if k is None else k * n.value
        return None
    if isinstance(expr, ast.Name) and expr.id in names:
        return _ctypes_kinds(names[expr.id], names)
    if isinstance(expr, ast.Call):
        return ["pointer"] if getattr(expr.func, "attr", getattr(
            expr.func, "id", "")) == "POINTER" else None
    name = expr.attr if isinstance(expr, ast.Attribute) else getattr(expr, "id", None)
    if name in _CTYPES_KIND:
        return [_CTYPES_KIND[name]]
    return None


def _local_bindings(fn: ast.AST) -> dict[str, ast.expr]:
    """Name → bound expression in ``fn``, tuple unpacking included
    (``p, i = ctypes.c_void_p, ctypes.c_int``)."""
    out: dict[str, ast.expr] = {}
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign) or len(n.targets) != 1:
            continue
        t, v = n.targets[0], n.value
        if isinstance(t, ast.Name):
            out[t.id] = v
        elif isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                and len(t.elts) == len(v.elts):
            for te, ve in zip(t.elts, v.elts):
                if isinstance(te, ast.Name):
                    out[te.id] = ve
    return out


def _check_prototypes(index: RepoIndex) -> list[Finding]:
    protos: dict[str, tuple[str, list[str]]] = {}
    for rel, text in cuda_sources(index).items():
        for sym, kinds in c_prototypes(text).items():
            protos[sym] = (rel, kinds)
    out: list[Finding] = []
    if not protos:
        return out
    for mod in index.modules:
        if mod.tree is None:
            continue
        parents = mod.parents()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "argtypes"):
                continue
            encl = _enclosing_fn(node, parents) or mod.tree
            names = _local_bindings(encl)
            target = node.targets[0].value
            if isinstance(target, ast.Name) and target.id in names:
                target = names[target.id]  # limits = lib.pio_x_limits
            sym = target.attr if isinstance(target, ast.Attribute) else None
            if sym is None or not sym.startswith("pio_"):
                continue
            kinds = _ctypes_kinds(node.value, names)
            if kinds is None:
                continue
            if sym not in protos:
                out.append(finding(
                    R_CTYPES_PROTO, mod, node.lineno,
                    f"argtypes for {sym}, which no extern \"C\" function of "
                    "the CUDA sources defines",
                    symbol=sym,
                ))
                continue
            rel, want = protos[sym]
            if kinds != want:
                diff = next((k for k, (a, b) in enumerate(zip(kinds, want)) if a != b), None)
                what = (f"{len(kinds)} argtypes vs {len(want)} parameters"
                        if len(kinds) != len(want) else
                        f"argument {diff} is {kinds[diff]} in argtypes, "
                        f"{want[diff]} in the prototype")
                out.append(finding(
                    R_CTYPES_PROTO, mod, node.lineno,
                    f"{sym}: {what} ({rel})",
                    symbol=sym,
                ))
    return out


# -- host sync one call deep ---------------------------------------------------


def _callee_readbacks(index: RepoIndex, graph: callgraph.CallGraph) -> list[Finding]:
    wrappers = kernel_wrappers(index)
    out: list[Finding] = []
    seen: set[str] = set()
    for q, node in sorted(graph.nodes.items()):
        if not (rel_in(node.rel, "serving", "models", "ops")
                and _is_request_name(node.name) and not _is_warmup_name(node.name)):
            continue
        for callee_q in sorted(graph.successors(q)):
            callee = graph.nodes.get(callee_q)
            if callee is None or callee.ast_node is None or callee_q in seen:
                continue
            if _is_request_name(callee.name) or _is_warmup_name(callee.name):
                continue  # request paths get hotpath's own pass
            seen.add(callee_q)
            mod = index.module(callee.rel)
            if mod is None:
                continue
            for call, what in extra_readbacks(callee.ast_node, wrappers, mod.parents()):
                out.append(finding(
                    R_HOST_IN_CALLEE, mod, call.lineno,
                    f"{what}() on a device tensor in {callee.name!r}, called from "
                    f"request-path {node.name!r}, after its one readback",
                    symbol=f"{callee.name}.{what}",
                ))
    return out


# -- analyzer ------------------------------------------------------------------


from predictionio_tpu_torch.analysis.core import owns_rules  # noqa: E402

owns_rules("collective", R_MESH_AXIS.id, R_UNKNOWN_AXIS.id,
           R_CTYPES_PROTO.id, R_HOST_IN_CALLEE.id)


@analyzer("collective")
def analyze_collective(index: RepoIndex) -> list[Finding]:
    graph = callgraph.get(index)
    declared = declared_axes(index)
    out: list[Finding] = []
    for mod in index.modules:
        if mod.tree is None:
            continue
        out.extend(_check_axes(index, mod, _Consts(index, mod), declared))
    out.extend(_check_prototypes(index))
    out.extend(_callee_readbacks(index, graph))
    return out
