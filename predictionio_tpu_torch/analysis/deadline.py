"""Interprocedural deadline-propagation checks for the request path.

The ``X-Request-Deadline`` contract (``common/resilience.py``): the
header carries *remaining milliseconds*, every hop re-derives it from a
monotonic :class:`Deadline`, and every resilience/batching boundary gets
the remaining (never the original) budget.  The router honours this
(``serving/router.py::_forward``); this analyzer makes the contract
checkable everywhere a request can reach.

Scope is computed over the call graph: everything reachable from a
*request entry point* — a function that parses the deadline header, or a
request-verb-named function (``handle_*``/``recommend*``/… per
hotpath's list, minus the internal boundary verbs ``submit``/
``dispatch``) in the serving/storage-client/API layers — plus the
network storage client wholesale (``data/storage/network.py``), which
the query path enters through DAO methods whose names carry no request
verb.  Thread-target/callback edges count as reachable: work a request
spawns is still request work.

Three rules:

* ``deadline-drop`` — an outbound ``urlopen`` in scope whose enclosing
  function never touches the deadline contract (``DEADLINE_HEADER`` /
  ``current_deadline`` / a ``deadline``-derived timeout).  Deliberate
  fire-and-forget hops (feedback queues) carry
  ``# pio: ignore[deadline-drop]`` with a rationale instead.
* ``deadline-not-forwarded`` — an in-scope ``call_with_resilience`` that
  doesn't pass ``deadline=`` (the ambient ``current_deadline()`` exists
  precisely so storage-layer code can always supply one), or a
  ``.submit(...)`` boundary in a function that *has* a deadline in hand
  and doesn't forward it.
* ``deadline-stale-forward`` — ``headers[DEADLINE_HEADER] = <inbound
  text>``: forwarding the original header value instead of
  ``remaining_ms()`` hands downstream time the client no longer has.

Unknown callees make reachability an under-approximation: a clean run
means "no drop visible to static resolution", and the always-in-scope
storage client narrows that gap on the layer where it matters most.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import callgraph
from predictionio_tpu_torch.analysis.core import (
    Finding,
    Module,
    RepoIndex,
    analyzer,
    finding,
    rule,
)

R_DROP = rule(
    "deadline-drop",
    "error",
    "outbound call on the request path drops the deadline contract",
    "a hop without X-Request-Deadline runs on its own timeout; under "
    "overload the client gives up while the fleet keeps burning chip "
    "time on an answer nobody is waiting for",
)
R_NOT_FORWARDED = rule(
    "deadline-not-forwarded",
    "error",
    "resilience/batch boundary on the request path without deadline=",
    "call_with_resilience/submit without the remaining budget will "
    "retry and backoff past the point the caller has already timed out",
)
R_STALE = rule(
    "deadline-stale-forward",
    "error",
    "deadline header forwarded from inbound text, not remaining budget",
    "re-sending the original header value gives every downstream hop "
    "the full original budget; deadlines must shrink at each hop "
    "(remaining_ms), never reset",
)

# request-verb entry prefixes: hotpath's list minus the internal
# boundary verbs (submit/dispatch name queue handoffs, not inbound HTTP).
# push_delta / catchup cover the streaming delta plane: the router's
# delta propagation hop and the replica catch-up workers make outbound
# calls on behalf of the freshness pipeline and must carry (or
# explicitly waive) the deadline contract like any other hop.
_ENTRY_PREFIXES = (
    "recommend", "score", "predict", "query", "handle", "serve",
    "lookup", "rank", "push_delta", "catchup",
    # pipeline plane (serving/pipeline.py): run_pipeline splits the
    # ambient budget into per-stage slices and each stage_* handler
    # executes under its slice — both must honor the deadline contract
    # like any other serving entry
    "run_pipeline", "stage_",
)
# the network storage client: its DAO surface has no request
# verbs but the query path flows straight through it
_ALWAYS_IN_SCOPE = ("data/storage/network.py",)
# layers whose request-verb functions count as entry points; control
# loops elsewhere (autoscaler scrapes, fleet health probes) own their
# own timeouts and have no inbound deadline to propagate
_ENTRY_LAYERS = ("serving", "data/api", "data/storage")

_DEADLINE_MARKERS = ("DEADLINE_HEADER", "current_deadline",
                     "X-Request-Deadline")


def _fn_segment(mod: Module, fn: ast.AST) -> str:
    end = max(
        (getattr(n, "end_lineno", None) or getattr(n, "lineno", 0)
         for n in ast.walk(fn)),
        default=fn.lineno,
    )
    return "\n".join(mod.lines[fn.lineno - 1:end])


def _entry_points(index: RepoIndex, graph: callgraph.CallGraph) -> set[str]:
    out: set[str] = set()
    # fixture layout (all files flat): every file is an "entry layer";
    # in the real checkout the flat top-level files are bench harnesses,
    # not request handlers
    fixture = all("/" not in m.rel for m in index.modules)
    for qual, node in graph.nodes.items():
        if node.ast_node is None:
            continue
        bare = node.name.lstrip("_")
        in_layer = fixture or any(
            node.rel.startswith(p + "/") or f"/{p}/" in node.rel
            for p in _ENTRY_LAYERS
        )
        if bare.startswith(_ENTRY_PREFIXES) and in_layer:
            out.add(qual)
            continue
        for n in ast.walk(node.ast_node):
            if isinstance(n, ast.Call):
                cname = (
                    n.func.attr if isinstance(n.func, ast.Attribute)
                    else getattr(n.func, "id", "")
                )
                if cname == "parse_deadline_header":
                    out.add(qual)
                    break
    return out


def _has_deadline_in_hand(mod: Module, node: callgraph.FuncNode) -> bool:
    """A concrete deadline value is available inside this function."""
    if "deadline" in node.params:
        return True
    seg = _fn_segment(mod, node.ast_node)
    return any(m in seg for m in _DEADLINE_MARKERS) or \
        "parse_deadline_header" in seg


def _call_name(n: ast.Call) -> str:
    return (
        n.func.attr if isinstance(n.func, ast.Attribute)
        else getattr(n.func, "id", "")
    )


from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("deadline", R_DROP.id, R_NOT_FORWARDED.id, R_STALE.id)


@analyzer("deadline")
def analyze_deadline(index: RepoIndex) -> list[Finding]:
    graph = callgraph.get(index)
    entries = _entry_points(index, graph)
    reachable = graph.reachable(entries)
    out: list[Finding] = []
    for qual in sorted(graph.nodes):
        node = graph.nodes[qual]
        mod = index.module(node.rel)
        if mod is None or node.ast_node is None:
            continue
        in_scope = qual in reachable or any(
            node.rel.endswith(p) for p in _ALWAYS_IN_SCOPE
        )
        if not in_scope:
            continue
        fn = node.ast_node
        seg = _fn_segment(mod, fn)
        touches_contract = any(m in seg for m in _DEADLINE_MARKERS)
        has_deadline = _has_deadline_in_hand(mod, node)
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            cname = _call_name(n)
            if cname == "urlopen" and not touches_contract:
                out.append(finding(
                    R_DROP, mod, n.lineno,
                    f"urlopen in {node.name!r} (reachable from the "
                    "request path) never sets X-Request-Deadline or "
                    "caps its timeout by the remaining budget; flow "
                    "current_deadline() or suppress with a rationale",
                    symbol=node.name,
                ))
            elif cname == "call_with_resilience":
                kwargs = {kw.arg for kw in n.keywords}
                if "deadline" not in kwargs:
                    out.append(finding(
                        R_NOT_FORWARDED, mod, n.lineno,
                        f"call_with_resilience in {node.name!r} without "
                        "deadline=; retries/backoff will outlive the "
                        "caller's budget — pass the in-scope deadline "
                        "or current_deadline()",
                        symbol=node.name,
                    ))
            elif cname == "submit" and has_deadline and \
                    isinstance(n.func, ast.Attribute):
                kwargs = {kw.arg for kw in n.keywords}
                # a deadline is in hand; the queue handoff must carry it
                if "deadline" not in kwargs and not any(
                    isinstance(a, ast.Name) and a.id == "deadline"
                    for a in n.args
                ):
                    out.append(finding(
                        R_NOT_FORWARDED, mod, n.lineno,
                        f".submit(...) in {node.name!r} has a deadline "
                        "in scope but doesn't forward it; the queued "
                        "work will run on its own clock",
                        symbol=f"{node.name}.submit",
                    ))
        # stale-forward: headers[DEADLINE_HEADER] = <inbound text>
        for n in ast.walk(fn):
            if not isinstance(n, ast.Assign):
                continue
            for t in n.targets:
                if not (isinstance(t, ast.Subscript) and _mentions(
                    t.slice, "DEADLINE_HEADER", "X-Request-Deadline"
                )):
                    continue
                if _mentions(n.value, "remaining_ms", "remaining_s"):
                    continue
                if _mentions(n.value, "headers", "get"):
                    out.append(finding(
                        R_STALE, mod, n.lineno,
                        f"{node.name!r} forwards the inbound deadline "
                        "header text verbatim; derive the value from "
                        "deadline.remaining_ms() so the budget shrinks "
                        "at every hop",
                        symbol=node.name,
                    ))
    return out


def _mentions(node: ast.AST, *needles: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in needles:
            return True
        if isinstance(n, ast.Attribute) and n.attr in needles:
            return True
        if isinstance(n, ast.Constant) and n.value in needles:
            return True
    return False
