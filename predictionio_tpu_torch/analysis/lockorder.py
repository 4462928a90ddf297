"""Global lock-order analysis: cross-call-chain AB/BA deadlock detection.

races.py sees one module at a time, so it catches "mutates shared
attr without the lock" but is structurally blind to the deadlock the
fleet actually risks: thread 1 takes the router lock then calls into the
breaker (which takes its own), while thread 2 holds the breaker lock and
calls back into a router method.  Neither module is wrong in isolation;
the *order* is.

This analyzer builds a **lock-order graph** over the interprocedural
engine in :mod:`callgraph`:

* node = static lock token (``rel::Class.attr`` / ``rel::name``);
* edge A→B = somewhere in the repo, B is acquired while A is held —
  either directly in one function, or through a call chain (the held
  set at a call site crossed with the transitive lock closure of the
  callee, computed over the call-graph condensation).

Cycles in that graph are potential deadlocks.  Every edge keeps a
*witness chain* — the ``file:line`` hops from "A held here" down to "B
acquired there" — so a report shows both sides of the inversion, not
just the pair of lock names.

Self-edges (A while A) are ignored: the repo's locks are per-instance
and the common re-entry cases (RLock, parent/child instances of one
class) are not inversions.  Unknown callees contribute no edges — the
graph under-approximates, so a clean report means "no deadlock visible
to static resolution", not "no deadlock".
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.analysis import callgraph
from predictionio_tpu_torch.analysis.core import (
    Finding,
    RepoIndex,
    analyzer,
    finding,
    rule,
)

R_CYCLE = rule(
    "lockorder-cycle",
    "error",
    "lock-order cycle across call chains: potential AB/BA deadlock",
    "two threads acquiring the same locks in opposite orders can each "
    "block on the lock the other holds; a hung fleet loses every "
    "latency win the kernels bought",
)

_MAX_CHAIN = 12  # reconstruction depth guard (matches call-graph depth)


# -- lock closures over the call-graph condensation ---------------------------


def _condense(
    graph: callgraph.CallGraph,
) -> tuple[dict[str, int], list[list[str]]]:
    """Tarjan SCC over call+ref edges → (qual → scc id, sccs in reverse
    topological order: callees before callers)."""
    index_of: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]
    scc_of: dict[str, int] = {}

    def strongconnect(root: str) -> None:
        # iterative tarjan: (node, successor-iterator) work stack
        work = [(root, iter(sorted(graph.successors(root))))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in graph.nodes:
                    continue
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.successors(w)))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index_of[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sid = len(sccs)
                sccs.append(comp)
                for w in comp:
                    scc_of[w] = sid

    for q in sorted(graph.nodes):
        if q not in index_of:
            strongconnect(q)
    # tarjan emits SCCs in reverse topological order already
    return scc_of, sccs


# witness for "function f eventually acquires token t":
#   ("acquire", line)                — t taken directly in f
#   ("call", line, callee_qual)      — via a call at `line` into callee
_Witness = tuple


def _lock_closures(
    graph: callgraph.CallGraph,
) -> dict[str, dict[str, _Witness]]:
    scc_of, sccs = _condense(graph)
    closures: dict[str, dict[str, _Witness]] = {
        q: {} for q in graph.nodes
    }
    for comp in sccs:  # reverse topo: callees already done
        # two passes inside one SCC so mutual recursion converges
        for _ in range(2 if len(comp) > 1 else 1):
            for q in comp:
                node = graph.nodes[q]
                cl = closures[q]
                for acq in node.acquires:
                    cl.setdefault(acq.token, ("acquire", acq.line))
                for site in node.calls:
                    for callee in site.callees:
                        if callee not in closures:
                            continue
                        for tok in closures[callee]:
                            cl.setdefault(
                                tok, ("call", site.line, callee)
                            )
    return closures


def _trace(
    closures: dict[str, dict[str, _Witness]],
    graph: callgraph.CallGraph,
    qual: str,
    token: str,
) -> list[str]:
    """file:line hops from entering ``qual`` to the acquire of ``token``."""
    chain: list[str] = []
    cur = qual
    for _ in range(_MAX_CHAIN):
        w = closures.get(cur, {}).get(token)
        if w is None:
            break
        node = graph.nodes[cur]
        if w[0] == "acquire":
            chain.append(f"{node.rel}:{w[1]} acquires {_short(token)}")
            return chain
        chain.append(
            f"{node.rel}:{w[1]} calls "
            f"{_short_qual(w[2], graph)}"
        )
        cur = w[2]
    chain.append(f"... {_short(token)} (chain truncated)")
    return chain


def _short(token: str) -> str:
    return token.split("::", 1)[-1]


def _short_qual(qual: str, graph: callgraph.CallGraph) -> str:
    n = graph.nodes.get(qual)
    if n is None:
        return qual
    return f"{n.cls}.{n.name}" if n.cls else n.name


# -- lock-order edges ----------------------------------------------------------


class _Edge:
    __slots__ = ("src", "dst", "rel", "line", "chain")

    def __init__(self, src: str, dst: str, rel: str, line: int,
                 chain: list[str]):
        self.src = src
        self.dst = dst
        self.rel = rel
        self.line = line
        self.chain = chain


def build_lock_order(
    index: RepoIndex,
) -> tuple[dict[tuple[str, str], _Edge], callgraph.CallGraph]:
    """All observed held→acquired pairs, each with one witness chain."""
    graph = callgraph.get(index)
    closures = _lock_closures(graph)
    edges: dict[tuple[str, str], _Edge] = {}

    def add(src: str, dst: str, rel: str, line: int, chain: list[str]):
        if src == dst:
            return  # reentrancy / per-instance pair, not an inversion
        edges.setdefault((src, dst), _Edge(src, dst, rel, line, chain))

    for q in sorted(graph.nodes):
        node = graph.nodes[q]
        # direct nesting: `with a: ... with b:` in one function
        for acq in node.acquires:
            for held in sorted(acq.held):
                add(
                    held, acq.token, node.rel, acq.line,
                    [f"{node.rel}:{acq.line} acquires "
                     f"{_short(acq.token)} while holding "
                     f"{_short(held)}"],
                )
        # interprocedural: held at a call site × callee's lock closure
        for site in node.calls:
            if not site.held:
                continue
            for callee in site.callees:
                for tok in sorted(closures.get(callee, {})):
                    for held in sorted(site.held):
                        if held == tok:
                            continue
                        chain = [
                            f"{node.rel}:{site.line} holds "
                            f"{_short(held)}, calls "
                            f"{_short_qual(callee, graph)}"
                        ] + _trace(closures, graph, callee, tok)
                        add(held, tok, node.rel, site.line, chain)
    return edges, graph


def to_dot(index: RepoIndex) -> str:
    """DOT dump of the lock-order graph for `pio analyze --graph
    lockorder`; cycle edges are drawn red."""
    edges, _ = build_lock_order(index)
    cyc_tokens = _cycle_tokens(edges)
    lines = [
        "digraph lockorder {",
        '  rankdir=LR;',
        '  node [shape=box, fontsize=10];',
    ]
    tokens = sorted({t for e in edges for t in e})
    for t in tokens:
        style = ', color=red' if t in cyc_tokens else ''
        lines.append(f'  "{_short(t)}" [tooltip="{t}"{style}];')
    for (a, b), e in sorted(edges.items()):
        in_cycle = a in cyc_tokens and b in cyc_tokens
        style = ' [color=red, penwidth=2.0]' if in_cycle else ''
        lines.append(
            f'  "{_short(a)}" -> "{_short(b)}"{style};'
            f'  // {e.rel}:{e.line}'
        )
    lines.append("}")
    return "\n".join(lines) + "\n"


# -- cycle detection -----------------------------------------------------------


def _token_sccs(
    edges: dict[tuple[str, str], _Edge],
) -> list[list[str]]:
    succ: dict[str, set[str]] = {}
    for a, b in edges:
        succ.setdefault(a, set()).add(b)
        succ.setdefault(b, set())
    index_of: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def connect(root: str) -> None:
        work = [(root, iter(sorted(succ[root])))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(succ[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index_of[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))

    for t in sorted(succ):
        if t not in index_of:
            connect(t)
    return out


def _cycle_tokens(edges: dict[tuple[str, str], _Edge]) -> set[str]:
    return {t for comp in _token_sccs(edges) for t in comp}


# -- analyzer ------------------------------------------------------------------


from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("lockorder", R_CYCLE.id)


@analyzer("lockorder")
def analyze_lockorder(index: RepoIndex):
    edges, graph = build_lock_order(index)
    findings: list[Finding] = []
    for comp in _token_sccs(edges):
        # pick one concrete inversion inside the SCC to anchor the
        # report: an edge pair (a→b, b→a) when one exists, else the
        # first edge of the component's cycle
        pair: Optional[tuple[_Edge, _Edge]] = None
        for a, b in ((x, y) for x in comp for y in comp if x != y):
            if (a, b) in edges and (b, a) in edges:
                pair = (edges[(a, b)], edges[(b, a)])
                break
        if pair is None:
            comp_edges = [
                e for (a, b), e in sorted(edges.items())
                if a in comp and b in comp
            ]
            pair = (comp_edges[0], comp_edges[-1])
        fwd, rev = pair
        msg = (
            f"lock-order cycle between {_short(fwd.src)} and "
            f"{_short(fwd.dst)} "
            f"(cycle: {', '.join(_short(t) for t in comp)}); "
            f"one side: {' -> '.join(fwd.chain)}; "
            f"other side: {' -> '.join(rev.chain)}"
        )
        findings.append(finding(
            R_CYCLE,
            fwd.rel,
            fwd.line,
            msg,
            symbol="|".join(_short(t) for t in comp),
        ))
    return findings, {"callgraph": graph.stats()}
