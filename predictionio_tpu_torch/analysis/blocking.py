"""Blocking-call detector for the serving dispatch hot loop.

The micro-batcher worker (``serving/batching.py``), the fastpath
scorer (``serving/fastpath.py``), the shard fan-out/merge layer
(``serving/sharding.py``), and the IVF probe-selection/pruned-scan
helpers (``ops/ivf.py``) sit between every query and the card: one
``time.sleep``, ``fsync``, JSON round-trip, or synchronous network
call there is paid by the whole batch at p50, not by one request at
p99.  Serialization belongs at the HTTP layer, durability in the WAL's
group-commit thread, and pacing in the condition-variable waits the
batcher already uses.

Scope: every function in the dispatch modules except constructors and
teardown (``__init__``/``_compile``/``stats``/``stop``/``close``) and
the publish-time plan builders (``build_plan``/``save_plan``/
``load_plan``/``plan_from_env``/``build_layout``/``to_payload``/
``from_payload``/``describe`` — they run at train/rebalance time, never
under a dispatch, and the sealed-blob write MUST fsync; the same goes
for ``ops/ivf.py``'s k-means/recall-gate/blob machinery), plus
worker-loop functions (``_loop``/``_run``/``_flush``/``_drain``/
``_health_loop``/``_monitor_loop``/``_control_loop`` — the last three
are the fleet router's health prober, the fleet supervisor's child
watcher, and the autoscaler's decision pacer) in the rest of
``serving/`` and ``data/api/``.  ``Condition.wait``/
``Event.wait`` are the sanctioned blocking primitives and are not
flagged.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis.core import (
    Finding, Module, RepoIndex, analyzer, finding, rel_in, rule,
)

R_BLOCKING = rule(
    "blocking-call-in-hot-loop", "error",
    "blocking syscall in the batcher/fastpath dispatch loop",
    "sleep/fsync/json/socket work in the dispatch loop taxes every "
    "batched query at p50; move it to the HTTP layer, the WAL thread, "
    "or a cv.wait",
)

# dispatch modules: every function is hot unless exempted.
# tenancy.py admission and pipeline.py stage execution run under every
# multi-tenant / composed-pipeline query — as hot as the batcher
_HOT_MODULES = ("batching.py", "fastpath.py", "sharding.py",
                "tenancy.py", "pipeline.py")
# ops modules on the serving dispatch path: probe selection and the
# pruned scan in ivf.py run under every cache-miss query
_HOT_OPS_MODULES = ("ivf.py",)
_EXEMPT_FUNCS = {"__init__", "_compile", "stats", "stop", "close",
                 "__repr__",
                 # sharding.py publish/rebalance-time plan machinery:
                 # runs at train or `pio shards rebuild` time, never
                 # under a dispatch (ShardAccounting.note/snapshot and
                 # ShardLayout.take_rows stay in scope)
                 "build_plan", "save_plan", "load_plan", "plan_from_env",
                 "plan_from_assignment",
                 "build_layout", "to_payload", "from_payload",
                 "describe", "validate", "shard_count_for_budget",
                 # ivf.py publish/rebuild-time machinery: k-means, the
                 # recall gate and the sealed-blob envelope run at train
                 # or `pio ivf rebuild` time, never under a dispatch
                 # (resolve_retrieval/default_nprobe stay in scope)
                 "train_kmeans", "build_index", "index_from_env",
                 "measure_recall", "save_index", "load_index",
                 # tenancy.py / pipeline.py config + publish-time
                 # machinery: registry/pipeline construction, the
                 # sealed-blob envelope and env loading run at deploy
                 # time, never under a dispatch (admit/release/
                 # record_result/run_pipeline/stage runners stay in
                 # scope)
                 "tenants_from_env", "registry_from_config",
                 "pipeline_from_env", "save_pipeline", "load_pipeline",
                 "from_dict", "to_dict",
                 # the injected stall IS the fault being modeled: a
                 # chaos-configured slow pipeline stage
                 "_fault_latency"}
# worker-loop functions checked across the wider threaded scope
# (_health_loop/_monitor_loop/_control_loop: the router's probe pacer,
# the fleet supervisor's child watcher, and the autoscaler's decision
# pacer; _delta_loop/_catchup_loop: the event server's delta flush
# worker and the replica's delta catch-up worker;
# _verify_loop/_soak_loop: the canary controller's verification window
# and post-promotion soak watchdog — all must pace on Event.wait and
# delegate real I/O to non-loop helpers)
_HOT_LOOP_NAMES = {"_loop", "_run", "_flush", "_drain",
                   "_health_loop", "_monitor_loop", "_control_loop",
                   "_delta_loop", "_catchup_loop",
                   "_verify_loop", "_soak_loop"}

# callee name → why it blocks
_BLOCKING_ATTRS = {
    "sleep": "time.sleep stalls the worker for every queued request",
    "fsync": "fsync is a disk barrier; it belongs in the WAL's "
             "group-commit thread",
    "fdatasync": "fdatasync is a disk barrier; it belongs in the WAL's "
                 "group-commit thread",
    "dumps": "JSON encode on the dispatch thread; serialize at the "
             "HTTP layer",
    "loads": "JSON decode on the dispatch thread; parse at the HTTP "
             "layer",
    "urlopen": "synchronous network I/O in the dispatch loop",
    "request": "synchronous network I/O in the dispatch loop",
    "recv": "synchronous socket read in the dispatch loop",
    "send": "synchronous socket write in the dispatch loop",
    "connect": "synchronous connect in the dispatch loop",
}
_BLOCKING_NAMES = {
    "open": "file I/O in the dispatch loop",
    "print": "stdout writes block on the consumer; use the obs "
             "registry",
}
# receivers whose .send/.recv/.request are NOT sockets
_SAFE_RECEIVERS = {"self", "q", "queue"}
# json.dumps/loads only count when the receiver IS json
_JSON_ONLY = {"dumps", "loads"}


def _hot_functions(mod: Module):
    if mod.tree is None:
        return
    base = mod.rel.rsplit("/", 1)[-1]
    hot_module = (
        rel_in(mod.rel, "serving") and base in _HOT_MODULES
    ) or (
        rel_in(mod.rel, "ops") and base in _HOT_OPS_MODULES
    )
    # wal.py is exempt: its group-commit thread exists to fsync
    in_threaded_scope = (
        rel_in(mod.rel, "serving", "data/api") and base != "wal.py"
    )
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if hot_module and node.name not in _EXEMPT_FUNCS:
            yield node
        elif in_threaded_scope and node.name in _HOT_LOOP_NAMES:
            yield node


@analyzer("blocking")
def analyze(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.modules:
        seen_lines: set[tuple[int, str]] = set()
        for fn in _hot_functions(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute):
                    attr = f.attr
                    recv = getattr(f.value, "id", "")
                    why = _BLOCKING_ATTRS.get(attr)
                    if why is None:
                        continue
                    if attr in _JSON_ONLY and recv != "json":
                        continue
                    if recv in _SAFE_RECEIVERS or recv.startswith("_"):
                        # self.send()/q.send() style helpers are not
                        # the socket syscall
                        if attr not in _JSON_ONLY and attr != "sleep" \
                                and attr not in ("fsync", "fdatasync"):
                            continue
                    key = (node.lineno, attr)
                    if key in seen_lines:
                        continue
                    seen_lines.add(key)
                    out.append(finding(
                        R_BLOCKING, mod, node.lineno,
                        f"{recv + '.' if recv else ''}{attr}() in hot "
                        f"function {fn.name!r}: {why}",
                        symbol=f"{fn.name}.{attr}",
                    ))
                elif isinstance(f, ast.Name) and f.id in _BLOCKING_NAMES:
                    key = (node.lineno, f.id)
                    if key in seen_lines:
                        continue
                    seen_lines.add(key)
                    out.append(finding(
                        R_BLOCKING, mod, node.lineno,
                        f"{f.id}() in hot function {fn.name!r}: "
                        f"{_BLOCKING_NAMES[f.id]}",
                        symbol=f"{fn.name}.{f.id}",
                    ))
    return out

from predictionio_tpu_torch.analysis.core import owns_rules

owns_rules("blocking", R_BLOCKING.id)
