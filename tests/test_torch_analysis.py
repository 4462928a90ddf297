"""``pio analyze`` pointed at the port, against the JAX package's analyzers.

* Every fixture tree of ``tests/test_analysis.py`` for the shared analyzers
  (blocking, deadline, hygiene, knobs, lockorder, metrics, races; the
  trees are read out of that file's ``make_repo`` calls, with the
  ``run(...)`` analyzers and ``changed_only`` the test passes) goes through
  both packages' ``run()``: the sets of (rule, file, symbol) and the
  suppression counts must be equal. One case per tree.
* The CUDA/torch forms of the JAX-specific rules catch their seeded faults
  and pass their clean twins: readbacks, fences and kernel builds in the
  request path (``hotpath``), ctypes ``argtypes`` against the ``extern "C"``
  prototypes, mesh axis names and readbacks one call deep
  (``collective``).
* The port's own tree analyzes with zero ``error`` findings against its
  baseline, and every baselined key still resolves.
* The CLI: ``--format json|sarif|human``, ``--list-rules``, ``--graph
  lockorder``, ``--write-baseline``, ``--prune-baseline``, ``--baseline``.
"""

import ast
import json
import os
import pathlib
import textwrap

import pytest

from predictionio_tpu.analysis import core as jax_core
from predictionio_tpu_torch.analysis import core as port_core
from predictionio_tpu_torch.tools import cli as port_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARED = ["blocking", "deadline", "hygiene", "knobs", "lockorder", "metrics", "races"]


def _fixture_trees():
    """(case id, files, analyzers, changed_only) for every make_repo call in
    tests/test_analysis.py whose analyzers are all shared ones."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Dict):
            consts[node.targets[0].id] = ast.literal_eval(node.value)
    cases = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        runs = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "run"]
        kw = {k.arg: k.value for k in runs[0].keywords} if runs else {}
        analyzers = ast.literal_eval(kw["analyzers"]) if "analyzers" in kw else SHARED
        changed = ast.literal_eval(kw["changed_only"]) if "changed_only" in kw else None
        if not set(analyzers) <= set(SHARED):
            continue
        k = 0
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "make_repo":
                arg = n.args[1]
                files = consts[arg.id] if isinstance(arg, ast.Name) else ast.literal_eval(arg)
                cases.append((f"{fn.name}-{k}", files, analyzers, changed))
                k += 1
    return cases


CASES = _fixture_trees()


def make_repo(root: pathlib.Path, files: dict) -> str:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def keyset(rep):
    return {(f.rule, f.path, f.symbol) for f in rep.findings}


def test_the_shared_fixture_trees_were_found():
    ids = {c[0].rsplit("-", 1)[0] for c in CASES}
    for name in ("test_races_positives_and_negatives", "test_knobs_contract_rules",
                 "test_metrics_contract_rules", "test_blocking_positives_and_negatives",
                 "test_lockorder_detects_ab_ba_cycle_across_calls",
                 "test_deadline_rules_positive_and_negative", "test_baseline_round_trip",
                 "test_races_acquire_release_pairs"):
        assert name in ids
    assert len(CASES) >= 20


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shared_fixture_gives_the_same_findings(case, tmp_path):
    _, files, analyzers, changed = case
    root = make_repo(tmp_path, files)
    jax_rep = jax_core.run(root, analyzers=analyzers, changed_only=changed)
    port_rep = port_core.run(root, analyzers=analyzers, changed_only=changed)
    assert keyset(port_rep) == keyset(jax_rep)
    assert port_rep.suppressed == jax_rep.suppressed
    assert port_rep.counts == jax_rep.counts


def test_shared_rule_catalogs_are_equal():
    """The language-level analyzers keep the JAX package's rule ids,
    severities and summaries."""
    import predictionio_tpu.analysis  # noqa: F401
    import predictionio_tpu_torch.analysis  # noqa: F401

    for name in SHARED:
        assert port_core.ANALYZER_RULES[name] == jax_core.ANALYZER_RULES[name]
        for rid in port_core.ANALYZER_RULES[name]:
            pr, jr = port_core.RULES[rid], jax_core.RULES[rid]
            assert (pr.severity, pr.summary) == (jr.severity, jr.summary)
    # the JAX-specific analyzers keep their names; hotpath its rule ids
    assert port_core.ANALYZER_RULES["hotpath"] == jax_core.ANALYZER_RULES["hotpath"]
    assert set(port_core.ANALYZER_RULES["collective"]) == {
        "collective-mesh-axis", "collective-unknown-axis", "collective-ctypes-prototype",
        "collective-host-in-callee"}


# -- the CUDA / torch forms ------------------------------------------------------


HOTPATH_FIXTURE = {
    "ops/kern.py": """\
        import ctypes

        import torch

        from pkg import _build

        _lib = None


        def _library():
            global _lib
            if _lib is None:
                _lib = ctypes.CDLL(str(_build.library("kern")))
            return _lib


        def _warm_library():
            return ctypes.CDLL(str(_build.library("warm")))


        def fused_kern(u, v):
            out = torch.empty(u.shape[0], device=u.device)
            _library().pio_kern(u.data_ptr(), v.data_ptr(), out.data_ptr())
            return out, out
    """,
    "serving/fast.py": """\
        import torch

        from ops.kern import fused_kern, _warm_library


        def score_answer(u, v):
            vals, idx = fused_kern(u, v)
            idx_h = idx.cpu().numpy()
            val_h = vals.cpu().numpy()
            return idx_h, val_h


        def score_twice(u, v, dev):
            vals, idx = fused_kern(u, v)
            n = int(vals.sum())
            first = idx.tolist()
            extra = torch.ones(3, device=dev)
            more = (idx + 1).to(dev)
            return n, first, more.tolist(), extra.item()


        def recommend_fenced(u, v):
            vals, _ = fused_kern(u, v)
            torch.cuda.synchronize()
            return vals.cpu()


        def warmup(u, v):
            fused_kern(u, v)
            torch.cuda.synchronize()
            _warm_library()


        def handle_host(x):
            a = x.tolist()
            b = x.tolist()
            return a, b


        def traced_style(u, v):
            vals, _ = fused_kern(u, v)
            if vals.sum() > 0:
                return 1
            return 0
    """,
}


def test_hotpath_cuda_forms(tmp_path):
    root = make_repo(tmp_path, HOTPATH_FIXTURE)
    rep = port_core.run(root, analyzers=["hotpath"])
    by = {}
    for f in rep.findings:
        by.setdefault(f.rule, set()).add(f.symbol)
    # a second readback of another origin, casts and .item() included
    assert by["hotpath-host-sync"] == {"score_twice.tolist", "score_twice.item"}
    # one fence in the request path; the warm-up's passes
    assert by["hotpath-block-sync"] == {"recommend_fenced"}
    # the lazy build reachable from the request paths; the warm-up's is not
    assert by["hotpath-jit-in-request"] == {"_library"}
    assert "hotpath-traced-branch" not in by and "hotpath-traced-loop" not in by
    # the answer's (vals, idx) readback, host .tolist() and branches: clean
    assert not any(s.startswith(("score_answer", "handle_host", "warmup", "traced_style"))
                   for ss in by.values() for s in ss)


def test_hotpath_suppression_and_warmup_fence(tmp_path):
    files = dict(HOTPATH_FIXTURE)
    line = '_lib = ctypes.CDLL(str(_build.library("kern")))'
    assert line in files["ops/kern.py"]
    files["ops/kern.py"] = files["ops/kern.py"].replace(
        line, line + "  # pio: ignore[hotpath-jit-in-request]")
    root = make_repo(tmp_path, files)
    rep = port_core.run(root, analyzers=["hotpath"])
    assert not any(f.rule == "hotpath-jit-in-request" for f in rep.findings)
    assert rep.suppressed == 1


COLLECTIVE_FIXTURE = {
    "parallel/mesh.py": """\
        DATA_AXIS = "data"
        MODEL_AXIS = "model"


        def make_mesh(axes=None, devices=None):
            return axes
    """,
    "csrc/kern.cu": """\
        #include <cuda_runtime.h>

        __global__ void body(const float* x) {}

        extern "C" {

        int pio_kern_limits(int* tile) { *tile = 4; return 0; }

        const char* pio_kern_error_string(int err) { return "x"; }

        // the launch: pointers, ints, one float, the stream
        int pio_kern(const float* u, const float* v, float* out, int n,
                     long long total, float alpha, cudaStream_t stream) {
          return 0;
        }

        int pio_other(const void* a, int b) { return 0; }

        }  // extern "C"

        extern "C" int pio_single(double scale, int* out);
    """,
    "ops/kern.py": """\
        import ctypes


        def _library(lib):
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.pio_kern.argtypes = [p] * 3 + [i, ctypes.c_longlong, f, p]
            limits = lib.pio_kern_limits
            limits.argtypes = [p]
            lib.pio_kern_error_string.argtypes = [i]
            lib.pio_single.argtypes = [ctypes.c_double, ctypes.POINTER(ctypes.c_int)]
            return lib


        def _bad_library(lib):
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.pio_other.argtypes = [p] * 2 + [i]
            lib.pio_kern_limits.argtypes = [i]
            lib.pio_missing.argtypes = [p]
            lib.pio_single.argtypes = (p, p)
    """,
    "serving/sharded.py": """\
        from parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

        AXIS = "modle"


        def place_ok(ctx, x):
            n = ctx.axis_size(DATA_AXIS)
            sub = ctx.submesh(n, axis=MODEL_AXIS)
            return sub.place(x, (DATA_AXIS, MODEL_AXIS))


        def place_bad(ctx, x):
            n = ctx.axis_size("dta")
            sub = ctx.submesh(n, AXIS)
            return sub.place(x, "host")


        def shape_bad(devs):
            return make_mesh(axes={"data": 2, "hots": 1}, devices=devs)


        def shape_ok(devs, axis):
            return make_mesh(axes={DATA_AXIS: 2, axis: 1}, devices=devs)
    """,
    "serving/helpers.py": """\
        import torch


        def _finish(vals, dev):
            a = vals.to(dev)
            first = a.cpu()
            more = torch.ones(2, device=dev).tolist()
            return first, more


        def score_via_helper(vals, dev):
            return _finish(vals, dev)
    """,
}


def test_collective_cuda_forms(tmp_path):
    root = make_repo(tmp_path, COLLECTIVE_FIXTURE)
    rep = port_core.run(root, analyzers=["collective"])
    by = {}
    for f in rep.findings:
        by.setdefault(f.rule, set()).add(f.symbol)
    # the seeded argtypes/prototype mismatches: count, kind, unknown symbol
    assert by["collective-ctypes-prototype"] == {
        "pio_other", "pio_kern_limits", "pio_missing", "pio_single"}
    msgs = {f.symbol: f.message for f in rep.findings if f.rule == "collective-ctypes-prototype"}
    assert "3 argtypes vs 2 parameters" in msgs["pio_other"]
    assert "argument 0 is int in argtypes, pointer in the prototype" in msgs["pio_kern_limits"]
    assert "argument 0 is pointer in argtypes, float in the prototype" in msgs["pio_single"]
    assert by["collective-unknown-axis"] == {"place_bad.dta", "place_bad.modle",
                                             "place_bad.host"}
    assert by["collective-mesh-axis"] == {"shape_bad.hots"}
    assert by["collective-host-in-callee"] == {"_finish.tolist"}
    # the clean twins: matching prototypes (aliases, tuples, POINTER),
    # declared axes, parameterised axes
    assert not any("place_ok" in s or "shape_ok" in s or s == "pio_kern"
                   for ss in by.values() for s in ss)


def test_a_seeded_mismatch_in_the_ports_own_binding(tmp_path):
    """Copy score_kernel.py and its .cu; drop one int from the argtypes."""
    pkg = tmp_path / "predictionio_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    src = (ROOT / "predictionio_tpu_torch" / "ops" / "score_kernel.py").read_text()
    (pkg / "csrc" / "score_topk.cu").write_text(
        (ROOT / "predictionio_tpu_torch" / "csrc" / "score_topk.cu").read_text())
    (pkg / "ops" / "score_kernel.py").write_text(src)
    rep = port_core.run(str(tmp_path), analyzers=["collective"], baseline_path="")
    assert not [f for f in rep.findings if f.rule == "collective-ctypes-prototype"]
    bad = src.replace("lib.pio_score_topk.argtypes = [p] * 10 + [i] * 8 + [p]",
                      "lib.pio_score_topk.argtypes = [p] * 10 + [i] * 7 + [p]")
    assert bad != src
    (pkg / "ops" / "score_kernel.py").write_text(bad)
    rep = port_core.run(str(tmp_path), analyzers=["collective"], baseline_path="")
    found = [f for f in rep.findings if f.rule == "collective-ctypes-prototype"]
    assert [(f.symbol, f.severity) for f in found] == [("pio_score_topk", "error")]
    assert "18 argtypes vs 19 parameters" in found[0].message


# -- the port's own tree --------------------------------------------------------


@pytest.fixture(scope="module")
def repo_report():
    return port_core.run(str(ROOT))


def test_the_ports_tree_analyzes_with_no_errors(repo_report):
    errors = [f.render() for f in repo_report.findings if f.severity == "error"]
    assert errors == []
    assert repo_report.counts["warning"] == 0  # every warning is baselined or waived
    assert repo_report.root == str(ROOT)
    scanned = {f.path.split("/")[0] for f in repo_report.findings}
    assert not scanned & {"predictionio_tpu", "bench.py", "tools"}


def test_the_ports_baseline_keys_all_resolve(repo_report):
    keys = port_core.load_baseline(str(ROOT / port_core.BASELINE_NAME))
    assert keys and repo_report.baselined == len(keys)
    assert port_core.stale_baseline_keys(keys, port_core.RepoIndex(str(ROOT))) == []
    # its own baseline file: the JAX package's stays the JAX package's
    assert port_core.BASELINE_NAME != jax_core.BASELINE_NAME


def test_the_ports_knobs_are_documented(repo_report):
    knobs = repo_report.extras["knobs"]
    assert knobs["count"] > 50 and knobs["documented"] == knobs["count"]


# -- the CLI ------------------------------------------------------------------------


def test_cli_formats_and_list_rules(tmp_path, capsys):
    root = make_repo(tmp_path, {"a.py": "import os\n"})
    assert port_cli.main(["analyze", "--root", root, "--format", "json"]) == 1
    d = json.loads(capsys.readouterr().out)
    assert d["counts"]["error"] == 1 and d["findings"][0]["rule"] == "hygiene-unused-import"
    assert port_cli.main(["analyze", "--root", root, "--format", "sarif"]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["version"] == "2.1.0"
    assert sarif["runs"][0]["results"][0]["partialFingerprints"]["pioKey"] == \
        "hygiene-unused-import:a.py:os"
    assert port_cli.main(["analyze", "--root", root]) == 1
    assert "1 error(s)" in capsys.readouterr().out
    assert port_cli.main(["analyze", "--list-rules"]) == 0
    rules = capsys.readouterr().out
    assert "hotpath-traced-branch" in rules and "no eager counterpart" in rules
    assert "collective-ctypes-prototype" in rules


def test_cli_baseline_round_trip_and_prune(tmp_path, capsys):
    root = make_repo(tmp_path, {"a.py": "import os\n", "b.py": "import sys\n"})
    assert port_cli.main(["analyze", "--root", root, "--write-baseline"]) == 0
    capsys.readouterr()
    base = pathlib.Path(root) / port_core.BASELINE_NAME
    assert len(json.loads(base.read_text())["findings"]) == 2
    assert port_cli.main(["analyze", "--root", root]) == 0
    assert "2 baselined" in capsys.readouterr().out
    os.remove(pathlib.Path(root) / "b.py")
    assert port_cli.main(["analyze", "--root", root, "--format", "json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in d["findings"]] == ["baseline-stale"]
    assert port_cli.main(["analyze", "--root", root, "--prune-baseline"]) == 0
    assert "1 stale entry pruned" in capsys.readouterr().out
    other = tmp_path / "elsewhere.json"
    assert port_cli.main(["analyze", "--root", root, "--baseline", str(other)]) == 1
    capsys.readouterr()


def test_cli_graph_lockorder(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_test_analysis",
                                                  ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = make_repo(tmp_path, mod.LOCKORDER_CYCLE_FIXTURE)
    assert port_cli.main(["analyze", "--root", root, "--graph", "lockorder"]) == 0
    port_dot = capsys.readouterr().out
    from predictionio_tpu.tools import cli as jax_cli

    assert jax_cli.main(["analyze", "--root", root, "--graph", "lockorder"]) == 0
    assert port_dot == capsys.readouterr().out
    assert port_dot.startswith("digraph")
