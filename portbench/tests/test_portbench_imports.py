"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT, TINY

from portbench import harness

REFERENCE = ROOT / "portbench" / "reference"


@pytest.mark.parametrize("workload", list(TINY))
def test_a_run_loads_no_jax(workload):
    overrides, mix = TINY[workload]
    code = (
        "import json, sys; sys.path.insert(0, {root!r})\n"
        "from portbench import harness\n"
        "r = harness.run_cell({w!r}, 9, 0.2, True, device='cpu', overrides={o!r},\n"
        "                     mix_overrides={m!r})\n"
        "print(json.dumps({{'found': harness.forbidden_modules(), 'correct': r['correct'],"
        " 'all': sorted({{k.split('.')[0] for k in sys.modules}})}}))\n"
    ).format(root=str(ROOT), w=workload, o=overrides, m=mix)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["found"] == [] and got["correct"] is True
    assert "predictionio_tpu_torch" in got["all"]
    assert not {"jax", "jaxlib", "flax", "predictionio_tpu"} & set(got["all"])


def test_forbidden_names_compare_whole():
    import predictionio_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "predictionio_tpu" in harness.FORBIDDEN
    assert "predictionio_tpu_torch" not in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"predictionio_tpu_torch", "predictionio_tpu", "jax", "jaxlib", "flax"}
    assert all(name.startswith("portbench.reference") or not name.startswith("portbench")
               for name in _imports(path))


def test_reference_modules_load_without_the_program():
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "import portbench.reference.als, portbench.reference.sasrec, portbench.reference.topk\n"
        "import portbench.reference.compare\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('predictionio')))\n"
    ).format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
