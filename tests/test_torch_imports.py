"""The port stands alone: no jax, nothing of ``predictionio_tpu``.

* A subprocess with ``sys.modules['jax']`` and ``sys.modules['predictionio_tpu']``
  set to None (any import of either then raises) imports every module of
  ``predictionio_tpu_torch`` and ``chip_smoke.py``.
* A source scan finds no import of jax, jaxlib, ml_dtypes, orbax or
  ``predictionio_tpu`` in the port or in ``chip_smoke.py``.
* ``DeviceContext.create()`` without CUDA and without ``device="cpu"``
  raises; ``chip_smoke.py`` exits non-zero and prints no result without a
  card, and in a directory that holds nothing else of the repository.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from predictionio_tpu_torch.device import DeviceContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ml_dtypes|orbax|predictionio_tpu)(?:\.|\s|$)",
    re.M,
)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['predictionio_tpu'] = None
import predictionio_tpu_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(
    predictionio_tpu_torch.__path__, 'predictionio_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'orbax', 'predictionio_tpu')]
assert not bad, bad
print(" ".join(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 30
    # the training and SASRec slices' modules, by name
    assert {
        "predictionio_tpu_torch.data.event", "predictionio_tpu_torch.data.batch",
        "predictionio_tpu_torch.data.store", "predictionio_tpu_torch.data.storage.base",
        "predictionio_tpu_torch.data.storage.memory",
        "predictionio_tpu_torch.data.storage.registry",
        "predictionio_tpu_torch.ops.train_kernel", "predictionio_tpu_torch.models.als",
        "predictionio_tpu_torch.core.workflow",
        "predictionio_tpu_torch.templates.recommendation",
        # the SASRec serving slice
        "predictionio_tpu_torch.ops.flash_attention", "predictionio_tpu_torch.parallel.ring",
        "predictionio_tpu_torch.models.sequential",
        "predictionio_tpu_torch.templates.sequentialrecommendation",
        # the segment solver's slice
        "predictionio_tpu_torch.ops.segment",
        # the quickstart's operator surface
        "predictionio_tpu_torch.data.storage.sqlite", "predictionio_tpu_torch.data.api.stats",
        "predictionio_tpu_torch.data.api.event_server", "predictionio_tpu_torch.tools.cli",
        # the operators' serving slice
        "predictionio_tpu_torch.common.resilience", "predictionio_tpu_torch.common.http",
        "predictionio_tpu_torch.utils.profiling", "predictionio_tpu_torch.obs",
        "predictionio_tpu_torch.obs.metrics", "predictionio_tpu_torch.obs.tracing",
        "predictionio_tpu_torch.obs.devprof", "predictionio_tpu_torch.obs.bridges",
        "predictionio_tpu_torch.serving.result_cache", "predictionio_tpu_torch.serving.batching",
        "predictionio_tpu_torch.serving.fastpath", "predictionio_tpu_torch.serving.plugins",
        "predictionio_tpu_torch.serving.query_server", "predictionio_tpu_torch.tools.loadtest",
        "predictionio_tpu_torch.tools.scenarios",
    } <= names
    # the SASRec training, segment and operators' slices' names, by attribute
    code = ("import sys; sys.modules['jax'] = None; sys.modules['predictionio_tpu'] = None; "
            "from predictionio_tpu_torch.ops.flash_attention import _FlashAttention, flash_block_bwd, "
            "flash_attention_bwd_reference, bwd_dq_launches, bwd_dkv_launches; "
            "from predictionio_tpu_torch.models.sequential import train_sasrec, build_sequences, "
            "_moe_ffn, _loss_fn, train_step; "
            "from predictionio_tpu_torch.ops.train_kernel import fused_gather_rows, "
            "gather_rows_reference, gather_launches; "
            "from predictionio_tpu_torch.models.als import _make_blocks, _half_step; "
            "from predictionio_tpu_torch.common.resilience import CircuitBreaker, RetryPolicy, "
            "call_with_resilience, deadline_scope, ErrorCounters, RateLimitedLogger; "
            "from predictionio_tpu_torch.obs import Telemetry, telemetry_enabled, maybe_install; "
            "from predictionio_tpu_torch.obs.devprof import DeviceUtilization, PEAKS, peak_for; "
            "from predictionio_tpu_torch.serving.result_cache import ResultCache, notify_event; "
            "from predictionio_tpu_torch.tools.scenarios import parse_scenario, run_scenario; "
            "from predictionio_tpu_torch.tools.loadtest import run_loadtest, run_ingest_loadtest; "
            "from predictionio_tpu_torch.ops._build import KernelError")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_every_kernel_source_is_built():
    """``build_all`` (what ``chip_smoke.py`` and the first launch run)
    builds every CUDA source of the port, the flash backward's included."""
    from predictionio_tpu_torch.ops import _build

    assert set(_build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert "flash_bwd" in _build.SOURCES and "gather_rows" in _build.SOURCES


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_device_context_refuses_cpu_fallback():
    if torch.cuda.is_available():
        assert DeviceContext.create().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceContext.create()
    assert DeviceContext.create(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        DeviceContext.create(device="meta")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout
