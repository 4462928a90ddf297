"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

The output lands under ``build/torch_kernels/`` at the repository root (a
directory ``.gitignore`` lists), named by a hash of the source and of the
headers it includes from ``csrc/`` (``#include "x.cuh"``, followed
through the headers' own includes), so a changed source or header builds
anew and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together.

:class:`KernelError` is the one exception type of the kernels' wrappers: a
refusal of their inputs, a build or launch that fails, and (through
:func:`as_kernel_error`) an error the card reports afterwards. The query
server lets it through as a 500 where it serves a degraded answer for other
failures, so a broken card never hides behind a stale answer.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

class KernelError(ValueError, RuntimeError):
    """A kernel refused its inputs, did not build or launch, or the card
    reported an error. It is a ValueError and a RuntimeError, the two
    types the wrappers raised before it, so existing handlers still match."""


def as_kernel_error(exc: BaseException, what: str) -> BaseException:
    """``exc`` as a :class:`KernelError` when the card reported it, else
    ``exc`` itself (the caller re-raises it unchanged). A sticky CUDA error
    surfaces at the next synchronizing call, such as a readback, as
    ``torch.AcceleratorError`` (torch 2.11), or a RuntimeError naming CUDA."""
    if isinstance(exc, KernelError):
        return exc
    card = type(exc).__name__ == "AcceleratorError" or (
        isinstance(exc, RuntimeError)
        and ("CUDA error" in str(exc) or "CUDA driver error" in str(exc))
    )
    return KernelError(f"{what}: {exc}") if card else exc


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = (
    "score_topk", "train_normal_eq", "gather_rows", "segment_normal_eq", "flash_fwd", "flash_bwd",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
# name → (library path, seconds the build took, compiler output)
build_log: dict[str, tuple[Path, float, str]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> list[Path]:
    """``path`` and every header it includes by a quoted name from its own
    directory, transitively, each once, in the order first met."""
    out, todo = [], [path]
    while todo:
        p = todo.pop(0)
        if p in out:
            continue
        out.append(p)
        for inc in _INCLUDE.findall(p.read_bytes()):
            dep = p.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return out


def _target(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    for p in _sources(csrc / f"{name}.cu"):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return build_dir / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, tuple[Path, float, str]]:
    """Build every named kernel not yet built, one nvcc each, in parallel."""
    with _lock:
        todo = [n for n in names if n not in build_log]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        for name in todo:
            target = _target(name)
            if target.exists():
                build_log[name] = (target, 0.0, "cached")
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                target,
            )
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, target)
            build_log[name] = (target, time.perf_counter() - t0, out)
        return {n: build_log[n] for n in names}


def library(name: str) -> Path:
    """Path of the built shared library for ``csrc/<name>.cu``."""
    return build_all((name,))[name][0]
