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
for them together. A source named in :data:`SPLIT` compiles instead as
several units side by side, one ``nvcc -c -DPIO_PART=<p>`` each (the
source says what a unit holds), linked into the one library by a last
``nvcc -shared``: one unit of ``score_topk.cu``'s 30 kernel instantiations
set the whole build's time.

:class:`KernelError` is the one exception type of the kernels' wrappers: a
refusal of their inputs, a build or launch that fails, and (through
:func:`as_kernel_error`) an error the card reports afterwards. The query
server lets it through as a 500 where it serves a degraded answer for other
failures, so a broken card never hides behind a stale answer.

The host libraries under ``csrc/host/`` (``snappy.cpp``, the Parquet
codec's page compression, and ``jsonprops.cpp``, the property scanner of
``native.py``) are host code, not kernels: :func:`build_host` builds each
with ``g++ -O3 -shared -fPIC`` at first use, into the same directory, with
the same hash-named targets and the same atomic rename. A failed or
impossible build raises :class:`KernelError` with the compiler's output.
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
# sources built as units compiled side by side and linked: name → the
# values of the source's PIO_PART macro, one unit each
SPLIT = {"score_topk": tuple(str(p) for p in range(7))}

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


def _target(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
            suffix: str = ".cu") -> Path:
    h = hashlib.sha256()
    for p in _sources(csrc / f"{name}{suffix}"):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return build_dir / f"{name}-{h.hexdigest()[:12]}.so"


def _build_each(names, log, csrc, suffix, compiler, flags, what) -> tuple[dict, float]:
    """Compile each of ``names`` not in ``log`` (``csrc/<name><suffix>``),
    one ``compiler`` process each, all started at once; each output is
    written to a temporary and moved into place atomically, so concurrent
    first-use processes never load a half-written file. Returns the
    processes run (name → ...) and the time they started."""
    todo = [n for n in names if n not in log]
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    for name in todo:
        target = _target(name, csrc, BUILD_DIR, suffix)
        if target.exists():
            log[name] = (target, 0.0, "cached")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        src = str(csrc / f"{name}{suffix}")
        parts = SPLIT.get(name, ()) if csrc == CSRC else ()
        if parts:
            units = [tmp.with_suffix(f".{p}.o") for p in parts]
            unit_flags = [f for f in flags if f != "-shared"]
            runs = [start([compiler(), *unit_flags, "-c", f"-DPIO_PART={p}", "-o", str(o), src])
                    for p, o in zip(parts, units)]
        else:
            units, runs = [], [start([compiler(), *flags, "-o", str(tmp), src])]
        procs[name] = (runs, units, tmp, target)
    for name, (runs, units, tmp, target) in procs.items():
        outs = [run.communicate()[0] for run in runs]
        if units and all(run.returncode == 0 for run in runs):
            link = start([compiler(), *flags, "-o", str(tmp), *map(str, units)])
            outs.append(link.communicate()[0])
            runs.append(link)
        for o in units:
            o.unlink(missing_ok=True)
        out = "".join(outs)
        if any(run.returncode != 0 for run in runs):
            shown = f"{name}{suffix}" if csrc == CSRC else f"{csrc.name}/{name}{suffix}"
            raise KernelError(f"{what} failed for {shown}:\n{out}")
        os.replace(tmp, target)
        log[name] = (target, time.perf_counter() - t0, out)
    return procs, t0


def build_all(names=SOURCES) -> dict[str, tuple[Path, float, str]]:
    """Build every named kernel not yet built, one nvcc each, in parallel."""
    with _lock:
        procs, t0 = _build_each(names, build_log, CSRC, ".cu", _nvcc, NVCC_FLAGS, "nvcc")
        if procs:
            _note_rank_build(procs, t0)
        return {n: build_log[n] for n in names}


def _note_rank_build(procs: dict, t0: float) -> None:
    """Under a launch every rank builds on a cold cache (each into its own
    temporary, moved into place atomically): say how long this rank took."""
    from predictionio_tpu_torch.parallel import distributed

    pid, n = distributed.process_slot()
    if n > 1:
        print(f"[INFO] process {pid}/{n}: built {', '.join(sorted(procs))} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def library(name: str) -> Path:
    """Path of the built shared library for ``csrc/<name>.cu``."""
    return build_all((name,))[name][0]


HOST_CSRC = CSRC / "host"
HOST_SOURCES = ("snappy", "jsonprops")
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC")

_host_lock = threading.Lock()
# name → (library path, seconds the build took, compiler output)
host_build_log: dict[str, tuple[Path, float, str]] = {}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise KernelError("no C++ compiler (g++) found: the host libraries under "
                      "csrc/host/ build with it at first use")


def build_host(names=HOST_SOURCES) -> dict[str, tuple[Path, float, str]]:
    """Build every named host library not yet built, one g++ each, in
    parallel (a lock of its own: the kernels' build can run beside it)."""
    with _host_lock:
        _build_each(names, host_build_log, HOST_CSRC, ".cpp", _cxx, CXX_FLAGS, "g++")
        return {n: host_build_log[n] for n in names}


def host_library(name: str) -> Path:
    """Path of the built shared library for ``csrc/host/<name>.cpp``."""
    return build_host((name,))[name][0]
