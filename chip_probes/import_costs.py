"""What ``import torch`` costs a fresh interpreter on this machine, and why.

Prints JSON lines: whether the installed packages' bytecode caches exist and
are writable, ``import torch`` timed in fresh interpreters with the default
bytecode cache and with ``PYTHONPYCACHEPREFIX`` under ``build/pycache`` and
``PYTHONDONTWRITEBYTECODE`` unset (the first of those writes the cache, the
next ones read it), and the imports of
largest cumulative time by ``-X importtime``.

From the repo root: ``python3 chip_probes/import_costs.py``.
"""
import json
import os
import subprocess
import sys
import sysconfig
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(env, code="import torch"):
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True)
    return time.perf_counter() - t


def main() -> int:
    import importlib.util

    spec = importlib.util.find_spec("torch")
    torch_dir = os.path.dirname(spec.origin)
    cache = os.path.join(torch_dir, "__pycache__")
    emit({"probe": "bytecode", "python": sys.version.split()[0], "torch_dir": torch_dir,
          "purelib": sysconfig.get_paths()["purelib"],
          "torch_pycache_exists": os.path.isdir(cache),
          "torch_pycache_files": len(os.listdir(cache)) if os.path.isdir(cache) else 0,
          "torch_dir_writable": os.access(torch_dir, os.W_OK),
          "dont_write_bytecode": sys.flags.dont_write_bytecode,
          "PYTHONDONTWRITEBYTECODE": os.environ.get("PYTHONDONTWRITEBYTECODE"),
          "PYTHONPYCACHEPREFIX": os.environ.get("PYTHONPYCACHEPREFIX"),
          "cpus": os.cpu_count()})
    base = dict(os.environ)
    prefix = os.path.join(ROOT, "build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    # the cache under the checkout, written even where the environment asks
    # for no bytecode (PYTHONDONTWRITEBYTECODE)
    cached = {k: v for k, v in base.items() if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = prefix
    emit({"probe": "import_torch_s",
          "default": [timed(base) for _ in range(2)],
          "prefix": [timed(cached) for _ in range(3)],
          "prefix_cuda": timed(cached, "import torch; torch.cuda.is_available() and "
                                       "torch.zeros(1, device='cuda')"),
          "prefix_bytes": sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(prefix) for f in fs)})
    for name, env in (("default", base), ("prefix", cached)):
        err = subprocess.run([sys.executable, "-X", "importtime", "-c", "import torch"], cwd=ROOT,
                             env=env, capture_output=True, text=True).stderr
        rows = []
        for line in err.splitlines():
            parts = line.split("|")
            if len(parts) == 3 and parts[1].strip().isdigit():
                rows.append((int(parts[1]), int(parts[0].split(":")[1]), parts[2].rstrip()))
        rows.sort(reverse=True)
        emit({"probe": "importtime", "mode": name,
              "total_us": max((r[0] for r in rows), default=0),
              "self_us_sum": sum(r[1] for r in rows),
              "top_cumulative": [f"{c} {s} {n}" for c, s, n in rows[:25]],
              "top_self": [f"{s} {n.strip()}" for c, s, n in sorted(rows, key=lambda r: -r[1])[:15]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
