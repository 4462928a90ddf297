"""Where a served process's start goes on the card, and each kernel's build time.

Prints one JSON line a measurement:

- ``build``: each CUDA source's ``nvcc`` time, all started at once as
  ``ops/_build.py`` starts them (the outputs land in the build cache);
- ``python``: ``import torch`` twice, then ``import torch`` with a CUDA
  context and one allocation, each a fresh interpreter;
- ``deploy``: ``pio deploy --batching`` of a quickstart-shaped model
  (rank 10, seeded events) from spawn to the first 200 on ``/readyz``,
  once plain and once under ``cProfile``, with the profiled run's
  functions of largest cumulative time.

From the repo root, on the card: ``python3 chip_probes/startup_costs.py``
(``--cpu``: the deploy measurement alone, on the host).
"""
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed_build():
    from predictionio_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, done = {}, {}
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        target = _build._target(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL),
                       tmp, target)
    while len(done) < len(procs):
        for name, (p, tmp, target) in procs.items():
            if name not in done and p.poll() is not None:
                done[name] = time.perf_counter() - t0
                if p.returncode == 0:
                    os.replace(tmp, target)
        time.sleep(0.05)
    emit({"probe": "build", "seconds_by_source": done, "wall_s": time.perf_counter() - t0,
          "cpus": os.cpu_count()})


def python_costs():
    rows = {}
    for name, code in (("import_torch_1", "import torch"), ("import_torch_2", "import torch"),
                       ("torch_cuda", "import torch; torch.zeros(1, device='cuda'); "
                                      "torch.cuda.synchronize()"),
                       ("cli_import", "import predictionio_tpu_torch.tools.cli")):
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                       env=dict(os.environ, PYTHONPATH=ROOT))
        rows[name] = time.perf_counter() - t
    emit({"probe": "python", **rows})


def wait_ready(port, proc, t0):
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"deploy exited {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.02)


def deploy_costs(device="cuda"):
    import numpy as np

    import chip_smoke as cs
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.registry import Storage

    tmp = tempfile.mkdtemp(prefix="pio-startup-")
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    key = cs.cli_run("app", "new", "StartApp")
    storage = Storage.instance()
    app_id = storage.get_meta_data_apps().get_by_name("StartApp").id
    rng = np.random.default_rng(0)
    n = 100_000
    users, items, stars = rng.integers(0, 6040, n), rng.integers(0, 3416, n), rng.integers(1, 6, n)
    le = storage.get_l_events()
    for c in range(0, n, 10_000):
        le.insert_batch([Event(event="rate", entity_type="user", entity_id=f"u{users[k]}",
                               target_entity_type="item", target_entity_id=f"i{items[k]}",
                               properties={"rating": int(stars[k])}, event_time=1.7e9 + k)
                         for k in range(c, min(c + 10_000, n))], app_id)
    eng = os.path.join(tmp, "rec")
    cs.cli_run("template", "get", "recommendation", "--directory", eng)
    cs.fill_engine_json(os.path.join(eng, "engine.json"), "StartApp", [
        {"name": "als", "params": {"rank": 10, "numIterations": 20}}])
    t = time.perf_counter()
    cs.cli_run("train", "--engine-dir", eng, "--device", device)
    emit({"probe": "train", "seconds": time.perf_counter() - t, "key_line": key.strip()[-60:]})
    env = dict(os.environ, PYTHONPATH=ROOT)
    for mode in ("plain", "profiled"):
        port = cs.free_port()
        prof = os.path.join(tmp, "deploy.prof")
        pre = [sys.executable] + (["-m", "cProfile", "-o", prof] if mode == "profiled" else [])
        argv = pre + ["-m", "predictionio_tpu_torch.tools.cli", "deploy", "--engine-dir", eng,
                      "--batching", "--device", device, "--ip", "127.0.0.1", "--port", str(port)]
        log = open(os.path.join(tmp, f"deploy-{mode}.log"), "w")
        t0 = time.perf_counter()
        p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=log)
        ready = wait_ready(port, p, t0)
        cs.cli_run("undeploy", "--port", str(port))
        p.wait(timeout=60)
        row = {"probe": "deploy", "mode": mode, "spawn_to_ready_s": ready}
        if mode == "profiled" and os.path.exists(prof):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(45)
            row["top"] = buf.getvalue().splitlines()[-52:]
        emit(row)


def main() -> int:
    import torch

    if sys.argv[1:] == ["--cpu"]:  # the deploy measurement alone, on the host (a dry run)
        deploy_costs("cpu")
        return 0
    if not torch.cuda.is_available():
        print("startup_costs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"probe": "card", "nvidia_smi": smi})
    timed_build()
    python_costs()
    deploy_costs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
