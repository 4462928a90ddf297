"""What the operator tools cost a process on the card, measured two ways.

``capture``: does a ``torch.profiler`` capture leave the process slower?
One child process a variant, since the profiler's state is process-global.
A long-lived worker thread, like the serving batcher's, times loops of small
launches and readbacks before a capture on the main thread, after it and
after a second one; it keeps launching while each capture is open. The
variants: ``none`` (a 0.5 s sleep in place of each capture: the host's own
drift), ``port`` (``utils.profiling.profiled``, the port's capture: CPU and
CUDA activity on every thread), ``default`` (CPU and CUDA activity, the
profiler's own thread setting) and ``cpu`` (CPU activity only). Each
capture's start, window, stop and export are timed. Traces go to a
temporary directory that is removed.

``timer``: the training loop's iteration timer (``models/als.py``
``_IterationTimer``). ``train_als`` at MovieLens-25M's shape, as
``chip_smoke.py``'s ``train`` phase draws it, trains once; then its loop
(``_run_shards``) runs again on the same layout, with the timer and with a
no-op timer in its place, five times in the order off, on, on, off, each
run timed between two synchronizes. The timer's own host time an iteration
is timed apart, on an idle stream.

From the repo root, on the card: ``python3 chip_probes/operator_tools_costs.py
[capture|timer]`` (both when neither is named). Prints one JSON line a
measurement and writes
``chiprun_out/operator_tools_costs.json``.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("none", "port", "default", "cpu")
LOOP_N = 3000
REPEATS = 5


def capture_child(variant: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    a = torch.randn(64, 64, device=dev)
    asks, results = [], []
    go, done, stop = threading.Event(), threading.Event(), threading.Event()

    def worker():
        while True:
            go.wait()
            go.clear()
            if not asks:
                return
            if asks.pop() == "loop":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LOOP_N):
                    (a @ a).sum().item()
                results.append((time.perf_counter() - t0) / LOOP_N * 1e6)
            else:
                while not stop.is_set():
                    (a @ a).sum().item()
            done.set()

    def ask(kind):
        done.clear()
        asks.append(kind)
        go.set()
        if kind == "loop":
            done.wait()

    def loops(n=5):
        out = []
        for _ in range(n):
            ask("loop")
            out.append(results.pop())
        return out

    tmp = tempfile.mkdtemp(prefix="pio-capture-")

    def capture(i):
        path = os.path.join(tmp, f"{variant}-{i}.json")
        stop.clear()
        ask("spin")
        t0 = time.perf_counter()
        row = {}
        if variant == "none":
            time.sleep(0.5)
        elif variant == "port":
            with profiling.profiled(path):
                row["start_s"] = time.perf_counter() - t0
                time.sleep(0.5)
        else:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if variant == "default" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            t1 = time.perf_counter()
            time.sleep(0.5)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            prof.__exit__(None, None, None)
            t3 = time.perf_counter()
            prof.export_chrome_trace(path)
            row.update(start_s=t1 - t0, window_s=t2 - t1, stop_s=t3 - t2,
                       export_s=time.perf_counter() - t3)
        row["capture_s"] = time.perf_counter() - t0
        stop.set()
        done.wait()
        if os.path.exists(path):
            events = json.load(open(path))["traceEvents"]
            row.update(events=len(events),
                       kernel_events=sum(e.get("cat") == "kernel" for e in events),
                       worker_mm_events=sum(e.get("name") == "aten::mm" for e in events),
                       trace_bytes=os.path.getsize(path))
        return row

    threading.Thread(target=worker, daemon=True).start()
    try:
        loops(1)
        out = {"variant": variant, "before_us": loops()}
        out["capture1"] = capture(1)
        out["after1_us"] = loops()
        out["capture2"] = capture(2)
        out["after2_us"] = loops()
    finally:
        asks.clear()
        go.set()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


class _NoTimer:
    def __init__(self, device):
        pass

    def start(self):
        return None

    def stop(self, it, start):
        pass

    def completed(self, wait=False):
        return []


def timer_cost() -> dict:
    import torch

    import chip_smoke as cs
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    inter = cs.zipf_interactions(0, cs.N_USERS, cs.N_ITEMS, cs.N_RATINGS)
    out = {"draw_s": time.perf_counter() - t0, "ratings": cs.N_RATINGS,
           "iterations": cs.TRAIN_ITERS}
    cfg = als.ALSConfig(rank=cs.RANK, iterations=cs.TRAIN_ITERS, seed=0)
    ctx = DeviceContext.create(device=dev)
    real_timer, real_run = als._IterationTimer, als._run_shards
    loop_args = []

    def timed_run(*args, **kw):
        loop_args.extend((args, kw))
        return real_run(*args, **kw)

    als._run_shards = timed_run
    try:
        t = time.perf_counter()
        als.train_als(ctx, inter, cfg)  # warm-up: the kernels' build and load
        out["train_als_s"] = time.perf_counter() - t
    finally:
        als._run_shards = real_run
    # the same loop again from the warm-up's layout, timer off and on in turn
    runs = []
    try:
        for on in (False, True, True, False) * REPEATS:
            als._IterationTimer = real_timer if on else _NoTimer
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_run(*loop_args[0], **loop_args[1])
            torch.cuda.synchronize()
            runs.append({"timer": on, "s_per_iteration": (time.perf_counter() - t) / cfg.iterations})
    finally:
        als._IterationTimer = real_timer
    out["runs"] = runs
    # the timer's own host time an iteration: start, stop and a poll
    timer = real_timer(dev)
    n = 10_000
    torch.cuda.synchronize()
    t = time.perf_counter()
    for it in range(n):
        timer.stop(it, timer.start())
        timer.completed()
    out["timer_host_us_per_iteration"] = (time.perf_counter() - t) / n * 1e6
    timer.completed(wait=True)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--capture-child":
        print(json.dumps(capture_child(sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    parts = sys.argv[1:] or ["capture", "timer"]
    res = {"card": card, "capture": []}
    # each variant twice, the second pass in reverse order
    for variant in VARIANTS + VARIANTS[::-1] if "capture" in parts else ():
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--capture-child", variant],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        res["capture"].append(row)
    if "timer" in parts:
        res["timer"] = timer_cost()
        print(json.dumps(res["timer"]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "operator_tools_costs" + ("" if len(parts) == 2 else "_" + parts[0])
    with open(os.path.join(ROOT, "chiprun_out", name + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
