"""The benchmark's general part: it finds a cell's files by the names in
``BENCHMARK.json``, times set-up and the measured window, traces a stretch
of the window, reads the metrics through their readers, has the adapter
check the window's output against the reference, and prints the result.

What belongs to one configuration, mix, limit set or metric is a file of
its own, found by name:

* ``BENCHMARK.json`` ``configs[].file``: the configuration (its ``family``
  names the adapter, ``adapters/<family>.py``);
* ``mixes/<traffic>.json``: the traffic mix (its ``mode`` is what the
  adapter runs);
* ``limits/<workload>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: a reader ``read(run)`` that returns the metric's
  value, or None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")


class CellFiles:
    """One cell's entries and files, resolved from ``BENCHMARK.json`` under
    ``root``."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        here = bench_dir(self.root)
        self.mix = json.loads((here / "mixes" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{workload}.json").read_text())

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        name = self.cell["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]


def bench_dir(root: Path) -> Path:
    """The benchmark's folder under a checkout's root."""
    return Path(root) / HERE.name


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds drawn from a run's seed."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(n, np.uint64)
    return [int(x) >> 1 for x in state]


def load_file(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adapter(root: Path, family: str):
    return load_file(bench_dir(root) / "adapters" / f"{family}.py", f"portbench_adapter_{family}")


def reader(root: Path, metric: str):
    return load_file(bench_dir(root) / "metrics" / f"{metric}.py",
                     "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def bracket_attr(owner, attr: str, wrap):
    """Replace ``owner.<attr>`` by ``wrap(original)`` inside the block."""
    original = getattr(owner, attr)
    setattr(owner, attr, wrap(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def profiler_range(label: str):
    """A wrapper factory for :func:`bracket_attr`: the call inside a
    profiler range ``portbench.<label>``, so a reader can take the device
    work launched under it."""
    def wrap(fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{label}"):
                return fn(*args, **kwargs)
        return call
    return wrap


class Profile:
    """A stretch of the window traced by ``torch.profiler``: device
    activity, host ranges and which host ranges launched which kernel."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

    def __init__(self, trace: dict, units: int):
        events = trace.get("traceEvents", [])
        self.units = units
        window = [e for e in events if e.get("name") == "portbench.window" and e.get("ph") == "X"]
        t0 = float(window[0]["ts"]) if window else min(float(e["ts"]) for e in events if "ts" in e)
        t1 = t0 + float(window[0]["dur"]) if window else max(
            float(e["ts"]) + float(e.get("dur", 0)) for e in events if "ts" in e)
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e6
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""),
             e.get("args", {}).get("correlation"))
            for e in events if e.get("ph") == "X" and e.get("cat") in self.DEVICE_CATS)
        self.kernels = [d for d in self.device if d[3] is not None]
        self.busy = _union(self.device, t0, t1)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""),
                e.get("tid")) for e in events
               if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation",
                                                          "python_function")]
        runtime = [(float(e["ts"]), e.get("args", {}).get("correlation"), e.get("tid"),
                    float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
                   for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
        self.ops, self.runtime = ops, runtime
        self.stack_of = _launch_stacks(ops, runtime)

    def device_s_under(self, op_name: str) -> float:
        """Seconds of device work launched from inside a host range whose
        name contains ``op_name``."""
        total = 0.0
        for a, b, _, corr in self.kernels:
            if any(op_name in name for name in self.stack_of.get(corr, ())):
                total += b - a
        return total / 1e6

    def kernel_events(self, names) -> list:
        """(start µs, end µs) of the device kernels whose name contains one
        of ``names``, in time order."""
        return [(a, b) for a, b, name, _ in self.kernels if any(n in name for n in names)]

    def idle_between(self, names) -> list:
        """Device idle µs between each two consecutive kernels whose name
        contains one of ``names``: the time from one's end to the next's
        start in which no device operation ran."""
        ev = self.kernel_events(names)
        out = []
        for (_, end), (start, _) in zip(ev, ev[1:]):
            if start <= end:
                out.append(0.0)
                continue
            busy = sum(min(b, start) - max(a, end) for a, b in self.busy if a < start and b > end)
            out.append(start - end - busy)
        return out

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for a, b, name, _ in self.device:
            by[_short(name)] = by.get(_short(name), 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in the
        window: each moment of a gap goes to the innermost host range open
        then, on any thread (the latest started of those open)."""
        gaps, prev = [], self.t0
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        ranges = self.ops + [(r[0], r[3], r[4], r[2]) for r in self.runtime]
        by: dict = {}
        segments = _timeline(ranges)
        j = 0
        for a, b in gaps:
            while j < len(segments) and segments[j][1] <= a:
                j += 1
            k, covered = j, 0.0
            while k < len(segments) and segments[k][0] < b:
                lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
                if hi > lo:
                    by[segments[k][2]] = by.get(segments[k][2], 0.0) + (hi - lo) / 1e6
                    covered += hi - lo
                k += 1
            if b - a > covered:
                by["host, no range open"] = (by.get("host, no range open", 0.0)
                                             + (b - a - covered) / 1e6)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def _short(name: str) -> str:
    """A kernel's name without its namespaces, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name


def _timeline(ranges) -> list:
    """(start, end, name) segments in which the latest started of the open
    ``ranges`` (start, end, name, thread) stays the same."""
    points = sorted({t for r in ranges for t in (r[0], r[1])})
    order = sorted(ranges, key=lambda r: r[0])
    heap, out, i = [], [], 0
    for t0, t1 in zip(points, points[1:]):
        while i < len(order) and order[i][0] <= t0:
            heapq.heappush(heap, (-order[i][0], order[i][1], order[i][2]))
            i += 1
        while heap and heap[0][1] <= t0:
            heapq.heappop(heap)
        if heap:
            name = heap[0][2]
            if out and out[-1][2] == name and out[-1][1] == t0:
                out[-1][1] = t1
            else:
                out.append([t0, t1, name])
    return out


def _union(intervals, t0: float, t1: float) -> list:
    out = []
    for a, b, *_ in intervals:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _launch_stacks(ops, runtime) -> dict:
    """correlation id → names of the host ranges open on the launching
    thread when the kernel was launched."""
    out = {}
    by_tid: dict = {}
    for o in ops:
        by_tid.setdefault(o[3], []).append(o)
    for tid, rows in by_tid.items():
        rows.sort(key=lambda o: (o[0], -o[1]))
        launches = sorted((r for r in runtime if r[2] == tid and r[1] is not None),
                          key=lambda r: r[0])
        stack, i = [], 0
        for ts, corr, *_ in launches:
            while i < len(rows) and rows[i][0] <= ts:
                while stack and stack[-1][1] <= rows[i][0]:
                    stack.pop()
                stack.append(rows[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = tuple(s[2] for s in stack if s[0] <= ts <= s[1])
    return out


class Run:
    """What a run hands to the metric readers."""

    def __init__(self, **kw):
        self.setup_s: float = 0.0
        self.window_s: float = 0.0
        self.counts: dict = {}
        self.shapes: dict = {}
        self.setup_spans: dict = {}
        self.profile: Optional[Profile] = None
        # the traced stretch's counts and kernel launches, the rest of the
        # window's counts and seconds
        self.trace_counts: dict = {}
        self.trace_launches: dict = {}
        self.kernels: dict = {}
        self.rest_counts: dict = {}
        self.rest_s: float = 0.0
        self.unit_s: list = []
        self.__dict__.update(kw)

    def kernel_seconds(self, label: str) -> tuple:
        """(device seconds, counts of the traced stretch) of the kernel
        ``label`` from its events in the profiler's trace, or (None, None)
        where those do not number its launches (the profiler drops device
        events at times), which it says on standard error."""
        names, primary = self.kernels.get(label, ((), ()))
        launches = self.trace_launches.get(label)
        if self.profile is None or not launches:
            return None, None
        found = len(self.profile.kernel_events(primary))
        if found != launches:
            print(f"portbench: kernel {label}: {found} profiler events for {launches} "
                  "launches; its metrics are left out", file=sys.stderr)
            return None, None
        ev = self.profile.kernel_events(names)
        return sum(b - a for a, b in ev) / 1e6, self.trace_counts

    def idle_percent(self) -> Optional[float]:
        """The device's idle share in the untraced rest of the window, in
        %, extrapolated from the traced stretch: 1 - its busy time (the union
        of device activity) a unit there, times the rest's units, over the
        rest's seconds. Device time is not stretched by the profiler's host
        overhead; the host's is, so the stretch's own union would overstate
        the idle share. Not clamped: a reading under 0 says the assumption of
        equal busy time a unit failed."""
        p, n = self.profile, self.trace_counts.get("units")
        rest = self.rest_counts.get("units", 0)
        if p is None or not n or not rest or self.rest_s <= 0 or p.busy_s <= 0:
            return None
        return 100.0 * (1.0 - p.busy_s / n * rest / self.rest_s)


def _profiler_activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _read_profile(prof, units: int) -> Profile:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Profile(json.load(f), units)
    finally:
        os.unlink(path)


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if isinstance(v, (int, float))}


def measure(cell, seconds: float, trace: bool, trace_units: int, device) -> dict:
    """The measured window: units of work until ``seconds`` have passed,
    then a drain of the queue. With ``trace`` the first ``trace_units``
    units run under the profiler and the adapter's probes (profiler ranges
    around the program's functions, where it has any), and the rest of
    the window runs as an untraced one does."""
    cell.begin_window()
    probes = getattr(cell, "probes", contextlib.nullcontext)
    out = {"trace_counts": {}, "trace_launches": {}}
    units, durations, prof = 0, [], None
    with contextlib.ExitStack() as stretch:
        t0 = t_mark = time.perf_counter()
        if trace:
            launches0 = cell.launch_counts()
            stretch.enter_context(probes())
            prof = stretch.enter_context(
                torch.profiler.profile(activities=_profiler_activities(device)))
            stretch.enter_context(torch.profiler.record_function("portbench.window"))
        counts_mark = dict(cell.counts(), units=0)
        while True:
            t_unit = time.perf_counter()
            with (torch.profiler.record_function("portbench.unit") if trace
                  else contextlib.nullcontext()):
                cell.unit()
            units += 1
            durations.append(time.perf_counter() - t_unit)
            if trace and units == trace_units:
                sync(device)
                stretch.close()  # the window's range, the profiler, the probes
                trace = False
                t_mark, counts_mark = time.perf_counter(), dict(cell.counts(), units=units)
                out["trace_counts"] = counts_mark
                out["trace_launches"] = _diff(cell.launch_counts(), launches0)
            if not trace and time.perf_counter() - t0 >= seconds:
                break
    sync(device)
    t_end = time.perf_counter()
    traced = out["trace_counts"].get("units")
    out.update(window_s=t_end - t0, units=units, rest_s=t_end - t_mark,
               rest_counts=_diff(dict(cell.counts(), units=units), counts_mark),
               unit_s=durations,
               profile=_read_profile(prof, traced) if traced else None)
    return out


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    text = out.stdout.strip()
    return text.splitlines()[0] if out.returncode == 0 and text else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device="cuda", overrides: Optional[dict] = None, mix_overrides: Optional[dict] = None,
             limits: Optional[dict] = None, t_start: Optional[float] = None):
    """One run of one cell: the result object, the last line's content.
    Set-up is timed from ``t_start`` (the process's start in a benchmark
    run), else from this call. ``overrides``, ``mix_overrides`` and
    ``limits`` replace entries of the cell's files, for runs at tiny sizes
    in the tests."""
    files = CellFiles(workload, root)
    files.limits = {**files.limits, **(limits or {})}
    config = {**files.config, **(overrides or {})}
    mix = {**files.mix, **(mix_overrides or {})}
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = adapter(files.root, config["family"])
    t_setup = time.perf_counter() if t_start is None else t_start
    cell = family.Cell(config, mix, seed, device)
    cell.setup()
    sync(device)
    if trace:  # the profiler's first start in a process costs seconds
        with torch.profiler.profile(activities=_profiler_activities(device)):
            torch.zeros(1, device=device).add_(1)
            sync(device)
    setup_s = time.perf_counter() - t_setup
    window = measure(cell, seconds, trace, int(mix.get("trace_units", 1)), device)
    dev = device_info(device, files.cell.get("chips", 1))
    units = window.pop("units")
    profile = window["profile"]
    run = Run(setup_s=setup_s, counts=dict(cell.counts(), units=units), shapes=cell.shapes(),
              setup_spans=dict(cell.setup_spans), kernels=cell.kernels(), **window)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in files.metrics(kind):
        value = reader(files.root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
    attempted = int(cell.counts().get("attempted", units))
    cell.release()
    numbers = cell.check(files.limits)
    checks = {name: {"value": float(value), "limit": float(files.limits[name])}
              for name, value in numbers.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": int(cell.failed),
              "metrics": metrics, "device": dev}
    if trace and profile is not None:
        result["breakdown"] = {"device_ops": profile.device_ops(), "idle_gaps": profile.idle_gaps()}
    units = np.array(window["unit_s"])
    result["_notes"] = [
        "units %d, seconds a unit: median %.6g, p10 %.6g, p90 %.6g, max %.6g" % (
            len(units), *np.percentile(units, [50, 10, 90]), units.max()),
        *(f"detail {k} {v}" for k, v in getattr(cell, "details", {}).items()),
        *(f"kernel {label}: {len(profile.kernel_events(primary))} profiler events, "
          f"{run.trace_launches.get(label)} launches"
          for label, (_, primary) in run.kernels.items() if profile is not None)]
    result["checks"] = checks
    return result


def main(args, t_start: float) -> int:
    files = CellFiles(args.workload)
    chips = int(files.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    limit = power_limit()
    if limit is not None:
        result["device"]["power_limit"] = limit
    for line in result.pop("_notes"):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
