#!/usr/bin/env python3
"""Run one cell several times, one process a run, and report the spread of
each metric: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median, the
measure the bounds in ``BENCHMARK.json`` are set from.

    python3 portbench/sets.py --workload <name> --seeds 11,12,13 --seconds 15 \\
        [--trace 0|1] [--out results.jsonl]

Each run's result line (or its failure) is appended to ``--out`` as one JSON
object with the seed, the exit code and the end of standard error.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_once(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                           cwd=HERE.parent)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [ln for ln in out.splitlines() if ln.strip()]
    result = None
    if rc == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr_tail": err[-3000:]}


def spread(values: list) -> float:
    """Inter-quartile distance over the median."""
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out")
    args = p.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_once(args.workload, seed, args.seconds, args.trace, args.timeout)
        runs.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        res = r["result"] or {}
        print(json.dumps({"seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 2),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}}),
              flush=True)
        if r["rc"] != 0 or not res:
            print(r["stderr_tail"][-1500:], file=sys.stderr, flush=True)
        for line in r["stderr_tail"].splitlines():
            if line.startswith(("units ", "detail ", "kernel ")):
                print("  " + line, flush=True)
    values: dict = {}
    for r in runs:
        for k, v in ((r["result"] or {}).get("metrics") or {}).items():
            values.setdefault(k, []).append(v["value"])
    summary = {k: {"n": len(v), "median": statistics.median(v), "spread": spread(v)}
               for k, v in values.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0 if all(r["rc"] == 0 and (r["result"] or {}).get("correct") for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
