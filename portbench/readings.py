#!/usr/bin/env python3
"""Readings that set a cell's limits, at the cell's own size on the card:
the control (the reference in TF32 in the program's place) and the planted
faults (a short run of the program with its timed path broken underneath).

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control] [--fault half_batch ...] [--seconds 2]

Prints one JSON line a reading: the workload, seed, what was read and the
numbers the check compares."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    from portbench import harness

    files = harness.CellFiles(args.workload)
    family = harness.adapter(ROOT, files.config["family"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control:
            details: dict = {}
            numbers = family.control(files.config, files.mix, seed, args.device, details)
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": "control",
                              "numbers": numbers, "details": details}, default=str), flush=True)
        for fault in args.fault:
            with family.faults(files.mix["mode"])[fault]():
                result = harness.run_cell(args.workload, seed, args.seconds, False,
                                          device=args.device)
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": fault,
                              "numbers": {k: v["value"] for k, v in result["checks"].items()},
                              "correct": result["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
