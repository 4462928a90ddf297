#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA card(s) the cell names; without them it exits with code 2
and prints no result."""

import time

T_START = time.perf_counter()  # set-up counts from here: the imports are part of it

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # bytecode and kernel caches at fixed paths inside the checkout, so only
    # a checkout's first run writes them
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = str(ROOT)
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
