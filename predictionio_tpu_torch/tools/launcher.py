"""``pio launch``: N coordinated processes of one ``pio`` command.

Counterpart of ``predictionio_tpu/tools/launcher.py`` (the reference's
``Runner.runOnSpark`` role). There is no cluster manager in the middle:
every process runs the same program under the launch contract of
``parallel/distributed.py``:

    PIO_COORDINATOR=host0:port PIO_NUM_PROCESSES=N PIO_PROCESS_ID=i pio <verb>

* **local mode** (the default) spawns all N workers here, each a fresh
  interpreter (``python -m predictionio_tpu_torch.tools.cli``; never a
  fork of a process that may hold a CUDA context);
* **--hosts h0,h1,...** prints each host's command line (host 0 is the
  coordinator) for the operator's own remote tooling.

The launcher prints each worker's pid (``[INFO] process <i>: pid <pid>``),
and every line of a worker's output is prefixed ``[p<i>] ``. The launch exits
0 only if every worker did; a worker killed by a signal reports a negative
code and fails it. When one worker fails, the others get
:data:`FAIL_GRACE_S` seconds to notice on their own (their next collective
fails) and are then terminated, so a dead worker never leaves the launch
hanging.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
import uuid
from typing import Optional, Sequence

WORKER_PREFIX = "[p{index}] "
WORKER_MODULE = "predictionio_tpu_torch.tools.cli"
# seconds the surviving workers get after a sibling failed, before the
# launch terminates them
FAIL_GRACE_S = 5.0


def worker_env(
    base_env: dict,
    coordinator: str,
    num_processes: int,
    process_id: int,
    run_id: Optional[str] = None,
) -> dict:
    env = dict(base_env)
    env.update(
        {
            "PIO_COORDINATOR": coordinator,
            "PIO_NUM_PROCESSES": str(num_processes),
            "PIO_PROCESS_ID": str(process_id),
        }
    )
    if run_id is not None:
        # one id for every worker of this launch: scopes the rendezvous
        env["PIO_RUN_ID"] = run_id
    return env


def _pump(proc: subprocess.Popen, index: int, out) -> None:
    prefix = WORKER_PREFIX.format(index=index)
    for line in proc.stdout:
        out.write(prefix + line)
        out.flush()


def _wait_all(procs: list, grace_s: float) -> list[int]:
    """Wait for every worker; once one fails, give the rest ``grace_s``
    seconds, then terminate (and after 5 more, kill) those still running."""
    deadline = None
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            return rcs
        if deadline is None and any(rc not in (None, 0) for rc in rcs):
            deadline = time.monotonic() + grace_s
        if deadline is not None and time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            t_kill = time.monotonic() + 5.0
            while any(p.poll() is None for p in procs) and time.monotonic() < t_kill:
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        time.sleep(0.05)


def launch_local(
    pio_args: Sequence[str],
    num_processes: int,
    coordinator_port: int,
    env: Optional[dict] = None,
    out=None,
) -> int:
    """Run ``pio <pio_args>`` as N coordinated local processes; 0 iff every
    worker exited 0 (:func:`aggregate_exit_codes`)."""
    out = out or sys.stdout
    base = dict(env if env is not None else os.environ)
    coordinator = f"127.0.0.1:{coordinator_port}"
    run = uuid.uuid4().hex[:12]
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    try:
        for i in range(num_processes):
            p = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE, *pio_args],
                env=worker_env(base, coordinator, num_processes, i, run_id=run),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            procs.append(p)
            out.write(f"[INFO] process {i}: pid {p.pid}\n")
            out.flush()
            t = threading.Thread(target=_pump, args=(p, i, out), daemon=True)
            t.start()
            pumps.append(t)
        rcs = _wait_all(procs, FAIL_GRACE_S)
    finally:
        for p in procs:  # never leave a worker behind
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in pumps:
        t.join(timeout=5)
    return aggregate_exit_codes(rcs, out)


def aggregate_exit_codes(rcs: Sequence[int], out=None) -> int:
    """The launch's exit code from the workers': 0 only when EVERY worker
    exited 0 (``max()`` would hide a signal-killed worker's negative code
    behind a sibling's 0). The first failure's code is returned, a negative
    one as 1 (a shell cannot carry it)."""
    out = out or sys.stdout
    failed = [(i, rc) for i, rc in enumerate(rcs) if rc != 0]
    if not failed:
        return 0
    for i, rc in failed:
        out.write(f"ERROR: process {i} exited with code {rc}\n")
    out.flush()
    first = failed[0][1]
    return first if first > 0 else 1


def render_host_commands(
    pio_args: Sequence[str],
    hosts: Sequence[str],
    coordinator_port: int,
) -> list[str]:
    """Each host's command line; hosts[0] is the coordinator."""
    coordinator = f"{hosts[0]}:{coordinator_port}"
    quoted = " ".join(shlex.quote(a) for a in pio_args)
    run = uuid.uuid4().hex[:12]
    lines = [
        "# PIO_RUN_ID scopes the run's cross-host rendezvous state; it must "
        "be IDENTICAL on every host\n"
        "# and FRESH per launch attempt — re-render (or substitute a new "
        "shared id) before re-running."
    ]
    for i, host in enumerate(hosts):
        lines.append(
            f"# on {host}:\n"
            f"PIO_COORDINATOR={coordinator} "
            f"PIO_NUM_PROCESSES={len(hosts)} "
            f"PIO_PROCESS_ID={i} "
            f"PIO_RUN_ID={run} python -m {WORKER_MODULE} {quoted}"
        )
    return lines
