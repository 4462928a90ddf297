"""Many processes in the port: the gloo runtime, the collectives across
processes, and ``pio launch``'s launcher.

* Two gloo processes of 2 CPU placements each (``--device cpu``'s mesh
  under a launch) run the four collectives, ``device_get_global`` and
  ``place``; each result equals the one-process mesh of the same 4
  placements BIT FOR BIT (the cross-process body gathers every block and
  runs the same tensor ops in placement order).
* ``host_sum`` above its slab size (shrunk to 1,000 elements) equals
  ``np.sum`` of the processes' parts bit for bit.
* ``process_slot``, ``shard_output_path`` and ``aggregate_exit_codes``
  equal the JAX package's functions on a table of inputs (negative signal
  codes included).
* A worker killed with SIGKILL fails ``launch_local`` within its grace
  period plus a few seconds, with the worker's code in the output, while
  its sibling waits in a barrier.

The worker processes are fresh interpreters (never a fork of a process that
imported torch) with jax and the JAX package blocked, on ports bound at 0.
"""

import io
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import distributed as jax_dist
from predictionio_tpu.tools import launcher as jax_launcher
from predictionio_tpu_torch.parallel import distributed, mesh
from predictionio_tpu_torch.tools import launcher

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = "import sys\nsys.modules['jax'] = None\nsys.modules['predictionio_tpu'] = None\n"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(pid: int, n: int, port: int, extra=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": str(ROOT), "PIO_COORDINATOR": f"127.0.0.1:{port}",
                "PIO_NUM_PROCESSES": str(n), "PIO_PROCESS_ID": str(pid),
                "OMP_NUM_THREADS": "1"})
    env.update(extra or {})
    return env


def run_workers(code: str, n: int = 2, timeout: float = 120, extra=None) -> list[str]:
    """Run ``code`` as n coordinated processes; every one must exit 0."""
    for _attempt in range(3):  # a port taken between bind and use: retry
        port = free_port()
        procs = [subprocess.Popen([sys.executable, "-c", BLOCKED + code],
                                  env=worker_env(i, n, port, extra), cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(n)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if all(p.returncode == 0 for p in procs):
            return outs
        if not any("address already in use" in o.lower() for o in outs):
            break
    raise AssertionError("\n".join(f"[p{i}] rc={p.returncode}\n{o}"
                                   for i, (p, o) in enumerate(zip(procs, outs))))


COLLECTIVES = """
import numpy as np, torch
from predictionio_tpu_torch.parallel import distributed, mesh
assert distributed.initialize()
pid = distributed.process_index()
ctx = mesh.MeshContext.create(devices=["cpu"] * 2)
assert ctx.spans_processes and ctx.n_devices == 4 and ctx.local_range == (2 * pid, 2 * pid + 2)
rng = np.random.default_rng(0)
blocks = [torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)) for _ in range(4)]
local = blocks[2 * pid:2 * pid + 2]
out = {"ag": mesh.all_gather(local, "cpu", ctx=ctx).numpy()}
for k, b in enumerate(mesh.ppermute(local, ["cpu"] * 2, shift=1, ctx=ctx)):
    out[f"pp{k}"] = b.numpy()
for k, b in enumerate(mesh.all_to_all(local, 0, 1, ctx=ctx)):
    out[f"a2a{k}"] = b.numpy()
for k, b in enumerate(mesh.psum(local, ctx=ctx)):
    out[f"ps{k}"] = b.numpy()
placed = ctx.place(np.arange(48, dtype=np.float32).reshape(8, 6), "data")
out["placed"] = np.stack([b.numpy() for b in placed])
out["dg"] = mesh.device_get_global(placed, ctx)
distributed._HOST_SUM_SLAB_ELEMS = 1000
out["hs"] = distributed.host_sum(np.random.default_rng(100 + pid).standard_normal(2500))
distributed.reset_stats()
mesh.all_gather(local, "cpu", ctx=ctx)
out["staged"] = np.array(distributed.STATS["staged_bytes"])
np.savez(f"{OUT}/p{pid}.npz", **out)
distributed.shutdown()
"""


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    run_workers(f"OUT = {str(d)!r}\n" + COLLECTIVES)
    return [dict(np.load(d / f"p{i}.npz")) for i in range(2)]


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)) for _ in range(4)]


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def test_all_gather_equals_one_process_bit_for_bit(two_processes, blocks):
    want = mesh.all_gather(blocks, "cpu").numpy()
    for out in two_processes:
        same_bits(out["ag"], want)


def test_ppermute_equals_one_process_bit_for_bit(two_processes, blocks):
    want = mesh.ppermute(blocks, ["cpu"] * 4, shift=1)
    for pid, out in enumerate(two_processes):
        for k in range(2):
            same_bits(out[f"pp{k}"], want[2 * pid + k].numpy())


def test_all_to_all_equals_one_process_bit_for_bit(two_processes, blocks):
    want = mesh.all_to_all(blocks, 0, 1)
    for pid, out in enumerate(two_processes):
        for k in range(2):
            same_bits(out[f"a2a{k}"], want[2 * pid + k].numpy())


def test_psum_equals_one_process_bit_for_bit(two_processes, blocks):
    want = mesh.psum(blocks)[0].numpy()
    for out in two_processes:
        for k in range(2):
            same_bits(out[f"ps{k}"], want)


def test_place_and_device_get_global_span_processes(two_processes):
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    one = mesh.MeshContext.create(devices=["cpu"] * 4)
    want = np.stack([b.numpy() for b in one.place(x, "data")])
    for pid, out in enumerate(two_processes):
        same_bits(out["placed"], want[2 * pid:2 * pid + 2])
        same_bits(out["dg"], x)


def test_host_sum_above_the_slab_equals_np_sum(two_processes):
    parts = [np.random.default_rng(100 + p).standard_normal(2500) for p in range(2)]
    want = np.sum(np.stack(parts), axis=0)
    for out in two_processes:
        same_bits(out["hs"], want)


def test_collectives_count_the_bytes_they_stage(two_processes):
    # 2 local blocks of 4 × 6 float32 gathered from 2 processes (host blocks
    # are gathered, not staged back: CPU placements)
    for out in two_processes:
        assert int(out["staged"]) == 2 * (2 * 4 * 6 * 4)


def test_one_process_helpers_are_the_identity():
    assert distributed.process_slot() == jax_dist.process_slot() == (0, 1)
    assert not distributed.is_initialized() and distributed.should_write_storage()
    x = np.arange(5.0)
    assert distributed.host_sum(x) is not None and np.array_equal(distributed.host_sum(x), x)
    ctx = mesh.MeshContext.create(devices=["cpu"] * 2)
    assert not ctx.spans_processes and ctx.local_range == (0, 2)


@pytest.mark.parametrize("slot", [(0, 1), (0, 3), (2, 3), (1, 2)])
def test_shard_output_path_equals_jax(tmp_path, monkeypatch, slot):
    results = []
    for mod, sub in ((distributed, "port"), (jax_dist, "jax")):
        d = tmp_path / sub
        d.mkdir()
        base = d / "out.json"
        for name in ("out.json", "out.json.part-0", "out.json.part-2", "out.json.part-5",
                     "out.json.part-x", "other.part-1"):
            (d / name).write_text("stale")
        monkeypatch.setattr(mod, "process_slot", lambda: slot)
        pid, n, path = mod.shard_output_path(str(base))
        results.append((pid, n, os.path.relpath(path, d), sorted(os.listdir(d))))
    assert results[0] == results[1]


@pytest.mark.parametrize("rcs", [[0, 0], [0, -9], [-9, 0], [3, 0, -11], [-11, 2], [0, 0, 1], [137]])
def test_aggregate_exit_codes_equal_jax(rcs):
    got, want = io.StringIO(), io.StringIO()
    assert launcher.aggregate_exit_codes(rcs, got) == jax_launcher.aggregate_exit_codes(rcs, want)
    assert got.getvalue() == want.getvalue()


def test_worker_env_equals_jax():
    base = {"A": "1", "PIO_RUN_ID": "old"}
    for run in (None, "r1"):
        assert launcher.worker_env(base, "h:1", 3, 2, run) == jax_launcher.worker_env(
            base, "h:1", 3, 2, run)


def test_render_host_commands_name_the_port_cli():
    lines = launcher.render_host_commands(["train", "--device", "cpu"], ["h0", "h1"], 9000)
    assert len(lines) == 3
    run_ids = {line.split("PIO_RUN_ID=")[1].split()[0] for line in lines[1:]}
    assert len(run_ids) == 1
    for i, line in enumerate(lines[1:]):
        assert f"PIO_COORDINATOR=h0:9000 PIO_NUM_PROCESSES=2 PIO_PROCESS_ID={i}" in line
        assert line.endswith("python -m predictionio_tpu_torch.tools.cli train --device cpu")


DYING = BLOCKED + """
import os, signal
from predictionio_tpu_torch.parallel import distributed
distributed.initialize()
print("joined", distributed.process_index(), flush=True)
if distributed.process_index() == 1:
    os.kill(os.getpid(), signal.SIGKILL)
distributed.barrier()
distributed.barrier()
"""


def test_a_killed_worker_fails_the_launch_without_hanging(tmp_path, monkeypatch):
    (tmp_path / "dying_worker.py").write_text(DYING)
    monkeypatch.setattr(launcher, "WORKER_MODULE", "dying_worker")
    env = worker_env(0, 2, 0, {"PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"})
    out = io.StringIO()
    t0 = time.monotonic()
    rc = launcher.launch_local([], 2, free_port(), env=env, out=out)
    elapsed = time.monotonic() - t0
    text = out.getvalue()
    assert rc == 1, text  # SIGKILL's -9 cannot ride a shell exit code
    assert "ERROR: process 1 exited with code -9" in text
    assert "[p0] joined 0" in text and "[p1] joined 1" in text
    # startup (two interpreters importing torch) + the grace + terminate
    assert elapsed < 60.0, elapsed


def test_pio_launch_needs_a_command():
    from predictionio_tpu_torch.tools import cli

    assert cli.main(["launch", "-n", "2"]) == 1
