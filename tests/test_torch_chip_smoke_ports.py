"""``chip_smoke.py``'s ``free_port`` across processes: its lanes of phases
run in processes of their own, each starting servers on ports it takes
from ``free_port``, and no two servers of a run may be handed one port.
With ``CHIP_SMOKE_PORTS`` naming a file, every process takes its ports
from that file under an exclusive lock. Runs on the CPU (no card: only
ports are handed out)."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_TAKE = """\
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(" ".join(str(cs.free_port()) for _ in range(int(sys.argv[2]))))
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_processes_sharing_the_registry_never_share_a_port(tmp_path):
    registry = tmp_path / "ports"
    registry.touch()
    env = dict(os.environ, CHIP_SMOKE_PORTS=str(registry))
    n_procs, each = 2 * (os.cpu_count() or 4), 40
    procs = [subprocess.Popen([sys.executable, "-c", _TAKE, str(ROOT / "chip_smoke.py"), str(each)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(n_procs)]
    taken = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        taken += [int(x) for x in out.split()]
    assert len(taken) == n_procs * each
    assert len(set(taken)) == len(taken)  # no port handed out twice
    assert sorted(int(x) for x in registry.read_text().split()) == sorted(taken)


def test_without_the_registry_one_process_never_repeats_a_port(monkeypatch):
    monkeypatch.delenv("CHIP_SMOKE_PORTS", raising=False)
    cs = _chip_smoke()
    taken = [cs.free_port() for _ in range(200)]
    assert len(set(taken)) == len(taken)
