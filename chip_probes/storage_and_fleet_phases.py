"""``chip_smoke.py``'s storage phases and its ``fleet`` phase alone, on the card.

``columnar``: ``quickstart-cli`` (which keeps its store), ``remote-storage``
(which keeps its export) and ``columnar-store``, as ``chip_smoke.py`` runs
them, with the host helpers of ``columnar-store`` started right before that
phase, after ``remote-storage`` (``chip_smoke.py`` starts them before it). ``fleet``: ``phase_fleet`` on a random
model of the ML-25M serving width (162,541 × 59,047, rank 10, seed 0).
Both build the kernels and the host libraries first. A failed check
raises, as in ``chip_smoke.py``.

From the repo root, on the card: ``python3 chip_probes/storage_and_fleet_phases.py
[columnar] [fleet]`` (both when neither is named). Prints ``chip_smoke.py``'s
JSON lines and one line a probe step.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from predictionio_tpu_torch.models.als import als_model_from_arrays
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.testing import warm_cpu_math

    os.chdir(ROOT)
    warm_cpu_math()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    t1 = time.perf_counter()
    _build.build_host()
    cs.emit({"probe": "build", "kernels_s": t1 - t0, "host_s": time.perf_counter() - t1})
    only = argv or ["columnar", "fleet"]
    if "columnar" in only:
        kept = {}
        t = time.perf_counter()
        cs.phase_quickstart_cli(0, dev, keep=kept)
        q = time.perf_counter() - t
        kept["keep_tmp"] = True
        t = time.perf_counter()
        cs.phase_remote_storage(dev, kept)
        r = time.perf_counter() - t
        t = time.perf_counter()
        cs.phase_columnar_store(0, dev, kept, smi, cs.start_columnar_helpers(0))
        cs.emit({"probe": "times", "quickstart_s": q, "remote_s": r,
                 "columnar_s": time.perf_counter() - t})
    if "fleet" in only:
        rng = np.random.default_rng(0)
        U = (rng.standard_normal((cs.N_USERS, cs.RANK)) / np.sqrt(cs.RANK)).astype(np.float32)
        V = (rng.standard_normal((cs.N_ITEMS, cs.RANK)) / np.sqrt(cs.RANK)).astype(np.float32)
        model = als_model_from_arrays(U, V, [f"u{i}" for i in range(cs.N_USERS)],
                                      [f"i{j}" for j in range(cs.N_ITEMS)])
        t = time.perf_counter()
        cs.phase_fleet(model, 0, dev)
        cs.emit({"probe": "fleet_s", "seconds": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
