"""Sizes of each cell for running the benchmark's code on the CPU.

``TINY`` runs the plumbing in a second or so. At those sizes a training
cell's float32 numbers swing more than at the cell's own size (one
gradient element's rounding moves a 16-position model's loss), so the
fault tests hold training cells to ``TINY_LIMITS``, set between the tiny
sizes' sound readings and their faults' readings. ``SMALL`` is large enough
that the control (TF32) falls outside the cells' own limits, as it does at
the cells' sizes on the card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_ALS = {"n_users": 300, "n_items": 120, "n_ratings": 6000}
TINY_SASREC = {"n_users": 60, "n_items": 40, "n_events": 2400, "min_events": 20}
TINY = {
    "als-ml25m-iterate": (TINY_ALS, {}),
    "als-ml25m-bulk": (TINY_ALS, {"check_chunks": 4, "trace_units": 5}),
    "sasrec-ml1m-t256": (TINY_SASREC, {"max_len": 16, "batch": 8, "trace_units": 3}),
    "sasrec-ml1m-t200": (TINY_SASREC, {"max_len": 12, "batch": 8, "trace_units": 3}),
}
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
SMALL_SASREC = ({"n_users": 300, "n_items": 1000, "n_events": 30000, "min_events": 20},
                {"max_len": 64, "batch": 32})
SMALL = {
    "als-ml25m-iterate": ({"n_users": 8000, "n_items": 2000, "n_ratings": 160000}, {}),
    "als-ml25m-bulk": TINY["als-ml25m-bulk"],
    "sasrec-ml1m-t256": SMALL_SASREC,
    "sasrec-ml1m-t200": SMALL_SASREC,
}


def tiny_limits(workload: str) -> dict:
    return TINY_LIMITS if workload.startswith("sasrec") else {}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip machine")
    return torch.device("cuda", 0)
