"""The check itself: a run with the timed path broken underneath comes out
not correct, once for each fault each cell can have. The runs skip the
look for a card and run at tiny sizes on the CPU."""

import pytest
from conftest import ROOT, TINY, tiny_limits

from portbench import harness

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _run(workload, seed=21):
    overrides, mix = TINY[workload]
    return harness.run_cell(workload, seed, 0.2, False, device="cpu", overrides=overrides,
                            mix_overrides=mix, limits=tiny_limits(workload))


@pytest.mark.parametrize("workload", list(TINY))
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", list(TINY))
def test_planted_fault_is_not_correct(workload, fault):
    files = harness.CellFiles(workload)
    family = harness.adapter(ROOT, files.config["family"])
    with family.faults(files.mix["mode"])[fault]():
        result = _run(workload)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0
