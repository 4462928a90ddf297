"""The control: the reference in TF32, the precision just below the
configuration's float32, put in the program's place, falls outside the
cell's own limits. On the CPU at small sizes; on a card at the cells' own
sizes, on three seeds (``python -m pytest -m cuda portbench/tests`` on the
chip machine)."""

import pytest
from conftest import ROOT, SMALL

from portbench import harness


def _control(workload, seed, device, small):
    files = harness.CellFiles(workload)
    overrides, mix = SMALL[workload] if small else ({}, {})
    family = harness.adapter(ROOT, files.config["family"])
    numbers = family.control({**files.config, **overrides}, {**files.mix, **mix}, seed, device)
    return numbers, files.limits


@pytest.mark.parametrize("workload", list(SMALL))
def test_control_fails_a_limit_on_the_cpu(workload):
    numbers, limits = _control(workload, 5, "cpu", small=True)
    assert any(not v <= limits[k] for k, v in numbers.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2_147_483_711, 7])
@pytest.mark.parametrize("workload", list(SMALL))
def test_control_fails_a_limit_at_cell_size(card, workload, seed):
    numbers, limits = _control(workload, seed, card, small=False)
    assert any(not v <= limits[k] for k, v in numbers.items()), numbers
