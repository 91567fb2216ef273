"""A run with the timed path broken underneath reads ``correct`` false, for
each fault a cell can have; and the control (the reference in the
precision below the configuration's) fails the limits at a size a test
holds. The look for a card is skipped: the port's CPU route runs."""

import pytest
import torch

from portbench import control, harness

ENGINE = ["ds1_jc69.bgrad_b2048", "ds1_100_gtr_w4.phylo_b256",
          "ds1_100_gtr_w4.bgrad_b256"]
SMALL = {"batch": 12, "check_calls": 2}
VBPI = "ds1_jc69.vbpi_p10"
SMALL_VBPI = {"window_steps": 4}


def _run(cell, fault, overrides):
    torch.set_num_threads(2)
    res, lines = harness.run_cell(cell, 2**32 + 7, 0.2, False, 0.0,
                                  device="cpu", overrides=overrides,
                                  fault=fault)
    return res


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
@pytest.mark.parametrize("cell", ENGINE)
def test_engine_fault_reads_incorrect(cell, fault):
    assert not _run(cell, fault, SMALL)["correct"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch",
                                   "unchanged_state"])
def test_vbpi_fault_reads_incorrect(fault):
    assert not _run(VBPI, fault, SMALL_VBPI)["correct"]


@pytest.mark.parametrize("cell", ENGINE + [VBPI])
def test_control_fails_a_limit(cell):
    torch.set_num_threads(2)
    small = SMALL_VBPI if cell == VBPI else SMALL
    rows, summary = control.readings(cell, [5], [5], 0.2, device="cpu",
                                     overrides=small)
    limits = harness.Cell(cell).limits
    ctrl = rows[0]["control"]
    assert any(ctrl[k] > limits[k] for k in limits), ctrl
    assert all(rows[0]["program"][k] <= limits[k] for k in limits)
