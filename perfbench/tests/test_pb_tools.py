"""The tool that sets the limits of ``correct`` runs end to end at a small
size on the CPU: sound runs, the control, the kernel witness."""
import sys

import pytest

from conftest import BENCH, CELLS, small_cell

sys.path.insert(0, str(BENCH / "tools"))


@pytest.mark.parametrize("name", CELLS)
def test_calibrate_reads_program_control_and_witness(name):
    from calibrate import calibrate
    rows = calibrate(small_cell(name), [11], {11}, 1.0, "cpu",
                     log=lambda m: None, witness_seeds={11})
    (row,) = rows
    assert row["correct"] and set(row["control"]) == {"logit_err", "token_gap"}
    assert row["control"]["logit_err"] > row["program"]["logit_err"]
    assert set(row["witness"]) == {"kernel", "plain"}
