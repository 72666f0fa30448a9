"""The control on the card at each cell's own size: on three seeds, sound
runs of the program pass every limit and the reference in TF32, in the
program's place, fails one.  Skips without a card; on the chip:

    python -m pytest perfbench/tests/test_pb_card.py -q
"""
import sys

import pytest

from conftest import BENCH, CELLS

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_full_size(name, card):
    sys.path.insert(0, str(BENCH / "tools"))
    from calibrate import calibrate
    from harness.cell import load_cell
    cell = load_cell(name)
    limits = cell.config["limits"]
    rows = calibrate(cell, SEEDS, set(SEEDS), 4.0, card, log=lambda m: None)
    for row in rows:
        assert row["correct"], row
        assert any(row["control"][k] > limits[k] for k in ("logit_err", "token_gap")), row
