"""The benchmark's pieces on the card (marked ``gpu``; they skip without
one, decided inside the fixture): a tiny month of each cell through the
program and the check."""

from __future__ import annotations

import pytest
import torch

from benchmark import check as C
from benchmark.tests.test_harness_rehearsal import CELLS
from benchmark.tests.tiny import tiny_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_tiny_month_is_correct_on_the_card(card, name):
    from benchmark import generators as G
    from benchmark import program

    cell = tiny_cell(name)
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, 31)
    ctrl = program.control_dict(cell.config, cell.mix, card)
    m = program.run_month(raw, program.to_ctm(ctm), lon2d, lat2d, cell.config, ctrl, card)
    checks = C.check(cell, 31, raw, ctm, m, card)
    assert all(v <= lim for v, lim in checks.values()), checks
