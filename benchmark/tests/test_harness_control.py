"""The comparison fails what it has to fail, at a tiny size on the CPU.

* The control: the reference put in the program's place, every stage one
  step below the precision the configuration states (float64 -> float32,
  float32 -> bfloat16), is not correct.
* A run with the timed path broken underneath is not correct: half of the
  month's granules left out (the mean taken over the rest); an answer
  altered where it is produced (one granule's regridded columns, 1% off);
  the OI step returning its state unchanged (the posterior is the prior).
  One chip runs each cell: there is no exchange between chips to leave out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check as C
from benchmark import generators as G
from benchmark import program
from benchmark import reference as R
from benchmark.tests.test_harness_rehearsal import month
from benchmark.tests.tiny import tiny_cell

CELLS = ("omi_no2.scalar_month", "mopitt_co.scalar_month")


class Judged:
    """A month's fields and granules as the check reads a program's."""

    def __init__(self, fields, grans):
        self._f, self.grans = fields, grans
        self.session = type("S", (), {"reader_obj": None})()

    def fields(self):
        return self._f


def correct(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, 21)
    kept = {}
    cf, _ = R.month_reference(raw, ctm, lon2d, lat2d, cell.config, cell.mix,
                                  R.Precision.control(cell.config["precision"]),
                                  torch.device("cpu"), on_regrid=lambda i, r: kept.__setitem__(
                                      i, type("G", (), r)))
    checks = C.check(cell, 21, raw, ctm, Judged(cf, [kept[i] for i in range(len(raw))]), "cpu")
    assert not correct(checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_half_the_granules_left_out(name, monkeypatch):
    cell = tiny_cell(name)
    inner = program.regrid_granule
    calls = {"n": 0}

    def lossy(*a, **k):
        calls["n"] += 1
        out = inner(*a, **k)
        if calls["n"] % 2 == 0:  # every second granule missing from the month
            out.vcd = torch.full_like(out.vcd, float("nan"))
        return out

    monkeypatch.setattr(program, "regrid_granule", lossy)
    raw, ctm, m = month(cell, 22)
    assert not correct(C.check(cell, 22, raw, ctm, m, "cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    cell = tiny_cell(name)
    inner = program.regrid_granule
    calls = {"n": 0}

    def altered(*a, **k):
        calls["n"] += 1
        out = inner(*a, **k)
        if calls["n"] == 2:
            out.vcd = out.vcd * 1.01
        return out

    monkeypatch.setattr(program, "regrid_granule", altered)
    raw, ctm, m = month(cell, 23)
    assert not correct(C.check(cell, 23, raw, ctm, m, "cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_the_oi_returning_its_state_unchanged(name):
    cell = tiny_cell(name)
    raw, ctm, m = month(cell, 24)
    s = m.session
    s.ctm_averaged_vcd_corrected = np.array(s.ctm_averaged_vcd, copy=True)
    s.increment_OI = np.zeros_like(s.ctm_averaged_vcd)
    s.ak_OI = np.zeros_like(s.ctm_averaged_vcd)
    s.error_OI = np.abs(s.ctm_averaged_vcd) * cell.config["control"]["ctm_error"] / 100.0
    assert not correct(C.check(cell, 24, raw, ctm, m, "cpu"))
