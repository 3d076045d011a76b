"""A CPU rehearsal of a run at a tiny size: the month through the program,
the check against the reference, and the refusals.  It never writes a
device metric: on the CPU the measurement path stops with an error."""

from __future__ import annotations

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import check as C
from benchmark import generators as G
from benchmark import harness, program, run
from benchmark.tests.tiny import tiny_cell

CELLS = ("omi_no2.scalar_month", "mopitt_co.scalar_month")


def month(cell, seed):
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, seed)
    offs = G.month_offsets(cell.mix, seed, 2)
    if not cell.config["granules"]["moving_geometry"]:
        offs[:] = 0.0
    raw = [G.offset_granule(g, offs[1]) for g in raw]
    ctrl = program.control_dict(cell.config, cell.mix, "cpu")
    m = program.run_month(raw, program.to_ctm(ctm), lon2d, lat2d, cell.config, ctrl, "cpu",
                          spans=[], stage_ms={})
    return raw, ctm, m


@pytest.mark.parametrize("name", CELLS)
def test_tiny_month_is_correct_on_the_cpu(name):
    cell = tiny_cell(name)
    raw, ctm, m = month(cell, 12)
    checks = C.check(cell, 12, raw, ctm, m, "cpu")
    assert set(checks) == set(cell.limits)
    for key, (value, limit) in checks.items():
        assert value <= limit, (key, value, limit)


@pytest.mark.parametrize("name", CELLS)
def test_measurement_refuses_the_cpu(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.measure(tiny_cell(name), 5, 1.0, False, device="cpu", check=C.check)


def test_run_exits_without_a_result_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


def test_run_exits_without_a_result_when_jax_is_loaded(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "measure", lambda *a, **k: {"checks": {}, "correct": True})
    monkeypatch.setitem(sys.modules, "jax", sys)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELLS[1], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


def test_run_needs_the_cells_chips(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                         "--trace", "1"]) != 0
    assert out.getvalue() == ""


def test_process_age_counts_from_the_start():
    assert 0.0 < harness.process_age_s() < 1e6
    assert np.isfinite(harness.process_age_s())
