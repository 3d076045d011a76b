"""The port's tracing module (``oisat_tpu_torch.utils.profiling``) on the
CPU: spans and counters off and on, their ranges in a profiler window, the
stage sums and the stage clock, and a tiny month of each benchmark cell
traced whole (every span inside its parent, the bytes it moved, its waits).
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oisat_tpu_torch.utils import profiling
from oisat_tpu_torch.utils.profiling import StageClock

CELLS = ["omi_no2.scalar_month", "mopitt_co.scalar_month"]
REGRID_PHASES = ("regrid.plan", "regrid.stack", "regrid.h2d", "regrid.apply",
                 "regrid.domain_check")
# the OMI month's CTM stays on its grid; MOPITT's is mapped onto the 1 deg one
ASSEMBLY = {"omi_no2.scalar_month": {"assemble.ctm_fields", "assemble.h2d", "assemble.stack"},
            "mopitt_co.scalar_month": {"assemble.ctm_fields", "assemble.h2d", "assemble.map",
                                       "assemble.stack"}}


@pytest.fixture
def tracing():
    profiling.take()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.take()


def names(spans):
    return [n for n, _, _ in spans]


def test_off_it_records_nothing_and_enters_no_range(monkeypatch):
    profiling.enable(False)
    profiling.take()

    def entered(*args, **kwargs):
        raise AssertionError("a record_function range was entered with tracing off")

    monkeypatch.setattr(profiling._torch_profiler, "record_function", entered)
    assert not profiling.enabled()
    first = profiling.span("regrid")
    assert first is profiling.span("assemble.h2d")  # one shared no-op
    with first:
        profiling.count("syncs")
        profiling.count("h2d.bytes", 4096)
    assert profiling.take() == ([], {})


def test_on_it_records_nested_spans_and_counters(tracing):
    with profiling.span("regrid"):
        with profiling.span("regrid.plan"):
            profiling.count("h2d.bytes", 100)
        profiling.count("h2d.bytes", 28)
        profiling.count("syncs")
    spans, counters = profiling.take()
    assert names(spans) == ["regrid.plan", "regrid"]  # in the order they ended
    (_, ps, pe), (_, rs, re) = spans
    assert rs <= ps <= pe <= re
    assert counters == {"h2d.bytes": 128, "syncs": 1}
    assert profiling.take() == ([], {})


def _profiled(on: bool):
    profiling.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert profiling.enabled()
            with profiling.span("regrid.plan"):
                torch.ones(8).sum()
            profiling.count("syncs")
    finally:
        profiling.enable(False)
    return {e.name for e in prof.events()}, profiling.take()


def test_an_open_profiler_window_records_the_spans_and_leaves_its_trace_alone():
    profiling.take()
    events, (spans, counters) = _profiled(False)
    assert not profiling.enabled()
    assert names(spans) == ["regrid.plan"] and counters == {"syncs": 1}
    assert "regrid.plan" not in events  # no range the trace would read as device time


def test_enabled_spans_are_ranges_of_an_open_profiler_window():
    profiling.take()
    events, (spans, counters) = _profiled(True)
    assert "regrid.plan" in events
    assert names(spans) == ["regrid.plan"] and counters == {"syncs": 1}


def test_a_stage_feeds_the_sums_and_is_a_span(tracing):
    profiling.reset()
    with profiling.stage("read_ctm", sync="cpu"):
        time.sleep(0.002)
    rep = json.loads(profiling.report())
    spans, _ = profiling.take()
    assert rep["read_ctm"]["count"] == 1 and rep["read_ctm"]["total_s"] >= 0.002
    assert names(spans) == ["read_ctm"] and spans[0][2] - spans[0][1] >= 0.002
    profiling.reset()


def test_the_stage_clock_adds_milliseconds_and_records_real_spans(tracing):
    out = {}
    clock = StageClock(out, "cpu", prefix="oi_full.")
    time.sleep(0.002)
    clock.mark("covariance")
    clock.mark("eigh")
    clock.mark("covariance")
    spans, _ = profiling.take()
    assert names(spans) == ["oi_full.covariance", "oi_full.eigh", "oi_full.covariance"]
    assert all(spans[i][2] == spans[i + 1][1] for i in range(2))  # end to end
    assert spans[0][2] - spans[0][1] >= 0.002
    cov = sum(e - s for n, s, e in spans if n == "oi_full.covariance")
    assert out["oi_full.covariance"] == pytest.approx(1e3 * cov)
    assert set(out) == {"oi_full.covariance", "oi_full.eigh"}
    StageClock(None, "cpu").mark("pull")  # untimed: the span alone
    assert names(profiling.take()[0]) == ["pull"]
    profiling.enable(False)
    StageClock(None, "cpu").mark("pull")
    assert profiling.take() == ([], {})


def _tiny_month(name: str, seed: int):
    """(the month's raw granules, a function that regrids and analyses them
    on the CPU) of the benchmark cell ``name`` at its tiny test size."""
    from benchmark import generators, program
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell(name)
    raw, ctm_raw, lon2d, lat2d = generators.make_month(cell.config, seed)
    ctm = program.to_ctm(ctm_raw)
    ctrl = program.control_dict(cell.config, cell.mix, "cpu")
    return raw, lambda: program.run_month(raw, ctm, lon2d, lat2d, cell.config, ctrl, "cpu")


def _traced(run):
    profiling.take()
    profiling.enable(True)
    try:
        run()
    finally:
        profiling.enable(False)
    return profiling.take()


def _inside(spans, child, parent):
    outer = [(s, e) for n, s, e in spans if n == parent]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for n, s, e in spans if n == child)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_month_records_every_span_inside_its_parent(name):
    raw, run = _tiny_month(name, 11)
    spans, _ = _traced(run)
    seen = collections.Counter(names(spans))
    assert seen["regrid"] == len(raw)
    for phase in REGRID_PHASES:
        assert seen[phase] == len(raw), phase
        assert _inside(spans, phase, "regrid"), phase
    assert {n for n in seen if n.startswith("assemble.")} == ASSEMBLY[name]
    for part in ASSEMBLY[name]:
        assert _inside(spans, part, "assemble"), part
    assert seen["assemble"] == seen["step"] == seen["pull"] == seen["oi.scalar"] == 1
    assert _inside(spans, "oi.scalar", "step")
    stages = [(s, e) for n, s, e in spans if n in ("assemble", "step", "pull")]
    assert all(stages[i][1] == stages[i + 1][0] for i in range(2))  # end to end
    assert max(e for n, s, e in spans if n == "regrid") <= stages[0][0]


def _spy_on_copies(monkeypatch):
    """Record the bytes of every host array the process turns into a tensor
    (on the card each of those is a host->device copy)."""
    moved = []
    for fn in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, fn)

        def spy(data, *args, _real=real, **kwargs):
            if isinstance(data, (np.ndarray, np.generic)):
                moved.append(np.asarray(data).nbytes)
            return _real(data, *args, **kwargs)

        monkeypatch.setattr(torch, fn, spy)
    return moved


@pytest.mark.parametrize("name", CELLS)
def test_h2d_bytes_sum_every_array_the_month_moved(name, monkeypatch):
    raw, run = _tiny_month(name, 12)
    run()  # the plans are cached from here on, as in a month of fixed geometry
    moved = _spy_on_copies(monkeypatch)
    _, counters = _traced(run)
    assert moved and counters["h2d.bytes"] == sum(moved)
    # a granule's value batch and error row alone exceed a pixel per granule
    assert counters["h2d.bytes"] > 4 * sum(np.size(g["vcd"]) for g in raw)


@pytest.mark.parametrize("name", CELLS)
def test_syncs_count_every_wait_of_the_month(name, monkeypatch):
    raw, run = _tiny_month(name, 13)
    run()
    moved = _spy_on_copies(monkeypatch)
    _, counters = _traced(run)
    # each copy to the device, each granule's domain check, the curve's pull
    # for the knee and the month's one pull
    assert counters["syncs"] == len(moved) + len(raw) + 2
    assert counters["syncs"] >= len(raw)


@pytest.mark.parametrize("name", CELLS)
def test_every_granule_batch_is_built_on_its_device(name):
    raw, run = _tiny_month(name, 14)
    _, counters = _traced(run)
    assert counters["regrid.batches_device"] == len(raw)


@pytest.mark.parametrize("name", CELLS)
def test_a_granule_copies_its_raw_fields_and_no_host_cast(name, monkeypatch):
    from benchmark import generators, program
    from benchmark.reference import granule_kind
    from benchmark.tests.tiny import tiny_cell
    from oisat_tpu_torch.ops import regrid as ops_regrid
    from oisat_tpu_torch.regridder import regrid_granule

    cell = tiny_cell(name)
    raw, _, lon2d, lat2d = generators.make_month(cell.config, 15)
    g, reg = raw[0], cell.config["regrid"]
    kind = granule_kind(g["kind"])

    def regrid():
        return regrid_granule(reg["interpolator_type"], reg["grid_size"], program.to_granule(g),
                              lon2d, lat2d, "cpu", flag_thresh=reg["flag_thresh"])

    assert regrid() is not None  # the plans are cached from here on
    index_rows = []  # the box filter's index copies (none where it passes through)
    real = ops_regrid.to_device

    def spy(x, *args, **kwargs):
        index_rows.append(np.asarray(x).nbytes)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(ops_regrid, "to_device", spy)
    _, counters = _traced(regrid)
    fields = kind.FIELDS2 + kind.FIELDS3 + ("uncertainty", "quality_flag")
    assert counters["h2d.bytes"] - sum(index_rows) == sum(g[f].nbytes for f in fields)
    assert counters["regrid.batches_device"] == 1
