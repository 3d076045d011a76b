"""The readers of the program's own spans and counters, on hand-made
numbers: each of the six per-layer metrics, their silence where the program
recorded nothing, and the breakdown naming an idle gap by the program's
innermost span."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import program_trace
from benchmark.harness import _breakdown
from benchmark.spec import metric_reader
from benchmark.tracing import DeviceTrace, Span

NEW = ("regrid.plan_ms_per_granule", "regrid.h2d_ms_per_granule", "driver.ctm_fields_ms",
       "driver.h2d_ms", "device.h2d_gb_per_month", "device.syncs_per_month")


class Ctx:
    def __init__(self, months=(), program=None):
        self.trace, self.months, self.peak_bytes = None, list(months), 0
        if program is not None:
            self.program = program


def _months(n):
    return [{"stage_ms": {}, "diag": {}, "regrid_spans": []} for _ in range(n)]


SPANS = [("regrid.plan", 0.0, 0.1), ("regrid.h2d", 0.1, 0.12), ("regrid", 0.0, 0.2),
         ("regrid.plan", 1.0, 1.3), ("regrid.h2d", 1.3, 1.34), ("regrid", 1.0, 1.5),
         ("regrid", 2.0, 2.1),  # a granule whose plan came from the cache in no time
         ("assemble.ctm_fields", 3.0, 3.5), ("assemble.h2d", 3.5, 3.75),
         ("assemble.h2d", 3.8, 3.85), ("assemble", 3.0, 4.0)]


def test_the_six_readers_on_a_hand_made_window():
    c = Ctx(_months(2), {"spans": SPANS, "counters": {"h2d.bytes": 7_000_000_000,
                                                      "syncs": 130}})
    read = {name: metric_reader(name)(c) for name in NEW}
    assert read["regrid.plan_ms_per_granule"] == pytest.approx(1e3 * 0.4 / 3)
    assert read["regrid.h2d_ms_per_granule"] == pytest.approx(1e3 * 0.06 / 3)
    assert read["driver.ctm_fields_ms"] == pytest.approx(250.0)
    assert read["driver.h2d_ms"] == pytest.approx(150.0)
    assert read["device.h2d_gb_per_month"] == pytest.approx(3.5)
    assert read["device.syncs_per_month"] == 65


def test_the_readers_are_silent_without_the_programs_records(monkeypatch):
    assert all(metric_reader(name)(Ctx(_months(2), {"spans": [], "counters": {}})) is None
               for name in NEW)
    no_months = Ctx([], {"spans": SPANS, "counters": {}})
    assert all(metric_reader(name)(no_months) is None for name in NEW[2:])
    # a program without the registry (older than its spans), and none loaded
    monkeypatch.setitem(sys.modules, program_trace.PROFILING, types.ModuleType("profiling"))
    assert all(metric_reader(name)(Ctx(_months(1))) is None for name in NEW)
    monkeypatch.delitem(sys.modules, program_trace.PROFILING)
    assert all(metric_reader(name)(Ctx(_months(1))) is None for name in NEW)


def test_the_window_is_taken_from_the_registry_once(monkeypatch):
    calls = []
    fake = types.ModuleType("profiling")

    def take():
        calls.append(1)
        return list(SPANS), {"syncs": 4}

    fake.take = take
    monkeypatch.setitem(sys.modules, program_trace.PROFILING, fake)
    c = Ctx(_months(2))
    assert metric_reader("device.syncs_per_month")(c) == 2
    assert metric_reader("driver.h2d_ms")(c) == pytest.approx(150.0)
    assert len(calls) == 1 and c.program["counters"] == {"syncs": 4}


def test_a_gap_inside_the_plan_phase_is_named_for_it():
    trace = DeviceTrace([("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0),
                         ("gather", 3.0, 4.0)], (0.0, 4.0))
    host = [Span("regrid", 0.5, 4.0)] + [Span(n, s, e) for n, s, e in
                                         [("regrid", 0.6, 3.9), ("regrid.plan", 1.5, 2.8)]]
    gaps = dict(_breakdown(trace, host)["idle_gaps"])
    assert gaps == {"regrid.plan": pytest.approx(2.0)}  # the gap (1, 3) at its midpoint
    gaps = dict(_breakdown(trace, host[:2])["idle_gaps"])
    assert gaps == {"regrid": pytest.approx(2.0)}  # outside every child: the parent's name
