"""The yardstick's arithmetic on hand-made numbers: the union of device
intervals, idle gaps and their labels, and the readers."""

from __future__ import annotations

import math

import pytest

from benchmark.spec import metric_reader
from benchmark.tracing import DeviceTrace, Span, idle_gaps, label_of, stage_spans, union_seconds


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert union_seconds(iv) == pytest.approx(3.0)
    assert idle_gaps(iv, 0.0, 6.0) == [(2.0, 3.0), (4.0, 6.0)]
    assert idle_gaps(iv, -1.0, 0.5) == [(-1.0, 0.0)]
    assert union_seconds([]) == 0.0


def test_labels_take_the_innermost_span():
    spans = [Span("month", 0.0, 10.0), Span("regrid", 1.0, 2.0)]
    assert label_of(1.5, spans) == "regrid"
    assert label_of(5.0, spans) == "month"
    assert label_of(11.0, spans) == "other"


def test_stage_spans_follow_the_sessions_order():
    sp = stage_spans(10.0, {"assemble": 2000.0, "step": 500.0, "oi_full.slq": 100.0,
                            "pull": 250.0})
    assert [(s.name, s.start, s.end) for s in sp] == [
        ("assemble", 10.0, 12.0), ("step", 12.0, 12.5), ("pull", 12.5, 12.75)]


class Ctx:
    def __init__(self, trace=None, months=(), peak=0):
        self.trace, self.months, self.peak_bytes = trace, months, peak


def test_idle_share_reader():
    tr = DeviceTrace([("ak_curve_f64(...)", 1.0, 1.5), ("Memcpy HtoD", 2.0, 2.25),
                      ("gemv", 2.2, 3.0)], (0.0, 10.0))
    assert metric_reader("device.idle_pct")(Ctx(tr)) == pytest.approx(100 * (1 - 1.5 / 10))
    assert tr.seconds_by_name()["gemv"] == pytest.approx(0.8)


def test_readers_return_nothing_without_their_data():
    empty = DeviceTrace([], (0.0, 1.0))
    assert metric_reader("device.idle_pct")(Ctx(empty)) is None
    assert metric_reader("device.idle_pct")(Ctx(None)) is None
    assert metric_reader("device.peak_gb")(Ctx()) is None
    months = [{"stage_ms": {}, "diag": {}, "regrid_spans": []}]
    for name in ("regrid.ms_per_granule", "driver.assemble_ms", "month_step.ms"):
        assert metric_reader(name)(Ctx(months=months)) is None


def test_stage_readers_average_over_months():
    months = [{"stage_ms": {"assemble": 10.0, "step": 2.0}, "diag": {},
               "regrid_spans": [(0.0, 0.1), (1.0, 1.3)]},
              {"stage_ms": {"assemble": 20.0, "step": 4.0}, "diag": {},
               "regrid_spans": [(2.0, 2.2)]}]
    c = Ctx(months=months, peak=12_500_000_000)
    assert metric_reader("driver.assemble_ms")(c) == 15.0
    assert metric_reader("month_step.ms")(c) == 3.0
    assert metric_reader("regrid.ms_per_granule")(c) == pytest.approx(200.0)
    assert metric_reader("device.peak_gb")(c) == 12.5
    assert not math.isnan(metric_reader("device.peak_gb")(c))
