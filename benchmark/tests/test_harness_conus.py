"""The CONUS full-OI cell, ``omi_no2.full_oi_conus``: its granule kind keeps
a month on the program's dense branch, the cell loads from its files, and
months of the kind run through the program and the check on the CPU."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from benchmark import check as C
from benchmark import generators as G
from benchmark import program
from benchmark import reference as R
from benchmark.reference import granule_kind
from benchmark.spec import load_cell

CELL = "omi_no2.full_oi_conus"
METRICS = {"oi_dense.ms", "oi_dense.eigh_ms", "oi_dense.fp64_roofline_pct",
           "correlation_f64_roofline"}


def test_the_footprint_stays_on_the_dense_branch_at_every_offset(monkeypatch):
    """At the configuration's full size, the month's valid CTM cells (a
    value and an uncertainty from some orbit, through the reference's
    regrid of the vcd alone) number between the window's 57 x 99 = 5,643
    and the dense scan's limit, with no offset, at each corner of the mix's
    offsets and at the seed's own draws."""
    from oisat_tpu_torch.ops.oi_full import DENSE_SCAN_MAX_CELLS

    cell = load_cell(CELL)
    cfg = cell.config
    kind = granule_kind(cfg["granules"]["kind"])
    monkeypatch.setattr(kind, "FIELDS2", ("vcd",))
    monkeypatch.setattr(kind, "FIELDS3", ())
    seed = 2300
    grans = kind.make(G.seed_sequence(seed).spawn(cfg["granules_per_month"]), cfg["granules"],
                      tuple(cfg["month"]))
    lon2d, lat2d = G.merra2_gmi_grid(cfg["ctm"].get("dlat", 0.5), cfg["ctm"].get("dlon", 0.625))
    south, north, west, east = cfg["granules"]["window"]
    window = int(((lat2d >= south) & (lat2d <= north) & (lon2d >= west) & (lon2d <= east)).sum())
    assert window == 5_643
    lo, la = cell.mix["lon_offset_deg"], cell.mix["lat_offset_deg"]
    offsets = [(0.0, 0.0), *((sx * lo, sy * la) for sx in (-1, 1) for sy in (-1, 1)),
               *G.month_offsets(cell.mix, seed, 2)]
    for off in offsets:
        valid = np.zeros(lon2d.shape, bool)
        for g in grans:
            r = R.regrid(G.offset_granule(g, off), lon2d, lat2d, cfg["regrid"], "cpu")
            valid |= np.isfinite(r["vcd"].numpy()) & np.isfinite(r["uncertainty"].numpy())
        assert window <= int(valid.sum()) <= DENSE_SCAN_MAX_CELLS, (off, int(valid.sum()))


def test_the_cell_loads_from_its_files():
    cell = load_cell(CELL)
    assert cell.config["name"] == cell.workload["config"] == "omi_no2_gmi_conus_full_oi"
    assert cell.workload["chips"] == 1
    ctrl = program.control_dict(cell.config, cell.mix, "cpu")
    assert ctrl["oi_method"] == "full" and float(ctrl["length_scale_km"]) == 300.0
    assert {m["name"] for m in cell.end_to_end} == {"month_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert set(cell.limits) == {"regrid", "average", "oi"}
    # the kind is omi_orbit's but for its window
    kind, omi = granule_kind("omi_orbit_conus"), granule_kind("omi_orbit")
    assert kind.operator is omi.operator and kind.container_fields is omi.container_fields
    assert (kind.CONTAINER, kind.FIELDS2, kind.FIELDS3) == (omi.CONTAINER, omi.FIELDS2,
                                                             omi.FIELDS3)


def _small(cell, grans, ny, nx, dlat, dlon, grid_size):
    cfg = copy.deepcopy(cell.config)
    cfg["granules_per_month"] = grans
    cfg["granules"].update(ny=ny, nx=nx, nz=6)
    cfg["ctm"].update(levels=10, dlat=dlat, dlon=dlon)
    cfg["regrid"].update(grid_size=grid_size)
    cell.config = cfg
    return cell


def _month(cell, seed):
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, seed)
    raw = [G.offset_granule(g, G.month_offsets(cell.mix, seed, 2)[1]) for g in raw]
    ctrl = program.control_dict(cell.config, cell.mix, "cpu")
    m = program.run_month(raw, program.to_ctm(ctm), lon2d, lat2d, cell.config, ctrl, "cpu",
                          spans=[], stage_ms={})
    return m, C.check(cell, seed, raw, ctm, m, "cpu")


@pytest.mark.parametrize("seed", [12, 2**31 + 77])
def test_tiny_month_is_correct_on_the_cpu(seed):
    """~300 valid cells of the window (2 x 2.5 deg CTM cells) through the
    harness on the CPU: the program's dense branch (the float64 scan and the
    float64 tail) against the float64 reference."""
    cell = _small(load_cell(CELL), 6, 57, 24, 2.0, 2.5, 0.5)
    m, checks = _month(cell, seed)
    assert m.diagnostics()["solver"] == "dense+direct_f64_dev"
    assert 200 < m.diagnostics()["n"] <= 350
    for key, (value, limit) in checks.items():
        assert value <= limit, (key, value, limit)


def test_the_card_route_passes_where_the_float32_scan_fails():
    """~1,150 valid cells (1 x 1.25 deg), sigma_b/sigma_o ~ 100: the float64
    scan picks the float64 reference's r = 1.1 and passes every number.
    The float32 scan's knee on this month is rounding noise (1.0 or 1.1 with
    the number of CPU threads; at 1.0 ``oi`` reads 0.74), the fault the cell
    holds the program to."""
    cell = _small(load_cell(CELL), 6, 113, 24, 1.0, 1.25, 0.25)
    m, checks = _month(cell, 12)
    assert m.diagnostics()["reg"] == pytest.approx(1.1)
    for key, (value, limit) in checks.items():
        assert value <= limit, (key, value, limit)
