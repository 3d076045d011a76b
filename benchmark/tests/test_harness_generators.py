"""The copied generators: the same seed gives the same month, every seed the
same sizes, and the per-month offset moves every orbit's geometry."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import generators as G
from benchmark.reference import granule_kind
from benchmark.tests.tiny import tiny_cell


def _same(a, b):
    for x, y in zip(a, b):
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


def test_same_seed_same_month():
    cell = tiny_cell("omi_no2.scalar_month")
    a = G.make_month(cell.config, 2**31 + 5)
    b = G.make_month(cell.config, 2**31 + 5)
    _same(a[0], b[0])
    for k in ("gas_profile", "pressure_mid", "delta_p"):
        np.testing.assert_array_equal(a[1][k], b[1][k])


def test_other_seed_other_values_same_sizes():
    cell = tiny_cell("mopitt_co.scalar_month")
    a, _, _, _ = G.make_month(cell.config, 1)
    b, _, _, _ = G.make_month(cell.config, -7)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["vcd"].shape == y["vcd"].shape
        assert not np.array_equal(np.nan_to_num(x["vcd"]), np.nan_to_num(y["vcd"]))


def test_month_offsets_move_every_orbit():
    cell = tiny_cell("omi_no2.scalar_month")
    raw, _, _, _ = G.make_month(cell.config, 3)
    offs = G.month_offsets(cell.mix, 3, 5)
    assert offs.shape == (5, 2) and len({tuple(o) for o in offs}) == 5
    assert np.all(np.abs(offs[:, 0]) <= cell.mix["lon_offset_deg"])
    for k in (1, 2):
        moved = [G.offset_granule(g, offs[k]) for g in raw]
        for g, m in zip(raw, moved):
            assert not np.array_equal(g["longitude_center"], m["longitude_center"])
            assert not np.array_equal(g["latitude_center"], m["latitude_center"])
            assert m["vcd"] is g["vcd"]  # only the geometry is copied
    np.testing.assert_array_equal(G.month_offsets(cell.mix, 3, 5), offs)


def test_fixed_geometry_has_no_offset():
    g = granule_kind("mopitt_day").day_granule(np.random.SeedSequence(0), pitch=10.0)
    assert G.offset_granule(g, (0.0, 0.0)) is g


@pytest.mark.parametrize("name, shape", [("omi_no2.scalar_month", (8, 10)),
                                         ("mopitt_co.scalar_month", (10,))])
def test_the_ctm_is_shaped_as_its_reader_gives_it(name, shape):
    """A 3-hourly averaged CTM carries a time axis of 8 snapshots; a monthly
    file (ECCOH) one snapshot and no time axis, at the start of the month."""
    cell = tiny_cell(name)
    _, ctm, lon2d, _ = G.make_month(cell.config, 9)
    c = cell.config["ctm"]
    for k in ("gas_profile", "pressure_mid", "delta_p"):
        assert ctm[k].shape == shape + lon2d.shape and ctm[k].dtype == np.float32
    assert ctm["ctmtype"] == c["type"] and ctm["averaged"] == c["averaged"]
    assert len(ctm["time"]) == c["snapshots"]
    assert ctm["time"][0].day == c["day"] and ctm["time"][0].month == cell.config["month"][1]


def test_layer_thickness_is_the_gradient_of_the_pressures():
    """The CTM's thickness is |d pmid / d level| as np.gradient takes it."""
    cell = tiny_cell("omi_no2.scalar_month")
    _, ctm, _, _ = G.make_month(cell.config, 4)
    want = np.abs(np.gradient(ctm["pressure_mid"].astype(np.float64), axis=1))
    np.testing.assert_allclose(ctm["delta_p"], want, rtol=2e-6)
    assert np.all(np.diff(ctm["pressure_mid"], axis=1) < 0)
