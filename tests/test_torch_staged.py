"""The port's staged driver path (oisat_tpu_torch.obs_operators,
.ops.averaging.averaging, .driver.oisatgmi) and its fused months for the
MOPITT, GOSAT and SSMIS granule kinds against the JAX package on the same
numpy inputs, on the CPU.

Both sides run at full precision: the JAX package under ``OISAT_PARITY=1``
(no float16 narrowing, no carrier compression, every level through the
upscaler), the port by construction.  Granule and CTM leaves are float64, so
both compute in float64 (tests/conftest.py turns x64 on).

Tolerances.  Per-granule operator outputs and averaged fields: rtol 1e-9 plus
that much of the field's largest finite magnitude (the level sums and the
granule means run in another order; MOPITT's log-difference sums cancel).
SSMIS: 2e-6, its water partial columns are float32 on both sides; weighted
fused months: 2e-6, the step's weights are float32 on both sides.
The OI fields after them: the same.  The knee factor and ``n`` exact.  The
port's fused month against its own staged path: rtol 1e-9 in float64, and
the JAX tests' own rtol 2e-4 / atol 2e-5 of the largest magnitude in float32
(tests/test_fused_month.py).  NaN patterns identical everywhere.
"""

import copy
import datetime
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oisat_tpu import datamodel as jdm
from oisat_tpu.driver import oisatgmi as jax_oisatgmi
from oisat_tpu.ops.averaging import averaging as jax_averaging
from oisat_tpu.regridder import regrid_granule as jax_regrid_granule
from oisat_tpu_torch import _device, convert
from oisat_tpu_torch.driver import oisatgmi as port_oisatgmi
from oisat_tpu_torch.ops.averaging import averaging as port_averaging
from tests.test_pipeline import ctm_grid, synthetic_ctm, synthetic_granule

torch.set_num_threads(1)

RTOL = 1e-9
# the water partial columns are stacked in float32 on both sides (after any
# upscaling), so the SSMIS model field and all that follows is float32-exact
KIND_RTOL = {"mopitt": RTOL, "gosat": RTOL, "ssmis": 2e-6}
FIELDS = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
          "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")
MONTH = ("2019-07-01", "2019-08-01")
SENSORS = {"mopitt": ("MOPITT", "CO"), "gosat": ("GOSAT", "CH4"), "ssmis": ("SSMIS", "H2O")}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, name="", rtol=RTOL, atol_scale=None):
    """Same shape and NaN / inf pattern; finite values within ``rtol`` plus
    ``atol_scale`` (default ``rtol``) of the largest finite magnitude."""
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    assert np.array_equal(np.isinf(got), np.isinf(want)), name
    fin = np.isfinite(want)
    if fin.any():
        atol = (rtol if atol_scale is None else atol_scale) * np.abs(want[fin]).max()
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=name)


# ---- synthetic months (host numpy, the JAX package's containers) ------------

def _sat_grid(H=12, W=14):
    return np.meshgrid(np.linspace(-20.0, 19.0, W), np.linspace(21.0, 54.0, H))


def _eccoh_day(day, H, W, nz, seed, lon2d=None, lat2d=None, month=7, dt=np.float64):
    """One ECCOH-like CTM day (no time axis, one timestamp)."""
    rng = np.random.default_rng(seed + 31 * month + day)
    pmid = np.sort(rng.uniform(60, 1000, (nz, H, W)), axis=0)[::-1].copy()
    lat = np.zeros((H, W)) if lat2d is None else lat2d
    lon = np.zeros((H, W)) if lon2d is None else lon2d
    return jdm.ctm_model(lat, lon, [datetime.datetime(2019, month, day)],
                         np.abs(rng.normal(80, 20, (nz, H, W))).astype(dt), pmid.astype(dt),
                         [], rng.uniform(10, 40, (nz, H, W)).astype(dt), "ECCOH", False)


def _gmi_mean(H, W, nz, seed, nt=3, dt=np.float64):
    """A GMI-like averaged CTM whose sub-daily axis the operators nanmean;
    a few NaN snapshots, none of them in every snapshot of a cell."""
    rng = np.random.default_rng(seed)
    pmid = np.sort(rng.uniform(60, 1000, (nt, nz, H, W)), axis=1)[:, ::-1].copy()
    prof = np.abs(rng.normal(80, 20, (nt, nz, H, W)))
    prof[0, :, 1, 2] = np.nan
    dp = rng.uniform(10, 40, (nt, nz, H, W))
    times = [datetime.datetime(2019, 7, 15, 8 * h) for h in range(nt)]
    return jdm.ctm_model(np.zeros((H, W)), np.zeros((H, W)), times, prof.astype(dt),
                         pmid.astype(dt), [], dp.astype(dt), "GMI", True)


def _granule(kind, seed, day, H, W, lon2d, lat2d, dt=np.float64, month=7, upscaled=False):
    """One gridded granule of ``kind`` with ~20% NaN cells, a negative
    observation and an infinite one."""
    r = np.random.default_rng(seed)
    when = datetime.datetime(2019, month, day, 12)
    if kind == "ssmis":
        vcd = np.abs(r.normal(20, 5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        vcd[0, 0] = np.inf
        return jdm.satellite_ssmis(
            vcd=vcd.astype(dt), uncertainty=np.abs(r.normal(1, 0.2, (H, W))).astype(dt),
            time=when, latitude_center=lat2d, longitude_center=lon2d,
            ctm_upscaled_needed=upscaled, ctm_vcd=[], sensor="SSMIS")
    if kind == "mopitt":
        Ls = 9
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        vcd[0, 0], vcd[0, 1] = np.inf, -0.5
        return jdm.satellite_opt(
            vcd=vcd.astype(dt), time=when, tropopause=np.empty((1,)),
            latitude_center=lat2d, longitude_center=lon2d,
            uncertainty=np.abs(r.normal(0.3, 0.05, (H, W))).astype(dt), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].astype(dt),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype(dt),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype(dt),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype(dt),
            surface_pressure=np.full((H, W), 1000.0, dt),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype(dt),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype(dt),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=upscaled)
    Ls = 6
    x_col = np.abs(r.normal(1.8, 0.1, (H, W)))
    x_col[r.random((H, W)) < 0.2] = np.nan
    x_col[0, 0] = np.inf
    return jdm.satellite_opt(
        vcd=x_col.astype(dt), time=when, tropopause=np.empty((1,)),
        latitude_center=lat2d, longitude_center=lon2d,
        uncertainty=np.abs(r.normal(0.05, 0.01, (H, W))).astype(dt), quality_flag=[],
        pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].astype(dt),
        averaging_kernels=r.uniform(0.2, 1.0, (Ls, H, W)).astype(dt),
        aprior_column=np.zeros((1,)), apriori_profile=np.abs(
            r.normal(1750, 40, (Ls, H, W))).astype(dt),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=x_col.astype(dt), pressure_weight=np.full((Ls, H, W), 1.0 / Ls, dt),
        sensor="GOSAT", ctm_upscaled_needed=upscaled)


def _month(kind, dt=np.float64, n=3, with_none=True, ctm="eccoh"):
    """(ctm_data, granules): ``n`` granules on days 2.., a None in between,
    and the CTM days they match (ECCOH-like daily list, or one GMI-like mean
    whose sub-daily axis is averaged)."""
    lon2d, lat2d = _sat_grid()
    H, W = lat2d.shape
    grans = [_granule(kind, 10 + s, 2 + s, H, W, lon2d, lat2d, dt) for s in range(n)]
    if with_none:
        grans.insert(1, None)
    if ctm == "gmi":
        ctm_data = [_gmi_mean(H, W, 12, seed=4, dt=dt)]
    else:
        ctm_data = [_eccoh_day(d, H, W, 12, seed=4, dt=dt) for d in range(1, 2 + n + 1)]
    if kind == "ssmis":  # a humidity profile whose column is ~20 mm, like the retrievals
        for c in ctm_data:
            c.gas_profile = c.gas_profile * dt(8e4)
    return ctm_data, grans


def _sessions(ctm_data, grans):
    """(port session, JAX session) over copies of the same month: the port's
    granule fields as CPU tensors, as its regrid leaves them."""
    jobj = jax_oisatgmi()
    jobj.reader_obj = SimpleNamespace(ctm_data=ctm_data, sat_data=copy.deepcopy(grans))
    pobj = port_oisatgmi()
    pobj.reader_obj = SimpleNamespace(
        ctm_data=[convert.ctm_model_from(c) for c in ctm_data],
        sat_data=[None if g is None else convert.granule_to(g, "cpu") for g in grans])
    return pobj, jobj


def _operate(obj, kind):
    if kind == "ssmis":
        obj.cal_pwv()
    elif kind == "amf":
        obj.recal_amf()
    else:
        obj.conv_ak(SENSORS[kind][0])


def _run_staged(obj, kind, sensor, gas, weighting=None, **oi_kw):
    _operate(obj, kind)
    obj.average(*MONTH, gasname=gas, weighting=weighting)
    obj.bias_correct(sensor, gas)
    obj.oi(sensor, error_ctm=50.0, **oi_kw)


def _assert_sessions(got, want, rtol=RTOL, atol_scale=None, exact=True):
    for name in FIELDS:
        _close(getattr(got, name), getattr(want, name), name, rtol, atol_scale)
    assert abs(got.avg_time.timestamp() - want.avg_time.timestamp()) < 1e-3
    assert set(got.oi_diagnostics) == set(want.oi_diagnostics)
    for k, v in want.oi_diagnostics.items():
        if k in ("n", "desroziers_iterations", "desroziers_bins"):
            assert got.oi_diagnostics[k] == v, k
        else:
            tol = max(rtol, 1e-7)
            np.testing.assert_allclose(got.oi_diagnostics[k], v, rtol=tol, atol=tol,
                                       err_msg=k)
    if exact:  # the same knee: the same factor scales Sa in both
        ok = np.isfinite(want.ak_OI)
        assert ok.sum() > 10
        np.testing.assert_allclose(got.ak_OI[ok], want.ak_OI[ok], rtol=max(1e-7, 10 * rtol))


# ---- the staged operators ----------------------------------------------------

@pytest.mark.parametrize("ctm", ["eccoh", "gmi"])
@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_staged_operator_matches_jax(monkeypatch, kind, ctm):
    """conv_ak / cal_pwv over a month with a None granule: the per-granule
    model fields, written back as tensors on the granules' device."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    pobj, jobj = _sessions(*_month(kind, ctm=ctm))
    _operate(pobj, kind)
    _operate(jobj, kind)
    assert pobj.reader_obj.sat_data[1] is None
    for g, w in zip(pobj.reader_obj.sat_data, jobj.reader_obj.sat_data):
        if w is None:
            continue
        assert torch.is_tensor(g.ctm_vcd) and g.ctm_vcd.device == g.vcd.device
        _close(g.ctm_vcd, w.ctm_vcd, "ctm_vcd", KIND_RTOL[kind])
        if kind != "ssmis":
            _close(g.ctm_xcol, w.ctm_xcol, "ctm_xcol")
            assert g.ctm_time_at_sat == w.ctm_time_at_sat
        if kind == "gosat":
            assert torch.isnan(g.ctm_vcd).all()
    if kind == "mopitt":  # the two masks: inf vcd loses its VCD, keeps its xcol
        g = pobj.reader_obj.sat_data[0]
        assert torch.isnan(g.ctm_vcd[0, 0]) and torch.isfinite(g.ctm_xcol[0, 0])


def _amf_month(monkeypatch, grid_size=0.25, n=3):
    """The JAX regrid's granules (parity mode) and the same arrays as the
    port's granules: the last one without scattering weights, a None."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    clon, clat = ctm_grid()
    grans = [jax_regrid_granule(1, grid_size, synthetic_granule(s, 4 + s), clon, clat,
                                flag_thresh=0.5, device=False) for s in range(n)]
    return [synthetic_ctm()], grans


@pytest.mark.parametrize("grid_size", [0.25, 2.0])
def test_amf_recal_matches_jax(monkeypatch, grid_size):
    """recal_amf on regridded granules, one of them without scattering
    weights, one None; ``grid_size`` 2.0 leaves the granules on a grid
    coarser than the CTM, whose slices are then mapped onto it."""
    ctm_data, grans = _amf_month(monkeypatch, grid_size)
    grans[-1].scattering_weights = np.empty((1,))
    grans.insert(1, None)
    assert grans[0].ctm_upscaled_needed is (grid_size == 2.0)
    pobj, jobj = _sessions(ctm_data, grans)
    pobj.recal_amf()
    jobj.recal_amf()
    for g, w in zip(pobj.reader_obj.sat_data, jobj.reader_obj.sat_data):
        if w is None:
            assert g is None
            continue
        # float32 granules against float64 partial columns on both sides
        for name in ("vcd", "ctm_vcd"):
            _close(getattr(g, name), getattr(w, name), name, rtol=1e-5)
        assert g.ctm_time_at_sat == w.ctm_time_at_sat
        if np.size(w.new_amf) == 1:
            assert _device.size(g.new_amf) == _device.size(g.old_amf) == 1
        else:
            _close(g.new_amf, w.new_amf, "new_amf", rtol=1e-5)
            _close(g.old_amf, w.old_amf, "old_amf", rtol=0)
    # a month with such a granule cannot be fused
    with pytest.raises(ValueError, match="scattering weights"):
        pobj.analyze_month_fused("OMI", "NO2", *MONTH)


@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_upscaled_ctm_month_matches_jax(monkeypatch, kind):
    """A CTM finer than the granule grid (``ctm_upscaled_needed``): the
    matched slices go through the KD-nearest upscaler onto the granule grid,
    staged and fused, and both match the JAX package."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    lon2d, lat2d = _sat_grid()
    H, W = lat2d.shape
    clon, clat = np.meshgrid(np.linspace(-21.0, 20.0, 2 * W + 3),
                             np.linspace(20.0, 55.0, 2 * H + 5))
    ctm_data = [_eccoh_day(d, *clat.shape, 12, seed=7, lon2d=clon, lat2d=clat)
                for d in range(1, 6)]
    grans = [_granule(kind, 20 + s, 2 + s, H, W, lon2d, lat2d, upscaled=True)
             for s in range(3)]
    sensor, gas = SENSORS[kind]
    pst, jst = _sessions(ctm_data, grans)
    _run_staged(pst, kind, sensor, gas)
    _run_staged(jst, kind, sensor, gas)
    _assert_sessions(pst, jst, KIND_RTOL[kind])
    assert pst.sat_averaged_vcd.shape == (H, W)
    pfu, jfu = _sessions(ctm_data, grans)
    pfu.analyze_month_fused(sensor, gas, *MONTH)
    jfu.analyze_month_fused(sensor, gas, *MONTH)
    _assert_sessions(pfu, jfu, KIND_RTOL[kind])
    _assert_sessions(pfu, pst, KIND_RTOL[kind])


# ---- averaging() -------------------------------------------------------------

@pytest.mark.parametrize("kind,weighting", [
    ("mopitt", None), ("mopitt", "inverse_variance"), ("mopitt", "ak"),
    ("gosat", "ak"), ("ssmis", None), ("ssmis", "inverse_variance")])
def test_averaging_two_month_window_matches_jax(monkeypatch, kind, weighting):
    """The date-bucketing driver over a June-July window with a None granule:
    one bucket per month on a trailing axis, vcd zeros-initialised."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    lon2d, lat2d = _sat_grid()
    H, W = lat2d.shape
    days = [(6, 29), (6, 30), (7, 1), (7, 2), (7, 3)]
    ctm_data = [_eccoh_day(d, H, W, 12, seed=5, month=m) for m, d in days]
    grans = [_granule(kind, 30 + i, d, H, W, lon2d, lat2d, month=m)
             for i, (m, d) in enumerate(days)]
    grans.insert(2, None)
    pobj, jobj = _sessions(ctm_data, grans)
    _operate(pobj, kind)
    _operate(jobj, kind)
    got = port_averaging("2019-06-01", "2019-08-01", pobj.reader_obj, weighting=weighting)
    want = jax_averaging("2019-06-01", "2019-08-01", jobj.reader_obj, weighting=weighting)
    for name, g, w in zip(FIELDS[:5], got, want):
        assert isinstance(g, np.ndarray) and g.shape == (H, W, 2), name
        _close(g, w, name, KIND_RTOL[kind])
    assert got[5] == want[5]
    # a window that holds no granule
    with pytest.raises(ValueError, match="no granules"):
        port_averaging("2019-09-01", "2019-10-01", pobj.reader_obj)


def test_averaging_multi_year_buckets_match_jax(monkeypatch):
    """tests/test_pipeline.py's multi-year range (the GOSAT 2005-2019
    reanalysis shape): June and July granules of 2010 and 2011 bucket into
    (H, W, 12 months, 2 years), each bucket holding its own month's data,
    as in the twin."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    clon, clat = ctm_grid()
    grans = []
    for year in (2010, 2011):
        for month in (6, 7):
            g = jax_regrid_granule(1, 0.25, synthetic_granule(year + month, 4), clon, clat,
                                   flag_thresh=0.5, device=False)
            g.time = datetime.datetime(year, month, 15)
            g.ctm_vcd = np.full_like(g.vcd, float(year + month))
            g.new_amf = np.ones_like(g.vcd)
            g.old_amf = np.ones_like(g.vcd)
            grans.append(g)
    pobj, jobj = _sessions([synthetic_ctm()], grans)
    got = port_averaging("2010-06-01", "2011-08-01", pobj.reader_obj)
    want = jax_averaging("2010-06-01", "2011-08-01", jobj.reader_obj)
    for name, g, w in zip(FIELDS[:5], got, want):
        assert isinstance(g, np.ndarray) and g.shape == clat.shape + (12, 2), name
        _close(g, w, name)
    assert got[5] == want[5]
    for yi, year in enumerate((2010, 2011)):
        for month in (6, 7):
            vals = got[2][:, :, month - 1, yi]
            np.testing.assert_allclose(vals[np.isfinite(vals)], year + month)


def test_averaging_refuses_ak_weights_without_averaging_kernels(monkeypatch):
    pobj, _ = _sessions(*_month("ssmis"))
    pobj.cal_pwv()
    with pytest.raises(ValueError, match="averaging-kernel"):
        pobj.average(*MONTH, weighting="ak")
    with pytest.raises(ValueError, match="unknown weighting"):
        pobj.average(*MONTH, weighting="median")
    with pytest.raises(ValueError, match="averaging-kernel"):
        pobj.analyze_month_fused("SSMIS", "H2O", *MONTH, weighting="ak")


def test_averaging_amf_month_matches_jax(monkeypatch):
    """AMF granules: aux1 / aux2 are the new and old AMFs once recal_amf has
    run, NaN planes before it (the ``[]`` placeholder), and O3 months
    convert the CTM column to DU."""
    ctm_data, grans = _amf_month(monkeypatch)
    pobj, jobj = _sessions(ctm_data, grans)
    for obj in (pobj, jobj):
        obj.recal_amf()
        obj.average(*MONTH, gasname="O3", weighting="inverse_variance")
    for name in FIELDS[:5]:
        _close(getattr(pobj, name), getattr(jobj, name), name, rtol=1e-5)
    assert pobj.avg_time == jobj.avg_time


# ---- the slice as a whole ------------------------------------------------------

@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_staged_driver_matches_jax(monkeypatch, kind):
    monkeypatch.setenv("OISAT_PARITY", "1")
    sensor, gas = SENSORS[kind]
    stage_ms = {}
    pobj, jobj = _sessions(*_month(kind))
    pobj.stage_ms = stage_ms
    _device.COPIES.update(h2d=0, d2h=0)
    _run_staged(pobj, kind, sensor, gas)
    copies = dict(_device.COPIES)
    _run_staged(jobj, kind, sensor, gas)
    _assert_sessions(pobj, jobj, KIND_RTOL[kind])
    for name in FIELDS:
        assert isinstance(getattr(pobj, name), np.ndarray), name
    op = "cal_pwv" if kind == "ssmis" else "conv_ak"
    assert list(stage_ms) == [op, "average", "bias_correct", "oi"]
    # average pulls once per month bucket, oi pushes once and pulls once; the
    # operators push each distinct CTM slice's fields once (3 matched days)
    n_ctm = {"mopitt": 3, "gosat": 2, "ssmis": 1}[kind]
    assert copies == {"h2d": 3 * n_ctm + 1, "d2h": 2}, copies
    if kind == "gosat":  # the OI ran on the xcol pair
        assert np.isnan(pobj.ctm_averaged_vcd).all()
        both = np.isfinite(pobj.increment_OI)
        np.testing.assert_allclose((pobj.ctm_averaged_vcd_corrected - pobj.aux2)[both],
                                   pobj.increment_OI[both], rtol=1e-6, atol=1e-9)
        assert pobj.oi_diagnostics["n"] > 0 and np.isfinite(pobj.oi_diagnostics["chi2"])


@pytest.mark.parametrize("kind,weighting", [
    ("mopitt", None), ("mopitt", "inverse_variance"), ("mopitt", "ak"),
    ("gosat", None), ("gosat", "inverse_variance"), ("gosat", "ak"),
    ("ssmis", None), ("ssmis", "inverse_variance")])
def test_fused_month_matches_jax_and_its_own_staged_path(monkeypatch, kind, weighting):
    monkeypatch.setenv("OISAT_PARITY", "1")
    sensor, gas = SENSORS[kind]
    month = _month(kind, ctm="gmi" if kind == "mopitt" else "eccoh")
    pfu, jfu = _sessions(*month)
    pout = pfu.analyze_month_fused(sensor, gas, *MONTH, weighting=weighting)
    jout = jfu.analyze_month_fused(sensor, gas, *MONTH, weighting=weighting)
    assert int(pout.oi.reg_index) == int(jout.oi.reg_index) >= 0
    assert float(pout.oi.reg_factor) == float(jout.oi.reg_factor)
    # the step computes its weights in float32 (both packages), the staged
    # averaging() in float64
    rtol = KIND_RTOL[kind] if weighting is None else 2e-6
    _assert_sessions(pfu, jfu, rtol)
    pst, _ = _sessions(*month)
    _run_staged(pst, kind, sensor, gas, weighting=weighting)
    _assert_sessions(pfu, pst, rtol)


@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_fused_month_float32_matches_staged_at_the_jax_bound(monkeypatch, kind):
    """The products' own dtype: the port's fused month against its staged
    path (float64 averaging of float32 granules) at the JAX tests' bound,
    with the same knee."""
    sensor, gas = SENSORS[kind]
    month = _month(kind, dt=np.float32)
    pfu, _ = _sessions(*month)
    pfu.analyze_month_fused(sensor, gas, *MONTH)
    pst, _ = _sessions(*month)
    _run_staged(pst, kind, sensor, gas)
    assert pfu.ctm_averaged_vcd_corrected.dtype == np.float64
    _assert_sessions(pfu, pst, rtol=2e-4, atol_scale=2e-5, exact=False)


def test_fused_month_refuses_mixed_months(monkeypatch):
    ctm_data, grans = _month("mopitt", with_none=False)
    lon2d, lat2d = _sat_grid()
    pobj, _ = _sessions(ctm_data, grans + [_granule("ssmis", 1, 9, 12, 14, lon2d, lat2d)])
    with pytest.raises(ValueError, match="one granule kind"):
        pobj.analyze_month_fused("MOPITT", "CO", *MONTH)
    lon_s, lat_s = _sat_grid(10, 14)
    pobj, _ = _sessions(ctm_data, grans + [_granule("mopitt", 1, 9, 10, 14, lon_s, lat_s)])
    with pytest.raises(ValueError, match="one granule shape"):
        pobj.analyze_month_fused("MOPITT", "CO", *MONTH)
    host, _ = _sessions(ctm_data, grans)
    host.reader_obj.sat_data[0].vcd = np.asarray(grans[0].vcd)
    with pytest.raises(TypeError, match="tensors on one device"):
        host.conv_ak("MOPITT")


# ---- the daily files -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_daily_files_match_jax(tmp_path, monkeypatch, kind):
    """savedaily (staged) and save_daily (fused): the JAX driver's file names
    and arrays, the counter taken from the granule's place in sat_data."""
    from scipy.io import loadmat

    monkeypatch.setenv("OISAT_PARITY", "1")
    sensor, gas = SENSORS[kind]
    ctm_data, grans = _month(kind)
    pst, jst = _sessions(ctm_data, grans)
    for obj, where in ((pst, "port_staged"), (jst, "jax_staged")):
        _operate(obj, kind)
        obj.savedaily(str(tmp_path / where), gas, "201907")
    pfu, jfu = _sessions(ctm_data, grans)
    pfu.analyze_month_fused(sensor, gas, *MONTH, save_daily=(str(tmp_path / "port_fused"),
                                                             "201907"))
    jfu.analyze_month_fused(sensor, gas, *MONTH, save_daily=(str(tmp_path / "jax_fused"),
                                                             "201907"))
    names = sorted(p.name for p in (tmp_path / "jax_staged").glob("*.mat"))
    assert len(names) == 3 and not any(n.endswith("1.mat") for n in names)  # None at 1
    for where in ("port_staged", "port_fused", "jax_fused"):
        assert sorted(p.name for p in (tmp_path / where).glob("*.mat")) == names, where
        for name in names:
            want = loadmat(tmp_path / "jax_staged" / name)
            got = loadmat(tmp_path / where / name)
            for key in ("vcd_sat", "vcd_ctm", "vcd_err", "time_sat", "lat", "lon"):
                _close(got[key], want[key], f"{where}/{name}:{key}", KIND_RTOL[kind])
    _assert_sessions(pfu, jfu, KIND_RTOL[kind])


def test_daily_latlon_keeps_the_reference_hazard():
    """The first valid satellite index addresses the CTM list."""
    ctm_data, grans = _month("ssmis", with_none=False)
    pobj, _ = _sessions(ctm_data[:1], [None] + grans)
    with pytest.raises(IndexError):
        pobj._daily_latlon()


# ---- the products' own widths, at a shallow depth ------------------------------

@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_synthetic_sensor_months_through_the_port(kind):
    """entry's synthetic MOPITT / GOSAT / SSMIS granules at their products'
    widths, regridded by the native builder onto the MERRA2-GMI grid with a
    6-level, 2-snapshot CTM: the staged driver and the fused month agree (the
    JAX tests' float32 bound) and pick the same factor; MOPITT and GOSAT stay
    on their 1 degree grid and take the upscaled CTM."""
    from oisat_tpu_torch import entry
    from oisat_tpu_torch.readers.sensors.gosat import filler_gosatxch4
    from oisat_tpu_torch.regridder import regrid_granule, regrid_ssmis_granule

    sensor, gas = SENSORS[kind]
    lon2d, lat2d = entry.merra2_gmi_grid()
    ctm = entry.synthetic_ctm(lon2d, lat2d, nt=2, nz=6, gas=gas)
    if kind == "mopitt":
        grans = [regrid_granule(1, 1.0, entry.synthetic_mopitt_day(1 + d, 1 + d), lon2d,
                                lat2d, "cpu", flag_thresh=0.0) for d in range(2)]
        assert grans[0].averaging_kernels.shape == (10, 181, 361)
    elif kind == "gosat":
        filled = [filler_gosatxch4(1.0, entry.synthetic_gosat_day(1 + d, 1 + d), "cpu",
                                   flag_thresh=0.0) for d in range(2)]
        assert filled[0].vcd.shape == (181, 361) and filled[0].pressure_weight.shape[0] == 20
        grans = [regrid_granule(1, 1.0, f, lon2d, lat2d, "cpu", flag_thresh=0.0)
                 for f in filled]
    else:
        grans = [regrid_ssmis_granule(0.25, entry.synthetic_ssmis_map(1 + k), lon2d, lat2d,
                                      "cpu") for k in range(2)]
        assert entry.synthetic_ssmis_map(1).vcd.shape == (720, 1440)
    assert all(g.ctm_upscaled_needed is (kind != "ssmis") for g in grans)
    assert tuple(grans[0].vcd.shape) == ((361, 576) if kind == "ssmis" else (181, 361))
    staged, fused = port_oisatgmi(), port_oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    _run_staged(staged, kind, sensor, gas)
    out = fused.analyze_month_fused(sensor, gas, *MONTH)
    _assert_sessions(fused, staged, rtol=2e-4, atol_scale=2e-5, exact=False)
    assert int(out.oi.reg_index) >= 0
    pair = (fused.aux2, fused.aux1) if kind == "gosat" else (fused.ctm_averaged_vcd,
                                                            fused.sat_averaged_vcd)
    both = np.isfinite(pair[0]) & np.isfinite(pair[1]) & np.isfinite(fused.sat_averaged_error)
    assert both.sum() > 1000 and np.isfinite(fused.ctm_averaged_vcd_corrected[both]).all()
    assert fused.oi_diagnostics["n"] == staged.oi_diagnostics["n"] > 1000
