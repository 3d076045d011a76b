"""The port's regrid (oisat_tpu_torch.ops.regrid, .regridder) and fused month
driver (oisat_tpu_torch.driver) against the JAX package on the CPU.

The JAX regrid runs in its parity mode (``OISAT_PARITY=1``: the scipy weight
builders and full-precision transfers, no affine carrier level), the port
with the matching ``fast_swath=False``.  Regridded fields are float32 on
both sides: rtol 1e-5 / atol 1e-6, NaN patterns identical, the knee exact.
"""

import copy
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.synthetic_month import make_ctm, make_granule
from oisat_tpu.driver import oisatgmi as jax_oisatgmi
from oisat_tpu.ops import regrid as jrg
from oisat_tpu.ops.weights import build_plan
from oisat_tpu.regridder import regrid_granule as jax_regrid_granule
from oisat_tpu_torch import convert
from oisat_tpu_torch.driver import oisatgmi as port_oisatgmi
from oisat_tpu_torch.ops import oi_full as port_oi_full
from oisat_tpu_torch.ops import regrid as trg
from oisat_tpu_torch.ops.oi import regularization_grid
from oisat_tpu_torch.regridder import regrid_granule as port_regrid_granule
from tests.test_regrid import swath, target_grid
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)



@pytest.mark.parametrize("method", [1, 2, 3, 4])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_apply_plan_arrays_matches_jax(method, dt):
    lon, lat, z = swath(seed=method)
    tlon, tlat = target_grid()
    plan = build_plan(lon, lat, tlon, tlat, method=method, threshold=0.5)
    batch = np.stack([z, 2.0 * z + 1.0, np.where(z > 0, np.nan, z)]).astype(dt)
    tp = convert.plan_to_torch(plan, "cpu")
    got = trg.apply_plan_arrays(torch.as_tensor(batch), tp.idx, tp.w, tp.mask)
    want = jrg.apply_plan_arrays(jnp.asarray(batch), jnp.asarray(plan.idx),
                                 jnp.asarray(plan.w), jnp.asarray(plan.mask))
    assert_parity(got.numpy(), want, dt)


def test_plan_to_torch_expands_compacted_plans():
    from oisat_tpu.ops.weights import compact_plan

    lon, lat, z = swath(seed=5)
    tlon, tlat = target_grid()
    plan = build_plan(lon, lat, tlon, tlat, method=1, threshold=0.5)
    small = compact_plan(plan, max_keep_frac=1.0)
    assert small.sel is not None
    a, b = convert.plan_to_torch(plan, "cpu"), convert.plan_to_torch(small, "cpu")
    zt = torch.as_tensor(z)[None]
    assert torch.equal(torch.nan_to_num(trg.apply_plan_arrays(zt, a.idx, a.w, a.mask), nan=-1.0),
                       torch.nan_to_num(trg.apply_plan_arrays(zt, b.idx, b.w, b.mask), nan=-1.0))


@pytest.mark.parametrize("k", [(1, 1), (2, 2), (3, 3), (2, 3), (4, 5), (8, 1)])
@pytest.mark.parametrize("squared", [False, True])
def test_boxfilter_same_symm_matches_jax(k, squared):
    ky, kx = k
    z = np.random.default_rng(ky * 10 + kx).standard_normal((3, 13, 17))
    z[0, 5, 5] = np.nan
    for dt in (np.float32, np.float64):
        got = trg.boxfilter_same_symm(torch.as_tensor(z.astype(dt)), ky, kx, squared=squared)
        want = jrg.boxfilter_same_symm(jnp.asarray(z.astype(dt)), ky, kx, squared=squared)
        assert_parity(got.numpy(), want, dt, str((dt, k)))


def test_boxfilter_matches_scipy_convolve2d():
    from scipy.signal import convolve2d

    z = np.random.default_rng(2).standard_normal((11, 14))
    for ky, kx in ((2, 2), (3, 4)):
        ref = convolve2d(z, np.ones((ky, kx)) / (ky * kx), mode="same", boundary="symm")
        got = trg.boxfilter_same_symm(torch.as_tensor(z), ky, kx)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def _regrid_pair(monkeypatch, seed, method=1, grid_size=0.25):
    """(port granule, jax granule) for examples/synthetic_month.make_granule."""
    _, clon, clat = make_ctm()
    monkeypatch.setenv("OISAT_PARITY", "1")
    want = jax_regrid_granule(method, grid_size, make_granule(seed, 4 + seed), clon, clat,
                              flag_thresh=0.5, device=False)
    got = port_regrid_granule(method, grid_size,
                              convert.satellite_amf_from(make_granule(seed, 4 + seed)),
                              clon, clat, "cpu", flag_thresh=0.5, fast_swath=False)
    return got, want


@pytest.mark.parametrize("method", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_regrid_granule_matches_jax(monkeypatch, method, seed):
    got, want = _regrid_pair(monkeypatch, seed, method)
    assert got.ctm_upscaled_needed is want.ctm_upscaled_needed is False
    assert np.array_equal(got.latitude_center, want.latitude_center)
    for name in ("vcd", "amf", "tropopause", "uncertainty", "pressure_mid",
                 "scattering_weights"):
        g = getattr(got, name)
        assert g.dtype == torch.float32, name
        assert_parity(g.numpy(), getattr(want, name), np.float32, name)
    assert torch.isfinite(got.vcd).sum() > 20
    assert got.time == want.time


def test_regrid_granule_passthrough_matches_jax(monkeypatch):
    """CTM finer than the analysis grid: fields stay on the fine grid."""
    got, want = _regrid_pair(monkeypatch, 2, grid_size=2.0)
    assert got.ctm_upscaled_needed is want.ctm_upscaled_needed is True
    for name in ("vcd", "uncertainty", "scattering_weights"):
        assert_parity(getattr(got, name).numpy(), getattr(want, name), np.float32, name)


def test_regrid_granule_fast_swath_runs_the_native_builder():
    _, clon, clat = make_ctm()
    g = convert.satellite_amf_from(make_granule(3, 7))
    fast = port_regrid_granule(1, 0.25, g, clon, clat, "cpu", flag_thresh=0.5)
    slow = port_regrid_granule(1, 0.25, g, clon, clat, "cpu", flag_thresh=0.5,
                               fast_swath=False)
    assert fast.vcd.shape == slow.vcd.shape == clon.shape
    # same linear interpolant up to the in-quad diagonal choice
    both = torch.isfinite(fast.vcd) & torch.isfinite(slow.vcd)
    assert both.sum() > 50
    np.testing.assert_allclose(fast.amf[both].numpy(), slow.amf[both].numpy(), rtol=0.2)


def test_regrid_granule_misses_domain_and_rejects_other_kinds():
    _, clon, clat = make_ctm()
    far_lon, far_lat = np.meshgrid(np.arange(100, 120, 1.0), np.arange(-40, -20, 1.0))
    g = convert.satellite_amf_from(make_granule(0, 4))
    assert port_regrid_granule(1, 0.25, g, far_lon, far_lat, "cpu") is None
    with pytest.raises(TypeError, match="satellite_amf"):
        port_regrid_granule(1, 0.25, make_granule(0, 4), clon, clat, "cpu")


def _month_pair(monkeypatch, n=3):
    ctm, clon, clat = make_ctm()
    monkeypatch.setenv("OISAT_PARITY", "1")
    jax_grans = [jax_regrid_granule(1, 0.25, make_granule(s, 4 + s), clon, clat,
                                    flag_thresh=0.5, device=False) for s in range(n)]
    port_grans = [port_regrid_granule(1, 0.25, convert.satellite_amf_from(make_granule(s, 4 + s)),
                                      clon, clat, "cpu", flag_thresh=0.5, fast_swath=False)
                  for s in range(n)]
    jobj = jax_oisatgmi()
    jobj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=jax_grans)
    pobj = port_oisatgmi()
    pobj.reader_obj = SimpleNamespace(ctm_data=[convert.ctm_model_from(ctm)],
                                      sat_data=port_grans)
    return pobj, jobj


def test_analyze_month_fused_matches_jax(monkeypatch):
    pobj, jobj = _month_pair(monkeypatch)
    pout = pobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")
    jout = jobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")
    assert int(pout.oi.reg_index) == int(jout.oi.reg_index)
    assert float(pout.oi.reg_factor) == float(jout.oi.reg_factor)
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI",
                 "sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd",
                 "aux1", "aux2"):
        assert_parity(getattr(pobj, name), getattr(jobj, name), np.float32, name)
    assert pobj.avg_time == jobj.avg_time
    assert pobj.oi_diagnostics["n"] == jobj.oi_diagnostics["n"]
    for k in ("omb_mean", "omb_rms", "oma_mean", "oma_rms", "chi2"):
        assert_parity(pobj.oi_diagnostics[k], jobj.oi_diagnostics[k], np.float32, k)


@pytest.mark.parametrize("error_scale", [1.0, 0.1, 0.04])
def test_analyze_month_fused_full_covariance_matches_jax(monkeypatch, error_scale):
    """oi_method="full" on the same regridded granules: the averaged fields
    at the float32 regrid tolerance, the posterior fields and diagnostics at
    the full OI's (tests/test_torch_oi_full.py): 5e-4 for the float32 dense
    scan, 1e-7 once the float64 exact tail has run; the residual statistics
    (which read xb) at the fields' tolerance on the scale of xb, the others
    at float32's.
    ``error_scale`` 0.1 shrinks the observation error into the tight regime
    where the tail runs (median sigma_b/sigma_o ~ 110); 0.04 into the
    production regime (median ~ 270, the 150-300 of monthly averages),
    where the float32 scan's curve moves by rounding only and the two
    packages' knees part (ROADMAP queue 3): there the port is given the JAX
    package's factor, so the two float64 tails are held at one factor."""
    pobj, jobj = _month_pair(monkeypatch)
    for obj in (pobj, jobj):
        for g in obj.reader_obj.sat_data:
            g.uncertainty = g.uncertainty * error_scale
    kw = dict(oi_method="full", length_scale_km=200.0)
    jout = jobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01", **kw)
    xa, so = np.asarray(jobj.ctm_averaged_vcd), np.asarray(jobj.sat_averaged_error)
    ok = np.isfinite(xa) & np.isfinite(so) & (so > 0)
    median_ratio = float(np.median(0.5 * xa[ok] / so[ok]))
    if error_scale < 0.1:
        assert 150.0 < median_ratio < 300.0
        idx = int(np.argmin(np.abs(regularization_grid() - jobj.oi_diagnostics["reg"])))
        monkeypatch.setattr(port_oi_full, "kneedle_index_np", lambda *a, **k: idx)
    stage_ms = {}
    pout = pobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                    stage_ms=stage_ms, **kw)
    assert {"assemble", "step", "pull", "oi_full", "innovation_stats", "oi_full.eigh",
            "oi_full.covariance"} <= set(stage_ms)
    assert int(pout.oi.reg_index) == int(jout.oi.reg_index) == -1
    assert np.isnan(float(pout.oi.reg_factor)) and torch.isnan(pout.oi.xb).all()
    assert torch.equal(pout.scaling_factor, torch.ones_like(pout.scaling_factor))
    for name in ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2"):
        assert_parity(getattr(pobj, name), getattr(jobj, name), np.float32, name)
    tail = error_scale < 1.0
    assert (pobj.oi_diagnostics.get("solver") == jobj.oi_diagnostics.get("solver")
            == ("dense+direct_f64_dev" if tail else None))
    tol = 1e-7 if tail else 5e-4
    # the posterior of each package's own averaged fields, which differ at
    # the float32 regrid tolerance: held at that tolerance (or the scan's)
    _assert_full_oi_parity(pobj, jobj, max(tol, 1e-5))
    # the port's full OI on the JAX package's averaged fields: the full OI's
    # own tolerance
    same = copy.copy(pobj)
    for name in ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd"):
        setattr(same, name, np.array(getattr(jobj, name)))
    same._oi_full(50.0, 200.0, torch.device("cpu"), "auto")
    _assert_full_oi_parity(same, jobj, tol)
    if tail:
        assert pobj.oi_diagnostics["f64_resid"] <= 1e-5


def _assert_full_oi_parity(pobj, jobj, tol):
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        got, want = getattr(pobj, name), np.asarray(getattr(jobj, name), np.float64)
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        assert np.isfinite(got).sum() > 50, name
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.nanmax(np.abs(want)),
                                   equal_nan=True, err_msg=name)
    assert set(pobj.oi_diagnostics) == set(jobj.oi_diagnostics)
    assert pobj.oi_diagnostics["n"] == jobj.oi_diagnostics["n"] > 50
    for k, v in jobj.oi_diagnostics.items():
        if k in ("solver", "exact_diag", "reg"):
            assert pobj.oi_diagnostics[k] == v, k
        elif k.startswith("oma"):  # y - xb cancels: held on the scale of xb
            scale = np.nanmax(np.abs(jobj.ctm_averaged_vcd_corrected))
            np.testing.assert_allclose(pobj.oi_diagnostics[k], v, rtol=max(tol, 1e-5),
                                       atol=tol * scale, err_msg=k)
        elif k == "f64_resid":
            assert pobj.oi_diagnostics[k] <= 1e-5 and v <= 1e-5
        elif k != "n":
            assert_parity(pobj.oi_diagnostics[k], v, np.float32, k)


def test_analyze_month_fused_refuses_what_is_not_ported(monkeypatch):
    pobj, _ = _month_pair(monkeypatch, n=1)
    for kw, what in ((dict(desroziers_iterations=1), "item 11"),):
        with pytest.raises(NotImplementedError, match=what):
            pobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01", **kw)
    with pytest.raises(ValueError, match="oi_method"):
        pobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01", oi_method="cg")
    empty = copy.copy(pobj)
    empty.reader_obj = SimpleNamespace(ctm_data=pobj.reader_obj.ctm_data, sat_data=[None])
    with pytest.raises(ValueError, match="no valid"):
        empty.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")


def test_synthetic_orbits_through_the_port_month():
    """chip_smoke.py's path at a small size on the CPU: entry's synthetic
    orbits and diurnal CTM -> the port's regrid (native builder) -> the
    fused month; the result is finite where the prior and the observation
    are, and the CTM snapshot is matched by the orbit's UTC hour."""
    from oisat_tpu_torch.entry import synthetic_ctm, synthetic_orbit

    lon2d, lat2d = np.meshgrid(np.arange(-40.0, 40.0, 0.625), np.arange(-30.0, 30.25, 0.5))
    ctm = synthetic_ctm(lon2d, lat2d, nz=20)
    assert ctm.averaged and ctm.pressure_mid.shape == (8, 20) + lat2d.shape
    orbits = [synthetic_orbit(i + 1, c, ny=300, nx=30, nz=8, day=1 + i,
                              lat_range=(-28.0, 28.0), width_deg=14.0)
              for i, c in enumerate((-25.0, 0.0, 25.0))]
    assert [o.time.hour for o in orbits] == [15, 13, 11]
    grans = [port_regrid_granule(1, 0.25, o, lon2d, lat2d, "cpu", flag_thresh=0.5)
             for o in orbits]
    assert all(g is not None and g.pressure_mid.shape == (8,) + lat2d.shape for g in grans)
    obj = port_oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    out = obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")
    assert out.oi.xb.dtype == torch.float64  # float64 partial columns
    both = (np.isfinite(obj.ctm_averaged_vcd) & np.isfinite(obj.sat_averaged_vcd)
            & np.isfinite(obj.sat_averaged_error))
    assert both.sum() > 0.2 * both.size
    assert np.isfinite(obj.ctm_averaged_vcd_corrected[both]).all()
    assert 0 < obj.oi_diagnostics["n"] <= both.sum()


def test_conus_window_and_its_regional_orbits():
    """chip_smoke.py's full-covariance month at a small depth: the CONUS
    window of the MERRA2-GMI grid holds 57 x 99 = 5,643 cells (under the
    scan's dense limit), and the regional orbits cross it and regrid onto
    it through the native builder."""
    from oisat_tpu_torch.entry import conus_window, merra2_gmi_grid, synthetic_regional_month
    from oisat_tpu_torch.ops.oi_full import DENSE_SCAN_MAX_CELLS

    lon2d, lat2d = conus_window()
    assert lon2d.shape == lat2d.shape == (57, 99) and lat2d.size <= DENSE_SCAN_MAX_CELLS
    assert (lat2d.min(), lat2d.max()) == (24.0, 52.0)
    assert -128.0 <= lon2d.min() < lon2d.max() <= -66.0
    glon, glat = merra2_gmi_grid()
    assert np.isin(lat2d[:, 0], glat[:, 0]).all() and np.isin(lon2d[0], glon[0]).all()
    orbits, ctm, wlon, wlat = synthetic_regional_month(3, ny=400, nx=30, nz=6, nz_ctm=12)
    assert np.array_equal(wlon, lon2d) and ctm.pressure_mid.shape == (8, 12, 57, 99)
    assert [o.time.day for o in orbits] == [1, 2, 3]
    for o in orbits:
        g = port_regrid_granule(1, 0.25, o, wlon, wlat, "cpu", flag_thresh=0.5)
        assert g is not None and int(torch.isfinite(g.vcd).sum()) > 300
        assert 0.05 < float(np.nanmedian(o.uncertainty)) < 0.15  # REGIONAL_ERROR_MEAN
