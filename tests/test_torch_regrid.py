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
    same._oi_impl("OMI", 50.0, "full", 200.0)
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
    """Nothing of this path raises NotImplementedError any more: the full OI
    above the dense limit (with and without a Desroziers pass) runs the
    matrix-free path and matches the JAX package's; the job runner's
    ``mesh_devices`` runs the month over CPU shards; Desroziers and the file
    I/O methods run; an unknown ``oi_method`` and an empty month raise
    ValueError."""
    pobj, jobj = _month_pair(monkeypatch, n=1)
    month = ("OMI", "NO2", "2019-07-01", "2019-08-01")
    pobj.analyze_month_fused(*month, desroziers_iterations=1)
    assert pobj.oi_diagnostics["desroziers_iterations"] == 1
    from oisat_tpu.ops import oi_full as jax_oi_full

    monkeypatch.setattr(port_oi_full, "DENSE_SCAN_MAX_CELLS", 10)
    monkeypatch.setattr(jax_oi_full, "DENSE_SCAN_MAX_CELLS", 10)
    for kw in (dict(oi_method="full"), dict(oi_method="full", desroziers_iterations=1)):
        pobj.analyze_month_fused(*month, **kw)
        jobj.analyze_month_fused(*month, **kw)
        assert pobj.oi_diagnostics["precond"] == jobj.oi_diagnostics["precond"] == "jacobi"
        assert set(pobj.oi_diagnostics) == set(jobj.oi_diagnostics)
        for name in ("ctm_averaged_vcd_corrected", "ak_OI", "error_OI"):
            got, want = getattr(pobj, name), np.asarray(getattr(jobj, name), np.float64)
            assert np.array_equal(np.isnan(got), np.isnan(want)), name
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.nanmax(np.abs(want)),
                                       equal_nan=True, err_msg=name)
    from oisat_tpu_torch.run import job as port_job

    # the job runner's mesh_devices: 4 logical CPU shards through _analyze
    # (fused) give the mesh-less session's fields
    ctrl = {"ctm_error": 50.0, "mesh_devices": 4, "device": "cpu", "fused_month": True}
    meshed = copy.copy(pobj)
    port_job._analyze(meshed, ctrl, *month, savedaily=("x", "y"))
    pobj.analyze_month_fused(*month)
    for name in ("sat_averaged_vcd", "ctm_averaged_vcd", "ctm_averaged_vcd_corrected",
                 "ak_OI", "error_OI"):
        want = getattr(pobj, name)
        np.testing.assert_allclose(getattr(meshed, name), want, rtol=1e-5,
                                   atol=1e-6 * np.nanmax(np.abs(want)), equal_nan=True,
                                   err_msg=name)
    assert not hasattr(pobj, "_not_ported")
    fields = pobj._diag_fields()  # the file I/O methods work on this session
    assert list(fields)[:2] == ["sat_averaged_vcd", "ctm_averaged_vcd_prior"]
    with pytest.raises(ValueError, match="oi_method"):
        pobj.analyze_month_fused(*month, oi_method="cg")
    empty = copy.copy(pobj)
    empty.reader_obj = SimpleNamespace(ctm_data=pobj.reader_obj.ctm_data, sat_data=[None])
    with pytest.raises(ValueError, match="no valid"):
        empty.analyze_month_fused(*month)


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


# ---- the other granule kinds: satellite_opt, satellite_ssmis, the GOSAT filler ----

def _region(pitch_lat, pitch_lon, lat0=20.0, lat1=44.0, lon0=-30.0, lon1=10.0):
    return np.meshgrid(np.arange(lon0, lon1 + 1e-9, pitch_lon),
                       np.arange(lat0, lat1 + 1e-9, pitch_lat))


def _opt_granule(sensor, seed=0, Ls=5):
    """A MOPITT- or GOSAT-like host granule on a regular 1 degree grid, a
    missing patch and 2% scattered NaN, float32 level stacks; MOPITT carries the 2-D a-priori fields, GOSAT
    their all-zero placeholders and the pressure weights."""
    import datetime

    from oisat_tpu.datamodel import satellite_opt

    rng = np.random.default_rng(seed)
    lon, lat = _region(1.0, 1.0, 21.0, 43.0, -29.0, 9.0)
    hw = lat.shape
    mopitt = sensor == "MOPITT"
    vcd = np.abs(rng.normal(2, 0.5, hw))
    vcd[rng.random(hw) < 0.02] = np.nan
    vcd[:6, :9] = np.nan
    qa = np.ones(hw)
    qa[rng.random(hw) < 0.02] = 0.0
    f32 = np.float32
    return satellite_opt(
        vcd=vcd, time=datetime.datetime(2019, 7, 3, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(0.3, 0.05, hw)), quality_flag=qa,
        pressure_mid=np.sort(rng.uniform(100, 900, (Ls,) + hw), axis=0)[::-1].astype(f32),
        averaging_kernels=rng.uniform(0, 0.5, (Ls + mopitt,) + hw).astype(f32),
        aprior_column=np.abs(rng.normal(2, 0.3, hw)) if mopitt else np.zeros((1,)),
        apriori_profile=np.abs(rng.normal(80, 15, (Ls,) + hw)).astype(f32),
        surface_pressure=np.full(hw, 1000.0) if mopitt else np.zeros((1,)),
        apriori_surface=np.abs(rng.normal(90, 10, hw)) if mopitt else np.zeros((1,)),
        x_col=np.abs(rng.normal(1.8, 0.1, hw)),
        pressure_weight=(np.empty((1,)) if mopitt
                         else np.full((Ls,) + hw, 1.0 / Ls, f32)),
        sensor=sensor)


_OPT_FIELDS = ("vcd", "uncertainty", "x_col", "pressure_mid", "averaging_kernels",
               "apriori_profile", "aprior_column", "surface_pressure", "apriori_surface",
               "pressure_weight")


def _assert_granule_parity(got, want, names):
    """Tensor fields at the float32 regrid tolerance; placeholders of the same
    size and content; the same geometry and flags."""
    assert got.ctm_upscaled_needed is want.ctm_upscaled_needed
    assert np.array_equal(got.latitude_center, want.latitude_center)
    assert np.array_equal(got.longitude_center, want.longitude_center)
    assert got.time == want.time and got.sensor == want.sensor
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if np.size(w) == 1:
            assert not torch.is_tensor(g) and np.shape(g) == np.shape(w), name
            if name != "pressure_weight":  # np.empty((1,)): no content
                assert np.array_equal(g, w), name
            continue
        assert g.dtype == torch.float32, name
        assert_parity(g.numpy(), w, np.float32, name)


@pytest.mark.parametrize("passthrough", [False, True])
@pytest.mark.parametrize("sensor", ["MOPITT", "GOSAT"])
def test_regrid_granule_opt_matches_jax(monkeypatch, sensor, passthrough):
    """A satellite_opt granule with the MOPITT_CO / GOSAT_XCH4 constants
    (linear, 1.0 degree, threshold 0.0): onto a 2 degree CTM grid through the
    box filter, and onto a 0.5 x 0.625 degree one, where the fields stay on
    the 1 degree grid and the CTM is flagged for upscaling."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    clon, clat = _region(0.5, 0.625) if passthrough else _region(2.0, 2.0)
    want = jax_regrid_granule(1, 1.0, _opt_granule(sensor), clon, clat, flag_thresh=0.0,
                              device=False)
    got = port_regrid_granule(1, 1.0, convert.satellite_opt_from(_opt_granule(sensor)),
                              clon, clat, "cpu", flag_thresh=0.0, fast_swath=False)
    assert got.ctm_upscaled_needed is passthrough
    _assert_granule_parity(got, want, _OPT_FIELDS)
    assert torch.isfinite(got.vcd).sum() > 50
    assert (np.size(got.aprior_column) == 1) == (sensor == "GOSAT")
    # the native builder regrids the same granule onto the same cells
    fast = port_regrid_granule(1, 1.0, convert.satellite_opt_from(_opt_granule(sensor)),
                               clon, clat, "cpu", flag_thresh=0.0)
    assert fast.vcd.shape == got.vcd.shape
    assert (torch.isfinite(fast.vcd) & torch.isfinite(got.vcd)).sum() > 50


def _ssmis_granule(seed=0):
    import datetime

    from oisat_tpu.datamodel import satellite_ssmis

    rng = np.random.default_rng(seed)
    lon, lat = _region(0.25, 0.25, 24.0, 40.0, -26.0, 6.0)
    vcd = np.abs(rng.normal(20, 5, lat.shape))
    vcd[rng.random(lat.shape) < 0.02] = np.nan
    vcd[:12, :20] = np.nan
    return satellite_ssmis(vcd=vcd, uncertainty=0.05 * vcd,
                           time=datetime.datetime(2019, 7, 15), latitude_center=lat,
                           longitude_center=lon, sensor="SSMIS")


@pytest.mark.parametrize("passthrough", [False, True])
def test_regrid_ssmis_granule_matches_jax(monkeypatch, passthrough):
    """The SSMIS variant: no QA mask, the raw uncertainty through the squared
    kernel with no sqrt, Delaunay-linear both ways with the 1x cutoff."""
    from oisat_tpu.regridder import regrid_ssmis_granule as jax_regrid_ssmis
    from oisat_tpu_torch.regridder import regrid_ssmis_granule as port_regrid_ssmis

    monkeypatch.setenv("OISAT_PARITY", "1")
    clon, clat = _region(0.125, 0.125, 26, 38, -24, 4) if passthrough else _region(0.5, 0.625)
    want = jax_regrid_ssmis(0.25, _ssmis_granule(), clon, clat, device=False)
    got = port_regrid_ssmis(0.25, convert.satellite_ssmis_from(_ssmis_granule()), clon, clat,
                            "cpu", fast_swath=False)
    assert got.ctm_upscaled_needed is passthrough
    _assert_granule_parity(got, want, ("vcd", "uncertainty"))
    both = torch.isfinite(got.vcd) & torch.isfinite(got.uncertainty)
    assert both.sum() > 100
    if not passthrough:  # a 2 x 2 box of the raw error with the squared kernel: ~ err / 4
        ratio = (got.uncertainty[both] / got.vcd[both]).median()
        assert 0.25 * 0.04 < float(ratio) < 0.25 * 0.06
    with pytest.raises(TypeError, match="satellite_ssmis"):
        port_regrid_ssmis(0.25, _opt_granule("MOPITT"), clon, clat, "cpu")


def _gosat_soundings(seed=0, n=400, Ls=4, with_ak=True):
    """Sparse GOSAT soundings (points on the last axis), float32 level stacks."""
    import datetime

    from oisat_tpu.datamodel import satellite_opt

    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = np.abs(rng.normal(1800, 30, n))
    one = np.empty((1,))
    return satellite_opt(
        vcd=x, time=datetime.datetime(2019, 7, 3), profile=[], tropopause=np.empty((1,)),
        latitude_center=rng.uniform(-60, 70, n), longitude_center=rng.uniform(-170, 170, n),
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(10, 2, n)),
        quality_flag=(rng.random(n) > 0.1) * 1.0,
        pressure_mid=(np.sort(rng.uniform(50, 990, (Ls, n)), axis=0)[::-1].astype(f32)
                      if with_ak else one),
        averaging_kernels=rng.uniform(0.2, 1.0, (Ls, n)).astype(f32) if with_ak else one,
        aprior_column=np.zeros((1,)),
        apriori_profile=(np.abs(rng.normal(1800, 40, (Ls, n))).astype(f32)
                         if with_ak else one),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)), x_col=x,
        pressure_weight=np.full((Ls, n), 1.0 / Ls, f32) if with_ak else one, sensor="GOSAT")


@pytest.mark.parametrize("with_ak", [True, False])
def test_filler_gosatxch4_matches_jax(monkeypatch, with_ak):
    """Sparse soundings -> global maps (here 5 degrees): every field in
    float64 at rtol 1e-12, the flag by nearest neighbour, size-1 placeholders
    kept; then the filled granule through both regrids."""
    from oisat_tpu.readers.sensors.gosat import filler_gosatxch4 as jax_filler
    from oisat_tpu_torch.readers.sensors.gosat import filler_gosatxch4 as port_filler

    monkeypatch.setenv("OISAT_PARITY", "1")
    want = jax_filler(5.0, _gosat_soundings(with_ak=with_ak), 0.5)
    got = port_filler(5.0, convert.satellite_opt_from(_gosat_soundings(with_ak=with_ak)),
                      "cpu", 0.5)
    assert got.vcd.shape == (37, 73) and got.sensor == "GOSAT"
    assert np.array_equal(got.latitude_center, want.latitude_center)
    for name in _OPT_FIELDS + ("quality_flag",):
        g, w = getattr(got, name), getattr(want, name)
        assert isinstance(g, np.ndarray) and g.shape == np.shape(w), name
        if np.size(w) > 1:
            assert np.array_equal(np.isnan(g), np.isnan(w)), name
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True, err_msg=name)
    assert np.isfinite(got.vcd).sum() > 300
    assert (np.size(got.averaging_kernels) == 1) == (not with_ak)
    if with_ak:
        clon, clat = np.meshgrid(np.arange(-180.0, 180.0, 10.0), np.arange(-90.0, 90.1, 10.0))
        rj = jax_regrid_granule(1, 5.0, want, clon, clat, flag_thresh=0.0, device=False)
        rp = port_regrid_granule(1, 5.0, got, clon, clat, "cpu", flag_thresh=0.0,
                                 fast_swath=False)
        _assert_granule_parity(rp, rj, _OPT_FIELDS)
    # soundings on one line cannot be triangulated
    line = convert.satellite_opt_from(_gosat_soundings(n=5, with_ak=False))
    line.latitude_center = np.zeros(5)
    assert port_filler(5.0, line, "cpu", 0.5) is None


def test_north_america_window_takes_the_exact_matrix_free_branch():
    """chip_smoke.py phase 13b's window at a small depth: North America
    (20-60 N x 140-60 W) on the MERRA2-GMI grid holds 81 x 129 = 10,449
    cells, above the scan's dense limit and, padded to the sweep block,
    under REFINE_MAX_CELLS (the exact float64 branch); the regional orbits
    cross it.  The CONUS default is unchanged."""
    from oisat_tpu_torch.entry import (CONUS, NORTH_AMERICA, conus_window, merra2_gmi_grid,
                                       synthetic_regional_month)
    from oisat_tpu_torch.ops.oi_full import (DENSE_SCAN_MAX_CELLS, MATFREE_BLOCK,
                                             REFINE_MAX_CELLS)

    lon2d, lat2d = conus_window(NORTH_AMERICA)
    assert lat2d.shape == (81, 129) and lat2d.size == 10_449
    npad = -(-lat2d.size // MATFREE_BLOCK) * MATFREE_BLOCK
    assert DENSE_SCAN_MAX_CELLS < lat2d.size and npad == 11_264 <= REFINE_MAX_CELLS
    glon, glat = merra2_gmi_grid()
    assert np.isin(lat2d[:, 0], glat[:, 0]).all() and np.isin(lon2d[0], glon[0]).all()
    assert np.array_equal(conus_window(CONUS)[0], conus_window()[0])
    orbits, ctm, wlon, wlat = synthetic_regional_month(2, ny=400, nx=30, nz=6, nz_ctm=12,
                                                       window=NORTH_AMERICA)
    assert np.array_equal(wlat, lat2d) and ctm.pressure_mid.shape == (8, 12, 81, 129)
    for o in orbits:
        g = port_regrid_granule(1, 0.25, o, wlon, wlat, "cpu", flag_thresh=0.5)
        assert g is not None and int(torch.isfinite(g.vcd).sum()) > 300
