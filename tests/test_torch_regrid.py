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
from oisat_tpu_torch.ops import regrid as trg
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


def test_analyze_month_fused_refuses_what_is_not_ported(monkeypatch):
    pobj, _ = _month_pair(monkeypatch, n=1)
    for kw, what in ((dict(oi_method="full"), "item 10"),
                     (dict(desroziers_iterations=1), "item 11")):
        with pytest.raises(NotImplementedError, match=what):
            pobj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01", **kw)
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
