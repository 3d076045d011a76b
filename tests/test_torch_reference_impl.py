"""The port against the independent float64 NumPy goldens of
tests/reference_impl.py, on the CPU, at the tolerances the JAX package's
own tests use for the same goldens (tests/test_oi.py, test_vertical.py,
test_pipeline.py, test_parity_composed.py)."""

import warnings

import numpy as np
import pytest
import torch

from oisat_tpu_torch import convert
from oisat_tpu_torch.ops.averaging import monthly_stats
from oisat_tpu_torch.ops.oi import oi
from oisat_tpu_torch.ops.vertical import (
    air_partial_column,
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    amf_recal_fields,
    partial_column,
)
from oisat_tpu_torch.regridder import make_upscaler, regrid_granule
from tests.reference_impl import (
    ak_conv_gosat_pixelwise,
    ak_conv_mopitt_pixelwise,
    amf_recal_pixelwise,
    error_average_numpy,
    interpolator_amf_scipy,
    oi_numpy,
    upscaler_scipy,
)
from tests.test_oi import make_fields
from tests.test_pipeline import ctm_grid, synthetic_granule
from tests.test_vertical import column_setup

torch.set_num_threads(1)


def _t(*arrays, dtype=None):
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oi_matches_numpy_f64(seed):
    xa, y, sa, so = make_fields(seed)
    ref_xb, ref_ak, ref_inc, ref_err, ref_idx, ref_curve = oi_numpy(xa, y, sa, so)
    res = oi(*_t(xa, y, sa, so))
    assert int(res.reg_index) == ref_idx
    for got, want in ((res.curve, ref_curve), (res.xb, ref_xb), (res.averaging_kernel, ref_ak),
                      (res.increment, ref_inc), (res.error, ref_err)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


def test_oi_f32_and_unregularized_match_numpy():
    xa, y, sa, so = make_fields(3)
    ref_xb, _, _, ref_err, ref_idx, _ = oi_numpy(xa, y, sa, so)
    res = oi(*_t(xa, y, sa, so, dtype=torch.float32))
    assert int(res.reg_index) == ref_idx
    np.testing.assert_allclose(res.xb.numpy(), ref_xb, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.error.numpy(), ref_err, rtol=1e-4, atol=1e-6)
    xa, y, sa, so = make_fields(4)
    ref = oi_numpy(xa, y, sa, so, regularization_on=False)
    res = oi(*_t(xa, y, sa, so), regularization_on=False)
    assert float(res.reg_factor) == 1.0
    np.testing.assert_allclose(res.xb.numpy(), ref[0], rtol=1e-8, atol=1e-12)


def test_monthly_error_matches_error_average_numpy():
    rng = np.random.default_rng(0)
    G, H, W = 5, 7, 9
    err = np.abs(rng.normal(1, 0.2, (G, H, W)))
    err[rng.random((G, H, W)) < 0.2] = np.nan
    err[1, 2, 3] = np.inf
    vcd = np.abs(rng.normal(2, 0.5, (G, H, W)))
    stats = monthly_stats(*_t(vcd, err, vcd, vcd, vcd))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = error_average_numpy(err ** 2)
    np.testing.assert_allclose(stats.sat_error.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("with_trop", [True, False])
def test_amf_recal_matches_pixelwise(with_trop):
    sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop = column_setup()
    pc = partial_column(*_t(dp, prof)).numpy()
    ref = amf_recal_pixelwise(sat_pmid, sat_sw, ctm_pmid, pc, trop if with_trop else None, vcd,
                              amf_old)
    got = amf_recal_fields(*_t(sat_pmid, sat_sw, ctm_pmid, pc,
                               trop if with_trop else np.zeros_like(vcd), vcd, amf_old),
                           with_trop)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9, atol=1e-12)


def test_ak_conv_mopitt_matches_pixelwise():
    rng = np.random.default_rng(5)
    H, W, Ls, Lc = 10, 12, 9, 47
    sat_pmid = np.sort(rng.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(80, 20, (Lc, H, W)))
    dp = rng.uniform(5, 30, (Lc, H, W))
    airpc = air_partial_column(*_t(dp)).numpy()
    aks = rng.uniform(0, 0.6, (Ls + 1, H, W))
    aprior_col = np.abs(rng.normal(2, 0.3, (H, W)))
    apriori_profile = np.abs(rng.normal(80, 15, (Ls, H, W)))
    apriori_surface = np.abs(rng.normal(90, 10, (H, W)))
    vcd = np.abs(rng.normal(2, 0.5, (H, W)))
    vcd[rng.random((H, W)) < 0.2] = np.nan
    args = (ctm_pmid, prof, airpc, sat_pmid, aks, aprior_col, apriori_profile, apriori_surface,
            vcd)
    ref = ak_conv_mopitt_pixelwise(*args)
    got = ak_conv_mopitt_fields(*_t(*args))
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-9, atol=1e-12)


def test_ak_conv_gosat_matches_pixelwise():
    rng = np.random.default_rng(6)
    H, W, Ls, Lc = 8, 9, 20, 72
    sat_pmid = np.sort(rng.uniform(50, 990, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(1800, 100, (Lc, H, W)))
    aks = rng.uniform(0, 1.2, (Ls, H, W))
    apriori_profile = np.abs(rng.normal(1800, 80, (Ls, H, W)))
    pw = rng.uniform(0, 0.1, (Ls, H, W))
    x_col = np.abs(rng.normal(1.8, 0.1, (H, W)))
    x_col[rng.random((H, W)) < 0.2] = np.nan
    args = (ctm_pmid, prof, sat_pmid, aks, apriori_profile, pw, x_col)
    ref = ak_conv_gosat_pixelwise(*args)
    got = ak_conv_gosat_fields(*_t(*args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("error", [False, True])
def test_upscaler_matches_scipy(error):
    """The fine grid -> CTM grid map (box filter + KD-nearest, 2x cutoff)
    with the scipy builders, against the reference's ``_upscaler``."""
    clon, clat = ctm_grid()
    gs = 0.25
    lons, lats = np.meshgrid(np.arange(clon.min(), clon.max() + gs, gs),
                             np.arange(clat.min(), clat.max() + gs, gs))
    z = np.sin(np.radians(lons) * 7.0) * np.cos(np.radians(lats) * 5.0) + 2.0
    z[np.random.default_rng(2).random(z.shape) < 0.05] = np.nan
    thr = np.hypot(abs(clon[0, 0] - clon[0, 1]), abs(clat[0, 0] - clat[1, 0]))
    _, _, ref, needed = upscaler_scipy(lons, lats, z, clon, clat, gs, thr, error=error)
    up = make_upscaler(lons, lats, clon, clat, gs, thr, "cpu", method=4, far_factor=2.0,
                       fast=False)
    assert up.needed is needed is False
    got = up.apply(torch.as_tensor(z), error=error).numpy()
    assert np.isfinite(ref).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("method", [1, 2, 4])
def test_regrid_granule_matches_composed_reference(method):
    g = synthetic_granule(0, 4)
    clon, clat = ctm_grid()
    ref = interpolator_amf_scipy(method, 0.25, g, clon, clat, flag_thresh=0.5)
    got = regrid_granule(method, 0.25, convert.satellite_amf_from(g), clon, clat, "cpu",
                         flag_thresh=0.5, dtype=np.float64, fast_swath=False)
    assert (ref is None) == (got is None)
    for name in ("vcd", "amf", "tropopause", "uncertainty", "scattering_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), ref[name], rtol=1e-9,
                                   atol=1e-11, err_msg=name)
    np.testing.assert_allclose(got.pressure_mid.numpy(), ref["pressure_mid"], rtol=1e-9,
                               atol=1e-9)
    assert got.ctm_upscaled_needed == ref["upneeded"] == False  # noqa: E712
