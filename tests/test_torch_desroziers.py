"""The port's Desroziers re-estimation (oisat_tpu_torch.ops.diagnostics and
the driver's ``oi(desroziers_iterations=...)``) against the JAX package on
the same numpy inputs, on the CPU.

Tolerances.  The estimators: float64 rtol 1e-12, float32 rtol 1e-5 (the
per-band means are float64 row sums in the port, segment sums in the JAX
package).  The driver's scalar OI after two re-estimation passes, in
float64: fields and scales rtol 1e-9 plus that much of the largest
magnitude; the full-covariance OI: rtol 5e-4 (its float32 dense scan,
tests/test_torch_oi_full.py), the knee factor exact.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu.driver import oisatgmi as jax_oisatgmi
from oisat_tpu.ops import diagnostics as jdiag
from oisat_tpu_torch.driver import oisatgmi as port_oisatgmi
from oisat_tpu_torch.ops import diagnostics as tdiag
from tests.test_desroziers import _north_south_analysis

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
OI_FIELDS = ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")


def _analysis(dt, seed=3, H=18, W=22):
    """(xa, y, xb, sa, so) with NaN / inf cells and a cell of zero variance."""
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(5, 0.5, (H, W)))
    y = xa + rng.normal(0, 0.5, (H, W))
    sa = np.abs(rng.normal(0.3, 0.05, (H, W))) ** 2
    so = np.abs(rng.normal(0.4, 0.05, (H, W))) ** 2
    xb = xa + sa / (sa + so) * (y - xa)
    xa[0, :3] = np.nan
    y[1, :2] = np.inf
    so[2, 0] = np.nan
    sa[3, 0] = 0.0
    return [a.astype(dt) for a in (xa, y, xb, sa, so)]


def _assert_estimate(got, want, dt):
    assert got._fields == want._fields == ("so_hat", "sa_hat", "so_scale", "sa_scale", "n")
    for name in got._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=RTOL[dt], atol=0, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_desroziers_estimates_matches_jax(dt):
    args = _analysis(dt)
    got = tdiag.desroziers_estimates(*(torch.as_tensor(a) for a in args))
    want = jdiag.desroziers_estimates(*(jnp.asarray(a) for a in args))
    _assert_estimate(got, want, dt)
    assert got.so_hat.dtype == getattr(torch, np.dtype(dt).name)
    assert int(got.n) == args[0].size - 6


def test_desroziers_scales_fall_back_to_one():
    """A negative or non-finite moment ratio gives scale 1; a huge one clips."""
    xa = torch.zeros(4, 4, dtype=torch.float64)
    y = torch.ones(4, 4, dtype=torch.float64)
    xb = 2.0 * y  # (y - xb)(y - xa) < 0
    est = tdiag.desroziers_estimates(xa, y, xb, 1e-9 * y, y)
    want = jdiag.desroziers_estimates(*(jnp.asarray(a.numpy()) for a in
                                        (xa, y, xb, 1e-9 * y, y)))
    assert float(est.so_scale) == float(want.so_scale) == 1.0
    assert float(est.sa_scale) == float(want.sa_scale) == 1e4
    empty = tdiag.desroziers_estimates(*(torch.full((3, 3), float("nan")),) * 5)
    assert int(empty.n) == 0 and float(empty.so_scale) == float(empty.sa_scale) == 1.0


@pytest.mark.parametrize("n_bins", [1, 3, 7])
def test_lat_band_index_matches_jax(n_bins):
    rng = np.random.default_rng(n_bins)
    lat = rng.uniform(-60, 70, (9, 11))
    lat[0, 0], lat[4, 5], lat[8, 10] = np.nan, np.nan, np.nan
    got, want = tdiag.lat_band_index(lat, n_bins), jdiag.lat_band_index(lat, n_bins)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got[0, 0] == got[4, 5] == got[8, 10] == -1 and got.max() == n_bins - 1
    # an infinite latitude is labelled -1 too, but the band edges come from
    # nanmin / nanmax, which see it: the span is infinite and every finite
    # cell lands in band 0, in both packages
    lat[4, 5] = np.inf
    got, want = tdiag.lat_band_index(lat, n_bins), jdiag.lat_band_index(lat, n_bins)
    assert np.array_equal(got, want) and got[4, 5] == -1 and got.max() == 0
    nowhere = np.full((3, 3), np.nan)
    assert np.array_equal(tdiag.lat_band_index(nowhere, n_bins),
                          jdiag.lat_band_index(nowhere, n_bins))
    flat = np.full((3, 3), 12.0)  # zero span
    assert np.array_equal(tdiag.lat_band_index(flat, n_bins),
                          jdiag.lat_band_index(flat, n_bins))


@pytest.mark.parametrize("n_bins", [1, 4])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_desroziers_binned_matches_jax(dt, n_bins):
    """Per-band moments with cells of label -1 (non-finite latitudes) and an
    empty band (NaN variances, scale 1)."""
    args = _analysis(dt)
    H, W = args[0].shape
    lat = np.linspace(-40.0, 50.0, H)[:, None] * np.ones((H, W))
    lat[5, :4] = np.nan
    bins = tdiag.lat_band_index(lat, n_bins)
    if n_bins > 1:
        bins[bins == 2] = 1  # band 2 holds no cell
    got = tdiag.desroziers_binned(*(torch.as_tensor(a) for a in args),
                                  torch.as_tensor(bins), n_bins)
    want = jdiag.desroziers_binned(*(jnp.asarray(a) for a in args), bins, n_bins)
    _assert_estimate(got, want, dt)
    assert got.so_hat.shape == (n_bins,)
    assert float(got.n.sum()) == args[0].size - 6 - 4
    if n_bins > 1:
        assert torch.isnan(got.so_hat[2]) and float(got.so_scale[2]) == 1.0
    again = tdiag.desroziers_binned(*(torch.as_tensor(a) for a in args),
                                    torch.as_tensor(bins), n_bins)
    for a, b in zip(got, again):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# ---- the driver ---------------------------------------------------------------

def _oi_sessions(sensor="OMI", seed=5, H=12, W=16, nan_lat=True):
    """(port, jax) sessions holding the same averaged fields of a month whose
    prescribed errors are 4x too large, the observation error 3x larger in
    the north; some NaN cells, a negative observation and (``nan_lat``) two
    cells without a latitude."""
    xa, y, sa, so, lat = _north_south_analysis(H, W, seed)
    so = so * 16.0
    y[0, 0], xa[1, 1], y[2, 2] = -0.5, np.nan, np.nan
    lon = np.linspace(-10.0, 10.0, W)[None, :] * np.ones((H, W))
    lat = lat / 4.0 + 35.0
    if nan_lat:
        lat[3, :2] = np.nan
    out = []
    for cls in (port_oisatgmi, jax_oisatgmi):
        obj = cls()
        pair = ("aux2", "aux1") if sensor == "GOSAT" else ("ctm_averaged_vcd",
                                                         "sat_averaged_vcd")
        obj.ctm_averaged_vcd = obj.sat_averaged_vcd = np.full_like(xa, np.nan)
        obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
        setattr(obj, pair[0], xa.copy())
        setattr(obj, pair[1], y.copy())
        obj.sat_averaged_error = np.sqrt(so)
        g = SimpleNamespace(latitude_center=lat, longitude_center=lon,
                            vcd=torch.zeros(H, W))
        obj.reader_obj = SimpleNamespace(sat_data=[None, g])
        out.append(obj)
    return out[0], out[1], 100.0 * 4.0 * 0.4 / float(np.nanmean(xa))


def _assert_oi(pobj, jobj, rtol):
    for name in OI_FIELDS + ("desroziers_sa_scale_map", "desroziers_so_scale_map"):
        got, want = getattr(pobj, name), getattr(jobj, name)
        if want is None:
            assert got is None, name
            continue
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, name
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True, err_msg=name,
                                   atol=rtol * np.nanmax(np.abs(want)))
    assert set(pobj.oi_diagnostics) == set(jobj.oi_diagnostics)
    for k, v in jobj.oi_diagnostics.items():
        if k in ("n", "desroziers_iterations", "desroziers_bins", "solver", "reg",
                 "exact_diag"):
            assert pobj.oi_diagnostics[k] == v, k
        elif k != "f64_resid":
            np.testing.assert_allclose(pobj.oi_diagnostics[k], v, rtol=max(rtol, 1e-7),
                                       atol=max(rtol, 1e-7), err_msg=k)


@pytest.mark.parametrize("sensor", ["OMI", "GOSAT"])
@pytest.mark.parametrize("n_bins", [1, 3])
def test_oi_scalar_desroziers_matches_jax(n_bins, sensor):
    pobj, jobj, e = _oi_sessions(sensor)
    first = port_oisatgmi()
    first.__dict__.update(pobj.__dict__)
    first.oi(sensor, error_ctm=e)
    for obj in (pobj, jobj):
        obj.oi(sensor, error_ctm=e, desroziers_iterations=2, desroziers_bins=n_bins)
    _assert_oi(pobj, jobj, 1e-9)
    d = pobj.oi_diagnostics
    assert d["desroziers_iterations"] == 2 and ("desroziers_bins" in d) == (n_bins > 1)
    assert d["desroziers_sa_scale"] < 0.5 and d["desroziers_so_scale"] < 0.5
    # chi2 moves toward 1 against the first pass
    assert abs(d["chi2"] - 1.0) < 0.1 < abs(first.oi_diagnostics["chi2"] - 1.0)
    if n_bins > 1:
        assert pobj.desroziers_sa_scale_map.shape == pobj.ak_OI.shape
        assert (pobj.desroziers_so_scale_map[3, :2] == 1.0).all()  # label -1 keeps scale 1
        assert d["desroziers_so_scale_max"] > 2.0 * d["desroziers_so_scale_min"]
    else:
        assert pobj.desroziers_sa_scale_map is None


@pytest.mark.parametrize("n_bins", [1, 3])
def test_oi_full_desroziers_matches_jax(n_bins):
    """method="full": the full-covariance solve re-run with the rescaled
    standard deviations; both packages take the dense eigen scan."""
    pobj, jobj, e = _oi_sessions(nan_lat=False)
    kw = dict(error_ctm=e, method="full", length_scale_km=150.0,
              desroziers_iterations=2, desroziers_bins=n_bins)
    jobj.oi("OMI", **kw)
    pobj.oi("OMI", **kw)
    _assert_oi(pobj, jobj, 5e-4)
    assert pobj.oi_diagnostics["desroziers_iterations"] == 2
    assert (pobj.desroziers_sa_scale_map is None) == (n_bins == 1)


def test_oi_resets_the_stale_state_of_a_previous_run():
    """A binned run's scale maps and a Desroziers run's diagnostics must not
    outlive it on the session (scalar and full)."""
    pobj, _, e = _oi_sessions(nan_lat=False)
    pobj.oi("OMI", error_ctm=e, desroziers_iterations=1, desroziers_bins=3)
    assert pobj.desroziers_sa_scale_map is not None
    assert "desroziers_bins" in pobj.oi_diagnostics
    pobj.oi("OMI", error_ctm=e)
    assert pobj.desroziers_sa_scale_map is None and pobj.desroziers_so_scale_map is None
    assert not any(k.startswith("desroziers") for k in pobj.oi_diagnostics)
    pobj.oi("OMI", error_ctm=e, desroziers_iterations=1, desroziers_bins=3)
    pobj.oi("OMI", error_ctm=e, method="full", length_scale_km=150.0)
    assert pobj.desroziers_sa_scale_map is None
    assert not any(k.startswith("desroziers") for k in pobj.oi_diagnostics)
    with pytest.raises(ValueError, match="method"):
        pobj.oi("OMI", error_ctm=e, method="cg")


@pytest.mark.parametrize("n_bins", [1, 3])
def test_oi_desroziers_repeats_bitwise(n_bins):
    runs = []
    for _ in range(2):
        pobj, _, e = _oi_sessions()
        pobj.oi("OMI", error_ctm=e, desroziers_iterations=2, desroziers_bins=n_bins)
        runs.append(pobj)
    for name in OI_FIELDS:
        assert np.array_equal(getattr(runs[0], name), getattr(runs[1], name), equal_nan=True)
    assert runs[0].oi_diagnostics == runs[1].oi_diagnostics
