"""The reference's full-covariance OI (``benchmark/reference_full_oi.py``) at
tiny sizes on the CPU, with the curve exact and with the SLQ estimate:

* it agrees with a direct ``numpy.linalg`` float64 solve of the same
  definitions, its curves with the same definitions summed directly;
* the blocked in-place Cholesky and its blocked solves equal unblocked ones;
* cells that are not valid come back NaN;
* the check of an ``oi_method: full`` month fails what it has to fail: the
  float32 control; the posterior returned as the prior; ``error_OI``
  replaced by the per-cell scalar closure ``bd so^2 / (bd + so^2)``; the
  increment of the wrong length scale (L / 2).  The faults are planted in
  the float64 reference put in the program's place, which reads correct
  unplanted.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check as C
from benchmark import generators as G
from benchmark import reference as R
from benchmark import reference_full_oi as F
from benchmark.tests.test_harness_control import Judged, correct
from benchmark.tests.tiny import tiny_cell

CELLS = ("omi_no2.scalar_month", "mopitt_co.scalar_month")
# the most valid cells whose curve is exact: the default, and one under the
# test sizes, which sends them to the SLQ estimate
BRANCHES = {"exact": F.DENSE_CURVE_MAX_CELLS, "slq": 20}
L_KM = 300.0


def patch(n_lat=12, n_lon=15, seed=0, ratio=3.0):
    """Fields on a 1 deg patch: xa, y, sigma_b, sigma_o, lat, lon (numpy),
    sigma_b / sigma_o about ``ratio``."""
    rng = np.random.default_rng(seed)
    lat, lon = np.meshgrid(np.linspace(30.0, 41.0, n_lat), np.linspace(-100.0, -86.0, n_lon),
                           indexing="ij")
    xa = 2.0 + np.sin(lat / 3.0) + 0.3 * rng.random(lat.shape)
    y = xa * (1.0 + 0.2 * rng.standard_normal(lat.shape))
    sb = 0.1 * xa
    so = sb / ratio * (0.5 + rng.random(lat.shape))
    return xa, y, sb, so, lat, lon


def direct_b(sb, lat, lon, length_scale_km=L_KM):
    la, lo = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)], 1)
    kappa = (6371.0 / length_scale_km) ** 2
    return np.outer(sb.ravel(), sb.ravel()) * np.exp(-kappa * (1.0 - u @ u.T))


def direct_oi(xa, y, sb, so, lat, lon, r):
    """xb, ak, increment, error by dense numpy solves: Sb = rB - rB A^-1 rB."""
    b = direct_b(sb, lat, lon)
    xa, y, so = xa.ravel(), np.maximum(y.ravel(), 0.0), so.ravel()
    a = r * b + np.diag(so ** 2)
    xb = xa + r * b @ np.linalg.solve(a, y - xa)
    sbd = np.diag(r * b - r * b @ np.linalg.inv(a) @ (r * b))
    return xb, 1.0 - sbd / (r * np.diag(b)), xb - xa, np.sqrt(sbd)


def direct_curve(b, so, probes=None):
    """meanAK(r) summed directly: over every cell, or with ``probes`` z as
    the probe average of z^T D^-1 B A^-1 B z."""
    out = []
    for r in R.REGS:
        m = b @ np.linalg.solve(r * b + np.diag(so ** 2), b)
        if probes is None:
            q = np.sum(np.diag(m) / np.diag(b))
        else:
            q = np.mean(np.einsum("ip,ij,jp->p", probes / np.diag(b)[:, None], m, probes))
        out.append(r * q / b.shape[0])
    return np.array(out)


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_full_oi_matches_a_direct_float64_solve(branch):
    xa, y, sb, so, lat, lon = patch()
    *got, info = F.full_oi(t64(xa), t64(y), t64(sb), t64(so), lat, lon, L_KM, torch.float64,
                           dense_max=BRANCHES[branch], block=7)
    assert info["curve"] == branch and info["n"] == xa.size
    for g, want in zip(got, direct_oi(xa, y, sb, so, lat, lon, info["reg"])):
        np.testing.assert_allclose(g.numpy().ravel(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


def test_exact_curve_and_its_knee_match_the_direct_curve():
    xa, y, sb, so, lat, lon = patch()
    b = direct_b(sb, lat, lon)
    want = direct_curve(b, so.ravel())
    got = F.exact_curve(t64(b), t64(so.ravel()), torch.ones(b.shape[0], dtype=torch.bool))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    *_, info = F.full_oi(t64(xa), t64(y), t64(sb), t64(so), lat, lon, L_KM, torch.float64)
    assert info["knee"] == R.kneedle_index(R.REGS, want, fallback=0)


def test_slq_curve_matches_the_probe_average():
    """At sigma_b / sigma_o ~ 1 sixty Lanczos steps price every probe's
    quadratic form to rounding, so the estimate equals the probes' exact
    average (the draw: ``default_rng(0)`` over the padded count)."""
    _, _, sb, so, lat, lon = patch(ratio=1.0)
    b = direct_b(sb, lat, lon)
    n = b.shape[0]
    z = np.random.default_rng(0).choice([-1.0, 1.0], size=(F.SLQ_PAD, F.SLQ_PROBES))[:n]
    got = F.slq_curve(t64(b), t64(so.ravel()), torch.ones(n, dtype=torch.bool))
    np.testing.assert_allclose(got, direct_curve(b, so.ravel(), z), rtol=1e-10)


@pytest.mark.parametrize("block", [5, 16, 64])
def test_blocked_cholesky_and_solves_equal_unblocked(block):
    rng = np.random.default_rng(block)
    m = rng.standard_normal((37, 37))
    a = m @ m.T + 37.0 * np.eye(37)
    lf = F.cholesky_(t64(a).clone(), block)
    want = np.linalg.cholesky(a)
    np.testing.assert_allclose(np.tril(lf.numpy()), want, rtol=0, atol=1e-12 * np.abs(want).max())
    rhs = rng.standard_normal((37, 3))
    x = F.backward_(lf, F.forward_(lf, t64(rhs).clone(), 0, block), block)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, rhs), rtol=1e-10)
    np.testing.assert_allclose(F.inverse_diag(lf, block).numpy(), np.diag(np.linalg.inv(a)),
                               rtol=1e-10)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_cells_that_are_not_valid_come_back_nan(branch):
    xa, y, sb, so, lat, lon = patch()
    xa[0, 0] = np.nan
    y[1, 2] = np.nan
    sb[2, 3] = np.inf
    so[3, 4] = 0.0
    so[4, 5] = np.nan
    lat = lat.copy()
    lon = lon.copy()
    lat[5, 6] = np.nan
    lon[6, 7] = np.nan
    bad = np.zeros(xa.shape, bool)
    for ij in ((0, 0), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7)):
        bad[ij] = True
    *got, info = F.full_oi(t64(xa), t64(y), t64(sb), t64(so), lat, lon, L_KM, torch.float64,
                           dense_max=BRANCHES[branch], block=16)
    assert info["n"] == xa.size - bad.sum()
    for g in got:
        g = g.numpy()
        assert g.shape == xa.shape
        assert np.isnan(g[bad]).all() and np.isfinite(g[~bad]).all()


# ---------------------------------------------------------------------------
# the check of a full-OI month
# ---------------------------------------------------------------------------

def full_cell(name):
    cell = tiny_cell(name)
    cell.mix = dict(cell.mix, control={"oi_method": "full"})
    return cell


def reference_in_place(cell, seed, prec):
    """(raw, ctm, fields, info, granules, grid): the reference's month in
    ``prec``, with its regridded granules and grid as a program's."""
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, seed)
    kept = {}
    fields, info = R.month_reference(raw, ctm, lon2d, lat2d, cell.config, cell.mix, prec,
                                     torch.device("cpu"),
                                     on_regrid=lambda i, r: kept.__setitem__(i, r))
    grans = [type("G", (), kept[i]) for i in range(len(raw))]
    return raw, ctm, fields, info, grans, kept[0]["grid"]


def planted(fields, info, grid, ctrl, fault):
    f = dict(fields)
    xa, so = f["ctm_averaged_vcd"], f["sat_averaged_error"]
    bd = info["reg"] * (xa * ctrl["ctm_error"] / 100.0) ** 2
    if fault == "prior":
        f["ctm_averaged_vcd_corrected"] = xa.copy()
        f["increment_OI"] = np.zeros_like(xa)
        f["ak_OI"] = np.zeros_like(xa)
        f["error_OI"] = np.abs(xa) * ctrl["ctm_error"] / 100.0
    elif fault == "scalar_error":
        f["error_OI"] = np.sqrt(bd * so ** 2 / (bd + so ** 2))
    elif fault == "half_length":
        xb, _, inc, _, _ = F.full_oi(t64(xa), t64(f["sat_averaged_vcd"]),
                                     t64(xa * ctrl["ctm_error"] / 100.0), t64(so), grid[0],
                                     grid[1], L_KM / 2.0, torch.float64)
        f["ctm_averaged_vcd_corrected"], f["increment_OI"] = xb.numpy(), inc.numpy()
    return f


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["none", "prior", "scalar_error", "half_length"])
def test_a_full_oi_month_with_a_fault_is_not_correct(name, branch, fault, monkeypatch):
    monkeypatch.setattr(F, "DENSE_CURVE_MAX_CELLS", BRANCHES[branch])
    cell = full_cell(name)
    raw, ctm, fields, info, grans, grid = reference_in_place(cell, 31, R.Precision.reference())
    assert info["curve"] == branch
    f = planted(fields, info, grid, cell.config["control"], fault)
    checks = C.check(cell, 31, raw, ctm, Judged(f, grans), "cpu")
    if fault == "none":
        assert correct(checks) and checks["oi"][0] == 0.0, checks
    else:
        assert not correct(checks), checks
        assert checks["oi"][0] > checks["oi"][1], checks


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("name", CELLS)
def test_the_full_oi_control_is_not_correct(name, branch, monkeypatch):
    monkeypatch.setattr(F, "DENSE_CURVE_MAX_CELLS", BRANCHES[branch])
    cell = full_cell(name)
    raw, ctm, fields, info, grans, _ = reference_in_place(
        cell, 32, R.Precision.control(cell.config["precision"]))
    assert info["curve"] == branch
    checks = C.check(cell, 32, raw, ctm, Judged(fields, grans), "cpu")
    assert not correct(checks), checks
    assert checks["oi"][0] > checks["oi"][1], checks
