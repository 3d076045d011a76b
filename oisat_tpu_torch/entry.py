"""Entry points of the port and its seeded synthetic inputs.

* :func:`entry` is the twin of ``__graft_entry__.entry()``: the flagship step
  (:func:`~oisat_tpu_torch.parallel.analysis.full_month_step`) with the same
  ``_synthetic_full_month`` inputs, drawn here from the same numpy seed.
* :func:`synthetic_month` builds an OMI-NO2-shaped month on the global
  MERRA2-GMI grid: ``n_orbits`` L2 orbits (1644 x 60 pixels, 35 scattering
  weight / pressure levels, the shape of ``bench._synthetic_orbit``) with
  tracks spread over the globe, and a 72-level CTM as a 3-hourly mean
  diurnal cycle.  Host
  numpy only; ``chip_smoke.py`` regrids and analyses it.
* :func:`synthetic_regional_month` builds the same kind of month on the
  CONUS window of that grid (:func:`conus_window`, 5,643 cells) in
  physical units, with observation errors in the production regime of the
  full-covariance OI (``oi_method="full"``).
"""

from __future__ import annotations

import datetime

import numpy as np

from oisat_tpu_torch.convert import full_month_inputs
from oisat_tpu_torch.datamodel import ctm_model, satellite_amf
from oisat_tpu_torch.parallel.analysis import FullMonthInputs, full_month_step

__all__ = ["entry", "synthetic_full_month", "merra2_gmi_grid", "synthetic_orbit",
           "synthetic_ctm", "synthetic_month", "conus_window", "synthetic_regional_month"]

# the CONUS analysis window: 24-52 N x 128-66 W
CONUS = (24.0, 52.0, -128.0, -66.0)


def synthetic_full_month(device, G=4, Ls=6, Lc=12, H=16, W=24, seed=0):
    """``__graft_entry__._synthetic_full_month`` with tensors on ``device``
    (the same draws from ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sat_pmid = np.sort(rng.uniform(100, 950, (G, Ls, H, W)), axis=1)[:, ::-1].astype(f32)
    ctm_pmid = np.sort(rng.uniform(60, 1000, (G, Lc, H, W)), axis=1)[:, ::-1].astype(f32)
    vcd = np.abs(rng.normal(3, 1, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    host = FullMonthInputs(
        sat_pmid=sat_pmid,
        sat_sw=np.abs(rng.normal(1, 0.2, (G, Ls, H, W))).astype(f32),
        vcd=vcd,
        amf=np.abs(rng.normal(2, 0.3, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(1, 0.2, (G, H, W))).astype(f32),
        tropopause=rng.uniform(100, 200, (G, H, W)).astype(f32),
        ctm_pmid=ctm_pmid,
        ctm_pc=np.abs(rng.normal(5, 1, (G, Lc, H, W))).astype(f32),
    )
    return full_month_inputs(host, device)


def entry(device="cuda"):
    """(fn, example_args): a full month of OI data assimilation (AMF recal ->
    monthly stats -> bias -> OI) on ``device`` (the card unless the caller
    asks for ``"cpu"``)."""
    return full_month_step, (synthetic_full_month(device),)


def merra2_gmi_grid():
    """(lon2d, lat2d) of the global MERRA2-GMI grid: 0.5 deg x 0.625 deg,
    361 x 576 cells."""
    lat = np.arange(-90.0, 90.0 + 0.25, 0.5)
    lon = np.arange(-180.0, 180.0, 0.625)
    return np.meshgrid(lon, lat)


def synthetic_orbit(seed, center_lon, ny=1644, nx=60, nz=35, day=1,
                    lat_range=(-82.0, 82.0), width_deg=24.0, error_mean=0.5):
    """One OMI-NO2-shaped L2 orbit (numpy leaves): ``ny`` scanlines pole to
    pole, ``nx`` cross-track pixels ~``width_deg`` wide around
    ``center_lon`` (drifting +-4 deg along track), ``nz`` hybrid-eta
    scattering-weight levels (A + B * psurf, level 0 at the surface), a QA
    channel with 1% bad pixels and a tropopause.  The time is the 13:30
    local overpass of ``day`` July 2019 in UTC at ``center_lon``.  VCDs are
    ~2 (x 1e15 molec/cm2, the unit of :func:`synthetic_ctm`'s columns), the
    pixel uncertainty ``error_mean`` +- 20%."""
    rng = np.random.default_rng(seed)
    along = np.linspace(lat_range[0], lat_range[1], ny)[:, None]
    across = np.linspace(-width_deg / 2, width_deg / 2, nx)[None, :]
    lat = along + 0.02 * rng.standard_normal((ny, nx))
    drift = 4.0 * np.sin(np.linspace(0.0, np.pi, ny))[:, None]
    lon = center_lon + across + drift + 0.02 * rng.standard_normal((ny, nx))
    eta_a = np.linspace(0.0, 100.0, nz)
    eta_b = np.linspace(1.0, 0.02, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((ny, nx))
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.01] = 0.0
    return satellite_amf(
        vcd=np.abs(2.0 + np.sin(np.radians(lon) * 3.0) * np.cos(np.radians(lat) * 2.0)
                   + 0.3 * rng.standard_normal((ny, nx))),
        amf=np.abs(rng.normal(1.5, 0.2, (ny, nx))),
        time=(datetime.datetime(2019, 7, day)
              + datetime.timedelta(hours=(13.5 - center_lon / 15.0) % 24.0)),
        tropopause=rng.uniform(100.0, 250.0, (ny, nx)),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(error_mean, 0.2 * error_mean, (ny, nx))),
        quality_flag=qa,
        pressure_mid=eta_a[:, None, None] + eta_b[:, None, None] * psurf[None],
        scattering_weights=np.abs(rng.normal(1.0, 0.2, (nz, ny, nx))),
        ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
        old_amf=[], new_amf=[],
    )


def synthetic_ctm(lon2d, lat2d, seed=0, nt=8, nz=72, dtype=np.float32):
    """A GMI-like CTM month as its mean diurnal cycle on the given grid
    (``averaged=True``: granules match a snapshot by hour of day): ``nt``
    3-hourly snapshots of ``nz``-level NO2 profiles [ppbv], layer
    thicknesses [hPa] and mid-level pressures on sigma-pressure levels
    (hybrid-eta with A = 0) from the surface (~1000 hPa) to ~0.02 hPa."""
    rng = np.random.default_rng(seed)
    hw = lat2d.shape
    sigma = np.geomspace(1.0, 2e-5, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((nt,) + hw)
    pmid = sigma[None, :, None, None] * psurf[:, None]
    dp = np.abs(np.gradient(pmid, axis=1))
    # ~0.5 ppbv NO2 concentrated in the boundary layer: a few 1e15 molec/cm2
    shape = np.exp(-np.arange(nz) / 8.0)[None, :, None, None]
    prof = 0.4 * shape * np.abs(rng.normal(0.5, 0.15, (nt, nz) + hw))
    times = [datetime.datetime(2019, 7, 15, 3 * h) for h in range(nt)]
    return ctm_model(lat2d, lon2d, times, prof.astype(dtype), pmid.astype(dtype), [],
                     dp.astype(dtype), "GMI", True)


def synthetic_month(n_orbits=60, seed=0):
    """(orbits, ctm, ctm_lon2d, ctm_lat2d) on the host: ``n_orbits``
    OMI-shaped orbits spread evenly over longitude (and over the days of
    July 2019) and the 72-level, 8-snapshot CTM on the MERRA2-GMI grid."""
    lon2d, lat2d = merra2_gmi_grid()
    centers = np.linspace(-160.0, 160.0, n_orbits)
    orbits = [synthetic_orbit(seed + 1 + i, c, day=1 + i % 28)
              for i, c in enumerate(centers)]
    return orbits, synthetic_ctm(lon2d, lat2d, seed=seed), lon2d, lat2d


def conus_window():
    """(lon2d, lat2d): the rows and columns of :func:`merra2_gmi_grid` in
    ``CONUS`` (24-52 N x 128-66 W), 57 x 99 = 5,643 cells -- under the
    full-covariance scan's 6,144-cell dense limit and close to it."""
    lon2d, lat2d = merra2_gmi_grid()
    lat_s, lat_n, lon_w, lon_e = CONUS
    rows = (lat2d[:, 0] >= lat_s) & (lat2d[:, 0] <= lat_n)
    cols = (lon2d[0] >= lon_w) & (lon2d[0] <= lon_e)
    return lon2d[np.ix_(rows, cols)], lat2d[np.ix_(rows, cols)]


# pixel uncertainty of the regional month (x 1e15 molec/cm2): after the
# regrid and the monthly average of 60 orbits it puts sigma_b / sigma_o =
# 0.5 xa / sigma_o near 100 on the median cell and max sigma_b / min sigma_o
# near 200 (chip_smoke.py prints both), the tight regime of monthly
# averages in which the full OI's float64 exact tail runs
# ((max sigma_b sqrt(r) / min sigma_o)^2 > 1e4 for the factors r the knee
# picks here); production months reach 150-300, where the float32 scan's
# knee is rounding noise (ROADMAP queue 3), so the month stays below them
REGIONAL_ERROR_MEAN = 0.1


def synthetic_regional_month(n_orbits=60, seed=0, ny=1644, nx=60, nz=35, nz_ctm=72,
                             error_mean=REGIONAL_ERROR_MEAN):
    """(orbits, ctm, ctm_lon2d, ctm_lat2d) on the host for the CONUS window:
    ``n_orbits`` OMI-shaped orbits (``ny`` x ``nx`` pixels pole to pole,
    ``nz`` levels) whose tracks cross the window, spread over its
    longitudes and over days 1-28 of July 2019, with the pixel uncertainty
    ``error_mean``, and the ``nz_ctm``-level, 8-snapshot CTM on the
    window."""
    lon2d, lat2d = conus_window()
    lon_w, lon_e = float(lon2d.min()), float(lon2d.max())
    centers = np.linspace(lon_w + 4.0, lon_e - 4.0, n_orbits)
    orbits = [synthetic_orbit(seed + 1 + i, c, ny=ny, nx=nx, nz=nz, day=1 + i % 28,
                              error_mean=error_mean)
              for i, c in enumerate(centers)]
    return orbits, synthetic_ctm(lon2d, lat2d, seed=seed, nz=nz_ctm), lon2d, lat2d
