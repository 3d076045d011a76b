"""Entry points of the port and its seeded synthetic inputs.

* :func:`entry` is the twin of ``__graft_entry__.entry()``: the flagship step
  (:func:`~oisat_tpu_torch.parallel.analysis.full_month_step`) with the same
  ``_synthetic_full_month`` inputs, drawn here from the same numpy seed.
* :func:`dryrun_multichip` is the twin of ``__graft_entry__.dryrun_multichip``:
  every granule kind's sharded month step, one regrid and one matrix-free
  full OI over a mesh, on the small inputs of :func:`synthetic_full_month`,
  :func:`synthetic_mopitt_step_inputs`, :func:`synthetic_gosat_step_inputs`
  and :func:`synthetic_ssmis_step_inputs` (the JAX twins' draws).
* :func:`synthetic_month` builds an OMI-NO2-shaped month on the global
  MERRA2-GMI grid: ``n_orbits`` L2 orbits (1644 x 60 pixels, 35 scattering
  weight / pressure levels, the shape of ``bench._synthetic_orbit``) with
  tracks spread over the globe, and a 72-level CTM as a 3-hourly mean
  diurnal cycle.  Host
  numpy only; ``chip_smoke.py`` regrids and analyses it.
* :func:`synthetic_regional_month` builds the same kind of month on a
  window of that grid (:func:`conus_window`: by default CONUS, 5,643 cells;
  ``NORTH_AMERICA``, TEMPO's field of regard, 10,449 cells) in physical
  units, with observation errors in the production regime of the
  full-covariance OI (``oi_method="full"``).
* :func:`synthetic_mopitt_month`, :func:`synthetic_gosat_month` and
  :func:`synthetic_ssmis_month` build months of the other granule kinds at
  their products' own widths (MOPITT CO daily L3 on its 1 degree grid with 9
  retrieval levels and the 10-row averaging kernel; GOSAT XCH4 as sparse
  20-level soundings; SSMIS water vapour as monthly 0.25 degree maps), each
  with a 72-level CTM of its gas on the MERRA2-GMI grid.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.convert import (
    full_month_inputs,
    gosat_month_inputs,
    mopitt_month_inputs,
    ssmis_month_inputs,
)
from oisat_tpu_torch.datamodel import ctm_model, satellite_amf, satellite_opt, satellite_ssmis
from oisat_tpu_torch.parallel.analysis import (
    FullMonthInputs,
    GosatMonthInputs,
    MopittMonthInputs,
    SsmisMonthInputs,
    full_month_step,
    make_full_month_step,
    make_gosat_month_step,
    make_mopitt_month_step,
    make_ssmis_month_step,
)
from oisat_tpu_torch.parallel.mesh import factor2, make_mesh

__all__ = ["entry", "dryrun_multichip", "synthetic_full_month", "synthetic_mopitt_step_inputs",
           "synthetic_gosat_step_inputs", "synthetic_ssmis_step_inputs", "merra2_gmi_grid", "synthetic_orbit",
           "synthetic_ctm", "synthetic_month", "conus_window", "synthetic_regional_month",
           "synthetic_mopitt_day", "synthetic_mopitt_month", "synthetic_gosat_day",
           "synthetic_gosat_month", "synthetic_ssmis_map", "synthetic_ssmis_month"]

# analysis windows (south, north, west, east): CONUS, 24-52 N x 128-66 W;
# North America as TEMPO's field of regard, 20-60 N x 140-60 W
CONUS = (24.0, 52.0, -128.0, -66.0)
NORTH_AMERICA = (20.0, 60.0, -140.0, -60.0)


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


def synthetic_mopitt_step_inputs(device, G=4, Ls=9, Lc=12, H=16, W=24, seed=1):
    """``__graft_entry__._synthetic_mopitt_month`` (its dense fields) with
    tensors on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ctm_pmid = np.sort(rng.uniform(60, 1000, (G, Lc, H, W)), axis=1)[:, ::-1].astype(f32)
    sat_pmid = np.sort(rng.uniform(100, 950, (G, Ls, H, W)), axis=1)[:, ::-1].astype(f32)
    prof = np.abs(rng.normal(90, 10, (G, Lc, H, W))).astype(f32)
    vcd = np.abs(rng.normal(2, 0.5, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    host = MopittMonthInputs(
        ctm_pmid=ctm_pmid, ctm_profile=prof,
        ctm_airpc=np.abs(rng.normal(2000, 100, (G, Lc, H, W))).astype(f32),
        sat_pmid=sat_pmid,
        aks=rng.uniform(0.1, 0.9, (G, Ls + 1, H, W)).astype(f32),
        apriori_profile=np.abs(rng.normal(80, 10, (G, Ls, H, W))).astype(f32),
        aprior_col=np.abs(rng.normal(2, 0.3, (G, H, W))).astype(f32),
        apriori_surface=np.abs(rng.normal(85, 8, (G, H, W))).astype(f32),
        vcd=vcd,
        x_col=np.abs(rng.normal(0.09, 0.01, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(0.2, 0.05, (G, H, W))).astype(f32),
    )
    return mopitt_month_inputs(host, device)


def synthetic_gosat_step_inputs(device, G=4, Ls=7, Lc=12, H=16, W=24, seed=3):
    """``__graft_entry__._synthetic_gosat_month`` with tensors on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ctm_pmid = np.sort(rng.uniform(60, 1000, (G, Lc, H, W)), axis=1)[:, ::-1].astype(f32)
    sat_pmid = np.sort(rng.uniform(100, 950, (G, Ls, H, W)), axis=1)[:, ::-1].astype(f32)
    pw = np.abs(rng.normal(1.0 / Ls, 0.02, (G, Ls, H, W))).astype(f32)
    vcd = np.abs(rng.normal(4, 0.5, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    host = GosatMonthInputs(
        ctm_pmid=ctm_pmid,
        ctm_profile=np.abs(rng.normal(1800, 100, (G, Lc, H, W))).astype(f32),
        sat_pmid=sat_pmid,
        aks=rng.uniform(0.2, 1.1, (G, Ls, H, W)).astype(f32),
        apriori_profile=np.abs(rng.normal(1750, 80, (G, Ls, H, W))).astype(f32),
        pressure_weight=pw,
        vcd=vcd,
        x_col=np.abs(rng.normal(1800, 30, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(10, 2, (G, H, W))).astype(f32),
    )
    return gosat_month_inputs(host, device)


def synthetic_ssmis_step_inputs(device, G=4, Lc=12, H=16, W=24, seed=2):
    """``__graft_entry__._synthetic_ssmis_month`` with tensors on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    vcd = np.abs(rng.normal(20, 5, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    host = SsmisMonthInputs(
        water_pc=np.abs(rng.normal(3000, 300, (G, Lc, H, W))).astype(f32),
        vcd=vcd,
        uncertainty=np.abs(rng.normal(1.0, 0.2, (G, H, W))).astype(f32),
    )
    return ssmis_month_inputs(host, device)


def entry(device="cuda"):
    """(fn, example_args): a full month of OI data assimilation (AMF recal ->
    monthly stats -> bias -> OI) on ``device`` (the card unless the caller
    asks for ``"cpu"``)."""
    return full_month_step, (synthetic_full_month(device),)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The twin of ``__graft_entry__.dryrun_multichip`` (its Eta step aside):
    a mesh of ``n_devices`` logical shards of ``device`` (the card unless
    the caller asks for the CPU; granules over 'obs', grid rows over
    'grid'), one sharded step of every granule kind on deliberately
    non-divisible shapes (G = 2a + 1 granules, H = 4b + 1 rows for an
    a x b mesh): full (AMF recalculation), MOPITT, GOSAT (the xcol pair;
    model VCD all NaN) and SSMIS; then one granule's regrid over the mesh
    and the mesh-sharded matrix-free full OI.  Asserts what the twin
    asserts and returns the regularization factors."""
    from oisat_tpu_torch.ops.oi_full import oi_full_matfree
    from oisat_tpu_torch.regridder import regrid_granule, regrid_mesh

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    a, b = factor2(n_devices)
    G, H, W = 2 * a + 1, 4 * b + 1, 24
    reg = {}
    for kind, maker, inputs in (
            ("amf", make_full_month_step, synthetic_full_month(dev, G=G, H=H, W=W)),
            ("opt", make_mopitt_month_step, synthetic_mopitt_step_inputs(dev, G=G, H=H, W=W)),
            ("gosat", make_gosat_month_step, synthetic_gosat_step_inputs(dev, G=G, H=H, W=W)),
            ("ssmis", make_ssmis_month_step, synthetic_ssmis_step_inputs(dev, G=G, H=H, W=W))):
        fn, shard = maker(mesh)
        out = fn(shard(inputs))
        assert tuple(out.oi.xb.shape) == (H, W), (kind, out.oi.xb.shape)
        if kind == "gosat":
            # GOSAT mode: the model VCD is NaN by design; the xcol pair carries the OI
            assert bool(torch.isnan(out.ctm_vcd).all())
            assert int(torch.isfinite(out.oi.xb).sum()) > 0
        else:
            assert bool(torch.isfinite(out.scaling_factor).all()), kind
        reg[kind] = float(out.oi.reg_factor)

    rng = np.random.default_rng(11)
    ny, nx, nz = 60, 40, 4
    clon2, clat2 = np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    gran = satellite_amf(
        vcd=np.abs(rng.normal(3, 1, (ny, nx))),
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))),
        time=datetime.datetime(2019, 7, 10, 13), tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
        quality_flag=np.ones((ny, nx)),
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)), axis=0)[::-1].copy(),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
    )
    with regrid_mesh(mesh):
        g = regrid_granule(1, 0.25, gran, clon2, clat2, dev, flag_thresh=0.5)
    assert g is not None and int(torch.isfinite(g.vcd).sum()) > 0

    mh, mw = 16, 32
    mlon, mlat = np.meshgrid(np.linspace(-3, 3, mw), np.linspace(38, 44, mh))
    mxa = np.abs(rng.normal(0.8, 0.1, (mh, mw))).ravel()
    my = mxa * rng.uniform(0.9, 1.2, mh * mw)
    _, _, minc, _, minfo = oi_full_matfree(
        mxa, my, 0.5 * mxa, np.full(mh * mw, 0.1), mlat.ravel(), mlon.ravel(), 300.0,
        block=128, precond="nystrom", nystrom_k=128, refine=0, device=dev, mesh=mesh)
    assert np.isfinite(minc).all() and minfo["cg_resid"] < 1e-3
    print(f"dryrun_multichip OK on {n_devices} logical shards of {dev} (mesh {a}x{b} "
          f"obs x grid); reg factors amf {reg['amf']:.2f} / opt {reg['opt']:.2f} / "
          f"gosat {reg['gosat']:.2f} / ssmis {reg['ssmis']:.2f}; sharded regrid "
          f"{g.vcd.numel()} CTM cells; sharded matfree resid {minfo['cg_resid']:.1e}")
    return reg


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


# (twice the surface mixing ratio, e-folding depth in levels) of the CTM
# profile of each gas: ~0.2 ppbv of NO2 in the boundary layer (a few 1e15
# molec/cm2), ~90 ppbv of CO and ~1800 ppbv of CH4 through the troposphere,
# and a humidity whose column is ~25 in the unit the PWV operator sums to
CTM_GASES = {"NO2": (0.4, 8.0), "CO": (180.0, 40.0), "CH4": (3600.0, 400.0),
             "H2O": (8.0e6, 8.0)}


def synthetic_ctm(lon2d, lat2d, seed=0, nt=8, nz=72, dtype=np.float32, gas="NO2"):
    """A GMI-like CTM month as its mean diurnal cycle on the given grid
    (``averaged=True``: granules match a snapshot by hour of day, or the
    mean over the snapshots for the daily-matched sensors): ``nt`` 3-hourly
    snapshots of ``nz``-level profiles of ``gas`` [ppbv] (``CTM_GASES``),
    layer thicknesses [hPa] and mid-level pressures on sigma-pressure levels
    (hybrid-eta with A = 0) from the surface (~1000 hPa) to ~0.02 hPa."""
    rng = np.random.default_rng(seed)
    hw = lat2d.shape
    sigma = np.geomspace(1.0, 2e-5, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((nt,) + hw)
    pmid = sigma[None, :, None, None] * psurf[:, None]
    dp = np.abs(np.gradient(pmid, axis=1))
    amplitude, depth = CTM_GASES[gas]
    shape = np.exp(-np.arange(nz) / depth)[None, :, None, None]
    prof = amplitude * shape * np.abs(rng.normal(0.5, 0.15, (nt, nz) + hw))
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


def conus_window(window=CONUS):
    """(lon2d, lat2d): the rows and columns of :func:`merra2_gmi_grid` in
    ``window`` (south, north, west, east in degrees).  The default ``CONUS``
    (24-52 N x 128-66 W) gives 57 x 99 = 5,643 cells -- under the
    full-covariance scan's 6,144-cell dense limit and close to it;
    ``NORTH_AMERICA`` (20-60 N x 140-60 W) 81 x 129 = 10,449 cells, which the
    matrix-free path solves exactly in float64."""
    lon2d, lat2d = merra2_gmi_grid()
    lat_s, lat_n, lon_w, lon_e = window
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
                             error_mean=REGIONAL_ERROR_MEAN, window=CONUS):
    """(orbits, ctm, ctm_lon2d, ctm_lat2d) on the host for ``window`` (see
    :func:`conus_window`; CONUS by default): ``n_orbits`` OMI-shaped orbits
    (``ny`` x ``nx`` pixels pole to pole, ``nz`` levels) whose tracks cross
    the window, spread over its longitudes and over days 1-28 of July 2019,
    with the pixel uncertainty ``error_mean``, and the ``nz_ctm``-level,
    8-snapshot CTM on the window."""
    lon2d, lat2d = conus_window(window)
    lon_w, lon_e = float(lon2d.min()), float(lon2d.max())
    centers = np.linspace(lon_w + 4.0, lon_e - 4.0, n_orbits)
    orbits = [synthetic_orbit(seed + 1 + i, c, ny=ny, nx=nx, nz=nz, day=1 + i % 28,
                              error_mean=error_mean)
              for i, c in enumerate(centers)]
    return orbits, synthetic_ctm(lon2d, lat2d, seed=seed, nz=nz_ctm), lon2d, lat2d


def _missing(lon, lat, phase, frac=0.2):
    """A mask of the ``frac`` of the cells that lie in contiguous patches (the
    gaps between swaths, land or ice of a gridded product), moved by
    ``phase`` from one granule to the next."""
    f = (np.sin(np.radians(lon) * 3.0 + phase)
         * np.cos(np.radians(lat) * 2.5 + 0.5 * phase)).astype(np.float64)
    return f > np.quantile(f, 1.0 - frac)


def synthetic_mopitt_day(seed, day=1, nlev=9):
    """One MOPITT-CO-shaped daily L3 granule (host numpy leaves) in the
    layout its reader gives: the 1 x 1 degree global grid stored longitude
    first (360 x 180), ``nlev`` fixed retrieval levels (900..100 hPa), the
    (nlev + 1)-row total-column averaging kernel with the surface row first,
    float32 columns / kernels / pressures and float64 a-priori mixing ratios,
    ~20% missing cells in patches that move from day to day, a quality flag
    of ones.  Columns are in 1e15
    molec/cm2 (~2000), ``x_col`` in ppmv (~0.1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lon, lat = np.meshgrid(np.arange(-179.5, 180.0, 1.0, dtype=f32),
                           np.arange(-89.5, 90.0, 1.0, dtype=f32))
    lon, lat = lon.T, lat.T
    hw = lat.shape
    vcd = 2000.0 * (1.0 + 0.2 * np.sin(np.radians(lon) * 2.0) * np.cos(np.radians(lat)))
    vcd = np.abs(vcd + 60.0 * rng.standard_normal(hw))
    vcd[_missing(lon, lat, 0.7 * day)] = np.nan
    levels = np.linspace(900.0, 100.0, nlev)
    return satellite_opt(
        vcd=vcd.astype(f32), time=datetime.datetime(2019, 7, day, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=(0.07 * vcd * np.abs(rng.normal(1.0, 0.2, hw))).astype(f32),
        quality_flag=np.ones(hw, f32),
        pressure_mid=np.broadcast_to(levels[:, None, None], (nlev,) + hw).astype(f32).copy(),
        averaging_kernels=np.abs(rng.normal(150.0, 50.0, (nlev + 1,) + hw)).astype(f32),
        aprior_column=np.abs(rng.normal(2000.0, 100.0, hw)).astype(f32),
        apriori_profile=np.abs(rng.normal(90.0, 12.0, (nlev,) + hw)),
        surface_pressure=(1000.0 + 30.0 * rng.standard_normal(hw)).astype(f32),
        apriori_surface=np.abs(rng.normal(100.0, 10.0, hw)),
        x_col=(1e6 * vcd / 2.1e10).astype(f32), pressure_weight=[], sensor="MOPITT")


def synthetic_mopitt_month(n_days=30, seed=0, nz_ctm=72):
    """(granules, ctm, ctm_lon2d, ctm_lat2d) on the host: ``n_days`` daily
    MOPITT-shaped granules of July 2019 and the ``nz_ctm``-level CO CTM on
    the MERRA2-GMI grid."""
    lon2d, lat2d = merra2_gmi_grid()
    grans = [synthetic_mopitt_day(seed + 1 + d, day=1 + d) for d in range(n_days)]
    return grans, synthetic_ctm(lon2d, lat2d, seed=seed, nz=nz_ctm, gas="CO"), lon2d, lat2d


def synthetic_gosat_day(seed, day=1, n_points=3000, nlev=20):
    """One day of GOSAT-XCH4-shaped soundings (host numpy leaves, points on
    the last axis) in the layout its reader gives: ``n_points`` scattered
    between 60 S and 75 N, ``nlev`` sigma levels from the surface up, float32
    averaging kernels, pressure weights and a-priori profiles [ppbv], XCH4
    ~1800 ppbv with a ~10 ppbv uncertainty, and a quality flag that rejects
    ~10% of the soundings."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lat = rng.uniform(-60.0, 75.0, n_points).astype(f32)
    lon = rng.uniform(-180.0, 180.0, n_points).astype(f32)
    xch4 = 1800.0 + 25.0 * np.sin(np.radians(lat)) + 8.0 * rng.standard_normal(n_points)
    sigma = np.linspace(1.0, 0.01, nlev)[:, None]
    psurf = 1000.0 + 30.0 * rng.standard_normal(n_points)
    weight = np.abs(np.gradient(sigma[:, 0]))
    return satellite_opt(
        vcd=xch4, time=datetime.datetime(2019, 7, day, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(10.0, 2.0, n_points)),
        quality_flag=(rng.random(n_points) > 0.1) * 1.0,
        pressure_mid=sigma * psurf[None],
        averaging_kernels=rng.uniform(0.3, 1.1, (nlev, n_points)).astype(f32),
        aprior_column=np.zeros((1,)),
        apriori_profile=(1800.0 * (0.85 + 0.15 * sigma)
                         + 10.0 * rng.standard_normal((nlev, n_points))).astype(f32),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)), x_col=xch4,
        pressure_weight=np.broadcast_to((weight / weight.sum())[:, None],
                                        (nlev, n_points)).astype(f32).copy(),
        sensor="GOSAT")


def synthetic_gosat_month(n_days=30, seed=0, n_points=3000, nz_ctm=72):
    """(soundings, ctm, ctm_lon2d, ctm_lat2d) on the host: ``n_days`` daily
    sets of GOSAT-shaped soundings of July 2019 and the ``nz_ctm``-level CH4
    CTM on the MERRA2-GMI grid."""
    lon2d, lat2d = merra2_gmi_grid()
    days = [synthetic_gosat_day(seed + 1 + d, day=1 + d, n_points=n_points)
            for d in range(n_days)]
    return days, synthetic_ctm(lon2d, lat2d, seed=seed, nz=nz_ctm, gas="CH4"), lon2d, lat2d


def synthetic_ssmis_map(seed, pitch=0.25):
    """One SSMIS-shaped monthly water-vapour map (host numpy leaves) in the
    layout its reader gives: the ``pitch``-degree global grid (720 x 1440)
    with longitudes wrapped into -180..180, float32 columns [mm] (wet
    tropics, dry poles), ~20% missing cells in patches and the flat 5% error."""
    rng = np.random.default_rng(seed)
    lat1 = np.arange(-90.0 + pitch / 2, 90.0, pitch, dtype=np.float32)
    lon1 = np.arange(pitch / 2, 360.0, pitch, dtype=np.float32)
    lon, lat = np.meshgrid(np.where(lon1 > 180.0, lon1 - 360.0, lon1), lat1)
    pwv = np.abs(5.0 + 40.0 * np.cos(np.radians(lat)) ** 2 + 3.0 * rng.standard_normal(lat.shape))
    pwv[_missing(lon, lat, 2.1 * seed)] = np.nan
    return satellite_ssmis(vcd=pwv.astype(np.float32), uncertainty=(pwv * 0.05).astype(np.float32),
                           time=datetime.datetime(2019, 7, 1), latitude_center=lat,
                           longitude_center=lon, ctm_upscaled_needed=False, ctm_vcd=[],
                           sensor="SSMI")


def synthetic_ssmis_month(n_sats=3, seed=0, nz_ctm=72):
    """(maps, ctm, ctm_lon2d, ctm_lat2d) on the host: one monthly map per
    satellite of the fleet and the ``nz_ctm``-level humidity CTM on the
    MERRA2-GMI grid."""
    lon2d, lat2d = merra2_gmi_grid()
    maps = [synthetic_ssmis_map(seed + 1 + k) for k in range(n_sats)]
    return maps, synthetic_ctm(lon2d, lat2d, seed=seed, nz=nz_ctm, gas="H2O"), lon2d, lat2d
