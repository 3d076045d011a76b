"""The benchmark's traffic generator: granules and CTM months from a seed.

:func:`make_month` is the one general generator.  A configuration's
``granules`` block names the granule kind (a file of ``benchmark/kinds/``,
whose ``make`` draws the granules) and its sizes; its ``ctm`` block gives the
CTM's type, levels, snapshots, cadence and averaging; a traffic mix's file
gives the per-month geometry offsets.  Granules and CTM are plain
dictionaries of host numpy arrays (the leaves the port's readers give);
:mod:`benchmark.program` wraps them for the program and
:mod:`benchmark.reference` reads them as they are.  Every random draw comes
from a ``numpy.random.SeedSequence`` child of the run's seed, so the same
seed gives the same month, and every seed the same sizes.

:func:`merra2_gmi_grid` and the CTM profile of :func:`ctm_month` are frozen
copies of ``merra2_gmi_grid`` and ``synthetic_ctm`` of
``oisat_tpu_torch/entry.py`` at commit 98b76ce; the large draws are float32.
"""

from __future__ import annotations

import datetime

import numpy as np

from benchmark.reference import granule_kind

__all__ = ["CTM_GASES", "merra2_gmi_grid", "ctm_month", "seed_sequence", "make_month",
           "month_offsets", "offset_granule"]

# (twice the surface mixing ratio, e-folding depth in levels) of each gas
CTM_GASES = {"NO2": (0.4, 8.0), "CO": (180.0, 40.0), "CH4": (3600.0, 400.0),
             "H2O": (8.0e6, 8.0)}


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """The run's seed as a SeedSequence: any whole number, negative ones and
    those above 64 bits included."""
    return np.random.SeedSequence(int(seed) % (1 << 128))


def merra2_gmi_grid(dlat=0.5, dlon=0.625):
    """(lon2d, lat2d) of the global MERRA2-GMI grid: 0.5 deg x 0.625 deg,
    361 x 576 cells (other pitches for the CPU tests' tiny months)."""
    lat = np.arange(-90.0, 90.0 + dlat / 2, dlat)
    lon = np.arange(-180.0, 180.0, dlon)
    return np.meshgrid(lon, lat)


def ctm_month(lon2d, lat2d, rng, ctm: dict, month) -> dict:
    """A CTM month as its reader hands it over: ``ctm["snapshots"]``
    snapshots ``ctm["step_hours"]`` apart from ``ctm["day"]`` of the month,
    each ``ctm["levels"]`` levels of ``ctm["gas"]`` [ppbv], layer
    thicknesses [hPa] and mid-level pressures on sigma levels from ~1000 hPa
    to ~0.02 hPa, all float32; a CTM with ``time_axis`` false (a monthly
    file) has one snapshot and no time axis.  ``type`` and ``averaged`` are
    passed on as the reader's ``ctmtype`` and ``averaged``."""
    rng = np.random.default_rng(rng)
    f32 = np.float32
    nt, nz = int(ctm["snapshots"]), int(ctm["levels"])
    hw = lat2d.shape
    sigma = np.geomspace(1.0, 2e-5, nz)
    psurf = rng.standard_normal((nt,) + hw, dtype=f32)
    psurf *= f32(30.0)
    psurf += f32(1000.0)
    pmid = sigma.astype(f32)[None, :, None, None] * psurf[:, None]
    # np.gradient is linear and psurf > 0: the thickness is psurf times
    # sigma's gradient
    dp = np.abs(np.gradient(sigma)).astype(f32)[None, :, None, None] * psurf[:, None]
    amplitude, depth = CTM_GASES[ctm["gas"]]
    shape = (amplitude * np.exp(-np.arange(nz) / depth)).astype(f32)[None, :, None, None]
    prof = rng.standard_normal((nt, nz) + hw, dtype=f32)
    prof *= f32(0.15)
    prof += f32(0.5)
    np.abs(prof, out=prof)
    prof *= shape
    start = datetime.datetime(month[0], month[1], int(ctm.get("day", 1)))
    times = [start + datetime.timedelta(hours=float(ctm.get("step_hours", 0)) * h)
             for h in range(nt)]
    if not ctm.get("time_axis", True):
        if nt != 1:
            raise ValueError("a CTM without a time axis has one snapshot")
        pmid, dp, prof = pmid[0], dp[0], prof[0]
    return dict(latitude=lat2d, longitude=lon2d, time=times, gas_profile=prof,
                pressure_mid=pmid, delta_p=dp, ctmtype=ctm["type"],
                averaged=bool(ctm["averaged"]))


def make_month(config: dict, seed: int):
    """(granules, ctm, ctm_lon2d, ctm_lat2d) of one configuration from the
    run's seed."""
    g, c = config["granules"], config["ctm"]
    lon2d, lat2d = merra2_gmi_grid(c.get("dlat", 0.5), c.get("dlon", 0.625))
    ss_ctm, ss_gran = seed_sequence(seed).spawn(2)
    month = tuple(config["month"])
    grans = granule_kind(g["kind"]).make(ss_gran.spawn(int(config["granules_per_month"])), g,
                                         month)
    return grans, ctm_month(lon2d, lat2d, ss_ctm, c, month), lon2d, lat2d


def month_offsets(mix: dict, seed: int, n_months: int) -> np.ndarray:
    """(n_months, 2) geometry offsets (dlon, dlat) in degrees, one draw per
    month from the seed within the mix's ``lon_offset_deg`` and
    ``lat_offset_deg``; zeros when the mix moves no geometry."""
    lo = float(mix.get("lon_offset_deg", 0.0))
    la = float(mix.get("lat_offset_deg", 0.0))
    rng = np.random.default_rng(seed_sequence(seed).spawn(3)[2])
    u = rng.uniform(-1.0, 1.0, (n_months, 2))
    return u * np.array([lo, la])


def offset_granule(gran: dict, offset) -> dict:
    """The granule with its longitudes and latitudes moved by ``offset``
    (dlon, dlat): two new arrays, every other leaf shared."""
    dlon, dlat = float(offset[0]), float(offset[1])
    if dlon == 0.0 and dlat == 0.0:
        return gran
    out = dict(gran)
    out["longitude_center"] = gran["longitude_center"] + dlon
    out["latitude_center"] = gran["latitude_center"] + dlat
    return out
