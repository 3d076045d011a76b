"""Granule kind ``omi_orbit``: OMI-NO2-shaped L2 orbits and their
observation operator, the AMF recalculation.

A granule kind is one file of ``benchmark/kinds/``, found by the name a
configuration's ``granules.kind`` gives.  It holds:

* ``make(seeds, block, month)``: one granule per ``numpy.random.SeedSequence``
  of ``seeds``, sized by the configuration's ``granules`` block, as a plain
  dictionary of host numpy arrays (``kind`` names the kind);
* ``CONTAINER`` and ``container_fields(g)``: the name of the program's
  granule container (a class of ``oisat_tpu_torch.datamodel``) and the
  keyword arguments its reader would fill;
* ``FIELDS2`` / ``FIELDS3``: the 2-D and 3-D fields the regrid carries; the
  check compares each, and the uncertainty, with the reference's;
* ``operator(r, ctm, state, prec, device)``: the reference's observation
  operator on one regridded granule ``r`` against the CTM dictionary, as
  (vcd, model vcd, aux1, aux2) on the granule's grid.  ``state`` is a dict
  that lives for one month.

The generator is a frozen copy of ``synthetic_orbit`` of
``oisat_tpu_torch/entry.py`` at commit 98b76ce; its large draws are float32.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from benchmark.reference import _interp_columns, _nansum0, _no_inf, f64, partial_column

CONTAINER = "satellite_amf"
FIELDS2 = ("vcd", "amf", "tropopause")
FIELDS3 = ("scattering_weights", "pressure_mid")


def orbit(rng, center_lon, ny=1644, nx=60, nz=35, day=1, month=(2019, 7),
          lat_range=(-82.0, 82.0), width_deg=24.0, error_mean=0.5) -> dict:
    """One orbit: ``ny`` scanlines pole to pole, ``nx`` cross-track pixels
    ~``width_deg`` wide around ``center_lon`` (drifting +-4 deg along track),
    ``nz`` hybrid-eta scattering-weight levels (float32), a QA channel with
    1% bad pixels and a tropopause; the 13:30 local overpass of ``day`` in
    UTC."""
    rng = np.random.default_rng(rng)
    f32 = np.float32
    along = np.linspace(lat_range[0], lat_range[1], ny)[:, None]
    across = np.linspace(-width_deg / 2, width_deg / 2, nx)[None, :]
    lat = along + 0.02 * rng.standard_normal((ny, nx))
    drift = 4.0 * np.sin(np.linspace(0.0, np.pi, ny))[:, None]
    lon = center_lon + across + drift + 0.02 * rng.standard_normal((ny, nx))
    eta_a = np.linspace(0.0, 100.0, nz, dtype=f32)
    eta_b = np.linspace(1.0, 0.02, nz, dtype=f32)
    psurf = (1000.0 + 30.0 * rng.standard_normal((ny, nx))).astype(f32)
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.01] = 0.0
    sw = rng.standard_normal((nz, ny, nx), dtype=f32)
    sw *= f32(0.2)
    sw += f32(1.0)
    np.abs(sw, out=sw)
    return dict(
        kind="omi_orbit",
        vcd=np.abs(2.0 + np.sin(np.radians(lon) * 3.0) * np.cos(np.radians(lat) * 2.0)
                   + 0.3 * rng.standard_normal((ny, nx))),
        amf=np.abs(rng.normal(1.5, 0.2, (ny, nx))),
        time=(datetime.datetime(month[0], month[1], day)
              + datetime.timedelta(hours=(13.5 - center_lon / 15.0) % 24.0)),
        tropopause=rng.uniform(100.0, 250.0, (ny, nx)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(error_mean, 0.2 * error_mean, (ny, nx))),
        quality_flag=qa,
        pressure_mid=eta_a[:, None, None] + eta_b[:, None, None] * psurf[None],
        scattering_weights=sw,
    )


def make(seeds, block: dict, month) -> list:
    """The month's orbits, their centres spread over longitude, days 1-28."""
    centers = np.linspace(-160.0, 160.0, len(seeds))
    return [orbit(s, ctr, ny=block["ny"], nx=block["nx"], nz=block["nz"], day=1 + i % 28,
                  month=month, width_deg=block["width_deg"], error_mean=block["error_mean"])
            for i, (s, ctr) in enumerate(zip(seeds, centers))]


def container_fields(g: dict) -> dict:
    return dict(vcd=g["vcd"], time=g["time"], latitude_center=g["latitude_center"],
                longitude_center=g["longitude_center"], latitude_corner=[],
                longitude_corner=[], uncertainty=g["uncertainty"],
                quality_flag=g["quality_flag"], pressure_mid=g["pressure_mid"],
                ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[], amf=g["amf"],
                tropopause=g["tropopause"], scattering_weights=g["scattering_weights"],
                old_amf=[], new_amf=[])


def _hour(t):
    return t.hour / 24.0 + t.minute / 60.0 / 24.0 + t.second / 3600.0 / 24.0


def operator(r: dict, ctm: dict, state: dict, prec, device):
    """The AMF recalculation against the CTM snapshot nearest in hour of
    day (the one snapshot of a CTM without a time axis), tropopause-masked:
    (vcd corrected, model vcd, new AMF, old AMF)."""
    an, it = prec.dtype("analysis"), prec.dtype("amf_interpolation")
    pick = lambda a: a  # noqa: E731
    if np.ndim(ctm["pressure_mid"]) == 4:
        hours = np.array([_hour(t) for t in ctm["time"]])
        k = int(np.argmin(np.abs(_hour(r["time"]) - hours)))
        pick = lambda a: a[k]  # noqa: E731
    ctm_pmid = torch.as_tensor(pick(ctm["pressure_mid"]), device=device)
    pc = partial_column(torch.as_tensor(pick(ctm["delta_p"]), device=device).to(an),
                        torch.as_tensor(pick(ctm["gas_profile"]), device=device).to(an))
    flat = lambda a: a.reshape(a.shape[0], -1)  # noqa: E731
    sat_pmid, sw = r["pressure_mid"], r["scattering_weights"]
    sw_i = _interp_columns(torch.log(flat(sat_pmid).to(it)), flat(sw).to(it),
                           torch.log(flat(ctm_pmid).to(it)), True).to(an)
    sw_i = torch.where(torch.isinf(sw_i), torch.zeros_like(sw_i), sw_i)
    pc = flat(pc)
    trop = r["tropopause"].reshape(1, -1)
    above = flat(ctm_pmid).to(f64) < trop.to(f64)
    sw_i = torch.where(above, torch.nan, sw_i)
    pc = torch.where(above, torch.nan, pc)
    scd = _nansum0(sw_i * pc)
    model = _nansum0(pc)
    new_amf = torch.where(model != 0, scd / model, torch.nan)
    vcd = r["vcd"].reshape(-1).to(an)
    new_amf = torch.where(torch.isnan(vcd), torch.nan, new_amf)
    amf_old = r["amf"].reshape(-1).to(an)
    vcd_corr = amf_old * vcd / new_amf
    model = torch.where(torch.isnan(vcd_corr) | torch.isinf(vcd_corr), torch.nan, model)
    hw = r["vcd"].shape
    return (_no_inf(vcd_corr.reshape(hw)), model.reshape(hw), new_amf.reshape(hw),
            amf_old.reshape(hw))
