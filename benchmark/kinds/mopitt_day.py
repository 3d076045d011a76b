"""Granule kind ``mopitt_day``: MOPITT-CO-shaped daily L3 granules and their
observation operator, the averaging-kernel convolution.

The interface of a kind is set out in ``omi_orbit.py``.  The generator is a
frozen copy of ``synthetic_mopitt_day`` and ``_missing`` of
``oisat_tpu_torch/entry.py`` at commit 98b76ce.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from benchmark.reference import _interp_columns, _nansum0, _no_inf, ctm_on_grid

CONTAINER = "satellite_opt"
FIELDS2 = ("vcd", "aprior_column", "surface_pressure", "apriori_surface", "x_col")
FIELDS3 = ("averaging_kernels", "pressure_mid", "apriori_profile")


def _missing(lon, lat, phase, frac=0.2):
    """A mask of the ``frac`` of the cells that lie in contiguous patches,
    moved by ``phase`` from one granule to the next."""
    f = (np.sin(np.radians(lon) * 3.0 + phase)
         * np.cos(np.radians(lat) * 2.5 + 0.5 * phase)).astype(np.float64)
    return f > np.quantile(f, 1.0 - frac)


def day_granule(rng, day=1, nlev=9, pitch=1.0, month=(2019, 7)) -> dict:
    """One day in its reader's layout: the 1 x 1 degree global grid stored
    longitude first (360 x 180), ``nlev`` retrieval levels (900..100 hPa),
    the (nlev + 1)-row averaging kernel with the surface row first, float32
    columns / kernels / pressures and float64 a-priori mixing ratios, ~20%
    missing cells in patches, a quality flag of ones."""
    rng = np.random.default_rng(rng)
    f32 = np.float32
    lon, lat = np.meshgrid(np.arange(-180.0 + pitch / 2, 180.0, pitch, dtype=f32),
                           np.arange(-90.0 + pitch / 2, 90.0, pitch, dtype=f32))
    lon, lat = lon.T, lat.T
    hw = lat.shape
    vcd = 2000.0 * (1.0 + 0.2 * np.sin(np.radians(lon) * 2.0) * np.cos(np.radians(lat)))
    vcd = np.abs(vcd + 60.0 * rng.standard_normal(hw))
    vcd[_missing(lon, lat, 0.7 * day)] = np.nan
    levels = np.linspace(900.0, 100.0, nlev)
    return dict(
        kind="mopitt_day", sensor="MOPITT",
        vcd=vcd.astype(f32), time=datetime.datetime(month[0], month[1], day, 12),
        latitude_center=lat, longitude_center=lon,
        uncertainty=(0.07 * vcd * np.abs(rng.normal(1.0, 0.2, hw))).astype(f32),
        quality_flag=np.ones(hw, f32),
        pressure_mid=np.broadcast_to(levels[:, None, None], (nlev,) + hw).astype(f32).copy(),
        averaging_kernels=np.abs(rng.normal(150.0, 50.0, (nlev + 1,) + hw)).astype(f32),
        aprior_column=np.abs(rng.normal(2000.0, 100.0, hw)).astype(f32),
        apriori_profile=np.abs(rng.normal(90.0, 12.0, (nlev,) + hw)),
        surface_pressure=(1000.0 + 30.0 * rng.standard_normal(hw)).astype(f32),
        apriori_surface=np.abs(rng.normal(100.0, 10.0, hw)),
        x_col=(1e6 * vcd / 2.1e10).astype(f32),
    )


def make(seeds, block: dict, month) -> list:
    """One granule a day, days 1, 2, ..."""
    return [day_granule(s, day=1 + d, nlev=block["nlev"], pitch=block.get("pitch", 1.0),
                        month=month) for d, s in enumerate(seeds)]


def container_fields(g: dict) -> dict:
    return dict(vcd=g["vcd"], time=g["time"], latitude_center=g["latitude_center"],
                longitude_center=g["longitude_center"], latitude_corner=[],
                longitude_corner=[], uncertainty=g["uncertainty"],
                quality_flag=g["quality_flag"], pressure_mid=g["pressure_mid"],
                ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[], profile=[],
                tropopause=np.empty((1,)), averaging_kernels=g["averaging_kernels"],
                ctm_xcol=[], aprior_column=g["aprior_column"],
                apriori_profile=g["apriori_profile"], surface_pressure=g["surface_pressure"],
                apriori_surface=g["apriori_surface"], x_col=g["x_col"], pressure_weight=[],
                sensor=g["sensor"])


def operator(r: dict, ctm: dict, state: dict, prec, device):
    """The averaging-kernel convolution against the CTM, time-collapsed and
    mapped onto the granule grid once a month: (vcd, model vcd, x_col,
    model x_col)."""
    an = prec.dtype("analysis")
    if "ctm_on" not in state:
        state["ctm_on"] = ctm_on_grid(ctm, r["grid"], r["ctm_upscaled_needed"], prec, device)
    pmid, prof, airpc = state["ctm_on"]
    flat = lambda a: a.reshape(a.shape[0], -1)  # noqa: E731
    prof_i = _interp_columns(torch.log(flat(pmid)), flat(prof),
                             torch.log(flat(r["pressure_mid"]).to(an)), False)
    dlog = torch.log10(prof_i) - torch.log10(flat(r["apriori_profile"]).to(an))
    aks = flat(r["averaging_kernels"]).to(an)
    pcomp = r["aprior_column"].reshape(-1).to(an) + _nansum0(aks[1:] * dlog)
    scomp = aks[0] * (torch.log10(flat(prof)[0]) - torch.log10(r["apriori_surface"].reshape(-1)
                                                              .to(an)))
    model = pcomp + scomp
    xcol = 1e6 * model / _nansum0(flat(airpc))
    vcd = r["vcd"].reshape(-1)
    model = torch.where(torch.isnan(vcd) | torch.isinf(vcd), torch.nan, model)
    xcol = torch.where(torch.isnan(vcd), torch.nan, xcol)
    hw = r["vcd"].shape
    return (_no_inf(r["vcd"].to(an)), model.reshape(hw), r["x_col"].to(an), xcol.reshape(hw))
