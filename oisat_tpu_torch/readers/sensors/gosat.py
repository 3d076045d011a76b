"""GOSAT XCH4 reader + point-to-map filler (twin of
:mod:`oisat_tpu.readers.sensors.gosat`; reference
oisatgmi/filler_gosat.py:87-201, reader.py:1216-1275, fleet :1434-1448)."""

from __future__ import annotations

import datetime
import glob

import numpy as np
import torch

from oisat_tpu_torch._device import default_device, resolve_device
from oisat_tpu_torch.convert import plan_to_torch
from oisat_tpu_torch.datamodel import satellite_opt
from oisat_tpu_torch.ops.regrid import apply_plan
from oisat_tpu_torch.ops.weights import build_plan
from oisat_tpu_torch.readers.ncio import read_nc
from oisat_tpu_torch.readers.sensors.common import (epoch_time, fleet_map, on_device,
                                                    regrid)

__all__ = ["filler_gosatxch4", "gosat_reader_xch4", "gosat_reader"]

EPOCH_1970 = datetime.datetime(1970, 1, 1)


def filler_gosatxch4(grid_size: float, sat_data: satellite_opt, device,
                     flag_thresh: float = 0.75):
    """Grid sparse GOSAT soundings (host numpy leaves, points on the last
    axis) into global maps: Delaunay-linear interpolation of every field onto
    an ``arange(-180..180) x arange(-90..90)`` grid with the filler's own 1x
    distance cutoff (filler_gosat.py:17; the main interpolator takes 2x), the
    quality flag gridded by nearest neighbour, the error through the variance
    path.  The interpolation runs in float64 on ``device``; the maps come
    back as host numpy, ready for ``regrid_granule``.  Returns None when the
    soundings cannot be triangulated.

    Size-1 placeholders (a granule read without averaging kernels) are kept
    as they are.  The grid coordinates are float64, as in the JAX package
    (the reference casts them to float16, filler_gosat.py:121-127).
    """
    dev = resolve_device(device)
    mask = (np.asarray(sat_data.quality_flag) > flag_thresh) * 1.0
    mask[mask != 1.0] = np.nan
    lon_grid = np.arange(-180.0, 180.0 + grid_size, grid_size)
    lat_grid = np.arange(-90.0, 90.0 + grid_size, grid_size)
    lons, lats = np.meshgrid(lon_grid, lat_grid)
    lin = build_plan(sat_data.longitude_center, sat_data.latitude_center,
                     lons, lats, method=1, threshold=grid_size, far_factor=1.0)
    if lin is None:
        return None
    near = build_plan(sat_data.longitude_center, sat_data.latitude_center,
                      lons, lats, method=2, threshold=grid_size, far_factor=1.0)
    lin, near = plan_to_torch(lin, dev), plan_to_torch(near, dev)

    def grid(plan, z):
        return apply_plan(plan, torch.as_tensor(np.asarray(z, np.float64), device=dev))

    xch4 = grid(lin, np.asarray(sat_data.x_col) * mask).cpu().numpy()
    quality_flag = grid(near, mask).cpu().numpy()
    uncertainty = torch.sqrt(grid(lin, np.asarray(sat_data.uncertainty) ** 2 * mask))

    def lv(arr):
        if np.size(arr) == 1:
            return np.empty((1,))
        return grid(lin, np.asarray(arr) * mask[None]).cpu().numpy()

    return satellite_opt(
        vcd=xch4, time=sat_data.time, profile=[], tropopause=np.empty((1,)),
        latitude_center=lats, longitude_center=lons,
        latitude_corner=[], longitude_corner=[], uncertainty=uncertainty.cpu().numpy(),
        quality_flag=quality_flag, pressure_mid=lv(sat_data.pressure_mid),
        averaging_kernels=lv(sat_data.averaging_kernels),
        aprior_column=np.zeros((1,)), apriori_profile=lv(sat_data.apriori_profile),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=xch4, pressure_weight=lv(sat_data.pressure_weight), sensor="GOSAT")


def gosat_reader_xch4(fname, ctm_lon=None, ctm_lat=None, read_ak=True, device=None,
                      fast_swath=True):
    """GOSAT L2 XCH4 soundings (reference reader.py:1216-1275): point data,
    gridded by the filler on ``device`` (None: the card), then the standard
    regrid."""
    print("Currently reading: " + fname.split("/")[-1])
    time = epoch_time(EPOCH_1970, np.nanmean(read_nc(fname, "time")))
    lat = read_nc(fname, "latitude").astype("float32")
    lon = read_nc(fname, "longitude").astype("float32")
    xch4 = np.array(read_nc(fname, "xch4"), np.float64)
    xch4[(xch4 <= 0) | np.isinf(xch4)] = np.nan
    apriori_profile = np.array(read_nc(fname, "ch4_profile_apriori"), np.float64).transpose()
    apriori_profile[apriori_profile <= 0] = np.nan
    quality_flag = read_nc(fname, "xch4_quality_flag")
    uncertainty = read_nc(fname, "xch4_uncertainty")
    p_mid = np.array(read_nc(fname, "pressure_levels"), np.float64)
    p_mid[p_mid <= 0] = np.nan
    if read_ak:
        aks = np.array(read_nc(fname, "xch4_averaging_kernel"), np.float64).transpose()
        pw = np.array(read_nc(fname, "pressure_weight"), np.float64).transpose()
        aks[aks <= 0] = np.nan
        pw[pw <= 0] = np.nan
    else:
        aks = np.empty((1,))
        pw = np.empty((1,))
    g = satellite_opt(
        vcd=xch4, time=time, profile=[], tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[], uncertainty=uncertainty,
        quality_flag=1 - np.asarray(quality_flag),  # 0 = good -> 1 (reader.py:1266)
        pressure_mid=p_mid.transpose(), averaging_kernels=aks,
        aprior_column=np.zeros((1,)), apriori_profile=apriori_profile,
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=xch4, pressure_weight=pw, sensor="GOSAT")
    g = on_device(filler_gosatxch4, 1.0, g, default_device(device), flag_thresh=0.0)
    return regrid("GOSAT_XCH4", g, ctm_lon, ctm_lat, device, fast_swath)


def gosat_reader(product_dir, ctm_lon, ctm_lat, YYYYMM, read_ak=True, num_job=1,
                 device=None, fast_swath=True):
    """GOSAT fleet reader: year-subdirectory layout (reference reader.py:1434-1448).
    The filler runs on the device even for a decode-only read."""
    files = sorted(glob.glob(product_dir + "/" + YYYYMM[0:4] + "/*"
                             + YYYYMM[0:4] + YYYYMM[4:] + "*.nc"))
    device = default_device(device)
    return fleet_map(lambda f: gosat_reader_xch4(f, ctm_lon, ctm_lat, read_ak, device,
                                                 fast_swath),
                     files, num_job, "GOSAT_XCH4")
