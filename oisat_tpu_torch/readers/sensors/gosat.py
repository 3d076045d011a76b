"""GOSAT XCH4 point-to-map filler (reference oisatgmi/filler_gosat.py:87-201).

Counterpart of :func:`oisat_tpu.readers.sensors.gosat.filler_gosatxch4`; the
file reader that stands beside it there is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.convert import plan_to_torch
from oisat_tpu_torch.datamodel import satellite_opt
from oisat_tpu_torch.ops.regrid import apply_plan
from oisat_tpu_torch.ops.weights import build_plan

__all__ = ["filler_gosatxch4"]


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
