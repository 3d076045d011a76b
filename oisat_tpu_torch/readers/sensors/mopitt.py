"""MOPITT CO L3 reader (twin of :mod:`oisat_tpu.readers.sensors.mopitt`;
reference oisatgmi/reader.py:1130-1213, fleet :1416-1431)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat_tpu_torch.datamodel import satellite_opt
from oisat_tpu_torch.readers.ncio import get_nc_attrs, read_group_nc, remove_empty_files
from oisat_tpu_torch.readers.sensors.common import (epoch_time, fleet_device,
                                                    fleet_map, regrid)

EPOCH_1993 = datetime.datetime(1993, 1, 1)
GRID = ["HDFEOS", "GRIDS", "MOP03", "Data Fields"]


def mopitt_reader_co(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                     device=None, fast_swath=True):
    """MOPITT CO monthly L3 (reference reader.py:1130-1213): day retrievals,
    10-row total-column averaging kernel (surface row first), x_col from the
    dry-air column."""
    print("Currently reading: " + fname.split("/")[-1])
    attrs = get_nc_attrs(fname, group=["HDFEOS", "ADDITIONAL", "FILE_ATTRIBUTES"])
    time = epoch_time(EPOCH_1993, 0.5 * (float(attrs["StartTime"]) + float(attrs["StopTime"])))
    lat1 = read_group_nc(fname, GRID, "Latitude").astype("float32")
    lon1 = read_group_nc(fname, GRID, "Longitude").astype("float32")
    lon, lat = np.meshgrid(lon1, lat1)
    lon = lon.transpose()
    lat = lat.transpose()
    vcd = np.array(read_group_nc(fname, GRID, "RetrievedCOTotalColumnDay"), np.float64)
    vcd[(vcd <= 0) | np.isinf(vcd)] = np.nan
    vcd = (vcd * 1e-15).astype("float32")
    dryair = np.asarray(read_group_nc(fname, GRID, "DryAirColumnDay"), np.float64)
    x_col = (1e6 * vcd / (dryair * 1e-15)).astype("float32")
    apriori_profile = np.array(read_group_nc(fname, GRID, "APrioriCOMixingRatioProfileDay"),
                               np.float64).transpose((2, 0, 1))
    apriori_profile[apriori_profile <= 0] = np.nan
    apriori_surface = np.array(read_group_nc(fname, GRID, "APrioriCOSurfaceMixingRatioDay"),
                               np.float64)
    apriori_surface[apriori_surface <= 0] = np.nan
    surface_pressure = read_group_nc(fname, GRID, "SurfacePressureDay")
    apriori_col = np.array(read_group_nc(fname, GRID, "APrioriCOTotalColumnDay"), np.float64) * 1e-15
    apriori_col[apriori_col <= 0] = np.nan
    unc = (np.asarray(read_group_nc(fname, GRID, "RetrievedCOTotalColumnMeanUncertaintyDay"),
                      np.float64) * 1e-15).astype("float32")
    ps = read_group_nc(fname, GRID, "Pressure").astype("float32")
    p_mid = np.broadcast_to(np.asarray(ps)[:9, None, None], (9,) + vcd.shape).astype("float32").copy()
    if read_ak:
        aks = np.asarray(read_group_nc(fname, GRID, "TotalColumnAveragingKernelDay"),
                         np.float64) * 1e-15
        aks = aks.transpose((2, 0, 1)).astype("float32")
    else:
        aks = np.empty((1,))
    g = satellite_opt(
        vcd=vcd, time=time, profile=[], tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[], uncertainty=unc,
        quality_flag=np.ones_like(vcd), pressure_mid=p_mid, averaging_kernels=aks,
        aprior_column=apriori_col.astype("float32"), apriori_profile=apriori_profile,
        surface_pressure=surface_pressure, apriori_surface=apriori_surface,
        x_col=x_col, pressure_weight=[], sensor="MOPITT")
    return regrid("MOPITT_CO", g, ctm_lon, ctm_lat, device, fast_swath)


def mopitt_reader(product_dir, ctm_lon, ctm_lat, YYYYMM, read_ak=True, num_job=1,
                  device=None, fast_swath=True):
    """MOPITT fleet reader (reference reader.py:1416-1431)."""
    device = fleet_device(device, ctm_lon)
    files = remove_empty_files(sorted(
        glob.glob(product_dir + "/*" + YYYYMM[0:4] + YYYYMM[4:] + "*.he5")))
    return fleet_map(lambda f: mopitt_reader_co(f, ctm_lon, ctm_lat, read_ak, device,
                                                fast_swath),
                     files, num_job, "MOPITT_CO")
