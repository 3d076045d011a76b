"""SSMIS water-vapor reader (twin of :mod:`oisat_tpu.readers.sensors.ssmis`;
reference oisatgmi/reader.py:1277-1305, fleet :1450-1464)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat_tpu_torch.datamodel import satellite_ssmis
from oisat_tpu_torch.readers.ncio import read_nc_raw, remove_empty_files
from oisat_tpu_torch.readers.sensors.common import fleet_device, fleet_map, regrid

__all__ = ["ssmis_reader_wv", "ssmis_reader"]


def ssmis_reader_wv(fname, ctm_lon=None, ctm_lat=None, device=None, fast_swath=True):
    """Monthly RSS SSMIS water-vapor L3 (reference reader.py:1277-1305):
    raw counts x0.3 -> mm, >=75 mm masked, flat 5% error model; month
    decoded from the filename's ...YYYYMMv7... token."""
    print("Currently reading: " + fname.split("/")[-1])
    token = fname.split("v7")[0]
    time = datetime.datetime(int(token[-6:-2]), int(token[-2:]), 1)
    # RAW reads (reference _read_ssmi, reader.py:28-34): RSS files store
    # vapor as counts with flags 250-254; CF auto-scaling would corrupt
    # the flag mask and double-apply the x0.3
    lat1 = read_nc_raw(fname, "latitude").astype("float32")
    lon1 = read_nc_raw(fname, "longitude").astype("float32")
    lon1 = np.where(lon1 > 180.0, lon1 - 360.0, lon1)
    lon, lat = np.meshgrid(lon1, lat1)
    pwv = np.array(read_nc_raw(fname, "atmosphere_water_vapor_content"), np.float64)
    pwv[pwv > 250.0] = np.nan
    pwv = pwv * 0.3
    pwv[(pwv >= 75.0) | np.isinf(pwv)] = np.nan
    g = satellite_ssmis(vcd=pwv.astype("float32"), uncertainty=(pwv * 0.05).astype("float32"),
                        time=time, latitude_center=lat, longitude_center=lon,
                        ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMI")
    return regrid("SSMIS_WV", g, ctm_lon, ctm_lat, device, fast_swath)


def ssmis_reader(product_dir, ctm_lon, ctm_lat, YYYYMM, num_job=1, device=None,
                 fast_swath=True):
    """SSMIS fleet reader (reference reader.py:1450-1464)."""
    device = fleet_device(device, ctm_lon)
    files = remove_empty_files(sorted(
        glob.glob(product_dir + "/*" + YYYYMM[0:4] + YYYYMM[4:] + "*.nc")))
    return fleet_map(lambda f: ssmis_reader_wv(f, ctm_lon, ctm_lat, device, fast_swath),
                     files, num_job, "SSMIS_WV")
