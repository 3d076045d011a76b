"""OMPS HCHO reader (twin of :mod:`oisat_tpu.readers.sensors.omps`; reference oisatgmi/reader.py:1052-1128, fleet :1363-1375)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat_tpu_torch.datamodel import satellite_amf
from oisat_tpu_torch.readers.ncio import read_group_nc, remove_empty_files
from oisat_tpu_torch.readers.sensors.common import (
    GEOS5_ETA_A48,
    GEOS5_ETA_B48,
    epoch_time,
    fleet_device,
    fleet_map,
    pmid_from_eta_edges,
    regrid,
    scrub_sws,
)

EPOCH_1993 = datetime.datetime(1993, 1, 1)


def omps_reader_hcho(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                     device=None, fast_swath=True):
    """OMPS HCHO L2 (reference reader.py:1052-1128).

    Quirk preserved: the reference reads 'column_amount' as the surface
    pressure for the hybrid-eta grid (reader.py:1089 — some files lack a
    surface-pressure variable), building pressure *edges* first and then
    mid-levels.
    """
    print("Currently reading: " + fname.split("/")[-1])
    time = epoch_time(EPOCH_1993, np.squeeze(np.nanmean(
        read_group_nc(fname, ["geolocation"], "time"), axis=0)))
    lat = read_group_nc(fname, ["geolocation"], "latitude").astype("float32")
    lon = read_group_nc(fname, ["geolocation"], "longitude").astype("float32")
    amf_total = read_group_nc(fname, ["support_data"], "amf")
    vcd = (read_group_nc(fname, ["key_science_data"], "column_amount") * 1e-15).astype("float32")
    cf_mask = (read_group_nc(fname, ["support_data"], "cloud_fraction") < 0.4) * 1.0
    qf = (read_group_nc(fname, ["key_science_data"], "main_data_quality_flag") == 0.0) * 1.0
    quality_flag = np.squeeze(qf) * np.squeeze(cf_mask)
    sur_pres = read_group_nc(fname, ["key_science_data"], "column_amount").astype("float32")
    p_mid = pmid_from_eta_edges(GEOS5_ETA_A48, GEOS5_ETA_B48, sur_pres)
    if read_ak:
        sws = scrub_sws(read_group_nc(fname, ["support_data"], "scattering_weights").astype("float32"))
    else:
        sws = np.empty((1,))
    unc = (read_group_nc(fname, ["key_science_data"], "column_uncertainty") * 1e-15).astype("float32")
    g = satellite_amf(vcd=vcd, amf=amf_total, time=time, tropopause=np.empty((1,)),
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("OMPS_HCHO", g, ctm_lon, ctm_lat, device, fast_swath)


def omps_reader(product_dir, product_name, ctm_lon, ctm_lat, YYYYMM, trop,
                read_ak=True, num_job=1, device=None, fast_swath=True):
    """OMPS fleet reader (reference reader.py:1363-1375)."""
    pattern = product_dir + "/*" + YYYYMM[0:4] + "m" + YYYYMM[4:] + "*.nc"
    print(pattern)
    files = remove_empty_files(sorted(glob.glob(pattern)))
    if product_name.split("_")[-1] != "HCHO":
        print("We have OMPS reader only for HCHO")
        return []
    device = fleet_device(device, ctm_lon)
    return fleet_map(lambda f: omps_reader_hcho(f, ctm_lon, ctm_lat, read_ak, device,
                                                fast_swath),
                     files, num_job, "OMPS_HCHO")
