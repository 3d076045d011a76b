"""OMI product readers: NO2, HCHO, total O3 (twin of
:mod:`oisat_tpu.readers.sensors.omi`).

Behavioral equivalents of the reference readers (reference
oisatgmi/reader.py:807-1050, fleet :1377-1413).  Per-product constants live
in :mod:`oisat_tpu_torch.readers.registry`; dtype policy is float32 (the
reference's float16 casts are a memory hack, not numerics).  Every reader
decodes on the host; with a CTM grid it regrids on ``device`` (None: the card).
"""

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


def decode_vcd_quality_flags(flags: np.ndarray) -> np.ndarray:
    """Vectorized VcdQualityFlags bit rule (reference reader.py:862-869):
    good when bit0==0, or bit0==1 with bit1==0; else -100."""
    f = np.asarray(flags)
    f_int = np.where(np.isfinite(f), f, -1).astype(np.int64)
    good = ((f_int & 1) == 0) | ((f_int & 2) == 0)
    good &= f_int >= 0
    return np.where(good, 1.0, -100.0)


def omi_reader_no2(fname, trop, ctm_lon=None, ctm_lat=None, read_ak=True,
                   device=None, fast_swath=True):
    """OMI NO2 L2 (reference reader.py:807-903)."""
    print("Currently reading: " + fname.split("/")[-1])
    time = epoch_time(EPOCH_1993, np.nanmean(read_group_nc(fname, ["GEOLOCATION_DATA"], "Time")))
    lat = read_group_nc(fname, ["GEOLOCATION_DATA"], "Latitude").astype("float32")
    lon = read_group_nc(fname, ["GEOLOCATION_DATA"], "Longitude").astype("float32")
    if not trop:
        vcd = read_group_nc(fname, ["SCIENCE_DATA"], "ColumnAmountNO2")
        amf = read_group_nc(fname, ["SCIENCE_DATA"], "Amf")
        unc = read_group_nc(fname, ["SCIENCE_DATA"], "ColumnAmountNO2Std")
    else:
        vcd = read_group_nc(fname, ["SCIENCE_DATA"], "ColumnAmountNO2Trop")
        amf = read_group_nc(fname, ["SCIENCE_DATA"], "AmfTrop")
        unc = read_group_nc(fname, ["SCIENCE_DATA"], "ColumnAmountNO2TropStd")
    vcd = (vcd * 1e-15).astype("float32")
    unc = (unc * 1e-15).astype("float32")
    # masks: cloud fraction < 0.3, terrain reflectivity < 0.2 (reader.py:849-857)
    cf = read_group_nc(fname, ["ANCILLARY_DATA"], "CloudFraction")
    cf_mask = (cf < 0.3) * 1.0
    tr = read_group_nc(fname, ["ANCILLARY_DATA"], "TerrainReflectivity")
    tr_mask = (tr < 0.2) * 1.0
    qflags = read_group_nc(fname, ["SCIENCE_DATA"], "VcdQualityFlags")
    quality_flag = decode_vcd_quality_flags(qflags) * np.squeeze(cf_mask) * np.squeeze(tr_mask)
    # fixed 35-level scattering-weight pressures (reader.py:871-884)
    ps = read_group_nc(fname, ["GEOLOCATION_DATA"], "ScatteringWeightPressure").astype("float32")
    p_mid = np.broadcast_to(np.asarray(ps)[:35, None, None], (35,) + vcd.shape).astype("float32").copy()
    if read_ak:
        sws = read_group_nc(fname, ["SCIENCE_DATA"], "ScatteringWeight").astype("float32")
        sws = scrub_sws(sws.transpose((2, 0, 1)))
    else:
        sws = np.empty((1,))
    if trop:
        tropopause = read_group_nc(fname, ["ANCILLARY_DATA"], "TropopausePressure").astype("float32")
    else:
        tropopause = np.empty((1,))
    g = satellite_amf(vcd=vcd, amf=amf, time=time, tropopause=tropopause,
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("OMI_NO2", g, ctm_lon, ctm_lat, device, fast_swath)


def omi_reader_hcho(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                    device=None, fast_swath=True):
    """OMI HCHO L2 (reference reader.py:906-984); hybrid-eta 47-layer pmids."""
    print("Currently reading: " + fname.split("/")[-1])
    time = epoch_time(EPOCH_1993, np.nanmean(read_group_nc(fname, ["geolocation"], "time")))
    lat = read_group_nc(fname, ["geolocation"], "latitude").astype("float32")
    lon = read_group_nc(fname, ["geolocation"], "longitude").astype("float32")
    vcd = (read_group_nc(fname, ["key_science_data"], "column_amount") * 1e-15).astype("float32")
    amf = read_group_nc(fname, ["support_data"], "amf")
    unc = (read_group_nc(fname, ["key_science_data"], "column_uncertainty") * 1e-15).astype("float32")
    cf_mask = (read_group_nc(fname, ["support_data"], "cloud_fraction") < 0.4) * 1.0
    qf = (read_group_nc(fname, ["key_science_data"], "main_data_quality_flag") == 0.0) * 1.0
    quality_flag = np.squeeze(qf) * np.squeeze(cf_mask)
    ps = read_group_nc(fname, ["support_data"], "surface_pressure").astype("float32")
    p_mid = pmid_from_eta_edges(GEOS5_ETA_A48, GEOS5_ETA_B48, ps)
    if read_ak:
        sws = scrub_sws(read_group_nc(fname, ["support_data"], "scattering_weights").astype("float32"))
    else:
        sws = np.empty((1,))
    g = satellite_amf(vcd=vcd, amf=amf, time=time, tropopause=np.empty((1,)),
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("OMI_HCHO", g, ctm_lon, ctm_lat, device, fast_swath)


def omi_reader_o3(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                  device=None, fast_swath=True):
    """OMI total O3 L2 he5 (reference reader.py:987-1050): SZA>80 mask,
    flat 4% error model, AMF set to the column itself."""
    print("Currently reading: " + fname.split("/")[-1])
    grp = ["HDFEOS", "SWATHS", "OMI Column Amount O3", "Geolocation Fields"]
    dgrp = ["HDFEOS", "SWATHS", "OMI Column Amount O3", "Data Fields"]
    time = epoch_time(EPOCH_1993, np.nanmean(read_group_nc(fname, grp, "Time")))
    lat = read_group_nc(fname, grp, "Latitude").astype("float32")
    lon = read_group_nc(fname, grp, "Longitude").astype("float32")
    sza = read_group_nc(fname, grp, "SolarZenithAngle").astype("float32")
    vcd = np.array(read_group_nc(fname, dgrp, "ColumnAmountO3"), np.float64)
    vcd[(vcd <= 0) | np.isinf(vcd) | (sza > 80.0)] = np.nan
    vcd = vcd.astype("float32")
    qflags = read_group_nc(fname, dgrp, "QualityFlags")
    f_int = np.where(np.isfinite(qflags), qflags, 1).astype(np.int64)
    quality_flag = np.where((f_int & 1) == 0, 1.0, 0.0)
    uncertainty = (vcd * 0.04).astype("float32")
    g = satellite_amf(vcd=vcd, amf=vcd, time=time, tropopause=np.empty((1,)),
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=uncertainty,
                      quality_flag=quality_flag, pressure_mid=np.empty((1,)),
                      scattering_weights=np.empty((1,)))
    return regrid("OMI_O3", g, ctm_lon, ctm_lat, device, fast_swath)


def omi_reader(product_dir, product_name, ctm_lon, ctm_lat, YYYYMM, trop,
               read_ak=True, num_job=1, device=None, fast_swath=True):
    """OMI fleet reader (reference reader.py:1377-1413)."""
    device = fleet_device(device, ctm_lon)
    gas = product_name.split("_")[-1]
    ext = "he5" if gas == "O3" else "nc"
    pattern = product_dir + "/*" + YYYYMM[0:4] + "m" + YYYYMM[4:] + "*." + ext
    print(pattern)
    files = remove_empty_files(sorted(glob.glob(pattern)))
    if gas == "NO2":
        fn = lambda f: omi_reader_no2(f, trop, ctm_lon, ctm_lat, read_ak, device,
                                      fast_swath)
    elif gas == "HCHO":
        fn = lambda f: omi_reader_hcho(f, ctm_lon, ctm_lat, read_ak, device, fast_swath)
    elif gas == "O3":
        fn = lambda f: omi_reader_o3(f, ctm_lon, ctm_lat, read_ak, device, fast_swath)
    else:
        raise ValueError(f"unsupported OMI product {product_name}")
    return fleet_map(fn, files, num_job, f"OMI_{gas}")
