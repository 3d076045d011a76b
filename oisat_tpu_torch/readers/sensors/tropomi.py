"""TROPOMI NO2 / HCHO readers (twin of
:mod:`oisat_tpu.readers.sensors.tropomi`; reference oisatgmi/reader.py:626-804, fleet :1307-1332)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat_tpu_torch.datamodel import satellite_amf
from oisat_tpu_torch.readers.ncio import read_group_nc, remove_empty_files
from oisat_tpu_torch.readers.sensors.common import (epoch_time, fleet_device,
                                                    fleet_map, regrid, scrub_sws)

EPOCH_2010 = datetime.datetime(2010, 1, 1)
PROD = ["PRODUCT"]
DET = ["PRODUCT", "SUPPORT_DATA", "DETAILED_RESULTS"]
INP = ["PRODUCT", "SUPPORT_DATA", "INPUT_DATA"]
MOLM2_TO_1E15 = 6.02214 * 1e19 * 1e-15  # mol/m^2 -> 1e15 molec/cm^2 (reader.py:660)


def tropomi_reader_no2(fname, trop, ctm_lon=None, ctm_lat=None, read_ak=True,
                       device=None, fast_swath=True):
    """TROPOMI NO2 L2 (reference reader.py:707-804)."""
    print("Currently reading: " + fname.split("/")[-1])
    t = read_group_nc(fname, PROD, "time") + np.nanmean(
        np.array(read_group_nc(fname, PROD, "delta_time")), axis=0) / 1000.0
    time = epoch_time(EPOCH_2010, np.squeeze(t))
    lat = read_group_nc(fname, PROD, "latitude").astype("float32")
    lon = read_group_nc(fname, PROD, "longitude").astype("float32")
    amf_total = read_group_nc(fname, PROD, "air_mass_factor_total")
    if not trop:
        vcd = read_group_nc(fname, DET, "nitrogendioxide_total_column")
        amf = amf_total
        unc = read_group_nc(fname, DET, "nitrogendioxide_total_column_precision")
    else:
        vcd = read_group_nc(fname, PROD, "nitrogendioxide_tropospheric_column")
        amf = read_group_nc(fname, PROD, "air_mass_factor_troposphere")
        unc = read_group_nc(fname, PROD, "nitrogendioxide_tropospheric_column_precision")
    vcd = (vcd * MOLM2_TO_1E15).astype("float32")
    unc = (unc * MOLM2_TO_1E15).astype("float32")
    quality_flag = read_group_nc(fname, PROD, "qa_value").astype("float32")
    # 34-layer TM5 edge coefficients: per-layer (base, top) pairs -> edges
    tm5_a = read_group_nc(fname, PROD, "tm5_constant_a") / 100.0
    tm5_a = np.concatenate((tm5_a[:, 0], [0.0]))
    tm5_b = read_group_nc(fname, PROD, "tm5_constant_b")
    tm5_b = np.concatenate((tm5_b[:, 0], [0.0]))
    ps = read_group_nc(fname, INP, "surface_pressure").astype("float32") / 100.0
    edges = tm5_a[:, None, None] + tm5_b[:, None, None] * np.asarray(ps, np.float64)[None]
    p_mid = (0.5 * (edges[:34] + edges[1:35])).astype("float32")
    if read_ak:
        aks = read_group_nc(fname, PROD, "averaging_kernel").astype("float32")
        sws = scrub_sws(np.moveaxis(aks, -1, 0) * np.asarray(amf_total)[None])  # SW = AK*AMF (reader.py:778)
    else:
        sws = np.empty((1,))
    if trop:
        # tropopause pressure from the TM5 layer index (reader.py:787-792), vectorized
        tl = np.asarray(read_group_nc(fname, PROD, "tm5_tropopause_layer_index"))
        tl_int = np.where(np.isfinite(tl.astype("float64")), tl, -1).astype(np.int64)
        valid = (tl_int > 0) & (tl_int < 34)
        safe = np.clip(tl_int, 0, 33)
        tropopause = np.take_along_axis(p_mid, safe[None], axis=0)[0]
        tropopause = np.where(valid, tropopause, np.nan).astype("float32")
    else:
        tropopause = np.empty((1,))
    g = satellite_amf(vcd=vcd, amf=amf, time=time, tropopause=tropopause,
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("TROPOMI_NO2", g, ctm_lon, ctm_lat, device, fast_swath)


def tropomi_reader_hcho(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                        device=None, fast_swath=True):
    """TROPOMI HCHO L2 (reference reader.py:626-705); per-file try/except
    like the reference (corrupt files are common)."""
    try:
        print("Currently reading: " + fname.split("/")[-1])
        t = read_group_nc(fname, PROD, "time") + np.nanmean(
            np.array(read_group_nc(fname, PROD, "delta_time")), axis=1) / 1000.0
        time = epoch_time(EPOCH_2010, np.squeeze(np.nanmean(t, axis=0)))
        lat = read_group_nc(fname, PROD, "latitude").astype("float32")
        lon = read_group_nc(fname, PROD, "longitude").astype("float32")
        amf_total = read_group_nc(fname, DET, "formaldehyde_tropospheric_air_mass_factor")
        vcd = (read_group_nc(fname, PROD, "formaldehyde_tropospheric_vertical_column")
               * MOLM2_TO_1E15).astype("float32")
        quality_flag = read_group_nc(fname, PROD, "qa_value").astype("float32")
        # HCHO a/b are mid-level values, not edges (reference comment reader.py:681)
        tm5_a = read_group_nc(fname, INP, "tm5_constant_a") / 100.0
        tm5_b = read_group_nc(fname, INP, "tm5_constant_b")
        ps = read_group_nc(fname, INP, "surface_pressure").astype("float32") / 100.0
        p_mid = (np.asarray(tm5_a, np.float64)[:34, None, None]
                 + np.asarray(tm5_b, np.float64)[:34, None, None]
                 * np.asarray(ps, np.float64)[None]).astype("float32")
        if read_ak:
            aks = read_group_nc(fname, DET, "averaging_kernel").astype("float32")
            sws = scrub_sws(np.moveaxis(aks, -1, 0)[:34] * np.asarray(amf_total)[None])
        else:
            sws = np.empty((1,))
        unc = (read_group_nc(fname, PROD, "formaldehyde_tropospheric_vertical_column_precision")
               * MOLM2_TO_1E15).astype("float32")
        g = satellite_amf(vcd=vcd, amf=amf_total, time=time, tropopause=np.empty((1,)),
                          latitude_center=lat, longitude_center=lon,
                          latitude_corner=[], longitude_corner=[], uncertainty=unc,
                          quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
        return regrid("TROPOMI_HCHO", g, ctm_lon, ctm_lat, device, fast_swath)
    except Exception as e:
        print(f"Error processing {fname}: {e}")
        return None


def tropomi_reader(product_dir, product_name, ctm_lon, ctm_lat, YYYYMM, trop,
                   read_ak=True, num_job=1, device=None, fast_swath=True):
    """TROPOMI fleet reader (reference reader.py:1307-1332)."""
    device = fleet_device(device, ctm_lon)
    files = remove_empty_files(sorted(
        glob.glob(product_dir + "/S5P_*" + "_L2__*___" + str(YYYYMM) + "*.nc")))
    gas = product_name.split("_")[-1]
    if gas == "NO2":
        fn = lambda f: tropomi_reader_no2(f, trop, ctm_lon, ctm_lat, read_ak, device,
                                          fast_swath)
    elif gas == "HCHO":
        fn = lambda f: tropomi_reader_hcho(f, ctm_lon, ctm_lat, read_ak, device,
                                           fast_swath)
    else:
        raise ValueError(f"unsupported TROPOMI product {product_name}")
    return fleet_map(fn, files, num_job, f"TROPOMI_{gas}")
