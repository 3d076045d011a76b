"""TEMPO NO2 / HCHO readers (twin of :mod:`oisat_tpu.readers.sensors.tempo`;
reference oisatgmi/reader.py:416-624, fleet :1334-1361)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat_tpu_torch.datamodel import satellite_amf
from oisat_tpu_torch.readers.ncio import get_nc_attrs, read_group_nc, read_nc, remove_empty_files
from oisat_tpu_torch.readers.sensors.common import (epoch_time, fleet_device,
    fleet_map, pmid_from_eta_edges, regrid, scrub_sws)

EPOCH_1980 = datetime.datetime(1980, 1, 6)


def _fix_edge_pixels(lat, lon):
    """TEMPO edge-pixel coordinate rewrite (reference reader.py:452-465):
    non-physical coordinates are replaced by a synthetic strip outside the
    analysis domain so triangulation survives; they never enter the
    analysis."""
    lat = np.array(lat, copy=True)
    lon = np.array(lon, copy=True)
    invalid = (np.abs(lat) > 90.0) | (np.abs(lon) > 360.0)
    n = int(invalid.sum())
    if n:
        lat[invalid] = 35.0 + np.arange(n) * 0.001
        lon[invalid] = -140.0 + np.arange(n) * 0.001
    return lat, lon


def _tempo_pmid_and_sws(fname, read_ak):
    """72-level hybrid-eta pmids from the surface_pressure attrs
    (reference reader.py:498-518)."""
    attrs = get_nc_attrs(fname, "surface_pressure", group=["support_data"])
    eta_a = np.asarray(attrs["Eta_A"], np.float64)
    eta_b = np.asarray(attrs["Eta_B"], np.float64)
    ps = read_group_nc(fname, ["support_data"], "surface_pressure").astype("float32")
    p_mid = pmid_from_eta_edges(eta_a, eta_b, ps)
    if read_ak:
        sws = scrub_sws(read_group_nc(fname, ["support_data"], "scattering_weights").astype("float32"))
    else:
        sws = np.empty((1,))
    return p_mid, sws


def _tempo_quality(fname):
    """main_data_quality_flag==0 AND eff_cloud_fraction<0.2 (reader.py:489-495)."""
    qtmp = read_group_nc(fname, ["product"], "main_data_quality_flag")
    cf = read_group_nc(fname, ["support_data"], "eff_cloud_fraction")
    qf = np.full_like(np.asarray(qtmp, np.float64), -100.0)
    qf[np.asarray(qtmp) == 0.0] = 1.0
    qf[np.asarray(cf) >= 0.2] = -100.0
    return qf


def _tempo_geo(fname):
    try:  # level 2
        t = read_group_nc(fname, ["geolocation"], "time")
        lat = read_group_nc(fname, ["geolocation"], "latitude").astype("float32")
        lon = read_group_nc(fname, ["geolocation"], "longitude").astype("float32")
    except KeyError:  # level 3
        t = read_nc(fname, "time")
        lat1 = read_nc(fname, "latitude").astype("float32")
        lon1 = read_nc(fname, "longitude").astype("float32")
        lon, lat = np.meshgrid(lon1, lat1)
    time = epoch_time(EPOCH_1980, np.nanmean(t))
    lat, lon = _fix_edge_pixels(lat, lon)
    return time, lat, lon


def tempo_reader_no2(fname, trop, ctm_lon=None, ctm_lat=None, read_ak=True,
                     device=None, fast_swath=True):
    """TEMPO NO2 L2/L3 (reference reader.py:416-532)."""
    print("Currently reading: " + fname.split("/")[-1])
    time, lat, lon = _tempo_geo(fname)
    if not trop:
        vcd = (read_group_nc(fname, ["product"], "vertical_column_troposphere")
               + read_group_nc(fname, ["product"], "vertical_column_stratosphere"))
        try:
            amf = read_group_nc(fname, ["support_data"], "amf")
        except KeyError:
            amf = read_group_nc(fname, ["support_data"], "amf_total")
        unc = read_group_nc(fname, ["support_data"], "vertical_column_total_uncertainty")
    else:
        vcd = read_group_nc(fname, ["product"], "vertical_column_troposphere")
        amf = read_group_nc(fname, ["support_data"], "amf_troposphere")
        unc = read_group_nc(fname, ["product"], "vertical_column_troposphere_uncertainty")
    vcd = (vcd * 1e-15).astype("float32")
    unc = (unc * 1e-15).astype("float32")
    quality_flag = _tempo_quality(fname)
    p_mid, sws = _tempo_pmid_and_sws(fname, read_ak)
    if trop:
        tropopause = read_group_nc(fname, ["support_data"], "tropopause_pressure").astype("float32")
    else:
        tropopause = np.empty((1,))
    g = satellite_amf(vcd=vcd, amf=amf, time=time, tropopause=tropopause,
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("TEMPO_NO2", g, ctm_lon, ctm_lat, device, fast_swath)


def tempo_reader_hcho(fname, ctm_lon=None, ctm_lat=None, read_ak=True,
                      device=None, fast_swath=True):
    """TEMPO HCHO L2 (reference reader.py:535-624)."""
    print("Currently reading: " + fname.split("/")[-1])
    time, lat, lon = _tempo_geo(fname)
    vcd = (read_group_nc(fname, ["product"], "vertical_column") * 1e-15).astype("float32")
    amf = read_group_nc(fname, ["support_data"], "amf")
    unc = (read_group_nc(fname, ["product"], "vertical_column_uncertainty") * 1e-15).astype("float32")
    quality_flag = _tempo_quality(fname)
    p_mid, sws = _tempo_pmid_and_sws(fname, read_ak)
    g = satellite_amf(vcd=vcd, amf=amf, time=time, tropopause=np.empty((1,)),
                      latitude_center=lat, longitude_center=lon,
                      latitude_corner=[], longitude_corner=[], uncertainty=unc,
                      quality_flag=quality_flag, pressure_mid=p_mid, scattering_weights=sws)
    return regrid("TEMPO_HCHO", g, ctm_lon, ctm_lat, device, fast_swath)


def tempo_reader(product_dir, tempo_hour, product_name, ctm_lon, ctm_lat, YYYYMM,
                 trop, read_ak=True, num_job=1, device=None, fast_swath=True):
    """TEMPO fleet reader: hour-filtered glob (reference reader.py:1334-1361)."""
    if tempo_hour is None:
        raise ValueError(
            "TEMPO products are read per UTC hour: pass tempo_hour (0-23) "
            "to read_satellite_data (oisat_tpu_torch.run.job loops the 24 hours)")
    device = fleet_device(device, ctm_lon)
    pattern = product_dir + "/TEMPO_*_L*_*" + str(YYYYMM) + f"*T{tempo_hour:02d}*.nc"
    files = sorted(glob.glob(pattern))
    print("the number of files is " + str(len(files)))
    files = remove_empty_files(files)
    gas = product_name.split("_")[-1]
    if gas == "NO2":
        fn = lambda f: tempo_reader_no2(f, trop, ctm_lon, ctm_lat, read_ak, device,
                                        fast_swath)
    elif gas == "HCHO":
        fn = lambda f: tempo_reader_hcho(f, ctm_lon, ctm_lat, read_ak, device, fast_swath)
    else:
        raise ValueError(f"unsupported TEMPO product {product_name}")
    return fleet_map(fn, files, num_job, f"TEMPO_{gas}")
