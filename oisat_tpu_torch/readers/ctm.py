"""CTM (chemical-transport-model) readers: GMI, HiGMI, ECCOH, CMAQ, FREE.

Twin of :mod:`oisat_tpu.readers.ctm`; the granules are the port's
:class:`~oisat_tpu_torch.datamodel.ctm_model` with host numpy leaves, what the
observation operators and the fused month's assembly take.  Behavioral
equivalents of the reference readers (reference
oisatgmi/reader.py:95-414, :1604-1630): fields come out bottom-to-top
(levels flipped), pressures in hPa, gas in ppbv.  The reference's joblib
process fan-out over day files (reader.py:169-170, :329-330) becomes a
thread pool (HDF5 reads release the GIL; no pickling of 4-D fields).

Precision policy: the reference downcasts fields to float32 on read — kept
here (it's the IO dtype; device compute promotes per the op dtype policy).
yaml is imported inside :func:`free_ctm`, the one function that needs it.
"""

from __future__ import annotations

import datetime
import glob
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from oisat_tpu_torch.datamodel import ctm_model
from oisat_tpu_torch.readers.ncio import get_nc_attrs, read_nc

__all__ = ["GMI_reader", "Hi_GMI_reader", "ECCOH_reader", "CMAQ_reader", "free_ctm"]


def _require_files(files, what, pattern):
    """Fail a wrong product_dir/month loudly: the downstream error from an
    empty glob is an opaque NoneType/IndexError."""
    if not files:
        raise FileNotFoundError(f"no {what} files match {pattern}")
    return files


def _stream_average(granules, n: int, ctmtype: str):
    """Streamed month mean of (gas, pmid, delta_p) — shared by the two
    readers that force averaging for memory (HiGMI, CMAQ; reference
    reader.py:249-268, :393-409).  Accumulates IN PLACE: this path exists
    because the month doesn't fit in memory, and ``a + t`` would double
    the peak (old list + new list + granule all live).  float32
    accumulation matches the reference's ``gas_profile_sum +=``."""
    acc = None
    last = None
    count = 0
    for last in granules:
        triple = (last.gas_profile, last.pressure_mid, last.delta_p)
        if acc is None:
            acc = [np.array(t, np.float32) for t in triple]
        else:
            for a, t in zip(acc, triple):
                a += t
        count += 1
    if count != n:
        # a zip() over inconsistent file lists would silently truncate and
        # then divide by the wrong n — fail instead
        raise RuntimeError(f"streamed {count} granules but expected {n} "
                           f"({ctmtype}: inconsistent file lists)")
    return [ctm_model(last.latitude, last.longitude, last.time,
                      acc[0] / n, acc[1] / n, [], acc[2] / n, ctmtype, True)]


def _pmap(fn, items, num_job):
    # threads, not processes: forked children would each open the card.
    # h5py's global lock serializes the libhdf5 calls, so num_job > 1
    # parallelizes only the numpy post-processing (the reference fans out
    # joblib processes)
    if num_job <= 1 or len(items) <= 1:
        return [fn(*it) for it in items]
    with ThreadPoolExecutor(max_workers=num_job) as ex:
        return list(ex.map(lambda it: fn(*it), items))


def _times_from_minutes(fname):
    """Decode the GMI time axis: minute offsets + begin_date/begin_time attrs
    (reference reader.py:121-135)."""
    minutes = np.atleast_1d(read_nc(fname, "time"))
    attrs = get_nc_attrs(fname, "time")
    d = str(attrs["begin_date"])
    t = str(attrs["begin_time"]).rjust(6, "0")
    base = datetime.datetime(int(d[0:4]), int(d[4:6]), int(d[6:8]),
                             int(t[0:2]), int(t[2:4]), int(t[4:6]))
    return [base + datetime.timedelta(minutes=int(m)) for m in minutes]


def _gas_var(gasname: str) -> str:
    return "CH2O" if gasname in ("HCHO", "FORM") else gasname


def _read_gmi_pair(fname_met, fname_gas, gasname, ctmtype):
    """One (met, gas) file pair -> ctm_model (reference reader.py:111-157)."""
    print("Currently reading: " + fname_met.split("/")[-1])
    lon = read_nc(fname_met, "lon")
    lat = read_nc(fname_met, "lat")
    lons, lats = np.meshgrid(lon, lat)
    time = _times_from_minutes(fname_met)
    # axis=1 assumes the (T, L, H, W) layout of the standard tavg3 day
    # files.  Hazard inherited from the reference (reader.py:20-26
    # squeezes on read): a file subset to ONE timestep would squeeze to
    # (L, H, W) and axis=1 would flip latitude instead of levels — same
    # behavior as the reference, documented here rather than fixed so the
    # two stay bit-identical on the same inputs.
    delta_p = np.flip(read_nc(fname_met, "DELP").astype("float32") / 100.0, axis=1)
    pressure_mid = np.flip(read_nc(fname_met, "PL").astype("float32") / 100.0, axis=1)
    g = _gas_var(gasname)
    if g == "H2O":
        gas = np.flip(read_nc(fname_met, "QV"), axis=1) * 1e9
    else:
        gas = np.flip(read_nc(fname_gas, g), axis=1) * 1e9  # mol/mol -> ppbv
    return ctm_model(lats, lons, time, gas.astype("float32"),
                     pressure_mid, [], delta_p, ctmtype, False)


def GMI_reader(product_dir: str, YYYYMM: str, gas: str, frequency_opt="3-hourly", num_job=1):
    """MERRA2-GMI day files: tavg3_3d met+tac pairs (reference reader.py:95-171)."""
    if frequency_opt != "3-hourly":
        raise ValueError("GMI reader supports 3-hourly files only")
    pattern = product_dir + "/*tavg3_3d_met_Nv." + str(YYYYMM) + "*.nc4"
    met = _require_files(sorted(glob.glob(pattern)), "GMI met", pattern)
    tac = sorted(glob.glob(product_dir + "/*tavg3_3d_tac_Nv." + str(YYYYMM) + "*.nc4"))
    if len(met) != len(tac):
        raise Exception("the data are not consistent")
    return _pmap(lambda m, t: _read_gmi_pair(m, t, gas, "GMI"),
                 list(zip(met, tac)), num_job)


def Hi_GMI_reader(product_dir: str, YYYYMM: str, gas: str, frequency_opt="hourly", num_job=1):
    """Hourly CONUS HiGMI; always streamed into one time-mean granule for
    memory (reference reader.py:173-269)."""
    if frequency_opt != "hourly":
        raise ValueError("HiGMI reader supports hourly files only")
    pattern = product_dir + "/*tavg1_3D_met_CONUS." + str(YYYYMM) + "*.nc4"
    met = _require_files(sorted(glob.glob(pattern)), "HiGMI met", pattern)
    gasf = sorted(glob.glob(product_dir + "/*tavg1_3D_gasconc_CONUS." + str(YYYYMM) + "*.nc4"))
    if len(met) != len(gasf):
        raise Exception("the data are not consistent")
    print("We must average HiGMI because of memory limits regardless of the user's choice")
    return _stream_average(
        (_read_gmi_pair(m, g, gas, "HiGMI") for m, g in zip(met, gasf)),
        len(met), "HiGMI")


def ECCOH_reader(product_dir: str, YYYYMM: str, gas: str, num_job=1):
    """Monthly ECCOH files; CH4 converted to dry-air mixing ratio
    (reference reader.py:271-331)."""

    def one(fname):
        print("Currently reading: " + fname.split("/")[-1])
        lon = read_nc(fname, "lon")
        lat = read_nc(fname, "lat")
        lons, lats = np.meshgrid(lon, lat)
        attrs = get_nc_attrs(fname, "time")
        d = str(attrs["begin_date"])
        time = [datetime.datetime(int(d[0:4]), int(d[4:6]), int(d[6:8]))]
        delta_p = np.flip(read_nc(fname, "DELP").astype("float32") / 100.0, axis=0)
        pressure_mid = np.flip(read_nc(fname, "PL").astype("float32") / 100.0, axis=0)
        g = "QV" if gas == "H2O" else gas
        prof = (np.flip(read_nc(fname, g), axis=0) * 1e9).astype("float32")
        if g == "CH4":
            qv = np.flip(read_nc(fname, "QV"), axis=0).astype("float32")
            w = qv / (1 - qv)
            prof = prof * (1 + w * (28.96 / 18.015))  # moist -> dry mixing ratio
        return ctm_model(lats, lons, time, prof, pressure_mid, [], delta_p, "ECCOH", False)

    files = sorted(glob.glob(product_dir + "/*eccoh_Nv." + str(YYYYMM) + "*.nc4"))
    return _pmap(lambda f: one(f), [(f,) for f in files], num_job)


def CMAQ_reader(dir_mcip: str, dir_cmaq: str, YYYYMM: str, gasname: str):
    """CMAQ CCTM conc + MCIP met; delta-p from PRES/PRSFC; always averaged
    (reference reader.py:333-414)."""

    def one(conc, met3d, met2d, grd2d):
        print("Currently reading: " + conc.split("/")[-1])
        lat = read_nc(grd2d, "LAT")
        lon = read_nc(grd2d, "LON")
        tflag = read_nc(conc, "TFLAG")
        time = []
        for t in range(tflag.shape[0]):
            date = datetime.datetime.strptime(str(tflag[t, 0, 0]), "%Y%j").date()
            time.append(datetime.datetime(date.year, date.month, date.day,
                                          int(tflag[t, 0, 1] / 10000.0), 0, 0))
        prs = read_nc(met3d, "PRES").astype("float32") / 100.0
        surf = read_nc(met2d, "PRSFC").astype("float32") / 100.0
        nl = prs.shape[1]
        delp = prs.copy()
        delp[:, 0] = 2.0 * (surf - prs[:, 0])
        delp[:, nl - 1] = prs[:, nl - 2] - prs[:, nl - 1]
        for i in range(1, nl - 1):
            delp[:, i] = 0.5 * (prs[:, i] + prs[:, i - 1]) - 0.5 * (prs[:, i + 1] + prs[:, i])
        g = "FORM" if gasname == "HCHO" else gasname
        gasv = (read_nc(conc, g) * 1000.0).astype("float32")  # ppmv -> ppbv
        return ctm_model(lat, lon, time, gasv, prs, [], delp, "CMAQ", False)

    pattern = dir_cmaq + "/CCTM_CONC_*" + YYYYMM + "*.nc"
    concs = _require_files(sorted(glob.glob(pattern)), "CMAQ conc", pattern)
    grd2d = sorted(glob.glob(dir_mcip + "/GRIDCRO2D_*" + YYYYMM + "*"))
    met2d = sorted(glob.glob(dir_mcip + "/METCRO2D_*" + YYYYMM + "*"))
    met3d = sorted(glob.glob(dir_mcip + "/METCRO3D_*" + YYYYMM + "*"))
    # ALL four lists must line up: zip() would silently truncate to the
    # shortest and the mean would divide by the wrong count
    if not (len(concs) == len(met3d) == len(met2d) == len(grd2d)):
        raise Exception(
            f"the data are not consistent: {len(concs)} CONC, "
            f"{len(met3d)} METCRO3D, {len(met2d)} METCRO2D, "
            f"{len(grd2d)} GRIDCRO2D files")
    print("We must average CMAQ because of memory limits regardless of the user's choice")
    return _stream_average(
        (one(*args) for args in zip(concs, met3d, met2d, grd2d)),
        len(concs), "CMAQ")


def free_ctm(control_free="control_free.yml"):
    """The model-free synthetic grid (reference reader.py:1604-1630): a
    user-specified lat/lon box with NaN 10-level profiles — the built-in
    fake backend that lets the whole satellite path run without model data.

    Unlike the reference (which hides this YAML read deep inside the
    facade), the control path is an argument.
    """
    import yaml

    with open(control_free, "r") as stream:
        opts = yaml.safe_load(stream)
    lon_grid = np.arange(opts["lonll"], opts["lonur"] + opts["gridsize"], opts["gridsize"])
    lat_grid = np.arange(opts["latll"], opts["latur"] + opts["gridsize"], opts["gridsize"])
    lons, lats = np.meshgrid(lon_grid, lat_grid)
    nanfield = np.full((10,) + lats.shape, np.nan)
    return [ctm_model(lats, lons, [datetime.datetime(1989, 1, 16)], nanfield.copy(),
                      nanfield.copy(), [], nanfield.copy(), "FREE", True)]
