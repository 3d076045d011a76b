"""Shared helpers of the per-sensor readers (twin of
:mod:`oisat_tpu.readers.sensors.common`).

The JAX package's pressure-table tags and pending-granule collection were
byte-cutters for its transfer link and are not ported: :func:`fleet_map` is the
fault-tolerant per-file map only, and :func:`regrid` is the one place a reader
touches the device.
"""

from __future__ import annotations

import threading
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from oisat_tpu_torch._device import default_device
from oisat_tpu_torch.readers.registry import SENSORS

__all__ = ["scrub_sws", "fleet_map", "fleet_device", "regrid", "on_device", "pmid_from_eta_edges",
           "epoch_time", "eta_mid_tables", "GEOS5_ETA_A48", "GEOS5_ETA_B48"]


def scrub_sws(sws: np.ndarray) -> np.ndarray:
    """Zero out bad scattering weights (reference reader.py:516-518 etc.):
    NaN/inf/<0/>100 -> 0."""
    if np.size(sws) == 1:
        return sws
    bad = np.isnan(sws) | np.isinf(sws) | (sws > 100.0) | (sws < 0.0)
    sws = np.array(sws, copy=True)
    sws[bad] = 0.0
    return sws


def epoch_time(epoch, seconds) -> "datetime.datetime":
    import datetime

    return epoch + datetime.timedelta(seconds=int(seconds))


def pmid_from_eta_edges(eta_a, eta_b, ps):
    """Mid-level pressures from hybrid-eta edge coefficients:
    p_mid[z] = 0.5*((a[z] + b[z]*ps) + (a[z+1] + b[z+1]*ps))."""
    eta_a = np.asarray(eta_a, np.float64)[:, None, None]
    eta_b = np.asarray(eta_b, np.float64)[:, None, None]
    ps = np.asarray(ps, np.float64)[None]
    edges = eta_a + eta_b * ps  # (L+1, H, W)
    return (0.5 * (edges[:-1] + edges[1:])).astype("float32")


def eta_mid_tables(eta_a, eta_b):
    """The mid-level (a, b) coefficient tables matching
    :func:`pmid_from_eta_edges`: ``p_mid[z] == a_mid[z] + b_mid[z]*ps``."""
    a = np.asarray(eta_a, np.float64)
    b = np.asarray(eta_b, np.float64)
    return 0.5 * (a[:-1] + a[1:]), 0.5 * (b[:-1] + b[1:])


# The decode of a file (h5py, numpy) runs in :func:`fleet_map`'s pool threads;
# whatever a reader does on the device (the regrid, the GOSAT filler) runs one
# at a time under this lock, so one stream-ordered device and the regridder's
# per-geometry plan caches see one granule after another whatever ``num_job``.
_DEVICE_LOCK = threading.Lock()


def on_device(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the readers' device lock held."""
    with _DEVICE_LOCK:
        return fn(*args, **kwargs)


def regrid(product: str, granule, ctm_lon, ctm_lat, device=None, fast_swath=True):
    """Regrid one decoded granule (host numpy leaves) onto the CTM grid with
    the constants ``SENSORS[product]`` holds, on ``device`` (None: the card).
    Without a CTM grid (``ctm_lon`` None: decode only) or without a granule
    the input is returned as it is."""
    from oisat_tpu_torch.regridder import regrid_granule, regrid_ssmis_granule

    if granule is None or ctm_lon is None:
        return granule
    print("Currently interpolating ...")
    spec = SENSORS[product]
    dev = default_device(device)
    if spec.kind == "ssmis":
        return on_device(regrid_ssmis_granule, spec.grid_size, granule, ctm_lon, ctm_lat,
                         dev, fast_swath=fast_swath)
    return on_device(regrid_granule, spec.interpolator_type, spec.grid_size, granule,
                     ctm_lon, ctm_lat, dev, flag_thresh=spec.flag_thresh,
                     fast_swath=fast_swath)


def fleet_device(device, ctm_lon):
    """The device a fleet reader regrids on, resolved before the per-file map:
    a card that is not there raises once, instead of failing every file inside
    :func:`fleet_map`.  Decode-only reads (``ctm_lon`` None) need no device."""
    return device if ctm_lon is None else default_device(device)


def fleet_map(reader, files, num_job, label):
    """Per-granule fault-tolerant fan-out (the reference's joblib role,
    reader.py:1327-1463): a failing file prints its traceback and becomes
    None, and the month continues.  ``num_job`` > 1 decodes the files in a
    thread pool (results in file order); the device work inside ``reader``
    is serialised by :func:`regrid`."""

    def safe(f):
        try:
            return reader(f)
        except Exception:
            print(f"[{label}] failed on {f}:")
            traceback.print_exc()
            return None

    if num_job <= 1 or len(files) <= 1:
        return [safe(f) for f in files]
    with ThreadPoolExecutor(max_workers=min(int(num_job), len(files))) as ex:
        return list(ex.map(safe, files))


# GEOS-5 47-layer hybrid-eta edge coefficients (hPa / unitless), the
# hard-coded tables the reference embeds in its OMI-HCHO and OMPS readers
# (reference reader.py:954-957, :1091-1100).  Physical constants, kept as
# data here.
GEOS5_ETA_A48 = np.array([
    0., 0.04804826, 6.593752, 13.1348, 19.61311, 26.09201, 32.57081, 38.98201,
    45.33901, 51.69611, 58.05321, 64.36264, 70.62198, 78.83422, 89.09992,
    99.36521, 109.1817, 118.9586, 128.6959, 142.91, 156.26, 169.609, 181.619,
    193.097, 203.259, 212.15, 218.776, 223.898, 224.363, 216.865, 201.192,
    176.93, 150.393, 127.837, 108.663, 92.36572, 78.51231, 56.38791, 40.17541,
    28.36781, 19.7916, 9.292942, 4.076571, 1.65079, 0.6167791, 0.211349,
    0.06600001, 0.01])
GEOS5_ETA_B48 = np.array([
    1., 0.984952, 0.963406, 0.941865, 0.920387, 0.898908, 0.877429, 0.856018,
    0.8346609, 0.8133039, 0.7919469, 0.7706375, 0.7493782, 0.721166,
    0.6858999, 0.6506349, 0.6158184, 0.5810415, 0.5463042, 0.4945902,
    0.4437402, 0.3928911, 0.3433811, 0.2944031, 0.2467411, 0.2003501,
    0.1562241, 0.1136021, 0.06372006, 0.02801004, 0.006960025, 8.175413e-09,
    0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0.])
