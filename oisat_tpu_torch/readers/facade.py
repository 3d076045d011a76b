"""The ``readers`` facade: same four-method API as the reference
(twin of :mod:`oisat_tpu.readers.facade`; reference
oisatgmi/reader.py:1466-1630).

``read_ctm_data`` loads CTM granules (GMI / HiGMI / ECCOH / CMAQ / FREE)
with optional month-averaging; ``read_satellite_data`` dispatches on the
product-name prefix to the per-sensor fleet readers, each of which globs the
month's files, decodes them on host threads and regrids every granule onto
the CTM grid on ``device`` (None: the card).  The CTM granules keep host numpy
leaves; the regridded satellite granules hold tensors on the device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from oisat_tpu_torch._device import default_device
from oisat_tpu_torch.datamodel import ctm_model
from oisat_tpu_torch.readers import ctm as ctm_readers

__all__ = ["readers"]


class readers:
    """Pipeline ingestion state: ``ctm_data`` + ``sat_data`` granule lists."""

    def __init__(self) -> None:
        self.ctm_data = None
        self.sat_data = None

    # -- registration (reference reader.py:1471-1506) ----------------------
    def add_satellite_data(self, product_name: str, product_dir: Path):
        self.satellite_product_dir = Path(product_dir)
        self.satellite_product_name = product_name

    def add_ctm_data(self, product_name: str, product_dir: Path, mcip_dir=None):
        self.ctm_product_dir = Path(product_dir)
        self.ctm_product = product_name
        self.mcip_dir = mcip_dir

    # -- CTM (reference reader.py:1552-1630) --------------------------------
    def read_ctm_data(self, YYYYMM: str, gas: str, frequency_opt: str,
                      averaging=False, num_job=1, control_free="control_free.yml"):
        product = self.ctm_product
        pdir = self.ctm_product_dir.as_posix()
        if product == "GMI":
            data = ctm_readers.GMI_reader(pdir, YYYYMM, gas,
                                          frequency_opt=frequency_opt, num_job=num_job)
            if averaging:
                print("Averaging CTM files ...")
                first = data[0]
                gp = np.nanmean(np.array([c.gas_profile for c in data]), axis=0)
                pm = np.nanmean(np.array([c.pressure_mid for c in data]), axis=0)
                dp = np.nanmean(np.array([c.delta_p for c in data]), axis=0)
                data = [ctm_model(first.latitude, first.longitude, first.time,
                                  gp, pm, [], dp, "GMI", True)]
            self.ctm_data = data
        elif product == "HiGMI":
            self.ctm_data = ctm_readers.Hi_GMI_reader(pdir, YYYYMM, gas,
                                                      frequency_opt=frequency_opt, num_job=1)
        elif product == "CMAQ":
            self.ctm_data = ctm_readers.CMAQ_reader(self.mcip_dir.as_posix(), pdir, YYYYMM, gas)
        elif product == "ECCOH":
            self.ctm_data = ctm_readers.ECCOH_reader(pdir, YYYYMM, gas, num_job=num_job)
        elif product == "FREE":
            self.ctm_data = ctm_readers.free_ctm(control_free)
        else:
            raise ValueError(f"unknown CTM product {product!r}")

    # -- satellite (reference reader.py:1508-1550) ---------------------------
    def read_satellite_data(self, YYYYMM: str, read_ak=True, trop=False,
                            num_job=1, tempo_hour=None, device=None, fast_swath=True):
        from oisat_tpu_torch.readers import sensors

        # resolved here, before any file is opened: no card and no device
        # named raises instead of reading a month and failing every granule
        kw = dict(num_job=num_job, device=default_device(device), fast_swath=fast_swath)

        satellite = self.satellite_product_name.split("_")[0]
        ctm_lat = self.ctm_data[0].latitude
        ctm_lon = self.ctm_data[0].longitude
        sat_dir = self.satellite_product_dir.as_posix()
        name = self.satellite_product_name
        if satellite == "TROPOMI":
            self.sat_data = sensors.tropomi_reader(sat_dir, name, ctm_lon, ctm_lat,
                                                   YYYYMM, trop, read_ak=read_ak, **kw)
        elif satellite == "OMI":
            self.sat_data = sensors.omi_reader(sat_dir, name, ctm_lon, ctm_lat,
                                               YYYYMM, trop, read_ak=read_ak, **kw)
        elif satellite == "OMPS":
            self.sat_data = sensors.omps_reader(sat_dir, name, ctm_lon, ctm_lat,
                                                YYYYMM, trop, read_ak=read_ak, **kw)
        elif satellite == "TEMPO":
            self.sat_data = sensors.tempo_reader(sat_dir, tempo_hour, name, ctm_lon, ctm_lat,
                                                 YYYYMM, trop, read_ak=read_ak, **kw)
        elif satellite == "MOPITT":
            self.sat_data = sensors.mopitt_reader(sat_dir, ctm_lon, ctm_lat,
                                                  YYYYMM, read_ak=read_ak, **kw)
        elif satellite == "GOSAT":
            self.sat_data = sensors.gosat_reader(sat_dir, ctm_lon, ctm_lat,
                                                 YYYYMM, read_ak=read_ak, **kw)
        elif satellite == "SSMIS":
            self.sat_data = sensors.ssmis_reader(sat_dir, ctm_lon, ctm_lat,
                                                 YYYYMM, **kw)
        else:
            raise Exception("the satellite is not supported, come tomorrow!")
