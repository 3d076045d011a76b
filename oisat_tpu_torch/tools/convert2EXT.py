"""Convert OI diag files into GMI ExtData scaling-factor files.

Twin of ``tools/convert2EXT.py:23-70`` (reference tools/convert2EXT.py:1-124)
over the port's ``ncwriter``: each ``<GAS>_<YYYYMM>.nc`` diag becomes an
ExtData file with a (time, lat, lon) ``SF`` variable, and the 1990-2004
spin-up years get SF=1.0 placeholders on the same grid.  Host numpy only.

Usage: python -m oisat_tpu_torch.tools.convert2EXT <diag_folder> <out_folder> [--no-fake]
"""

from __future__ import annotations

import datetime
import glob
import os
import sys
import time as _time

import numpy as np

from oisat_tpu_torch.ncwriter import read_diag_nc, write_nc

__all__ = ["convert"]

GLOBAL_ATTRS = {
    "Source": "OI-SAT-TPU tool",
    "Institution": "NASA GSFC Code 614",
}


def _write_sf(path, lat2d, lon2d, sf, when):
    attrs = dict(GLOBAL_ATTRS)
    attrs["creation_time"] = _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime())
    write_nc(
        path,
        dims={"time": np.array([0.0]), "lat": np.asarray(lat2d)[:, 0],
              "lon": np.asarray(lon2d)[0, :]},
        variables={
            "time": (("time",), None, {"long_name": "time",
                                       "units": "hours since " + when.strftime("%Y-%m-%d %H:%M:%S")}),
            "lat": (("lat",), None, {"units": "degrees_north", "long_name": "latitude"}),
            "lon": (("lon",), None, {"units": "degrees_east", "long_name": "longitude"}),
            "SF": (("time", "lat", "lon"), np.asarray(sf, np.float64)[None], {"units": "fraction"}),
        },
        global_attrs=attrs,
    )


def convert(diag_folder, out_folder, fake_years=range(1990, 2005), gas="HCHO"):
    os.makedirs(out_folder, exist_ok=True)
    lat = lon = None
    for fname in sorted(glob.glob(os.path.join(str(diag_folder), "*.nc"))):
        print("Now processing " + fname)
        date = fname.split(".")[-2].split("_")[-1]
        when = datetime.datetime(int(date[0:4]), int(date[4:6]), 1)
        fields, _ = read_diag_nc(fname)
        lat, lon = fields["lat"], fields["lon"]
        _write_sf(os.path.join(str(out_folder), os.path.basename(fname)),
                  lat, lon, fields["scaling_factor"], when)
    if lat is None:
        return
    for yr in fake_years:
        for mm in range(1, 13):
            print(f"Now faking for {yr}{mm:02}")
            when = datetime.datetime(yr, mm, 1)
            _write_sf(os.path.join(str(out_folder), f"{gas}_{yr}{mm:02}.nc"),
                      lat, lon, np.ones(np.shape(lat)), when)


if __name__ == "__main__":
    fake = "--no-fake" not in sys.argv
    convert(sys.argv[1], sys.argv[2], fake_years=range(1990, 2005) if fake else [])
