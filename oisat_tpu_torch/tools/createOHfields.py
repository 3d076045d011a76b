"""Build OH number-density fields [molec/cm^3] from MERRA2-GMI monthlies.

Twin of ``tools/createOHfields.py:25-71`` (reference
tools/createOHfields.py:1-91) over the port's ``ncwriter`` and
``readers.ncio``: ``OH * N_A * PL / R / T`` from the dac (OH mixing ratio)
and met (PL, T) monthly files.  The MERRA2 root and year are arguments.
Host numpy only.

Usage: python -m oisat_tpu_torch.tools.createOHfields <out_folder> [--merra2 PATH] [--year YYYY]
"""

from __future__ import annotations

import argparse
import datetime
import os
import time as _time

import numpy as np

from oisat_tpu_torch.ncwriter import write_nc
from oisat_tpu_torch.readers.ncio import read_nc

__all__ = ["create"]

N_A = 6.02214076e23
R = 8.314e4  # cm^3 mbar / K / mol


def create(out_folder, merra2_path, year):
    os.makedirs(out_folder, exist_ok=True)
    outputs = []
    for mm in range(1, 13):
        when = datetime.datetime(year, mm, 1)
        mdir = os.path.join(merra2_path, f"Y{year}", f"M{mm:02}")
        dac = os.path.join(mdir, f"MERRA2_GMI.tavg24_3d_dac_Nv.monthly.{year}{mm:02}.nc4")
        met = os.path.join(mdir, f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4")
        oh = read_nc(dac, "OH")
        lat = read_nc(dac, "lat")
        lon = read_nc(dac, "lon")
        lev = read_nc(dac, "lev")
        pl = read_nc(met, "PL") / 100.0
        temp = read_nc(met, "T")
        oh = oh * N_A * pl / R / temp  # mixing ratio -> molec/cm^3
        path = os.path.join(str(out_folder), f"OH_Conc_{year}{mm:02}.nc")
        write_nc(
            path,
            dims={"time": np.array([0.0]), "lev": np.asarray(lev),
                  "lat": np.asarray(lat), "lon": np.asarray(lon)},
            variables={
                "time": (("time",), None, {"long_name": "time",
                                           "units": "hours since " + when.strftime("%Y-%m-%d %H:%M:%S")}),
                "lat": (("lat",), None, {"units": "degrees_north", "long_name": "latitude"}),
                "lon": (("lon",), None, {"units": "degrees_east", "long_name": "longitude"}),
                "lev": (("lev",), None, {"units": "layer", "long_name": "vertical layer",
                                         "positive": "down"}),
                "OH": (("time", "lev", "lat", "lon"), np.asarray(oh)[None], {"units": "molec cm^-3"}),
            },
            global_attrs={"Source": "OI-SAT-TPU tool",
                          "creation_time": _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime())},
        )
        outputs.append(path)
    return outputs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_folder")
    ap.add_argument("--merra2", default="/css/merra2gmi/pub")
    ap.add_argument("--year", type=int, default=2005)
    args = ap.parse_args()
    create(args.out_folder, args.merra2, args.year)
