"""The system under test, as a month job drives it: the port's regrid of
every granule, then the job runner's analysis of the month.

This is the only module of the benchmark that imports the program
(``oisat_tpu_torch``); it imports nothing else of the repository.  It turns
the generators' dictionaries into the port's granule and CTM containers,
regrids each granule with :func:`oisat_tpu_torch.regridder.regrid_granule`
(the call its readers make, with the product's interpolator, grid size and
QA threshold from the configuration) and runs
:func:`oisat_tpu_torch.run.job._analyze` on a fresh driver session with the
configuration's control keys, which takes ``analyze_month_fused``.
"""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from oisat_tpu_torch import datamodel
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.regridder import regrid_granule
from oisat_tpu_torch.run.job import _analyze, month_window

from benchmark.reference import granule_kind

__all__ = ["DRIVER_FIELDS", "to_ctm", "to_granule", "Month", "run_month"]

# the nine posterior and diagnostic fields a month job writes
DRIVER_FIELDS = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")


def to_ctm(ctm: dict):
    return datamodel.ctm_model(ctm["latitude"], ctm["longitude"], list(ctm["time"]),
                               ctm["gas_profile"], ctm["pressure_mid"], [], ctm["delta_p"],
                               ctm["ctmtype"], ctm["averaged"])


def to_granule(g: dict):
    """A generator dictionary as the port's reader would hand it over: the
    container its kind names, with the fields its kind fills."""
    kind = granule_kind(g["kind"])
    return getattr(datamodel, kind.CONTAINER)(**kind.container_fields(g))


class Month:
    """One analysed month: the regridded granules (the program's, on the
    device) and the session whose nine fields and ``oi_diagnostics`` are the
    month's result."""

    def __init__(self, grans, session, regrid_s=None):
        self.grans = grans
        self.session = session
        self.regrid_s = regrid_s  # host seconds of the month's regrid loop

    def fields(self) -> dict:
        return {name: np.asarray(getattr(self.session, name)) for name in DRIVER_FIELDS}

    def diagnostics(self) -> dict:
        return dict(getattr(self.session, "oi_diagnostics", {}) or {})


def control_dict(config: dict, mix: dict, device) -> dict:
    """The job runner's control keys for this configuration and mix."""
    ctrl = dict(config["control"])
    ctrl.update(mix.get("control", {}))
    ctrl["device"] = str(device)
    return ctrl


def run_month(granules, ctm, lon2d, lat2d, config: dict, ctrl: dict, device,
              spans=None, stage_ms=None) -> Month:
    """Regrid every granule and analyse the month with a fresh driver
    session.  ``spans``: a list that receives (start, end) host seconds of
    each regrid call, each closed by a device synchronise (traced runs
    only: the synchronise changes the timing).  ``stage_ms``: the dict the
    session adds its stage milliseconds to (traced runs only)."""
    reg = config["regrid"]
    cuda = torch.device(device).type == "cuda"
    grans = []
    t_start = time.perf_counter()
    for g in granules:
        t0 = time.perf_counter() if spans is not None else 0.0
        out = regrid_granule(reg["interpolator_type"], reg["grid_size"], to_granule(g),
                             lon2d, lat2d, device, flag_thresh=reg["flag_thresh"])
        if spans is not None:
            if cuda:
                torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
        grans.append(out)
    regrid_s = time.perf_counter() - t_start
    session = oisatgmi(stage_ms=stage_ms)
    session.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    start, end = month_window(config["month"][0], config["month"][1])
    with contextlib.redirect_stdout(sys.stderr):
        _analyze(session, ctrl, ctrl["sensor"], ctrl["gas"], start, end,
                 savedaily=("diag", "month"), mesh=None)
    return Month(grans, session, regrid_s)
