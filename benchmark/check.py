"""The comparison that decides ``correct``: the window's last month against
the plain reference, at the timed sizes.

The reference (:mod:`benchmark.reference`) redoes the month from the same
raw granules and CTM: every granule's regrid, the observation operator, the
monthly average, the bias correction and the OI.  Each number compared is
one of:

* ``regrid``: the share of the month's regridded values (every field of
  every granule, the program's against the reference's) that differ by more
  than ``TOL["regrid"]`` of the reference's magnitude (floored at 1% of the
  field's largest), or are NaN on one side only;
* ``average``: the same share over the five averaged fields
  (``sat_averaged_vcd`` ... ``aux2``), at ``TOL["fields"]``;
* ``oi``: the same share over the four OI fields.

Each number's limit comes from ``benchmark/limits/<cell>.json``; a number
without one has the limit 0.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark import reference as R

__all__ = ["TOL", "bad_share", "compared", "check", "judge"]

# a value is bad beyond this share of the reference's magnitude: 1e-5 for
# the float32 regrid (~5e-7 of rounding), 1e-4 for fields fed by float32
# stages (~1e-6)
TOL = {"regrid": 1e-5, "fields": 1e-4}
AVERAGE = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2")
OI = ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")


def bad_share(p, r, tol: float):
    """(bad, counted): values of ``p`` that differ from ``r`` by more than
    ``tol`` x max(|r|, 1% of the largest |r|), or are NaN where ``r`` is
    not (or the other way round), and the values finite on either side."""
    p = torch.as_tensor(p).to(torch.float64)
    r = torch.as_tensor(r, device=p.device).to(torch.float64)
    nan_p, nan_r = torch.isnan(p), torch.isnan(r)
    both = ~nan_p & ~nan_r
    scale = float(r[both].abs().max()) if bool(both.any()) else 0.0
    den = torch.clamp(r.abs(), min=0.01 * scale)
    off = both & ((p - r).abs() > tol * den)
    bad = (nan_p != nan_r) | off
    return int(bad.sum()), int((~(nan_p & nan_r)).sum())


def compared(gran: dict) -> tuple:
    """The regridded fields of a granule that the check compares: those its
    kind regrids, and the uncertainty."""
    kind = R.granule_kind(gran["kind"])
    return kind.FIELDS2 + kind.FIELDS3 + ("uncertainty",)


def _share(pf: dict, rf: dict, names) -> float:
    b = c = 0
    for name in names:
        x, y = bad_share(pf[name], rf[name], TOL["fields"])
        b, c = b + x, c + y
    return b / max(c, 1)


def judge(pf: dict, rf: dict, regrid_counts) -> dict:
    """The numbers compared, from the program's and the reference's fields
    and the regrid's (bad, counted) values."""
    return {"regrid": regrid_counts[0] / max(regrid_counts[1], 1),
            "average": _share(pf, rf, AVERAGE), "oi": _share(pf, rf, OI)}


def reference_month(cell, raw, ctm_raw, program_grans, prec, device):
    """The reference's month in ``prec`` with the regrid counts of the
    program's granules against it (None: no regrid counts)."""
    config = cell.config
    counts = [0, 0]
    lon2d, lat2d = _ctm_grid(ctm_raw)

    def on_regrid(i, r):
        if program_grans is None:
            return
        g = program_grans[i]
        for name in compared(raw[i]):
            if name not in r:
                continue
            x, y = bad_share(getattr(g, name), r[name], TOL["regrid"])
            counts[0] += x
            counts[1] += y
        program_grans[i] = None  # the program's granule is judged: free it

    rf, info = R.month_reference(raw, ctm_raw, lon2d, lat2d, config, cell.mix, prec, device,
                                 on_regrid=on_regrid)
    return rf, info, counts


def _ctm_grid(ctm_raw):
    return np.asarray(ctm_raw["longitude"]), np.asarray(ctm_raw["latitude"])


def check(cell, seed, raw, ctm_raw, last, device) -> dict:
    """Judge the window's last month: {name: (value, limit)}."""
    pf = last.fields()
    grans = list(last.grans)
    last.grans = None
    last.session.reader_obj = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rf, _, counts = reference_month(cell, raw, ctm_raw, grans, R.Precision.reference(),
                                    torch.device(device))
    nums = judge(pf, rf, counts)
    return {name: (value, float(cell.limits.get(name, 0.0))) for name, value in nums.items()}
