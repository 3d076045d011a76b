"""Re-run the OI stage from saved diagnostic files: no L2 re-read needed.

Twin of ``tools/readjust_OI.py`` (reference tools/readjust_OI.py:1-110) on
the port's scalar OI: diag netCDF -> new OI -> new diag, the source file's
global attributes passed through.  As in the twin, the ``aux1`` / ``aux2``
pair the diag writer emits is read and carried over.

Usage: python -m oisat_tpu_torch.tools.readjust_OI <diag_folder> <out_folder>
       [error_ctm_percent] [--desroziers N] [--desroziers-bins B]
       [--device DEVICE]     (default: the card)
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from oisat_tpu_torch._device import d2h, default_device, h2d
from oisat_tpu_torch.driver import _desroziers_step
from oisat_tpu_torch.ncwriter import read_diag_nc, write_diag_nc
from oisat_tpu_torch.ops.diagnostics import lat_band_index
from oisat_tpu_torch.ops.oi import oi

__all__ = ["readjust"]


def readjust(diag_folder, out_folder, error_ctm=50.0, desroziers_iterations=0,
             desroziers_bins=1, device=None):
    """Every ``*.nc`` of ``diag_folder`` re-analysed with the prior error
    ``error_ctm`` percent (and ``desroziers_iterations`` passes of So / Sa
    re-estimation, per latitude band with ``desroziers_bins`` > 1) on
    ``device`` (None: the card); returns the written paths."""
    import torch

    dev = default_device(device)
    os.makedirs(out_folder, exist_ok=True)
    outputs = []
    nb = int(desroziers_bins)
    for fname in sorted(glob.glob(os.path.join(str(diag_folder), "*.nc"))):
        print("Now processing " + fname)
        fields, tstr, attrs = read_diag_nc(fname, with_attrs=True)
        xa_np = np.asarray(fields["ctm_averaged_vcd_prior"], np.float64)
        xa, y, err = h2d(np.stack([xa_np,
                                   np.asarray(fields["sat_averaged_vcd"], np.float64),
                                   np.asarray(fields["sat_averaged_error"], np.float64)]), dev)
        so = err ** 2
        sa = (xa * error_ctm / 100.0) ** 2
        res = oi(xa, y, sa, so)
        y_clip = torch.where(y < 0, torch.zeros_like(y), y)  # what the OI assimilated
        bins = None
        if nb > 1:
            bins = h2d(lat_band_index(np.asarray(fields["lat"], np.float64), nb), dev)
        sa_total = so_total = None
        for _ in range(int(desroziers_iterations)):
            sa_step, so_step = _desroziers_step(xa, y_clip, res.xb, sa, so, bins, nb)
            sa = sa * sa_step
            so = so * so_step
            sa_total = sa_step if sa_total is None else sa_total * sa_step
            so_total = so_step if so_total is None else so_total * so_step
            res = oi(xa, y, sa, so)
        xb, ak, error = d2h(torch.stack([res.xb, res.averaging_kernel, res.error]))
        with np.errstate(invalid="ignore", divide="ignore"):
            sf = xb / xa_np
        sf = np.where(np.isnan(sf) | np.isinf(sf) | (sf == 0.0), 1.0, sf)
        out = dict(fields)
        # the source file's per-cell Desroziers scale maps describe ITS
        # tuning, not this readjustment: persist the re-estimated maps when
        # this run used binned Desroziers, otherwise drop the fields
        out.pop("desroziers_sa_scale", None)
        out.pop("desroziers_so_scale", None)
        out.update({"ctm_averaged_vcd_posterior": xb, "ak_OI": ak, "error_OI": error,
                    "scaling_factor": sf})
        if bins is not None and sa_total is not None:
            out["desroziers_sa_scale"] = d2h(sa_total)
            out["desroziers_so_scale"] = d2h(so_total)
        path = os.path.join(str(out_folder), os.path.basename(fname))
        # carry the source file's persisted OI diagnostics through the round trip
        write_diag_nc(path, out, tstr, global_attrs=attrs or None)
        outputs.append(path)
    return outputs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("diag_folder")
    ap.add_argument("out_folder")
    ap.add_argument("error_ctm", nargs="?", type=float, default=50.0)
    ap.add_argument("--desroziers", type=int, default=0,
                    help="passes of So/Sa re-estimation")
    ap.add_argument("--desroziers-bins", type=int, default=1,
                    help="estimate per latitude band")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    readjust(args.diag_folder, args.out_folder, args.error_ctm,
             desroziers_iterations=args.desroziers, desroziers_bins=args.desroziers_bins,
             device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
