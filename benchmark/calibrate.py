"""The readings the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 [--control 1]

For each seed, in one process: the cell's inputs, one month through the
program as the window runs it (after one warm month for the first seed),
then the plain reference in float64, and with ``--control 1`` the control:
the reference in the program's place, every stage one step below the
precision the configuration states.  Prints one JSON line per seed with the
program's numbers and the control's, each against the float64 reference,
the seconds and the peak device memory each part took, the reference's
knee (and for the full OI its factor, cells and curve), the median
``sigma_b / sigma_o`` of its month, and the largest and median ratio of the
program's ``error_OI`` to the reference's.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _ROOT / "benchmark"]
sys.path.insert(0, str(_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check as C  # noqa: E402
from benchmark import generators, reference as R  # noqa: E402
from benchmark.spec import load_cell  # noqa: E402


def _field(g, name):
    return g[name] if isinstance(g, dict) else getattr(g, name, None)


def readings(cell, seed: int, device, control: bool, warm: bool) -> dict:
    from benchmark import program

    config, mix = cell.config, cell.mix
    t = {}
    t0 = time.perf_counter()
    raw, ctm_raw, lon2d, lat2d = generators.make_month(config, seed)
    ctm = program.to_ctm(ctm_raw)
    ctrl = program.control_dict(config, mix, device)
    moving = bool(config["granules"].get("moving_geometry"))
    offs = generators.month_offsets(mix, seed, 2) if moving else np.zeros((2, 2))
    grans = [generators.offset_granule(g, offs[1]) for g in raw]
    t["inputs_s"] = time.perf_counter() - t0
    if warm:
        program.run_month([generators.offset_granule(g, offs[0]) for g in raw], ctm, lon2d,
                          lat2d, config, ctrl, device)
    t0 = time.perf_counter()
    month = program.run_month(grans, ctm, lon2d, lat2d, config, ctrl, device)
    torch.cuda.synchronize()
    t["program_s"] = time.perf_counter() - t0
    pf = month.fields()
    diag = month.diagnostics()
    prog_grans = list(month.grans)
    del month
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed, "diag": {k: v for k, v in diag.items()
                                  if isinstance(v, (int, float, str))}}
    ctl = None
    peak = {}
    if control:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kept = {}
        try:
            cf, cinfo = R.month_reference(grans, ctm_raw, lon2d, lat2d, config, mix,
                                          R.Precision.control(config["precision"]), device,
                                          on_regrid=lambda i, r: kept.__setitem__(i, r))
            ctl = (cf, cinfo, kept)
        except RuntimeError as e:  # a control that crashes has failed
            out["control_error"] = repr(e)[:300]
        torch.cuda.synchronize()
        t["control_s"] = time.perf_counter() - t0
        peak["control_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts = {"program": [0, 0], "control": [0, 0]}

    def on_regrid(i, r):
        names = C.compared(raw[i])
        for who, g in (("program", prog_grans[i]),
                       ("control", ctl[2].get(i) if ctl is not None else None)):
            if g is None:
                continue
            for name in names:
                if name in r and _field(g, name) is not None:
                    b, c = C.bad_share(_field(g, name), r[name], C.TOL["regrid"])
                    counts[who][0] += b
                    counts[who][1] += c
        prog_grans[i] = None
        if ctl is not None:
            ctl[2].pop(i, None)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rf, info = R.month_reference(grans, ctm_raw, lon2d, lat2d, config, mix,
                                 R.Precision.reference(), device, on_regrid=on_regrid)
    torch.cuda.synchronize()
    t["reference_s"] = time.perf_counter() - t0
    peak["reference_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["program"] = C.judge(pf, rf, counts["program"])
    out["reference_info"] = info
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = rf["ctm_averaged_vcd"] * config["control"]["ctm_error"] / 100.0 / \
            rf["sat_averaged_error"]
        err = pf["error_OI"] / rf["error_OI"]
    out["sigma_ratio_median"] = float(np.nanmedian(np.where(np.isfinite(ratio), ratio, np.nan)))
    err = err[np.isfinite(err)]
    if err.size:
        out["error_oi_ratio"] = {"max": float(err.max()), "median": float(np.median(err)),
                                 "min": float(err.min())}
    if ctl is not None:
        out["control"] = C.judge(ctl[0], rf, counts["control"])
        out["control_info"] = ctl[1]
    out["seconds"] = t
    out["peak"] = peak
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate runs on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        r = readings(cell, s, torch.device("cuda"), bool(args.control), warm=(i == 0))
        print(json.dumps(r, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
