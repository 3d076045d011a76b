"""End-to-end demo of the port on synthetic data: no input files needed.

Twin of ``examples/synthetic_month.py``: one month of synthetic OMI-NO2-like
granules plus a synthetic GMI-like CTM (the same draws from the same numpy
seeds) through the complete analysis pipeline, the way
``oisat_tpu_torch.run.job`` runs a real month:

  regrid (swath -> CTM grid)  ->  AMF recalculation  ->  monthly averaging
  ->  bias correction  ->  optimal interpolation  ->  diag netCDF + PDF report

Two paths (the ones the ``fused_month`` control key switches between):

  python -m oisat_tpu_torch.examples.synthetic_month           # staged pipeline
  python -m oisat_tpu_torch.examples.synthetic_month --fused   # one month step
  python -m oisat_tpu_torch.examples.synthetic_month --oi-method full
  python -m oisat_tpu_torch.examples.synthetic_month --fused --mesh 4

``--mesh N`` runs the regrid, the month step and the OI over a mesh of N
logical shards of the device (the sharded makers on one card, or on the
CPU with ``--device cpu``); for N cards, set ``mesh_devices`` in a
``control.yml``.

It runs on the card unless ``--device cpu`` is given.  Outputs land in
./demo_out/.  For real data, write a ``control.yml`` and run
``python -m oisat_tpu_torch.run.job <year> <month>``.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from oisat_tpu_torch._device import default_device
from oisat_tpu_torch.datamodel import ctm_model, satellite_amf
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.parallel.mesh import make_mesh
from oisat_tpu_torch.regridder import regrid_granule, regrid_mesh


def make_ctm(seed=0, nt=8, nz=12):
    """A GMI-like model month: 3-hourly profiles on a 1.25x1.0 deg grid,
    hybrid-eta pressures (pmid = A + B * psurf)."""
    rng = np.random.default_rng(seed)
    clon, clat = np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))
    H, W = clat.shape
    eta_a = np.concatenate([[0.0], np.linspace(40.0, 600.0, nz - 1)])
    eta_b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    psurf = 1000.0 + 30.0 * rng.standard_normal((nt, H, W))
    pmid = eta_a[None, :, None, None] + eta_b[None, :, None, None] * psurf[:, None]
    dp = rng.uniform(10, 40, (nt, nz, H, W))
    # ~0.5 ppbv NO2 over 12 layers integrates to a 3-4 x1e15 molec/cm2
    # column, the magnitude of the synthetic observations below
    prof = np.abs(rng.normal(0.5, 0.15, (nt, nz, H, W)))
    times = [datetime.datetime(2019, 7, 5, 3 * h) for h in range(nt)]
    return ctm_model(clat, clon, times, prof.astype("float32"),
                     pmid.astype("float32"), [], dp.astype("float32"),
                     "GMI", False), clon, clat


def make_granule(seed, day, nz=6):
    """An OMI-NO2-shaped L2 granule: VCD + AMF + scattering-weight profile
    over an 80x50 swath, with a QA flag channel (1 % bad pixels) and
    hybrid-eta pressures whose level 0 is the surface."""
    rng = np.random.default_rng(seed)
    ny, nx = 80, 50
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.01] = 0.0
    eta_a = np.linspace(0.0, 100.0, nz)
    eta_b = np.linspace(1.0, 0.02, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((ny, nx))
    return satellite_amf(
        vcd=np.abs(rng.normal(3, 1, (ny, nx))),
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))),
        time=datetime.datetime(2019, 7, day, 13, 30),
        tropopause=rng.uniform(100, 200, (ny, nx)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
        quality_flag=qa,
        pressure_mid=eta_a[:, None, None] + eta_b[:, None, None] * psurf[None],
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused", action="store_true",
                    help="run the month as one month step on the device "
                         "(the `fused_month: true` production path)")
    ap.add_argument("--oi-method", choices=("scalar", "full"), default="scalar",
                    help="per-cell OI (reference semantics) or the "
                         "full-covariance solve")
    ap.add_argument("--granules", type=int, default=6)
    ap.add_argument("--mesh", type=int, default=1,
                    help="run over a mesh of this many logical shards of the device")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default="demo_out")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    mesh = make_mesh(args.mesh, devices=[device] * args.mesh) if args.mesh > 1 else None
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    ctm, clon, clat = make_ctm()

    # 1. regrid each granule onto the CTM grid (what read_data does per file);
    #    the gridded fields stay on the device
    print(f"regridding {args.granules} granules ...")
    with regrid_mesh(mesh):
        granules = [regrid_granule(1, 0.25, make_granule(s, 4 + s), clon, clat, device,
                                   flag_thresh=0.5)
                    for s in range(args.granules)]

    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.gasname = "NO2"

    start, end = "2019-07-01", "2019-08-01"
    if args.fused:
        # observation operator + averaging + bias + OI as one month step;
        # save_daily= brings the post-operator daily fields back in one copy
        print("running the fused month ...")
        obj.analyze_month_fused("OMI", "NO2", start, end, error_ctm=50.0,
                                oi_method=args.oi_method, mesh=mesh,
                                save_daily=(str(out / "daily"), "201907"))
    else:
        print("running the staged pipeline ...")
        obj.recal_amf()                       # AMF recalculation (obs operator)
        obj.average(start, end)               # monthly statistics
        obj.bias_correct("OMI", "NO2")        # reference regression coefficients
        obj.oi("OMI", error_ctm=50.0, method=args.oi_method, mesh=mesh)

    # 2. outputs: the diag netCDF / daily .mat / PDF files the job runner writes
    if not args.fused:
        obj.savedaily(str(out / "daily"), "NO2", "201907")
    obj.write_to_nc("demo_201907", str(out))
    obj.reporting("NO2_201907_demo", "NO2", str(out))

    prior = obj.ctm_averaged_vcd
    post = obj.ctm_averaged_vcd_corrected
    m = np.isfinite(prior) & np.isfinite(post)
    print(f"\nanalysis grid {prior.shape}, {int(m.sum())} analyzed cells")
    print(f"mean prior  {np.nanmean(prior[m]):.3f}  ->  mean posterior "
          f"{np.nanmean(post[m]):.3f}  (x1e15 molec/cm2)")
    print("OI diagnostics:",
          {k: round(v, 4) if isinstance(v, float) else v
           for k, v in obj.oi_diagnostics.items()})
    print(f"\nwrote {out}/demo_201907.nc, {out}/daily/*.mat and "
          f"{out}/OI_report_NO2_201907_demo.pdf")
    return 0


if __name__ == "__main__":
    sys.exit(main())
