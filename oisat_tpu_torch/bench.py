"""The port's benchmark: the twin of every row of ``bench.py``, on one NVIDIA GPU.

Run from the repository root::

    python -m oisat_tpu_torch.bench                # the headline: one JSON line
    python -m oisat_tpu_torch.bench --all          # every row, one line each
    python -m oisat_tpu_torch.bench --month        # (or --month-fused, --month-full,
                                                   #  --matfree, --year, --oi-bw,
                                                   #  --tempo, --tropomi, --campaign)
    python -m oisat_tpu_torch.bench --device cpu   # a rehearsal on the CPU

Each row is a function that runs its twin's computation on the port, checks
the result (the twin's check and the one PERF.md section 2 names for that
path; a failed check raises, so no row times a wrong result), times it, and
prints and returns one line with bench.py's five keys: ``metric``,
``value``, ``unit``, ``vs_baseline``, ``detail``.  ``detail`` holds
``"backend": "torch"``, the device (``torch.cuda.get_device_name``, the
``nvidia-smi`` power limit and the card count, with the H100 ceilings the
rooflines use; or ``{"platform": "cpu"}`` when the caller asked for the
CPU) and, for a timed row, ``median``, ``min``, ``max``, ``repeats`` and the
``timer``: CUDA events around a run of launches for device work (the median
of >= 5 estimates), the host clock closed by a device synchronise for host
work (the median of >= 5 passes).  Without ``--device cpu`` the bench runs
on the card and, where there is none, stops with the error of
``_device.resolve_device``; it never falls back to the CPU or to a plain
version.

The inputs are bitwise those of ``bench.py`` (``make_fields``,
``numpy_reference_oi``, ``_synthetic_orbit``, ``_eta_pmid``).  What differs
from the twin, and why:

* the rows take a ``device``; the regrid and month rows repeat their
  passes over the same orbits (each made inside the timed region, as
  bench.py's are) and empty the regrid's plan cache before each pass, so
  every pass pays every orbit's plan build, as a real month's new orbits
  do;
* ``bench.py``'s link probe and marginal-cost timer, its compile census and
  the affine pressure carrier have no counterpart (ROADMAP "Do not port");
* the XLA curve row has no twin (the curve's engine is picked by the
  device, not by the caller), the Pallas curve row is
  ``oi_curve_phase_kernel`` (``ak_curve.cu``, with the plain version's time
  beside it);
* the bandwidth row's fields are drawn on the card from a seeded
  ``torch.Generator``, not ``jax.random``;
* ``--all`` also runs the year (``bench.py --year`` only), and runs the
  three rows that write product files (``--tempo``, ``--tropomi``,
  ``--campaign``) only where h5py and matplotlib are installed, saying on
  stderr which it left out.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import importlib.util
import json
import shutil
import statistics
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from oisat_tpu_torch import convert, regridder
from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.datamodel import ctm_model, satellite_amf, satellite_opt, satellite_ssmis
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.obs_operators import amf_recal
from oisat_tpu_torch.ops.kernels import b_matmat as sweep
from oisat_tpu_torch.ops.kernels import covariance as cov
from oisat_tpu_torch.ops.kernels import oi_scan
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops.oi import curve_inputs, oi, regularization_grid
from oisat_tpu_torch.ops.oi_full import (
    CG_WARN_RESID,
    DENSE_SCAN_MAX_CELLS,
    compact,
    oi_full_dense,
)
from oisat_tpu_torch.ops.oi_full_matfree import oi_full_matfree
from oisat_tpu_torch.readers.sensors.common import fleet_map
from oisat_tpu_torch.regridder import regrid_granule
from oisat_tpu_torch.utils import roofline as rl

__all__ = ["make_fields", "numpy_reference_oi", "kalman_inputs", "matfree_inputs",
           "month_session", "year_granules", "bench_oi", "bench_curve_phase",
           "bench_kalman", "regrid_rows", "bench_regrid_pipelined",
           "bench_matfree", "bench_month", "bench_year", "bench_oi_bandwidth", "bench_tempo",
           "bench_tropomi", "bench_campaign_prefetch", "run_all", "main"]

REFERENCE_BUDGET_S = 43200.0  # the reference's 12 h cluster job per (month, sensor)
OI_RTOL = 1e-5  # float32 fields against the float64 reference (PERF.md section 2)
CURVE_RTOL = 1e-5  # kernel against plain curve sums, float32
STAGED_RTOL, STAGED_ATOL = 2e-4, 2e-5  # fused vs staged month (PERF.md section 2)
DRIVER_FIELDS = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")
FILE_PACKAGES = ("h5py", "matplotlib")  # what the three file rows need
MONTH = ("2019-07-01", "2019-08-01")
ORBIT_SYNTHESIS = "inside the timed region, as bench.py"


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"bench check failed: {msg}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _month_grid():
    """The 0.25 deg 160 x 120 analysis grid of bench.py's regrid and month rows."""
    clat = np.arange(20.0, 60.0, 0.25)
    clon = np.arange(-20.0, 10.0, 0.25)
    clon2, clat2 = np.meshgrid(clon, clat)
    return clon2, clat2


# ---- the inputs, bitwise bench.py's ------------------------------------------

def make_fields(H, W, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(3.0, 1.0, (H, W)))
    y = xa * rng.uniform(0.7, 1.4, (H, W)) + rng.normal(0, 0.3, (H, W))
    sa = (xa * 0.5) ** 2
    so = np.abs(rng.normal(0.4, 0.1, (H, W))) ** 2
    nanmask = rng.random((H, W)) < 0.2
    for f in (xa, y, sa, so):
        f[nanmask] = np.nan
    return (xa.astype(dtype), y.astype(dtype), sa.astype(dtype), so.astype(dtype))


def _numpy_reference(xa, y, sa, so):
    """bench.py's float64 NumPy OI (the reference's per-factor loop), with
    the knee index it picked."""
    y = np.array(y, np.float64, copy=True)
    xa = xa.astype(np.float64)
    sa = sa.astype(np.float64)
    so = so.astype(np.float64)
    y[y < 0] = 0.0
    regs = np.arange(0.1, 10.0, 0.1)
    curve = np.empty(len(regs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, r in enumerate(regs):
            k = sa * r / (sa * r + so)
            sb = (1.0 - k) * sa * r
            ak = 1.0 - sb / (sa * r)
            curve[i] = np.nanmean(ak)
        idx = kneedle_index_np(regs, curve, fallback=0)
        r = regs[idx]
        k = sa * r / (sa * r + so)
        sb = (1.0 - k) * sa * r
        ak = 1.0 - sb / (sa * r)
    inc = k * (y - xa)
    return xa + inc, ak, inc, np.sqrt(sb), idx


def numpy_reference_oi(xa, y, sa, so):
    """(xb, ak, increment, error): bench.py's ``numpy_reference_oi``."""
    return _numpy_reference(xa, y, sa, so)[:4]


def _synthetic_orbit(seed=0, ny=1644, nx=60, nz=35):
    """bench.py's OMI-NO2-shaped orbit: 74 interpolated fields (vcd, amf,
    trop, err + 35 SW + 35 hybrid-eta pmid levels) over a 1644 x 60 swath,
    as the port's host ``satellite_amf`` (without the twin's affine pressure
    tables, which the port does not carry)."""
    rng = np.random.default_rng(seed)
    along = np.linspace(25.0, 55.0, ny)[:, None]
    across = np.linspace(-15.0, 5.0, nx)[None, :]
    lat = along + 0.02 * rng.standard_normal((ny, nx))
    lon = across + 3.0 * np.sin(np.linspace(0, 2.0, ny))[:, None] + 0.02 * rng.standard_normal((ny, nx))
    eta_a = np.linspace(0.0, 100.0, nz)
    eta_b = np.linspace(1.0, 0.02, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((ny, nx))
    pm = eta_a[:, None, None] + eta_b[:, None, None] * psurf[None]
    return satellite_amf(
        vcd=2.0 + np.sin(lon / 5.0) * np.cos(lat / 7.0),
        amf=np.full((ny, nx), 1.5), time=None, tropopause=np.full((ny, nx), 150.0),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.full((ny, nx), 0.5), quality_flag=np.ones((ny, nx)),
        pressure_mid=pm, scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
        ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
        old_amf=[], new_amf=[],
    )


def _eta_pmid(nz, hw, rng):
    """A hybrid-eta CTM pressure stack (A + B*psurf), bench.py's."""
    eta_a = np.concatenate([[0.0], np.linspace(40.0, 600.0, nz - 1)])
    eta_b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal(hw)
    return eta_a[:, None, None] + eta_b[:, None, None] * ps[None]


def kalman_inputs(n):
    """bench.py's ``bench_kalman`` cells (float64 host arrays): xa, y,
    sigma_b, sigma_o over CONUS-like lat / lon."""
    rng = np.random.default_rng(1)
    return (np.abs(rng.normal(3, 1, n)), np.abs(rng.normal(3, 1, n)),
            np.abs(rng.normal(1, 0.2, n)), np.abs(rng.normal(0.6, 0.1, n)),
            rng.uniform(20, 60, n), rng.uniform(-130, -60, n))


def matfree_inputs(n_cells=64800, rows=180):
    """bench.py's ``bench_matfree`` arguments on a ``rows`` x (n_cells //
    rows) global grid (bench.py: 180 rows, a 1 deg grid)."""
    H, W = rows, n_cells // rows
    rng = np.random.default_rng(0)
    lon, lat = np.meshgrid(np.linspace(-179.5, 179.5, W), np.linspace(-89.5, 89.5, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.8, 1.3, (H, W))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    return (xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(), lat.ravel(), lon.ravel(), 300.0)


def _month_ctm(clon2, clat2, month=7, nz=20, rng=None, pmid=None):
    """bench.py's FREE CTM of a month (8 3-hourly times, 20 eta levels) as
    the port's ``ctm_model``; the draws in bench.py's order."""
    hw = clat2.shape
    return ctm_model(
        ctmtype="FREE", averaged=True, latitude=clat2, longitude=clon2,
        time=[datetime.datetime(2019, month, 15, h) for h in range(0, 24, 3)],
        pressure_mid=_eta_pmid(nz, hw, rng) if pmid is None else pmid,
        delta_p=np.full((nz,) + hw, 40.0),
        gas_profile=np.abs(rng.normal(2, 0.5, (nz,) + hw)))


# ---- the line ------------------------------------------------------------------

def device_entry(dev) -> dict:
    """The device a line ran on: the card's name, ``nvidia-smi`` power limit
    and count beside the H100 ceilings of the rooflines, or the CPU."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    power = rl.smi_query("power.limit")
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "power_limit": power, "count": torch.cuda.device_count(),
            "ceilings": {"hbm_bytes_per_s": rl.PEAK_BYTES_S,
                         "float32_flops": rl.PEAK_FLOPS[torch.float32],
                         "float64_flops": rl.PEAK_FLOPS[torch.float64],
                         "source": "NVIDIA H100 SXM data sheet, 700 W"}}


def _json_default(o):
    if isinstance(o, (np.generic, np.ndarray)):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serialisable")


def _emit(metric, value, unit, vs_baseline, detail, dev) -> dict:
    """Print and return one line: bench.py's five keys, ``detail`` with the
    backend and the device (no NaN or inf: ``allow_nan=False``)."""
    line = {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs_baseline,
            "detail": {"backend": "torch", "device": device_entry(dev), **detail}}
    print(json.dumps(line, allow_nan=False, default=_json_default), flush=True)
    return line


def _timing(stats: dict, unit: str) -> dict:
    """A timer's spread as the detail keys of a timed row."""
    return {"median": stats["median"], "min": stats["min"], "max": stats["max"],
            "repeats": stats["repeats"], "values": stats["values"], "timer": stats["timer"],
            "time_unit": unit}


NOT_MEASURED = "not measured: the run was on the CPU"


def _roofline(nbytes, ops, dtype, ms, model: str, dev):
    """The row against the H100 ceilings; on the CPU, no device number."""
    if dev.type != "cuda":
        return NOT_MEASURED
    bms, by = rl.bound_ms(nbytes, ops, dtype)
    gbps = nbytes / (ms * 1e-3) / 1e9
    return {"model": model, "bound_ms": bms, "bound_by": by, "pct_of_bound": 100.0 * bms / ms,
            "achieved_gbps": gbps, "pct_of_hbm_peak": 100.0 * gbps * 1e9 / rl.PEAK_BYTES_S}


def _max_sm_mhz() -> float:
    return float(rl.smi_query("clocks.max.sm").split()[0])


# ---- the OI headline, the curve phase, the Kalman solve ----------------------------

@functools.cache
def _reference_oi(H, W):
    """(xb, ak, increment, error, knee) of the float64 reference and its
    host seconds, once per process and size (no part of any timed value)."""
    fields64 = make_fields(H, W, dtype=np.float64)
    t0 = time.perf_counter()
    ref = _numpy_reference(*fields64)
    ref[0].sum()
    return ref, time.perf_counter() - t0


def bench_oi(H=1440, W=2880, reps=100, repeats=rl.MIN_REPEATS, device="cuda") -> dict:
    """bench.py ``main``: ``ops.oi.oi`` on ``make_fields(H, W)`` float32
    (4,147,200 cells), grid-cells/s from the median of CUDA-event estimates
    of ``reps`` calls; ``vs_baseline`` against the float64 NumPy reference
    on the host.  Checks: the reference's knee, the same NaN cells, fields
    within ``OI_RTOL``."""
    metric_name = "oi_analysis_throughput"
    dev = resolve_device(device)
    cells = H * W
    ref, t_np = _reference_oi(H, W)
    host = make_fields(H, W)
    fields = [torch.as_tensor(f, device=dev) for f in host]
    launches = oi_scan.ak_curve_sums_kernel.launches
    out = oi(*fields)
    launches = oi_scan.ak_curve_sums_kernel.launches - launches
    knee = int(out.reg_index)
    _check(knee == ref[4], f"{metric_name}: knee {knee}, the float64 reference's {ref[4]}")
    xb = out.xb.double().cpu().numpy()
    _check(np.array_equal(np.isnan(xb), np.isnan(ref[0])), f"{metric_name}: NaN cells differ")
    with np.errstate(invalid="ignore"):
        rel = np.abs((xb - ref[0]) / np.where(np.abs(ref[0]) > 1e-12, ref[0], 1.0))
    agree = float(np.nanmax(rel))
    _check(agree <= OI_RTOL, f"{metric_name}: xb {agree:.3e} from the float64 reference")
    stats = rl.median_ms(lambda: oi(*fields), reps, repeats, dev)
    ms = stats["median"]
    _, _, sa, so = host
    n_valid = int((np.isfinite(sa) & (sa != 0) & ~np.isnan(so)).sum())
    nfac = regularization_grid().size
    return _emit(metric_name, cells / (ms * 1e-3), "grid-cells/sec", t_np / (ms * 1e-3), {
        "grid": [H, W], "cells": cells, "valid_cells": n_valid,
        "kernel_launches_per_call": launches, **_timing(stats, "ms"),
        "cells_per_s_range": [cells / (stats["max"] * 1e-3), cells / (stats["min"] * 1e-3)],
        "reps_per_estimate": reps, "numpy_ms": t_np * 1e3, "knee": knee,
        "max_rel_diff_vs_f64_reference": agree,
        "roofline": _roofline(32 * cells, 3.0 * n_valid * nfac, torch.float32, ms,
                              "32 B/cell minimal HBM traffic; the curve's 3 operations "
                              "per valid cell and factor", dev)}, dev)


def bench_curve_phase(n=1440 * 2880, reps=100, repeats=rl.MIN_REPEATS, device="cuda") -> dict:
    """bench.py ``bench_curve_phase``: the curve sums of ``ak_curve.cu``
    (``ak_curve_sums``: the kernel on the card) against the plain version at
    n x 99 float32, both on the hoisted u = So/Sa; ``vs_baseline`` = plain /
    kernel.  Checks: the two agree within ``CURVE_RTOL`` and pick one knee."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    sa = torch.as_tensor(np.abs(rng.normal(2, 1, n)), dtype=torch.float32, device=dev)
    so = torch.as_tensor(np.abs(rng.normal(1, 0.5, n)), dtype=torch.float32, device=dev)
    regs_np = regularization_grid()
    regs = torch.as_tensor(regs_np, dtype=torch.float32, device=dev)
    u, valid = curve_inputs(sa, so)
    u = u.contiguous()
    n_valid = int(valid.sum())
    launches = oi_scan.ak_curve_sums_kernel.launches
    kc = oi_scan.ak_curve_sums(u, regs).double().cpu().numpy() / n_valid
    launches = oi_scan.ak_curve_sums_kernel.launches - launches
    pc = oi_scan.ak_curve_sums_plain(u, regs).double().cpu().numpy() / n_valid
    err = float(np.max(np.abs(kc - pc)))
    _check(np.allclose(kc, pc, rtol=CURVE_RTOL, atol=0), f"curve: kernel {err:.3e} from plain")
    knee = kneedle_index_np(regs_np, kc)
    _check(knee == kneedle_index_np(regs_np, pc), "curve: the kernel and plain knees differ")
    t_k = rl.median_ms(lambda: oi_scan.ak_curve_sums(u, regs), reps, repeats, dev)
    t_p = rl.median_ms(lambda: oi_scan.ak_curve_sums_plain(u, regs), reps, repeats, dev)
    ms = t_k["median"]
    bms, by = rl.ak_curve_bound(n_valid, n, regs.numel(), torch.float32)
    floor = (rl.division_floor_ms(n_valid, regs.numel(), _max_sm_mhz())
             if dev.type == "cuda" else NOT_MEASURED)
    return _emit("oi_curve_phase_kernel", ms, "ms", t_p["median"] / ms, {
        "cells": n, "valid_cells": n_valid, "factors": regs.numel(), "dtype": "float32",
        "engine": "ak_curve.cu" if dev.type == "cuda" else "plain (cpu)",
        "kernel_launches_per_call": launches, **_timing(t_k, "ms"),
        "reps_per_estimate": reps, "plain_ms": t_p["median"],
        "plain": _timing(t_p, "ms"), "max_abs_err": err, "knee": knee,
        "division_floor_ms": floor,
        "roofline": NOT_MEASURED if dev.type != "cuda" else {
            "model": "u read once, 3 operations per valid cell and factor",
            "bound_ms": bms, "bound_by": by, "pct_of_bound": 100.0 * bms / ms}}, dev)


def bench_kalman(n=8192, reps=5, repeats=rl.MIN_REPEATS, device="cuda") -> dict:
    """bench.py ``bench_kalman``: ``ops.oi_full.oi_full_dense`` (the
    covariance kernel, float32 Cholesky, column-block posterior diagonal) in
    TFLOP/s under the twin's flop models, against 67 TFLOP/s float32 outside
    the tensor cores (TF32 is off, torch's default, and checked).  Checks:
    the kernel's B bitwise the plain version's, finite fields, -0.05 < AK <
    1.05, err >= 0."""
    dev = resolve_device(device)
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "float32 matrix products must not run in TF32")
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in kalman_inputs(n)]
    xa, y, sigb, sigo, lat, lon = args
    b_auto = cov.build_covariance(lat, lon, sigb, 300.0, device=dev)
    b_plain = cov.build_covariance_plain(cov.radians_f32(lat, dev), cov.radians_f32(lon, dev),
                                         sigb, 300.0)
    _check(torch.equal(b_auto, b_plain), "kalman: the covariance kernel's B is not the plain B")
    del b_auto, b_plain
    launches = cov.build_covariance_kernel.launches
    xb, ak, inc, err = (t.cpu().numpy() for t in oi_full_dense(*args, 300.0))
    launches = cov.build_covariance_kernel.launches - launches
    _check(all(np.isfinite(f).all() for f in (xb, ak, inc, err)), "kalman: non-finite fields")
    _check(bool((ak > -0.05).all() and (ak < 1.05).all() and (err >= 0).all()),
           "kalman: AK outside (-0.05, 1.05) or a negative error")
    stats = rl.median_ms(lambda: oi_full_dense(*args, 300.0), reps, repeats, dev)
    t = stats["median"] * 1e-3
    # the twin's task-level flops (chol N^3/3 + a solve pair per diagonal
    # block) and the implementation's (one triangular solve: N^3)
    task_flops = n**3 / 3 + 2 * n**3 + 10 * n**2
    impl_flops = n**3 / 3 + n**3 + 10 * n**2
    achieved = impl_flops / t / 1e12
    return _emit("kalman_full_solve", task_flops / t / 1e12, "TFLOP/s", None, {
        "n_cells": n, "ms": stats["median"], **_timing(stats, "ms"), "reps_per_estimate": reps,
        "flop_model": "task N^3/3+2N^3+10N^2; impl half-solve N^3/3+N^3",
        "impl_tflops": achieved, "tf32": False, "covariance_launches_per_call": launches,
        "roofline": NOT_MEASURED if dev.type != "cuda" else {
            "pct_of_float32_peak": 100.0 * achieved * 1e12 / rl.PEAK_FLOPS[torch.float32],
            "ceiling": "67 TFLOP/s float32 outside the tensor cores"}}, dev)


# ---- the regrid -------------------------------------------------------------------

def _regrid_pass(seeds, fast, dev, lon2, lat2, ny, nx):
    """(milliseconds per orbit, granules) of one pass over the orbits of
    ``seeds``, each made inside the timed region as bench.py's are, the plan
    cache emptied first: every orbit of a real month has a geometry of its
    own, while the passes re-use theirs."""
    regridder._plan_cache.clear()
    t0 = time.perf_counter()
    outs = [regrid_granule(1, 0.25, _synthetic_orbit(s, ny=ny, nx=nx), lon2, lat2, dev,
                           flag_thresh=0.0, fast_swath=fast) for s in seeds]
    _sync(dev)
    return (time.perf_counter() - t0) / len(seeds) * 1e3, outs


def _check_regridded(outs, what: str) -> None:
    _check(all(g is not None for g in outs), f"{what}: an orbit missed the grid")
    _check(all(int(torch.isfinite(g.vcd).sum()) > 0 for g in outs), f"{what}: an empty orbit")


def regrid_rows(orbits=8, repeats=rl.MIN_REPEATS, ny=1644, nx=60, device="cuda") -> list:
    """bench.py ``bench_regrid(False)``, ``bench_regrid(True)`` and
    ``run_all``'s ``regrid_fast_speedup``: ms/orbit of
    ``regridder.regrid_granule`` (orbit synthesis, host plan build, device
    apply of 74 fields) onto the 0.25 deg 160 x 120 grid, the median of
    ``repeats`` passes over ``orbits`` orbits with the scipy builders (the
    twin's ``OISAT_PARITY=1``) and with the native builder, in turns
    (parity, fast, fast, parity, ...) after one warm orbit each; then the
    ratio of the two medians.  Checks: every orbit regridded, none empty."""
    dev = resolve_device(device)
    from oisat_tpu_torch import native

    _check(native.available(), "the native swath builder did not build")
    lon2, lat2 = _month_grid()
    sides = (False, True)
    for fast in sides:
        _check_regridded(_regrid_pass([0], fast, dev, lon2, lat2, ny, nx)[1], "warm-up")
    seeds = range(1, orbits + 1)
    times = {fast: [] for fast in sides}
    for k in range(repeats):
        for fast in (sides if k % 2 == 0 else sides[::-1]):
            t, outs = _regrid_pass(seeds, fast, dev, lon2, lat2, ny, nx)
            _check_regridded(outs, f"regrid fast={fast}")
            times[fast].append(t)
    stats = {fast: rl.spread(v, "host_clock") for fast, v in times.items()}
    lines = [_emit(f"regrid_orbit_{'fast' if fast else 'parity'}", stats[fast]["median"],
                   "ms/orbit", None, {
                       "fields": 74, "swath": [ny, nx], "grid_deg": 0.25, "orbits": orbits,
                       "builder": "native structured swath" if fast else "scipy qhull / cKDTree",
                       "orbit_synthesis": ORBIT_SYNTHESIS, **_timing(stats[fast], "ms/orbit")},
                   dev) for fast in sides]
    ratios = [p / f for p, f in zip(stats[False]["values"], stats[True]["values"])]
    lines.append(_emit("regrid_fast_speedup", stats[False]["median"] / stats[True]["median"],
                       "x", None, {"pair_ratios": ratios, "orbits": orbits,
                                   "order": "parity, fast, fast, parity, ..."}, dev))
    return lines


def bench_regrid_pipelined(orbits=8, repeats=rl.MIN_REPEATS, ny=1644, nx=60,
                           device="cuda") -> dict:
    """bench.py ``bench_regrid_pipelined``: the fast regrid through
    ``readers.sensors.common.fleet_map`` (the production fan-out), each
    orbit made inside the reader as the twin's is.  The port's regrid ends
    each granule in a device synchronise (its off-domain check), so nothing
    overlaps: expect the sequential row's number."""
    dev = resolve_device(device)
    lon2, lat2 = _month_grid()

    def reader(s):
        return regrid_granule(1, 0.25, _synthetic_orbit(s, ny=ny, nx=nx), lon2, lat2, dev,
                              flag_thresh=0.0, fast_swath=True)

    _check_regridded([reader(0)], "warm-up")

    def one_pass():
        regridder._plan_cache.clear()
        _check_regridded(fleet_map(reader, list(range(1, orbits + 1)), 1, "bench"),
                         "pipelined regrid")

    secs = rl.host_s(one_pass, repeats, dev)
    stats = rl.spread([v / orbits * 1e3 for v in secs["values"]], "host_clock")
    return _emit("regrid_orbit_fast_pipelined", stats["median"], "ms/orbit", None, {
        "fields": 74, "swath": [ny, nx], "grid_deg": 0.25, "orbits": orbits,
        "pipeline": "fleet_map, num_job 1", "orbit_synthesis": ORBIT_SYNTHESIS,
        **_timing(stats, "ms/orbit")}, dev)


# ---- the matrix-free solve ----------------------------------------------------------

def _converged(cg_resid, resid_abs, stat_norm) -> bool:
    """The matrix-free solve converged: its relative residual under
    ``CG_WARN_RESID``, or its field-error bound under 0.3 of the posterior
    std's norm (where ops/oi_full.py prints no warning)."""
    return bool(cg_resid <= CG_WARN_RESID
                or (resid_abs is not None and resid_abs <= 0.3 * stat_norm))


MATFREE_CELLS = 64800  # bench.py's 1 deg global grid, the "64k" of the metric's name


def bench_matfree(n_cells=MATFREE_CELLS, rows=180, block=2048, device="cuda") -> dict:
    """bench.py ``bench_matfree``: ``ops.oi_full_matfree.oi_full_matfree``
    on the 1 deg global grid (64,800 cells: Nystrom PCG), host seconds of a
    first and a second call.  The metric keeps its twin's name at any
    ``n_cells``; ``detail.size`` says whether the run was cut.  Checks: finite fields, -0.05 < AK < 1.05,
    err >= 0, the second call bitwise the first.  Whether the PCG converged
    (``cg_resid`` under 1e-4, or ``resid_abs`` under 0.3 ``stat_norm``, the
    norm of the posterior std) is recorded, not required: the twin's
    unconverged result is the result."""
    dev = resolve_device(device)
    args = matfree_inputs(n_cells, rows)

    def call():
        t0 = time.perf_counter()
        res = oi_full_matfree(*args, block=block, device=dev)
        _sync(dev)
        return res, time.perf_counter() - t0

    first, first_s = call()
    launches = sweep.b_matmat_kernel.launches
    (xb, ak, inc, err, info), t = call()
    launches = sweep.b_matmat_kernel.launches - launches
    _check(all(np.array_equal(a, b) for a, b in zip(first[:4], (xb, ak, inc, err))),
           "matfree: a repeat differs from the first call")
    _check(all(np.isfinite(f).all() for f in (xb, ak, inc, err)), "matfree: non-finite fields")
    _check(bool((ak > -0.05).all() and (ak < 1.05).all() and (err >= 0).all()),
           "matfree: AK outside (-0.05, 1.05) or a negative error")
    stat_norm = float(np.linalg.norm(err))
    resid_abs = info.get("resid_abs")
    converged = _converged(info["cg_resid"], resid_abs, stat_norm)
    size = ("full: bench.py's 64,800 cells" if xb.size == MATFREE_CELLS
            else f"cut: {xb.size} cells of bench.py's {MATFREE_CELLS}")
    npad = -(-xb.size // block) * block
    sweep_bound, sweep_by = rl.b_matmat_bound(npad, 1)
    return _emit("oi_full_matfree_64k", t, "s", None, {
        **info, "cells": xb.size, "size": size, "rows": rows, "block": block, "first_s": first_s,
        "sweep_engine": "kernel" if dev.type == "cuda" else "plain",
        "b_matmat_launches": launches,
        "sweep_bound_ms_k1": sweep_bound, "sweep_bound_by": sweep_by,
        "repeats": 1, "timer": "host_clock", "stat_norm": stat_norm,
        "resid_abs_over_stat_norm": None if resid_abs is None else resid_abs / stat_norm,
        "converged": converged}, dev)


# ---- the months and the year ----------------------------------------------------------

def month_session(orbits=60, fused=False, oi_method="scalar", device="cuda"):
    """One synthetic month as bench.py's ``bench_month.run_once``: the half
    orbits of seeds 0 .. ``orbits`` - 1 (822 x 60: the 30-day pace), each
    made and regridded inside the timed region through ``fleet_map`` onto
    the 160 x 120 grid (the plan cache emptied first), the FREE CTM, then
    ``analyze_month_fused(oi_method=)`` or the staged ``amf_recal ->
    average -> bias_correct -> oi``.  Returns (session, (total, regrid,
    analysis or AMF seconds), granule count), each stage closed by a device
    synchronise."""
    dev = resolve_device(device)
    lon2, lat2 = _month_grid()
    regridder._plan_cache.clear()
    t_start = time.perf_counter()

    def one(s):
        return regrid_granule(1, 0.25, _synthetic_orbit(s, ny=822, nx=60), lon2, lat2, dev,
                              flag_thresh=0.0)

    outs = fleet_map(one, list(range(orbits)), 1, "bench-month")
    grans = []
    for s, g in enumerate(outs):
        if g is not None:
            g.time = datetime.datetime(2019, 7, 1 + (s % 28), 12)
            grans.append(g)
    _sync(dev)
    t_regrid = time.perf_counter()
    ctm = _month_ctm(lon2, lat2, rng=np.random.default_rng(0))
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    if fused:
        obj.analyze_month_fused("OMI", "NO2", *MONTH, oi_method=oi_method)
        _sync(dev)
        t_op = time.perf_counter()
    else:
        amf_recal([ctm], grans)
        _sync(dev)
        t_op = time.perf_counter()
        obj.average(*MONTH)
        obj.bias_correct("OMI", "NO2")
        obj.oi("OMI", method=oi_method)
    np.asarray(obj.ctm_averaged_vcd_corrected)
    _sync(dev)
    t_end = time.perf_counter()
    return obj, (t_end - t_start, t_regrid - t_start, t_op - t_regrid), len(grans)


def _check_analysed(obj, sensor: str, what: str) -> None:
    """A posterior wherever the OI had a prior, an observation and an error."""
    xa, y = (np.asarray(f) for f in obj._oi_pair(sensor))
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(obj.sat_averaged_error)
    _check(both.any(), f"{what}: no cell with a prior, an observation and an error")
    _check(np.isfinite(obj.ctm_averaged_vcd_corrected[both]).all(),
           f"{what}: the posterior is not finite where the prior and observation are")


def _assert_fields_agree(a, b, what: str) -> None:
    """The nine driver fields of two sessions within the fused-vs-staged
    bound (the absolute part on the field's largest magnitude)."""
    for name in DRIVER_FIELDS:
        x, y = (np.asarray(getattr(o, name), np.float64) for o in (a, b))
        _check(x.shape == y.shape and np.array_equal(np.isnan(x), np.isnan(y)),
               f"{what}: {name} shape or NaN cells differ")
        if np.isfinite(y).any():
            atol = STAGED_ATOL * float(np.nanmax(np.abs(y)))
            _check(np.allclose(x, y, rtol=STAGED_RTOL, atol=atol, equal_nan=True),
                   f"{what}: {name} beyond rtol {STAGED_RTOL} / atol {atol:.3e}")


def _full_branch(obj) -> dict:
    """The cells the full OI solved and the branch it took."""
    n = int(compact(*obj.full_oi_inputs(50.0, "OMI")).idx.size)
    d = obj.oi_diagnostics
    out = {"oi_cells": n, "branch": "dense" if n <= DENSE_SCAN_MAX_CELLS else "matrix-free"}
    for key in ("solver", "precond", "cg_iters", "cg_resid", "resid_abs", "stat_norm",
                "f64_resid", "exact_diag"):
        if key in d:
            out[key] = d[key]
    if "cg_resid" in d:
        out["converged"] = _converged(d["cg_resid"], d.get("resid_abs"), d.get("stat_norm", 0.0))
    return out


def bench_month(orbits=60, fused=False, oi_method="scalar", repeats=rl.MIN_REPEATS,
                device="cuda") -> dict:
    """bench.py ``bench_month``: a synthetic month of ``orbits`` half orbits
    (:func:`month_session`), a cold run and the median of ``repeats`` warm
    runs (host clock); ``vs_baseline`` = the reference's 12 h budget over
    the median.  Checks: every orbit regridded, a finite posterior where the
    OI's inputs are, and (scalar OI) the staged and fused months agree on
    the nine driver fields with one factor; (``oi_method="full"``) every
    repeat bitwise the cold run, the branch, its cells and its convergence
    in the detail."""
    dev = resolve_device(device)
    name = "synthetic_month_fused" if fused else "synthetic_month_steady"
    if oi_method == "full":
        name = "synthetic_month_fused_oifull"
    cold, (cold_s, *_), n_grans = month_session(orbits, fused, oi_method, dev)
    _check(n_grans == orbits, f"{name}: {n_grans} of {orbits} orbits regridded")
    _check_analysed(cold, "OMI", name)
    runs = []
    for _ in range(repeats):
        obj, stages, _ = month_session(orbits, fused, oi_method, dev)
        runs.append(stages)
        if oi_method == "full":
            _check(all(np.array_equal(getattr(obj, f), getattr(cold, f), equal_nan=True)
                       for f in DRIVER_FIELDS), f"{name}: a repeat differs from the cold run")
    detail = {}
    if oi_method == "full":
        detail = _full_branch(cold)
    else:
        twin, _, _ = month_session(orbits, not fused, oi_method, dev)
        other = "staged" if fused else "fused"
        _check(twin.oi_diagnostics["n"] == cold.oi_diagnostics["n"],
               f"{name}: the {other} month analysed other cells")
        _assert_fields_agree(cold, twin, f"{name} against the {other} month")
        detail["fused_vs_staged"] = f"nine fields within rtol {STAGED_RTOL} / atol {STAGED_ATOL}"
    stats = rl.spread([r[0] for r in runs], "host_clock")
    steady = stats["median"]
    return _emit(name, steady, "s", REFERENCE_BUDGET_S / steady, {
        "orbits": orbits, "cold_s": cold_s, **_timing(stats, "s"),
        "regrid_s": statistics.median(r[1] for r in runs),
        ("analysis_s" if fused else "amf_s"): statistics.median(r[2] for r in runs),
        "oi_method": oi_method, "ctm": "eta", "orbit_synthesis": ORBIT_SYNTHESIS,
        "reference_budget_s": REFERENCE_BUDGET_S, **detail}, dev)


def year_granules(sensor: str, month: int, orbits=60, device="cuda", rng=None):
    """bench.py ``bench_year``'s granules of one (kind, month) on the 160 x
    120 grid, as the fused month takes them on ``device``: OMI orbits
    (seeds s + 100 month) regridded; MOPITT, GOSAT and SSMIS days (28, from
    ``default_rng(1000 / 2000 / 3000 + month)``) moved there."""
    dev = resolve_device(device)
    lon2, lat2 = _month_grid()
    hw = lat2.shape
    if sensor == "OMI":
        def one(s):
            return regrid_granule(1, 0.25, _synthetic_orbit(s + 100 * month, ny=822, nx=60),
                                  lon2, lat2, dev, flag_thresh=0.0)

        grans = []
        for s, g in enumerate(fleet_map(one, list(range(orbits)), 1, "bench-year")):
            if g is not None:
                g.time = datetime.datetime(2019, month, 1 + (s % 28), 12)
                grans.append(g)
        return grans
    ls, f32 = 9, "float32"
    r = np.random.default_rng({"MOPITT": 1000, "GOSAT": 2000, "SSMIS": 3000}[sensor] + month)

    def mopitt(day):
        vcd = np.abs(r.normal(2, 0.5, hw))
        vcd[r.random(hw) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd.astype(f32), time=datetime.datetime(2019, month, 1 + day, 12),
            tropopause=np.empty((1,)), latitude_center=lat2, longitude_center=lon2,
            uncertainty=np.abs(r.normal(0.3, 0.05, hw)).astype(f32), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (ls,) + hw), axis=0)[::-1].copy().astype(f32),
            averaging_kernels=r.uniform(0, 0.5, (ls + 1,) + hw).astype(f32),
            aprior_column=np.abs(r.normal(2, 0.3, hw)).astype(f32),
            apriori_profile=np.abs(r.normal(80, 15, (ls,) + hw)).astype(f32),
            surface_pressure=np.full(hw, 1000.0, f32),
            apriori_surface=np.abs(r.normal(90, 10, hw)).astype(f32),
            x_col=np.abs(r.normal(0.1, 0.02, hw)).astype(f32),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    def gosat(day):
        x_col = np.abs(r.normal(1.8, 0.1, hw))
        x_col[r.random(hw) < 0.3] = np.nan
        return satellite_opt(
            vcd=np.abs(r.normal(2, 0.5, hw)).astype(f32),
            time=datetime.datetime(2019, month, 1 + day, 12),
            tropopause=np.empty((1,)), latitude_center=lat2, longitude_center=lon2,
            uncertainty=np.abs(r.normal(0.05, 0.01, hw)).astype(f32), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (ls,) + hw), axis=0)[::-1].copy().astype(f32),
            averaging_kernels=r.uniform(0.2, 1.0, (ls,) + hw).astype(f32),
            aprior_column=np.zeros(hw, f32),
            apriori_profile=np.abs(r.normal(1.7, 0.1, (ls,) + hw)).astype(f32),
            surface_pressure=np.zeros(hw, f32), apriori_surface=np.zeros(hw, f32),
            x_col=x_col.astype(f32),
            pressure_weight=np.full((ls,) + hw, 1.0 / ls, f32),
            sensor="GOSAT", ctm_upscaled_needed=False)

    def ssmis(day):
        vcd = np.abs(r.normal(20, 5, hw))
        vcd[r.random(hw) < 0.2] = np.nan
        return satellite_ssmis(
            vcd=vcd.astype("float32"),
            uncertainty=np.abs(r.normal(1.0, 0.2, hw)).astype("float32"),
            time=datetime.datetime(2019, month, 1 + day, 12),
            latitude_center=lat2, longitude_center=lon2,
            ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMIS")

    make = {"MOPITT": mopitt, "GOSAT": gosat, "SSMIS": ssmis}[sensor]
    return [convert.granule_to(make(d), dev) for d in range(28)]


YEAR_PLAN = (("OMI", "NO2"), ("MOPITT", "CO"), ("GOSAT", "CH4"), ("SSMIS", "PWV"))


def bench_year(orbits=60, months=12, device="cuda") -> dict:
    """bench.py ``bench_year``: ``months`` months x the four granule kinds
    (OMI with the real regrid, MOPITT, GOSAT, SSMIS), each through
    ``analyze_month_fused``, in one process (host clock; each month's
    granules are made inside it, as the twin's are).  ``vs_baseline`` = the
    reference's 4 x 12 cluster jobs of 12 h over the total.  Checks: a
    finite posterior where each month's OI inputs are."""
    dev = resolve_device(device)
    lon2, lat2 = _month_grid()
    rng = np.random.default_rng(0)
    pm3 = _eta_pmid(20, lat2.shape, rng)
    month_times = {sensor: [] for sensor, _ in YEAR_PLAN}
    t_year0 = time.perf_counter()
    for month in range(1, months + 1):
        c = [_month_ctm(lon2, lat2, month=month, rng=rng, pmid=pm3)]
        end = f"2019-{month + 1:02}-01" if month < 12 else "2020-01-01"
        for sensor, gas in YEAR_PLAN:
            t0 = time.perf_counter()
            obj = oisatgmi()
            obj.reader_obj = SimpleNamespace(ctm_data=c, sat_data=year_granules(
                sensor, month, orbits, dev))
            obj.analyze_month_fused(sensor, gas, f"2019-{month:02}-01", end)
            np.asarray(obj.ctm_averaged_vcd_corrected)
            _sync(dev)
            month_times[sensor].append(time.perf_counter() - t0)
            _check_analysed(obj, sensor, f"year {sensor} month {month}")
    total = time.perf_counter() - t_year0
    med = {k: statistics.median(v) for k, v in month_times.items()}
    first = sum(v[0] for v in month_times.values())
    steady = sum(med.values())
    jobs = len(YEAR_PLAN) * months
    return _emit("full_year_all_sensor", total, "s", jobs * REFERENCE_BUDGET_S / total, {
        "months": months, "kinds": len(YEAR_PLAN), "omi_orbits_per_month": orbits,
        "repeats": 1, "timer": "host_clock", "month_s_per_kind": month_times,
        "median_month_s_per_kind": med, "first_month_all_kinds_s": first,
        "steady_month_all_kinds_s": steady, "first_over_steady": first / max(steady, 1e-9),
        "ctm": "eta", "orbit_synthesis": ORBIT_SYNTHESIS,
        "reference_budget_s": jobs * REFERENCE_BUDGET_S}, dev)


# ---- the bandwidth-regime OI ------------------------------------------------------------

def bench_oi_bandwidth(H=6144, W=12288, reps=20, repeats=rl.MIN_REPEATS, device="cuda") -> dict:
    """bench.py ``bench_oi_bandwidth``: ``oi(regularization_on=False)`` on
    75M float32 cells made on the device from a seeded ``torch.Generator``
    (the twin draws them with ``jax.random``: other values, the same law),
    against the 32 B/cell HBM floor.  Checks: the factor is 1 and the first
    8 rows equal a float64 NumPy Kalman update within ``OI_RTOL``."""
    dev = resolve_device(device)
    cells = H * W
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    xa = torch.abs(3.0 + torch.randn((H, W), generator=g, device=dev))
    y = xa * torch.empty((H, W), device=dev).uniform_(0.8, 1.3, generator=g)
    sa = (xa * 0.5) ** 2
    so = torch.abs(0.8 + 0.2 * torch.randn((H, W), generator=g, device=dev)) ** 2
    out = oi(xa, y, sa, so, regularization_on=False)
    _check(int(out.reg_index) == 0 and float(out.reg_factor) == 1.0, "oi_bw: the factor is not 1")
    a, b, c, d = (t[:8].double().cpu().numpy() for t in (xa, y, sa, so))
    want = a + c / (c + d) * (b - a)
    _check(np.allclose(out.xb[:8].double().cpu().numpy(), want, rtol=OI_RTOL, atol=0),
           "oi_bw: xb differs from the float64 Kalman update")
    del out
    stats = rl.median_ms(lambda: oi(xa, y, sa, so, regularization_on=False), reps, repeats, dev)
    ms = stats["median"]
    return _emit("oi_analysis_throughput_bw", cells / (ms * 1e-3), "grid-cells/sec", None, {
        "grid": [H, W], "cells": cells, **_timing(stats, "ms"), "reps_per_estimate": reps,
        "roofline": _roofline(32 * cells, 10.0 * cells, torch.float32, ms,
                              "32 B/cell minimal HBM traffic, ~10 operations per cell", dev),
        "fields": "drawn on the device from torch.Generator(seed 0), not jax.random",
        "note": "regularization off (the pure Kalman update)"}, dev)


# ---- the job-level rows: product files through the port's job runner ------------------------

def _write_bench_gmi_pair(met_path, gas_path, yyyymm, day, nt=8, nz=20,
                          nlat=160, nlon=120, gas="NO2"):
    """bench.py's MERRA2-GMI file pair (hybrid-eta PL)."""
    import h5py

    minutes = np.arange(nt) * 180.0 + 90.0
    with h5py.File(met_path, "w") as f:
        f["lon"] = np.linspace(-20.0, 9.75, nlon)
        f["lat"] = np.linspace(20.0, 59.75, nlat)
        t = f.create_dataset("time", data=minutes)
        t.attrs["begin_date"] = np.int32(yyyymm * 100 + day)
        t.attrs["begin_time"] = np.int32(0)
        f["DELP"] = np.full((nt, nz, nlat, nlon), 4000.0, np.float32)
        eta_a = np.linspace(10000.0, 0.0, nz)
        eta_b = np.linspace(0.0, 0.9, nz)
        ps = 100000.0 + 3000.0 * np.random.default_rng(day).standard_normal(
            (nt, 1, nlat, nlon))
        f["PL"] = (eta_a[None, :, None, None]
                   + eta_b[None, :, None, None] * ps).astype(np.float32)
    with h5py.File(gas_path, "w") as f:
        f[gas] = np.full((nt, nz, nlat, nlon), 2e-9, np.float32)


def _write_bench_tempo(path, hour, ny=360, nx=240, nl=26, seed=0):
    """bench.py's TEMPO L2 NO2 granule file."""
    import h5py

    r = np.random.default_rng(seed)
    lat = np.linspace(24.0, 44.0, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-18.0, 6.0, nx)[None, :]
    with h5py.File(path, "w") as f:
        g = f.create_group("geolocation")
        g["time"] = np.full(ny, (datetime.datetime(2023, 9, 5, hour)
                                 - datetime.datetime(1980, 1, 6)).total_seconds())
        g["latitude"] = lat
        g["longitude"] = lon
        p = f.create_group("product")
        p["vertical_column_troposphere"] = np.abs(
            r.normal(4.0e15, 1e15, (ny, nx))).astype(np.float32)
        p["vertical_column_troposphere_uncertainty"] = np.full(
            (ny, nx), 1.0e15, np.float32)
        p["main_data_quality_flag"] = np.zeros((ny, nx), np.float32)
        s = f.create_group("support_data")
        s["amf_troposphere"] = np.full((ny, nx), 1.8, np.float32)
        s["eff_cloud_fraction"] = np.full((ny, nx), 0.05, np.float32)
        ps = s.create_dataset(
            "surface_pressure", data=np.full((ny, nx), 1000.0, np.float32))
        ps.attrs["Eta_A"] = np.linspace(0, 1, nl + 1)
        ps.attrs["Eta_B"] = np.linspace(1, 0, nl + 1)
        s["scattering_weights"] = np.abs(
            r.normal(1.0, 0.2, (nl, ny, nx))).astype(np.float32)
        s["tropopause_pressure"] = np.full((ny, nx), 140.0, np.float32)


def _write_bench_tropomi(path, day, ny=600, nx=300, nl=34, seed=0, month=7):
    """bench.py's TROPOMI L2 NO2 orbit file."""
    import h5py

    r = np.random.default_rng(seed)
    lat = np.linspace(21.0, 59.0, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-19.0, 9.0, nx)[None, :]
    with h5py.File(path, "w") as f:
        p = f.create_group("PRODUCT")
        p["time"] = np.array([(datetime.datetime(2019, month, day)
                               - datetime.datetime(2010, 1, 1)).total_seconds()])
        p["delta_time"] = np.full(ny, 3_600_000.0)
        p["latitude"] = lat
        p["longitude"] = lon
        p["air_mass_factor_total"] = np.full((ny, nx), 2.2, np.float32)
        p["nitrogendioxide_tropospheric_column"] = np.abs(
            r.normal(8e-5, 2e-5, (ny, nx))).astype(np.float32)
        p["air_mass_factor_troposphere"] = np.full((ny, nx), 1.9, np.float32)
        p["nitrogendioxide_tropospheric_column_precision"] = np.full(
            (ny, nx), 2e-5, np.float32)
        p["qa_value"] = np.full((ny, nx), 0.9, np.float32)
        p["tm5_constant_a"] = np.column_stack(
            [np.linspace(0, 1, nl), np.linspace(1, 2, nl)])
        p["tm5_constant_b"] = np.column_stack(
            [np.linspace(1, 0, nl), np.linspace(0.9, 0, nl)])
        p["averaging_kernel"] = np.abs(
            r.normal(1.0, 0.2, (ny, nx, nl))).astype(np.float32)
        p["tm5_tropopause_layer_index"] = np.full((ny, nx), 20, np.int32)
        sd = p.create_group("SUPPORT_DATA")
        sd.create_group("INPUT_DATA")["surface_pressure"] = np.full(
            (ny, nx), 101325.0, np.float32)
        sd.create_group("DETAILED_RESULTS")


def _bench_job_ctrl(tmp, sensor, yyyymm, device):
    """bench.py's control dictionary, plus the port's ``device`` key."""
    return {
        "python_bin": "python3", "debug": False, "save_daily": False,
        "num_job": 1, "ctm_name": "GMI", "ctm_dir": str(tmp / "ctm"),
        "mcip_dir": str(tmp), "ctm_freq": "3-hourly", "ctm_avg": True,
        "ctm_error": 50.0, "gas": "NO2", "sensor": sensor, "read_AK": True,
        "troposphere_only": True, "sat_dir": str(tmp / "sat"),
        "start_date": f"{yyyymm // 100}-{yyyymm % 100:02}",
        "end_date": f"{yyyymm // 100}-{yyyymm % 100:02}",
        "output_pdf_dir": str(tmp / "report"),
        "output_nc_dir": str(tmp / "diag"), "fused_month": True,
        "device": str(device),
    }


def _absent_file_packages() -> list:
    return [p for p in FILE_PACKAGES if importlib.util.find_spec(p) is None]


def _need_file_packages(row: str) -> None:
    """ImportError naming what the row needs (h5py writes the product files,
    matplotlib the job's PDF report) where it is absent."""
    absent = _absent_file_packages()
    if absent:
        raise ImportError(f"{row} needs {' and '.join(absent)} (not installed): it writes "
                          "product files with h5py and the job's PDF report with matplotlib")


def bench_tempo(days=3, hours=24, device="cuda") -> dict:
    """bench.py ``bench_tempo``: a TEMPO month through
    ``oisat_tpu_torch.run.job.run_month``'s 24-hour loop over ``days`` days
    of files for the first ``hours`` UTC hours (bench.py: all 24; each hour
    a fused sub-month with its report and diag file; an hour without files
    fails inside the loop and the loop goes on), host clock.  Checks: one
    diag file per hour with files."""
    _need_file_packages("bench_tempo")
    from oisat_tpu_torch.run.job import run_month

    dev = resolve_device(device)
    tmp = Path(tempfile.mkdtemp(prefix="bench_tempo_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        for d in range(1, days + 1):
            _write_bench_gmi_pair(
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_met_Nv.202309{d:02}.nc4",
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_tac_Nv.202309{d:02}.nc4",
                202309, d)
            for hour in range(hours):
                _write_bench_tempo(
                    tmp / "sat" / f"TEMPO_NO2_L2_202309{d:02}T{hour:02d}0000.nc",
                    hour, seed=d * 100 + hour)
        ctrl = _bench_job_ctrl(tmp, "TEMPO", 202309, dev)
        marks = []
        t0 = time.perf_counter()
        run_month(ctrl, 2023, 9, on_hour=lambda h: marks.append(time.perf_counter()))
        _sync(dev)
        total = time.perf_counter() - t0
        n_nc = len(list((tmp / "diag").glob("*.nc")))
        _check(n_nc == hours, f"tempo: {n_nc} diag files for {hours} hours")
        hour_s = np.diff(marks + [t0 + total])[:hours]
        return _emit("tempo_month_24h", total, "s", REFERENCE_BUDGET_S / total, {
            "days": days, "hours": hours, "diag_files": n_nc, "repeats": 1,
            "timer": "host_clock", "hour_s": hour_s,
            "reference_budget_s": REFERENCE_BUDGET_S}, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_tropomi(orbits=8, device="cuda") -> dict:
    """bench.py ``bench_tropomi``: a TROPOMI month of ``orbits`` orbit
    files through ``run_month`` (the reader's trop-index gather, SW = AK x
    AMF, the fused month, the report and the diag file), host clock.
    Checks: the month's diag file is written."""
    _need_file_packages("bench_tropomi")
    from oisat_tpu_torch.run.job import run_month

    dev = resolve_device(device)
    tmp = Path(tempfile.mkdtemp(prefix="bench_tropomi_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        _write_bench_gmi_pair(
            tmp / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190715.nc4",
            tmp / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190715.nc4",
            201907, 15)
        for k in range(orbits):
            _write_bench_tropomi(
                tmp / "sat" / f"S5P_OFFL_L2__NO2____201907{1 + k:02}.nc",
                1 + k, seed=k)
        ctrl = _bench_job_ctrl(tmp, "TROPOMI", 201907, dev)
        t0 = time.perf_counter()
        run_month(ctrl, 2019, 7)
        _sync(dev)
        total = time.perf_counter() - t0
        n_nc = len(list((tmp / "diag").glob("*.nc")))
        _check(n_nc == 1, f"tropomi: {n_nc} diag files for one month")
        return _emit("tropomi_month", total, "s", REFERENCE_BUDGET_S / total, {
            "orbits": orbits, "repeats": 1, "timer": "host_clock",
            "reference_budget_s": REFERENCE_BUDGET_S}, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_campaign_prefetch(months=3, orbits=6, repeats=rl.MIN_REPEATS, device="cuda") -> dict:
    """bench.py ``bench_campaign_prefetch``: the same multi-month TROPOMI
    campaign through ``oisat_tpu_torch.run.campaign.run_campaign`` with the
    prefetch off and on, in turns ``repeats`` times after a warm sweep; the
    median of the per-pair ratios off / on.  Checks: no month failed."""
    _need_file_packages("bench_campaign_prefetch")
    from oisat_tpu_torch.run.campaign import run_campaign

    if months > 6:
        raise ValueError("the July start cannot cross the year end: months <= 6")
    dev = resolve_device(device)
    tmp = Path(tempfile.mkdtemp(prefix="bench_campaign_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        for m in range(7, 7 + months):
            _write_bench_gmi_pair(
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_met_Nv.2019{m:02}15.nc4",
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_tac_Nv.2019{m:02}15.nc4",
                201900 + m, 15)
            for k in range(orbits):
                _write_bench_tropomi(
                    tmp / "sat" / f"S5P_OFFL_L2__NO2____2019{m:02}{1 + k:02}.nc",
                    1 + k, seed=100 * m + k, month=m)
        ctrl = _bench_job_ctrl(tmp, "TROPOMI", 201907, dev)
        ctrl["start_date"] = "2019-07"
        ctrl["end_date"] = f"2019-{6 + months:02}"
        _check(not run_campaign(dict(ctrl), prefetch=False), "campaign: the warm sweep failed")

        def sweep(prefetch):
            t0 = time.perf_counter()
            failed = run_campaign(dict(ctrl), prefetch=prefetch)
            _sync(dev)
            _check(not failed, f"campaign: months {failed} failed")
            return time.perf_counter() - t0

        pairs = []
        for _ in range(repeats):
            off_s = sweep(False)
            on_s = sweep(True)
            pairs.append({"off_s": off_s, "on_s": on_s, "ratio": off_s / on_s})
        ratios = [p["ratio"] for p in pairs]
        return _emit("campaign_prefetch", statistics.median(ratios), "x", None, {
            "months": months, "orbits_per_month": orbits, "pairs": pairs,
            "median": statistics.median(ratios), "min": min(ratios), "max": max(ratios),
            "repeats": repeats, "timer": "host_clock"}, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the command line ---------------------------------------------------------------------

FILE_ROWS = (("tempo_month_24h", bench_tempo), ("tropomi_month", bench_tropomi),
             ("campaign_prefetch", bench_campaign_prefetch))


def file_rows_runnable() -> bool:
    """True where h5py and matplotlib are installed; else one line on stderr
    for each file row left out."""
    absent = _absent_file_packages()
    if not absent:
        return True
    for metric, _ in FILE_ROWS:
        print(f"oisat_tpu_torch.bench: {metric} left out: {' and '.join(absent)} not "
              "installed (the row writes product files with h5py and the job's PDF report "
              "with matplotlib; the CPU tests run it)", file=sys.stderr, flush=True)
    return False


def run_all(device="cuda") -> list:
    """Every row in bench.py ``run_all``'s order, then the year; the three
    file rows where :func:`file_rows_runnable`."""
    lines = [bench_oi(device=device),
             bench_curve_phase(device=device),
             bench_kalman(2048, device=device),
             bench_kalman(8192, device=device)]
    lines += regrid_rows(device=device)
    lines += [bench_regrid_pipelined(device=device),
              bench_matfree(device=device),
              bench_month(device=device),
              bench_month(fused=True, device=device),
              bench_month(fused=True, oi_method="full", device=device),
              bench_oi_bandwidth(device=device),
              bench_year(device=device)]
    if file_rows_runnable():
        lines += [fn(device=device) for _, fn in FILE_ROWS]
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m oisat_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    rows = p.add_mutually_exclusive_group()
    for flag in ("--all", "--month", "--month-fused", "--month-full", "--matfree", "--year",
                 "--oi-bw", "--tempo", "--tropomi", "--campaign"):
        rows.add_argument(flag, action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; stops where there is none) or 'cpu'")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"oisat_tpu_torch.bench: {e}", file=sys.stderr)
        return 1
    if args.all:
        run_all(device)
    elif args.month_full:
        bench_month(fused=True, oi_method="full", device=device)
    elif args.month_fused:
        bench_month(fused=True, device=device)
    elif args.month:
        bench_month(device=device)
    elif args.matfree:
        bench_matfree(device=device)
    elif args.year:
        bench_year(device=device)
    elif args.oi_bw:
        bench_oi_bandwidth(device=device)
    elif args.tempo:
        bench_tempo(device=device)
    elif args.tropomi:
        bench_tropomi(device=device)
    elif args.campaign:
        bench_campaign_prefetch(device=device)
    else:
        bench_oi(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
