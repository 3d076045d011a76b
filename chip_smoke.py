#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc``, ``g++`` and ``nvidia-smi``; it builds the
port's CUDA kernels and its C++ swath-weight library from
``oisat_tpu_torch/csrc`` into ``oisat_tpu_torch/_build`` (all at once, one
compiler per source) and imports nothing of JAX or of the JAX package.
Phases (any failure raises, exit code != 0):

1. Device and build: the ``nvidia-smi`` name / power-limit line, the build
   time and ptxas's register report of each kernel.
2. Kernel vs plain: the mean-AK curve sums at 4,147,200 cells (the global
   0.125 deg grid, 1440 x 2880) x 99 factors in float32 and float64, and the
   edge cases N=1, N off the tile size, all-invalid (NaN curve), R = 1, 5,
   127, 128.  Curves agree to rtol 1e-5 (float32) / 1e-12 (float64) -- the
   kernel sums in double in a fixed order, the plain version in torch's
   order -- and the knee index is identical; two kernel runs are bitwise
   equal.  Beside each time: the bound and the division floor (one MUFU
   reciprocal per valid term at 16 per SM per clock, at the card's maximum
   SM clock).
3. ``oi()`` at 1440 x 2880 float32 with the kernel engine vs the plain one:
   identical ``reg_index``, fields within rtol 1e-5; and ``oi()`` on a small
   float64 input against a literal numpy transcription of the reference
   (rtol 1e-10, knee exact).
4. The month through ``oisat_tpu_torch.driver.oisatgmi.analyze_month_fused``:
   60 OMI-shaped orbits (1644 x 60 pixels, 35 levels) spread over the globe,
   regridded by the port (linear, 0.25 deg fine grid, 2 x 2 box filter)
   onto the global MERRA2-GMI grid (0.5 x 0.625 deg, 361 x 576 = 207,936
   cells), a 72-level CTM with 8 3-hourly snapshots.  The kernel's launch
   count over the regrid + month must be > 0; the same month with the plain
   curve engine must give the identical ``reg_index`` and fields within
   rtol 1e-5.
5. Timings with CUDA events (kernel vs plain, ``oi()``, the month step and
   its AMF-recalculation part) and the host clock (regrid s/orbit, the
   driver's month, its host assembly).
6. The covariance kernel vs plain: B at n = 6,144 (the scan branch's
   largest) and 10,240 (the dense branch's largest) float32, and N = 1,
   ragged N around the 64-cell tile and all sigma = 0, within rtol 2e-4 /
   atol 1e-6 max sigma^2 (the CPU tests' bounds) and bitwise equal (the
   float32 scan's knee moves with any ulp of B); the plain B bitwise
   symmetric (the kernel computes one triangle and mirrors it); two kernel
   runs are bitwise equal; times with CUDA events beside the bound.
7. The full-covariance month (``oi_method="full"``, L = 300 km): 60
   OMI-shaped orbits crossing the CONUS window of the MERRA2-GMI grid
   (57 x 99 = 5,643 cells, ``entry.synthetic_regional_month``), a 72-level
   8-snapshot CTM, regridded by the native builder, then
   ``analyze_month_fused``: the dense eigen scan with the covariance kernel
   and the float64 exact tail on the card.  Checks: covariance launches
   > 0, solver "dense+direct_f64_dev", the sampled float64 residual under
   the gate, the native builder in use, a finite posterior wherever prior
   and observation are, the kernel bitwise equal to the plain version and
   the plain B bitwise symmetric on the month's own compacted cells, and
   the same month with the plain covariance engine giving the identical
   factor and fields within rtol 1e-9 (the tail never reads B; the factor
   holds only while B is bitwise equal).  The driver's and ``oi_full``'s own stage times
   (``stage_ms``: assembly, step, pull, compaction, covariance, eigh, the
   scan's GEMMs, knee, tail, residual, ...) for the first run, the plain
   run and a warm repeat, and the peak device memory.
8. The MOPITT CO month: 30 daily L3 granules on the product's 1 degree grid
   (360 x 180 cells, 9 retrieval levels, the 10-row averaging kernel with
   the surface row first, ~20% missing), regridded with the MOPITT_CO
   constants (linear, 1.0 degree, flag threshold 0.0).  The CTM (72 levels,
   the mean of 8 snapshots) is finer than 1 degree, so its matched slices
   are mapped onto the granule grid.  The month runs both ways on the same
   granules: staged (``conv_ak`` -> ``average`` -> ``bias_correct`` ->
   ``oi``) and ``analyze_month_fused``.  Checks: the nine driver fields
   agree within rtol 2e-4 / atol 2e-5 of the field's largest magnitude with
   identical NaN patterns; the same regularization factor; the posterior
   finite wherever prior, observation and error are; the ak_curve kernel
   launched exactly once per scalar OI pass.
9. The GOSAT XCH4 month: 30 daily sets of 3,000 sparse soundings (20
   levels, float32 kernels / weights / a-priori) -> ``filler_gosatxch4``
   (1 degree maps) -> ``regrid_granule`` with the GOSAT_XCH4 constants ->
   staged and fused as above; the OI ran on the xcol pair (``aux2``,
   ``aux1``) and ``ctm_averaged_vcd`` is all NaN.
10. The SSMIS water-vapour month: 3 monthly maps (one per satellite) on the
    0.25 degree global grid (720 x 1440, ~20% missing, flat 5% error) ->
    ``regrid_ssmis_granule`` onto the CTM grid -> ``cal_pwv`` staged and
    fused as above.
11. Desroziers: on phase 8's averaged fields ``oi("MOPITT",
    desroziers_iterations=2)`` globally and with 4 latitude bands: chi2
    moves toward 1 against the first pass, the scale maps are set only when
    binned, a repeat is bitwise equal, 3 kernel launches per call.  On phase
    7's CONUS month ``analyze_month_fused(oi_method="full",
    desroziers_iterations=1)`` finishes with finite fields and reports
    ``desroziers_iterations``.

Each new month logs its wall seconds, the stage split (one stage per driver
method), the regrid seconds per granule, the host<->device copies of the
staged path and the peak device memory.

Reductions from a real deployment: a real OMI month is ~430 orbits, whose
inputs (430 x 872 B x 207,936 cells ~ 78 GB) would fill the 80 GB card, so
the month is cut to 60 orbits, the repo's own synthetic month.  The MOPITT
and GOSAT months hold 30 days and the SSMIS month 3 satellites, as real ones
do.  Widths, levels and grids are the products' own.  The data are synthetic, made from
numpy seeds.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on its path, error, times and bound.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

N_ORBITS = 60
HEADLINE = (1440, 2880)
FACTORS_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = ("ak_curve", "covariance")
COV_SIZES = (6144, 10240)  # the dense scan's and the dense solve's largest B
COV_EDGE = (1, 63, 65, 1000, 6143)  # N = 1 and N off the 64-cell tile
COV_RTOL = 2e-4  # + atol 1e-6 * max sigma^2: the CPU tests' bounds
LENGTH_SCALE_KM = 300.0  # run/control.yml's length_scale_km
FULL_RTOL = 1e-9  # kernel vs plain covariance engine, after the float64 tail
MONTH = ("2019-07-01", "2019-08-01")
DRIVER_FIELDS = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")
# fused month vs staged path, float32 granules: the bound of the JAX package's
# own fused-vs-staged tests, the absolute part on the field's largest magnitude
STAGED_RTOL, STAGED_ATOL = 2e-4, 2e-5
N_DAYS = 30  # MOPITT and GOSAT granules of the month
N_SSMIS = 3  # one monthly map per satellite
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FLOP/s outside the
# tensor cores; the card's power limit is printed beside every time
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
COV_OPS_PER_ELEMENT = 19  # covariance.cu: 2 sub, 1 add, 9 mul, 1 div, 1 neg,
# 2 compares (the clip), 2 sin, 1 exp -- each sin / exp counted once
MUFU_PER_SM_CLOCK = 16  # Hopper's special-function unit: reciprocals per SM per clock


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    """(least milliseconds, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the card's peak for ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ak_curve_bound(n_valid: int, n: int, nfac: int, dtype) -> tuple:
    """u read once, the factors read once, the (R,) float64 sums written
    once; r / (r + u) and its accumulation (an add, a divide, an add) for
    each valid cell and factor (invalid cells add exactly 0)."""
    item = torch.tensor([], dtype=dtype).element_size()
    return bound_ms(n * item + nfac * item + nfac * 8, 3.0 * n_valid * nfac, dtype)


def covariance_bound(n: int) -> tuple:
    """lat, lon, sigma read once, the (n, n) float32 B written once;
    ``COV_OPS_PER_ELEMENT`` operations per element."""
    return bound_ms(3 * n * 4 + n * n * 4, COV_OPS_PER_ELEMENT * n * n, torch.float32)


def division_floor_ms(n_valid: int, nfac: int, max_sm_mhz: float) -> float:
    """ak_curve's floor on its own division unit: one MUFU reciprocal per
    valid cell and factor, at MUFU_PER_SM_CLOCK per SM at the maximum SM
    clock (the IEEE division's FMA steps and range check come on top)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_valid * nfac / (sms * MUFU_PER_SM_CLOCK * max_sm_mhz * 1e6) * 1e3


def smi_query(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def smi_line() -> str:
    return smi_query("name,power.limit")


def variances(n: int, seed: int, nan_frac: float = 0.2):
    """Sa, So for ``n`` cells as the OI sees them (bench.make_fields' law)."""
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(3.0, 1.0, n))
    sa = (xa * 0.5) ** 2
    so = np.abs(rng.normal(0.4, 0.1, n)) ** 2
    bad = rng.random(n) < nan_frac
    sa[bad] = np.nan
    so[bad] = np.nan
    return sa, so


def oi_fields(shape, seed: int):
    """xa, y, Sa, So as bench.make_fields draws them (20% NaN cells)."""
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(3.0, 1.0, shape))
    y = xa * rng.uniform(0.7, 1.4, shape) + rng.normal(0, 0.3, shape)
    sa = (xa * 0.5) ** 2
    so = np.abs(rng.normal(0.4, 0.1, shape)) ** 2
    nan = rng.random(shape) < 0.2
    for f in (xa, y, sa, so):
        f[nan] = np.nan
    return xa, y, sa, so


def compare_curve(u, regs, count, oi_scan, what: str):
    """Kernel vs plain curve for one u (checked to FACTORS_RTOL, the kernel
    bitwise equal on repeat); returns (max_abs_err, kernel curve, plain curve)."""
    dtype = u.dtype
    k = oi_scan.ak_curve_sums_kernel(u, regs)
    p = oi_scan.ak_curve_sums_plain(u, regs)
    k2 = oi_scan.ak_curve_sums_kernel(u, regs)
    torch.cuda.synchronize()
    check(torch.equal(k, k2), f"{what}: two kernel runs differ")
    kc = k.cpu().numpy() / count if count else np.full(regs.numel(), np.nan)
    pc = p.double().cpu().numpy() / count if count else np.full(regs.numel(), np.nan)
    check(np.array_equal(np.isnan(kc), np.isnan(pc)), f"{what}: NaN patterns differ")
    err = float(np.nanmax(np.abs(kc - pc))) if np.isfinite(kc).any() else 0.0
    if np.isfinite(kc).any():
        np.testing.assert_allclose(kc, pc, rtol=FACTORS_RTOL[dtype], atol=0,
                                   err_msg=what)
    return err, kc, pc


def phase_kernel(dev, oi_scan, curve_inputs, kneedle_index_np, regs_np):
    log("== phase 2: ak_curve kernel vs plain")
    results = {}
    n = HEADLINE[0] * HEADLINE[1]
    sa, so = variances(n, seed=0)
    for dtype in (torch.float32, torch.float64):
        u, valid = curve_inputs(torch.as_tensor(sa, dtype=dtype, device=dev),
                                torch.as_tensor(so, dtype=dtype, device=dev))
        u = u.contiguous()
        regs = torch.as_tensor(regs_np, dtype=dtype, device=dev)
        count = int(valid.sum())
        err, kc, pc = compare_curve(u, regs, count, oi_scan, f"{n} cells {dtype}")
        ki, pi = kneedle_index_np(regs_np, kc), kneedle_index_np(regs_np, pc)
        check(ki == pi, f"knee differs: kernel {ki} plain {pi}")
        ms = cuda_ms(lambda: oi_scan.ak_curve_sums_kernel(u, regs), reps=20)
        plain_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_plain(u, regs), reps=5)
        results[str(dtype)] = (err, ms, plain_ms, count)
        log(f"kernel vs plain {n} cells x {regs.numel()} factors {dtype}: "
            f"max_abs_err {err:.3e}, knee {ki} == {pi}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
    edge = [("N=1", 1, 99, 0.0), ("N=2049", 2049, 99, 0.1), ("N=5*2048+3", 5 * 2048 + 3, 99, 0.1),
            ("R=1", 10007, 1, 0.1), ("R=5", 10007, 5, 0.5), ("R=127", 10007, 127, 0.1),
            ("R=128", 10007, 128, 0.1), ("all-invalid", 5000, 99, 1.0)]
    for name, n_e, nfac, nan_frac in edge:
        sa_e, so_e = variances(n_e, seed=n_e + nfac, nan_frac=nan_frac)
        for dtype in (torch.float32, torch.float64):
            u, valid = curve_inputs(torch.as_tensor(sa_e, dtype=dtype, device=dev),
                                    torch.as_tensor(so_e, dtype=dtype, device=dev))
            regs = torch.as_tensor(np.linspace(0.1, 9.9, nfac), dtype=dtype, device=dev)
            count = int(valid.sum())
            err, kc, _ = compare_curve(u.contiguous(), regs, count, oi_scan,
                                       f"{name} {dtype}")
            if name == "all-invalid":
                check(count == 0 and np.isnan(kc).all(), "all-invalid curve is not NaN")
        log(f"edge case {name}: kernel == plain (float32, float64)")
    return results


def reference_oi_numpy(xa, y, sa, so, kneedle_index_np):
    """The reference's literal per-factor loop (optimal_interpolation.py:6-52)."""
    y = np.where(y < 0, 0.0, y)
    regs = np.arange(0.1, 10.0, 0.1)
    with np.errstate(all="ignore"):
        curve = np.array([np.nanmean(1.0 - (1.0 - sa * r / (sa * r + so)) * sa * r / (sa * r))
                          for r in regs])
        idx = kneedle_index_np(regs, curve, fallback=0)
        r = regs[idx]
        k = sa * r / (sa * r + so)
        sb = (1.0 - k) * sa * r
        ak = 1.0 - sb / (sa * r)
    inc = k * (y - xa)
    return xa + inc, ak, inc, np.sqrt(sb), idx


def phase_oi(dev, oi, kneedle_index_np):
    log("== phase 3: oi() kernel engine vs plain engine")
    fields = oi_fields(HEADLINE, seed=1)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in fields]
    rk = oi(*args, curve_impl="kernel")
    rp = oi(*args, curve_impl="plain")
    check(int(rk.reg_index) == int(rp.reg_index),
          f"oi reg_index kernel {int(rk.reg_index)} vs plain {int(rp.reg_index)}")
    for name in ("xb", "averaging_kernel", "increment", "error"):
        a, b = getattr(rk, name).cpu().numpy(), getattr(rp, name).cpu().numpy()
        check(a.shape == HEADLINE, f"oi {name} shape {a.shape}")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, equal_nan=True, err_msg=name)
    ms = cuda_ms(lambda: oi(*args, curve_impl="kernel"), reps=10)
    plain_ms = cuda_ms(lambda: oi(*args, curve_impl="plain"), reps=5)
    cells_per_s = HEADLINE[0] * HEADLINE[1] / (ms * 1e-3)
    log(f"oi() {HEADLINE[0]}x{HEADLINE[1]} float32: reg_index {int(rk.reg_index)} "
        f"(factor {float(rk.reg_factor):.1f}) identical; kernel engine {ms:.4f} ms "
        f"({cells_per_s:.4e} cells/s), plain engine {plain_ms:.4f} ms")

    small = [f.astype(np.float64) for f in oi_fields((64, 96), seed=2)]
    small[1][0, :5] = -1.0  # the y < 0 clamp
    small[2][1, :5] = 0.0  # Sa == 0 -> NaN averaging kernel
    res = oi(*(torch.as_tensor(a, device=dev) for a in small), curve_impl="kernel")
    ref = reference_oi_numpy(*small, kneedle_index_np)
    check(int(res.reg_index) == ref[4], "small oi knee differs from the numpy reference")
    for name, want in zip(("xb", "averaging_kernel", "increment", "error"), ref[:4]):
        np.testing.assert_allclose(getattr(res, name).cpu().numpy(), want, rtol=1e-10,
                                   atol=1e-12, equal_nan=True, err_msg=f"small {name}")
    log("oi() 64x96 float64 vs the numpy reference: agree (rtol 1e-10), knee exact")
    return ms, plain_ms


def cov_inputs(n: int, seed: int, dev, cov, zero_sigma: bool = False):
    """(lat, lon, sigma) float32 tensors for ``n`` cells scattered over the
    CONUS window (radians as the wrapper converts them), and sigma (numpy)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(24.0, 52.0, n)
    lon = rng.uniform(-128.0, -66.0, n)
    sig = np.zeros(n) if zero_sigma else np.abs(rng.normal(1.5, 0.3, n))
    return (cov.radians_f32(lat, dev), cov.radians_f32(lon, dev),
            torch.as_tensor(sig, dtype=torch.float32, device=dev)), sig


def compare_cov(args, sig, cov, what: str):
    """Kernel vs plain B: within COV_RTOL / 1e-6 max sigma^2 and bitwise
    equal, the kernel bitwise equal on repeat; returns the max_abs_err."""
    k = cov.build_covariance_kernel(*args, LENGTH_SCALE_KM)
    k2 = cov.build_covariance_kernel(*args, LENGTH_SCALE_KM)
    p = cov.build_covariance_plain(*args, LENGTH_SCALE_KM)
    torch.cuda.synchronize()
    check(torch.equal(k, k2), f"{what}: two covariance kernel runs differ")
    # the kernel mirrors its upper triangle: that is the plain B only while
    # the plain B is itself bitwise symmetric on this card
    check(torch.equal(p, p.T), f"{what}: the plain B is not bitwise symmetric")
    atol = 1e-6 * max(float(np.max(sig ** 2)), 1e-30)
    check(torch.allclose(k, p, rtol=COV_RTOL, atol=atol),
          f"{what}: covariance kernel vs plain beyond rtol {COV_RTOL} / atol {atol:.3e}")
    # bitwise: near the knee the float32 scan's curve moves with any ulp of B
    check(torch.equal(k, p), f"{what}: covariance kernel and plain not bitwise equal")
    return float((k - p).abs().max())


def phase_covariance(dev, cov):
    log("== phase 6: covariance kernel vs plain")
    times = {}
    for n in COV_SIZES:
        args, sig = cov_inputs(n, seed=n, dev=dev, cov=cov)
        err = compare_cov(args, sig, cov, f"n={n}")
        ms = cuda_ms(lambda: cov.build_covariance_kernel(*args, LENGTH_SCALE_KM), reps=20)
        plain_ms = cuda_ms(lambda: cov.build_covariance_plain(*args, LENGTH_SCALE_KM), reps=5)
        bms, by = covariance_bound(n)
        times[n] = (ms, plain_ms, bms, by)
        log(f"covariance n={n} float32: max_abs_err {err:.3e} (bitwise equal to plain), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), kernel at {bms / ms:.1%} of its bound")
    for n in COV_EDGE:
        args, sig = cov_inputs(n, seed=n, dev=dev, cov=cov)
        compare_cov(args, sig, cov, f"n={n}")
        log(f"edge case N={n}: kernel == plain, bitwise")
    args, sig = cov_inputs(2049, seed=5, dev=dev, cov=cov, zero_sigma=True)
    k = cov.build_covariance_kernel(*args, LENGTH_SCALE_KM)
    check(not bool(k.any()), "all-zero sigma gives a nonzero B")
    log("edge case all sigma = 0: B == 0")
    return times


def log_stages(what: str, stage_ms: dict, wall_s: float) -> None:
    """The driver's stages (they sum to its wall time) and the full OI's."""
    top = {k: v for k, v in stage_ms.items() if "." not in k}
    sub = {k.split(".", 1)[1]: v for k, v in stage_ms.items() if k.startswith("oi_full.")}
    log(f"{what}: analyze_month_fused {wall_s * 1e3:.2f} ms = "
        + " + ".join(f"{k} {v:.2f}" for k, v in top.items())
        + f" ms (sum {sum(top.values()):.2f} ms)")
    log(f"{what}: oi_full {top.get('oi_full', 0.0):.2f} ms = "
        + " + ".join(f"{k} {v:.2f}" for k, v in sub.items()) + " ms")


def full_month(reader, dev, **kw):
    """One full-covariance month through the driver with its stage times:
    (session, wall seconds, stage milliseconds)."""
    from oisat_tpu_torch.driver import oisatgmi

    obj = oisatgmi()
    obj.reader_obj = reader
    stage_ms: dict = {}
    t0 = time.perf_counter()
    out = obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                  oi_method="full", length_scale_km=LENGTH_SCALE_KM,
                                  stage_ms=stage_ms, **kw)
    torch.cuda.synchronize(dev)
    return obj, out, time.perf_counter() - t0, stage_ms


def phase_full_month(dev, cov, oi_scan, native):
    from oisat_tpu_torch.entry import synthetic_regional_month
    from oisat_tpu_torch.ops.oi import regularization_grid
    from oisat_tpu_torch.ops.oi_full import DEVICE_EXACT_RESID_GATE, compact
    from oisat_tpu_torch.regridder import regrid_granule

    log(f"== phase 7: the full-covariance month (oi_method='full', "
        f"L = {LENGTH_SCALE_KM:g} km) on the CONUS window")
    t0 = time.perf_counter()
    orbits, ctm, lon2d, lat2d = synthetic_regional_month(N_ORBITS, seed=0)
    log(f"regional month built on the host in {time.perf_counter() - t0:.1f} s: "
        f"{len(orbits)} orbits {orbits[0].vcd.shape} x {orbits[0].pressure_mid.shape[0]} "
        f"levels, CTM {ctm.pressure_mid.shape}, grid {lat2d.shape} = {lat2d.size} cells")

    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    cov.build_covariance_kernel.launches = 0
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of this slice: regrid every orbit, the full month ----
    t0 = time.perf_counter()
    grans = [regrid_granule(1, 0.25, o, lon2d, lat2d, dev, flag_thresh=0.5) for o in orbits]
    torch.cuda.synchronize()
    regrid_s = time.perf_counter() - t0
    reader = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    obj, out, month_s, stage_ms = full_month(reader, dev)
    cov_launches = cov.build_covariance_kernel.launches
    curve_launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(g is not None for g in grans), "an orbit missed the CONUS window")
    check(cov_launches > 0, "the full-covariance month never launched the covariance kernel")
    check(native.available(), "the regrid did not use the native swath builder")
    diag = obj.oi_diagnostics
    check(diag.get("solver") == "dense+direct_f64_dev",
          f"the float64 exact tail did not run: {diag}")
    check(diag["f64_resid"] <= DEVICE_EXACT_RESID_GATE, f"f64_resid {diag['f64_resid']}")
    check(int(out.oi.reg_index) == -1, "the step ran its scalar OI on a full month")
    xa, y, so = obj.ctm_averaged_vcd, obj.sat_averaged_vcd, obj.sat_averaged_error
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(so) & (so > 0)
    post = obj.ctm_averaged_vcd_corrected
    check(both.sum() > 0.9 * post.size, f"only {both.sum()} of {post.size} cells valid")
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        check(np.isfinite(getattr(obj, name)[both]).all(),
              f"{name} not finite where prior and observation are")
    grid = regularization_grid()
    reg_index = int(np.argmin(np.abs(grid - diag["reg"])))
    ratio = 0.5 * xa[both] / so[both]
    log(f"full month: {int(both.sum())} valid cells, sigma_b/sigma_o median "
        f"{np.median(ratio):.1f}, max sigma_b / min sigma_o "
        f"{np.max(0.5 * xa[both]) / np.min(so[both]):.1f}; covariance launches "
        f"{cov_launches}, ak_curve launches {curve_launches}; solver {diag['solver']}, "
        f"factor {diag['reg']:.1f} (index {reg_index}), f64_resid {diag['f64_resid']:.3e} "
        f"(gate {DEVICE_EXACT_RESID_GATE:g})")
    log(f"full month: innovation n={int(diag['n'])} OmB {diag['omb_mean']:+.4f}/"
        f"{diag['omb_rms']:.4f} OmA {diag['oma_mean']:+.4f}/{diag['oma_rms']:.4f} "
        f"chi2 {diag['chi2']:.4f}")
    log(f"full month: regrid {regrid_s:.3f} s for {len(orbits)} orbits, "
        f"analyze_month_fused {month_s:.3f} s (host clock); peak device memory "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB of it held before the phase)")
    log_stages("full month, first run (kernel engine)", stage_ms, month_s)

    # the covariance kernel against its plain version on the month's own B
    # inputs: the compaction oi_full runs on the fields the driver gives it
    cp = compact(*obj.full_oi_inputs())
    n = cp.idx.size
    args = (cov.radians_f32(cp.lat, dev), cov.radians_f32(cp.lon, dev),
            torch.as_tensor(cp.sb, dtype=torch.float32, device=dev))
    cov_err = compare_cov(args, cp.sb, cov, f"full month n={n}")
    k_ms = cuda_ms(lambda: cov.build_covariance_kernel(*args, LENGTH_SCALE_KM), reps=20)
    p_ms = cuda_ms(lambda: cov.build_covariance_plain(*args, LENGTH_SCALE_KM), reps=5)
    bms, by = covariance_bound(n)
    log(f"full month covariance at n = {n} (CUDA events): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {bms:.4f} ms ({by}), max_abs_err {cov_err:.3e} "
        f"(bitwise equal to plain)")

    ref, _, ref_s, ref_ms = full_month(reader, dev, cov_impl="plain")
    check(ref.oi_diagnostics["reg"] == diag["reg"],
          f"full month factor kernel {diag['reg']} vs plain {ref.oi_diagnostics['reg']}")
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI",
                 "sat_averaged_vcd", "ctm_averaged_vcd"):
        np.testing.assert_allclose(getattr(obj, name), getattr(ref, name), rtol=FULL_RTOL,
                                   atol=0, equal_nan=True, err_msg=name)
    log(f"full month: the plain covariance engine gives the identical factor and "
        f"fields (rtol {FULL_RTOL:g})")
    log_stages("full month, plain engine (warm)", ref_ms, ref_s)
    again, _, again_s, again_ms = full_month(reader, dev)
    check(again.oi_diagnostics["reg"] == diag["reg"], "a second kernel-engine run "
          f"picked factor {again.oi_diagnostics['reg']} instead of {diag['reg']}")
    log_stages("full month, kernel engine again (warm)", again_ms, again_s)
    return dict(launches=cov_launches, err=cov_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bms, bound_by=by, cells=n, reader=reader)


def implied_factor(obj, sensor: str, grid) -> int:
    """The index of the regularization factor a scalar OI chose, read back
    from its fields: ak = Sa r / (Sa r + So) gives r = ak / (1 - ak) * So / Sa
    on every analysed cell."""
    xa = obj.aux2 if sensor == "GOSAT" else obj.ctm_averaged_vcd
    sa, so, ak = (xa * 0.5) ** 2, obj.sat_averaged_error ** 2, obj.ak_OI
    ok = np.isfinite(ak) & (ak > 0) & (ak < 1) & (sa > 0) & (so > 0)
    check(ok.sum() > 100, f"{sensor}: too few cells to read the factor back")
    r = float(np.median(ak[ok] / (1.0 - ak[ok]) * so[ok] / sa[ok]))
    idx = int(np.argmin(np.abs(grid - r)))
    # ak near 1 in float32 leaves 1 - ak a few 1e-4 of relative error
    check(abs(grid[idx] - r) < 0.02, f"{sensor}: implied factor {r} is off the grid")
    return idx


def assert_fused_equals_staged(fused, staged, what: str) -> float:
    """The nine driver fields of the fused month against the staged path:
    identical NaN patterns, values within STAGED_RTOL / STAGED_ATOL of the
    field's largest magnitude; returns the largest scaled difference."""
    worst = 0.0
    for name in DRIVER_FIELDS:
        a, b = getattr(fused, name), getattr(staged, name)
        check(a.shape == b.shape, f"{what} {name}: shapes {a.shape} vs {b.shape}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what} {name}: NaN patterns differ")
        fin = np.isfinite(b)
        if not fin.any():
            continue
        scale = float(np.abs(b[fin]).max())
        np.testing.assert_allclose(a[fin], b[fin], rtol=STAGED_RTOL, atol=STAGED_ATOL * scale,
                                   err_msg=f"{what} {name}")
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max()) / max(scale, 1e-300))
    return worst


def phase_sensor_month(sensor: str, gas: str, ctm, grans, regrid_s, oi_scan, grid):
    """One month of a non-AMF sensor through the driver both ways on the
    same gridded granules: the staged methods, then ``analyze_month_fused``.
    Returns (staged session, ak_curve launches of the two runs, the curve
    kernel's times at this month's shape)."""
    from oisat_tpu_torch import _device
    from oisat_tpu_torch.driver import oisatgmi

    check(all(g is not None for g in grans), f"{sensor}: a granule did not regrid")
    what = f"{sensor} month"
    reader = SimpleNamespace(ctm_data=[ctm], sat_data=[copy.copy(g) for g in grans])
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _device.COPIES.update(h2d=0, d2h=0)
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of this slice, staged ----
    staged = oisatgmi(stage_ms={})
    staged.reader_obj = reader
    t0 = time.perf_counter()
    if sensor == "SSMIS":
        staged.cal_pwv()
    else:
        staged.conv_ak(sensor)
    staged.average(*MONTH, gasname=gas)
    staged.bias_correct(sensor, gas)
    staged.oi(sensor, error_ctm=50.0)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    staged_launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the staged path ----
    copies = dict(_device.COPIES)
    staged_gb = torch.cuda.max_memory_allocated() / 1e9
    check(staged_launches == 1, f"{what}, staged: {staged_launches} ak_curve launches for "
          "1 scalar OI pass")

    torch.cuda.reset_peak_memory_stats()
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of this slice, fused ----
    fused = oisatgmi(stage_ms={})
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    t0 = time.perf_counter()
    out = fused.analyze_month_fused(sensor, gas, *MONTH, error_ctm=50.0)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the fused path ----
    fused_gb = torch.cuda.max_memory_allocated() / 1e9
    check(fused_launches == 1, f"{what}, fused: {fused_launches} ak_curve launches for "
          "1 scalar OI pass")

    worst = assert_fused_equals_staged(fused, staged, what)
    reg_index = int(out.oi.reg_index)
    check(0 <= reg_index < grid.size, f"{what}: reg_index {reg_index}")
    check(implied_factor(fused, sensor, grid) == reg_index,
          f"{what}: the fused fields do not carry the factor of reg_index {reg_index}")
    check(implied_factor(staged, sensor, grid) == reg_index,
          f"{what}: staged and fused picked different factors")
    if sensor == "GOSAT":
        xa, y = fused.aux2, fused.aux1
        check(np.isnan(fused.ctm_averaged_vcd).all() and np.isnan(staged.ctm_averaged_vcd).all(),
              "GOSAT: the model VCD must stay NaN")
        inc = np.isfinite(fused.increment_OI)
        np.testing.assert_allclose((fused.ctm_averaged_vcd_corrected - xa)[inc],
                                   fused.increment_OI[inc], rtol=1e-4, atol=1e-3,
                                   err_msg="GOSAT: the OI did not run on the xcol pair")
    else:
        xa, y = fused.ctm_averaged_vcd, fused.sat_averaged_vcd
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(fused.sat_averaged_error)
    check(both.sum() > 0.02 * both.size, f"{what}: only {both.sum()} of {both.size} cells")
    for obj in (staged, fused):
        check(np.isfinite(obj.ctm_averaged_vcd_corrected[both]).all(),
              f"{what}: posterior not finite where prior and observation are")
        d = obj.oi_diagnostics
        check(d["n"] > 0 and np.isfinite(d["chi2"]), f"{what}: innovation stats {d}")
    check(staged.oi_diagnostics["n"] == fused.oi_diagnostics["n"], f"{what}: n differs")

    def stages(ms):
        return " + ".join(f"{k} {v:.1f}" for k, v in ms.items()) + " ms"

    d = fused.oi_diagnostics
    log(f"{what}: {len(grans)} granules {tuple(grans[0].vcd.shape)} "
        f"(ctm_upscaled_needed {grans[0].ctm_upscaled_needed}), regrid "
        f"{regrid_s[0]:.3f} s first, then {np.mean(regrid_s[1:]):.4f} s/granule; "
        f"{int(both.sum())} of {both.size} cells analysed, factor {grid[reg_index]:.1f} "
        f"(index {reg_index}) both ways, dtype {out.oi.xb.dtype}")
    log(f"{what}: innovation n={int(d['n'])} OmB {d['omb_mean']:+.4g}/{d['omb_rms']:.4g} "
        f"OmA {d['oma_mean']:+.4g}/{d['oma_rms']:.4g} chi2 {d['chi2']:.4g}")
    log(f"{what}, staged: {staged_s:.3f} s = {stages(staged.stage_ms)}; ak_curve launches "
        f"{staged_launches}; host->device copies {copies['h2d']}, device->host "
        f"{copies['d2h']}; peak device memory {staged_gb:.2f} GB ({base_gb:.2f} GB held "
        "before)")
    log(f"{what}, fused: {fused_s:.3f} s = {stages(fused.stage_ms)}; ak_curve launches "
        f"{fused_launches}; peak device memory {fused_gb:.2f} GB; fused == staged on "
        f"{len(DRIVER_FIELDS)} fields (rtol {STAGED_RTOL:g}, atol {STAGED_ATOL:g} of the "
        f"largest magnitude; largest scaled difference {worst:.2e})")
    shape = month_device_times(sensor, ctm, grans, out, oi_scan, grid)
    return staged, staged_launches + fused_launches, shape


def month_device_times(sensor: str, ctm, grans, out, oi_scan, grid) -> dict:
    """Where a new month's time goes, and the ak_curve kernel against its
    plain version at this month's own shape: the host's time-collapse of the
    CTM (numpy nanmean over the snapshots), the month step and its vertical
    operator alone between CUDA events, and the curve kernel's entry for the
    ``kernels`` line."""
    from oisat_tpu_torch import obs_operators as ops
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.ops import vertical
    from oisat_tpu_torch.ops.oi import curve_inputs
    from oisat_tpu_torch.parallel.analysis import over_granule_chunks

    names = {"MOPITT": ("pressure_mid", "gas_profile", "delta_p"),
             "GOSAT": ("pressure_mid", "gas_profile"),
             "SSMIS": ("delta_p", "gas_profile")}[sensor]
    t0 = time.perf_counter()
    ops._time_collapsed(ctm, names)
    collapse_s = time.perf_counter() - t0
    kind = "ssmis" if sensor == "SSMIS" else "opt"
    inputs, step = oisatgmi._fused_inputs(kind, sensor, [ctm], grans)
    i = inputs
    operator, args = {
        "MOPITT": lambda: (vertical.ak_conv_mopitt_fields, (
            i.ctm_pmid, i.ctm_profile, i.ctm_airpc, i.sat_pmid, i.aks, i.aprior_col,
            i.apriori_profile, i.apriori_surface, i.vcd)),
        "GOSAT": lambda: (vertical.ak_conv_gosat_fields, (
            i.ctm_pmid, i.ctm_profile, i.sat_pmid, i.aks, i.apriori_profile,
            i.pressure_weight, i.x_col)),
        "SSMIS": lambda: (vertical.pwv_fields, (i.water_pc, i.vcd)),
    }[sensor]()
    step_ms = cuda_ms(lambda: step(inputs), reps=3)
    op_ms = cuda_ms(lambda: over_granule_chunks(operator, args), reps=3)
    del inputs, i, args

    xa = out.aux2 if sensor == "GOSAT" else out.ctm_vcd
    u, valid = curve_inputs((xa * 50.0 / 100.0) ** 2, out.sat_error ** 2)
    u = u.reshape(-1).contiguous()
    regs = torch.as_tensor(grid, dtype=u.dtype, device=u.device)
    n_valid = int(valid.sum())
    err, _, _ = compare_curve(u, regs, n_valid, oi_scan, f"{sensor} month curve")
    k_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_kernel(u, regs), reps=50)
    p_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_plain(u, regs), reps=10)
    bms, by = ak_curve_bound(n_valid, u.numel(), regs.numel(), u.dtype)
    log(f"{sensor} month, where the time goes: host time-collapse of the CTM "
        f"({len(names)} numpy nanmeans over {ctm.pressure_mid.shape}) {collapse_s:.3f} s; "
        f"the month step {step_ms:.2f} ms, its vertical operator alone {op_ms:.2f} ms "
        "(CUDA events)")
    log(f"ak_curve at the {sensor} month's shape ({u.numel()} cells, {n_valid} valid, x "
        f"{regs.numel()} factors, {u.dtype}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), max_abs_err {err:.3e}")
    return {"path": f"{sensor.lower()}_month", "cells": u.numel(), "factors": regs.numel(),
            "dtype": str(u.dtype).replace("torch.", ""), "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bms, "bound_by": by}


def timed_regrid(fn, items):
    """``fn(item)`` for every item, each closed by a device synchronise:
    (results, seconds per item)."""
    out, secs = [], []
    for it in items:
        t0 = time.perf_counter()
        out.append(fn(it))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def phase_mopitt(dev, oi_scan, grid):
    from oisat_tpu_torch.entry import synthetic_mopitt_month
    from oisat_tpu_torch.regridder import regrid_granule

    log(f"== phase 8: the MOPITT CO month ({N_DAYS} daily L3 granules), staged and fused")
    t0 = time.perf_counter()
    days, ctm, lon2d, lat2d = synthetic_mopitt_month(N_DAYS, seed=0)
    log(f"MOPITT month built on the host in {time.perf_counter() - t0:.1f} s: {len(days)} "
        f"granules {days[0].vcd.shape} x {days[0].pressure_mid.shape[0]} levels, kernel "
        f"{days[0].averaging_kernels.shape[0]} rows, CTM {ctm.pressure_mid.shape}")
    grans, secs = timed_regrid(
        lambda g: regrid_granule(1, 1.0, g, lon2d, lat2d, dev, flag_thresh=0.0), days)
    check(all(g.ctm_upscaled_needed for g in grans), "MOPITT: the CTM must be upscaled")
    return phase_sensor_month("MOPITT", "CO", ctm, grans, secs, oi_scan, grid)


def phase_gosat(dev, oi_scan, grid):
    from oisat_tpu_torch.entry import synthetic_gosat_month
    from oisat_tpu_torch.readers.sensors.gosat import filler_gosatxch4
    from oisat_tpu_torch.regridder import regrid_granule

    log(f"== phase 9: the GOSAT XCH4 month ({N_DAYS} daily sets of soundings), staged "
        "and fused")
    t0 = time.perf_counter()
    days, ctm, lon2d, lat2d = synthetic_gosat_month(N_DAYS, seed=0)
    log(f"GOSAT month built on the host in {time.perf_counter() - t0:.1f} s: {len(days)} "
        f"days x {days[0].vcd.shape[0]} soundings x {days[0].pressure_mid.shape[0]} levels, "
        f"kernels {days[0].averaging_kernels.dtype}, CTM {ctm.pressure_mid.shape}")
    filled, fill_s = timed_regrid(
        lambda g: filler_gosatxch4(1.0, g, dev, flag_thresh=0.0), days)
    check(all(f is not None and f.vcd.shape == (181, 361) for f in filled),
          "GOSAT: the filler did not give 1 degree global maps")
    grans, secs = timed_regrid(
        lambda f: regrid_granule(1, 1.0, f, lon2d, lat2d, dev, flag_thresh=0.0), filled)
    log(f"GOSAT filler: {fill_s[0]:.3f} s first, then {np.mean(fill_s[1:]):.4f} s/day; "
        f"{int(np.isfinite(filled[0].vcd).sum())} of {filled[0].vcd.size} map cells filled "
        "on day 1")
    return phase_sensor_month("GOSAT", "CH4", ctm, grans, secs, oi_scan, grid)


def phase_ssmis(dev, oi_scan, grid):
    from oisat_tpu_torch.entry import synthetic_ssmis_month
    from oisat_tpu_torch.regridder import regrid_ssmis_granule

    log(f"== phase 10: the SSMIS water-vapour month ({N_SSMIS} monthly maps), staged "
        "and fused")
    t0 = time.perf_counter()
    maps, ctm, lon2d, lat2d = synthetic_ssmis_month(N_SSMIS, seed=0)
    log(f"SSMIS month built on the host in {time.perf_counter() - t0:.1f} s: {len(maps)} "
        f"maps {maps[0].vcd.shape}, CTM {ctm.pressure_mid.shape}")
    grans, secs = timed_regrid(
        lambda g: regrid_ssmis_granule(0.25, g, lon2d, lat2d, dev), maps)
    check(all(tuple(g.vcd.shape) == lat2d.shape and not g.ctm_upscaled_needed for g in grans),
          "SSMIS: the maps must land on the CTM grid")
    return phase_sensor_month("SSMIS", "H2O", ctm, grans, secs, oi_scan, grid)


def phase_desroziers(oi_scan, cov, mopitt, full_reader):
    """Desroziers re-estimation on phase 8's averaged fields (scalar OI,
    global and 4 latitude bands) and on phase 7's CONUS month (full OI).
    Returns (ak_curve launches of the scalar runs, covariance launches of
    the full run)."""
    from oisat_tpu_torch.driver import oisatgmi

    log("== phase 11: Desroziers re-estimation")
    first_chi2 = mopitt.oi_diagnostics["chi2"]
    total = 0
    for bins in (1, 4):
        runs = []
        for _ in range(2):
            oi_scan.ak_curve_sums_kernel.launches = 0
            # ---- main path: the OI with two re-estimation passes ----
            t0 = time.perf_counter()
            mopitt.oi("MOPITT", error_ctm=50.0, desroziers_iterations=2, desroziers_bins=bins)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = oi_scan.ak_curve_sums_kernel.launches
            # ---- end ----
            check(launches == 3, f"Desroziers ({bins} bins): {launches} ak_curve launches "
                  "for 3 scalar OI passes")
            total += launches
            runs.append(({n: getattr(mopitt, n).copy() for n in DRIVER_FIELDS[5:]},
                         dict(mopitt.oi_diagnostics), mopitt.desroziers_sa_scale_map))
        d = runs[0][1]
        check(d["desroziers_iterations"] == 2, f"Desroziers diagnostics {d}")
        check(abs(d["chi2"] - 1.0) < abs(first_chi2 - 1.0),
              f"Desroziers ({bins} bins): chi2 {first_chi2} -> {d['chi2']} moved away from 1")
        check((runs[0][2] is not None) == (bins > 1),
              f"Desroziers ({bins} bins): scale maps set only when binned")
        if bins > 1:
            check(runs[0][2].shape == mopitt.ak_OI.shape and d["desroziers_bins"] == bins,
                  "Desroziers: the binned scale map's shape")
        for name, a in runs[0][0].items():
            check(np.array_equal(a, runs[1][0][name], equal_nan=True),
                  f"Desroziers ({bins} bins): {name} differs between two runs")
        check(runs[0][1] == runs[1][1], f"Desroziers ({bins} bins): diagnostics differ "
              "between two runs")
        log(f"Desroziers on the MOPITT month, {bins} bin(s): chi2 {first_chi2:.4g} -> "
            f"{d['chi2']:.4g}, Sa x{d['desroziers_sa_scale']:.4g}, So "
            f"x{d['desroziers_so_scale']:.4g}"
            + (f" (per band Sa {d['desroziers_sa_scale_min']:.3g}-"
               f"{d['desroziers_sa_scale_max']:.3g}, So {d['desroziers_so_scale_min']:.3g}-"
               f"{d['desroziers_so_scale_max']:.3g})" if bins > 1 else "")
            + f"; {secs:.3f} s (oi stage {mopitt.stage_ms['oi']:.1f} ms summed so far), "
            f"{launches} ak_curve launches, repeat bitwise equal")

    obj = oisatgmi()
    obj.reader_obj = full_reader
    stage_ms: dict = {}
    cov.build_covariance_kernel.launches = 0
    # ---- main path: the full-covariance month with one re-estimation pass ----
    t0 = time.perf_counter()
    out = obj.analyze_month_fused("OMI", "NO2", *MONTH, oi_method="full",
                                  length_scale_km=LENGTH_SCALE_KM, desroziers_iterations=1,
                                  stage_ms=stage_ms)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cov_launches = cov.build_covariance_kernel.launches
    # ---- end ----
    check(cov_launches == 2, f"full-covariance Desroziers: {cov_launches} covariance "
          "launches for 2 solves")
    d = obj.oi_diagnostics
    check(d.get("desroziers_iterations") == 1 and "desroziers_sa_scale" in d,
          f"full-covariance Desroziers diagnostics {d}")
    check(int(out.oi.reg_index) == -1, "the step ran its scalar OI on a full month")
    xa, y, so = obj.ctm_averaged_vcd, obj.sat_averaged_vcd, obj.sat_averaged_error
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(so) & (so > 0)
    for name in DRIVER_FIELDS[5:]:
        check(np.isfinite(getattr(obj, name)[both]).all(),
              f"full-covariance Desroziers: {name} not finite")
    log(f"Desroziers on the CONUS month (oi_method='full', 1 pass): {secs:.3f} s, "
        f"oi_full {stage_ms.get('oi_full', 0.0):.1f} ms for 2 solves; Sa "
        f"x{d['desroziers_sa_scale']:.4g}, So x{d['desroziers_so_scale']:.4g}, chi2 "
        f"{d['chi2']:.4g}, factor {d.get('reg')}, solver {d.get('solver')}; "
        f"{cov_launches} covariance launches")
    return total, cov_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from oisat_tpu_torch import native
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.entry import synthetic_month
    from oisat_tpu_torch.ops.kernels import covariance as cov
    from oisat_tpu_torch.ops.kernels import oi_scan
    from oisat_tpu_torch.ops.kernels._build import build_log, load_library
    from oisat_tpu_torch.ops.knee import kneedle_index_np
    from oisat_tpu_torch.ops.oi import curve_inputs, oi, regularization_grid
    from oisat_tpu_torch.parallel.analysis import _amf_recal_month, full_month_step
    from oisat_tpu_torch.regridder import regrid_granule

    dev = torch.device("cuda", 0)
    smi = smi_line()
    max_sm_mhz = float(smi_query("clocks.max.sm").split()[0])
    log("== phase 1: device and build")
    log(f"nvidia-smi: {smi}; maximum SM clock {max_sm_mhz:g} MHz, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matrix products must not run in TF32")

    def timed(fn, *args):
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:  # one compiler per source
        builds = {name: pool.submit(timed, load_library, name) for name in KERNELS}
        swath = pool.submit(timed, native.available)
        build_s = {name: f.result() for name, f in builds.items()}
        swath_s = swath.result()
    check(native.available(), "the C++ swath-weight library did not build")
    log(f"built {', '.join(f'{n}.cu in {s:.2f} s' for n, s in build_s.items())} for "
        f"sm_90a and swath_weights.cpp in {swath_s:.2f} s, all at once in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    regs_np = regularization_grid()
    kres = phase_kernel(dev, oi_scan, curve_inputs, kneedle_index_np, regs_np)
    oi_ms, oi_plain_ms = phase_oi(dev, oi, kneedle_index_np)

    log(f"== phase 4: the {N_ORBITS}-orbit month through analyze_month_fused")
    t0 = time.perf_counter()
    orbits, ctm, lon2d, lat2d = synthetic_month(N_ORBITS, seed=0)
    log(f"synthetic month built on the host in {time.perf_counter() - t0:.1f} s: "
        f"{N_ORBITS} orbits {orbits[0].vcd.shape} x {orbits[0].pressure_mid.shape[0]} levels, "
        f"CTM {ctm.pressure_mid.shape}, grid {lat2d.shape}")

    torch.cuda.reset_peak_memory_stats()
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path: regrid every orbit, then the fused month ----
    per_orbit = []
    grans = []
    for o in orbits:
        t0 = time.perf_counter()
        g = regrid_granule(1, 0.25, o, lon2d, lat2d, dev, flag_thresh=0.5)
        torch.cuda.synchronize()
        per_orbit.append(time.perf_counter() - t0)
        grans.append(g)
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    t0 = time.perf_counter()
    out = obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")
    torch.cuda.synchronize()
    month_s = time.perf_counter() - t0
    launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_ok = sum(g is not None for g in grans)
    check(n_ok == N_ORBITS, f"only {n_ok} of {N_ORBITS} orbits regridded")
    check(launches == 1, f"the month launched the ak_curve kernel {launches} times for "
          "1 scalar OI pass")
    regrid_steady = float(np.mean(per_orbit[1:]))
    log(f"regrid: first orbit {per_orbit[0]:.3f} s (fine grid + upscaler build), "
        f"then {regrid_steady:.4f} s/orbit (mean of {N_ORBITS - 1})")
    post = obj.ctm_averaged_vcd_corrected
    check(post.shape == lat2d.shape, f"posterior shape {post.shape}")
    cells = post.size
    finite = {name: int(np.isfinite(getattr(obj, name)).sum()) for name in
              ("sat_averaged_vcd", "ctm_averaged_vcd", "ctm_averaged_vcd_corrected",
               "ak_OI", "error_OI")}
    check(finite["ctm_averaged_vcd_corrected"] > 0.1 * cells, f"too few analysed cells {finite}")
    reg_index = int(out.oi.reg_index)
    check(0 <= reg_index < regs_np.size, f"reg_index {reg_index}")
    diag = obj.oi_diagnostics
    check(diag["n"] > 0 and np.isfinite(diag["chi2"]), f"innovation stats {diag}")
    xa, y = obj.ctm_averaged_vcd, obj.sat_averaged_vcd
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(obj.sat_averaged_error)
    check(np.isfinite(post[both]).all(), "posterior not finite where prior and obs are")
    log(f"month: kernel launches {launches}, regularization factor "
        f"{float(out.oi.reg_factor):.1f} (index {reg_index}), dtype {out.oi.xb.dtype}, "
        f"finite cells of {cells}: {finite}")
    log(f"month: innovation n={int(diag['n'])} OmB {diag['omb_mean']:+.4f}/{diag['omb_rms']:.4f} "
        f"OmA {diag['oma_mean']:+.4f}/{diag['oma_rms']:.4f} chi2 {diag['chi2']:.4f}")
    log(f"month: analyze_month_fused {month_s:.3f} s (host clock, incl. CTM matching "
        f"and the H2D of the matched slices); peak device memory {peak_gb:.2f} GB")

    ref = oisatgmi()
    ref.reader_obj = obj.reader_obj
    ref_out = ref.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                      curve_impl="plain")
    check(int(ref_out.oi.reg_index) == reg_index,
          f"month reg_index kernel {reg_index} vs plain {int(ref_out.oi.reg_index)}")
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI",
                 "sat_averaged_vcd", "ctm_averaged_vcd"):
        np.testing.assert_allclose(getattr(obj, name), getattr(ref, name), rtol=1e-5,
                                   atol=0, equal_nan=True, err_msg=name)
    log("month: plain curve engine gives the identical reg_index and fields (rtol 1e-5)")
    del ref_out, out

    log("== phase 5: timings")
    t0 = time.perf_counter()
    inputs, _ = oisatgmi._fused_inputs("amf", "OMI", [ctm], grans)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    kw = dict(bias_offset=0.32, bias_slope=0.63)
    amf_ms = cuda_ms(lambda: _amf_recal_month(inputs), reps=3)
    step_ms = cuda_ms(lambda: full_month_step(inputs, curve_impl="kernel", **kw), reps=3)
    step_plain_ms = cuda_ms(lambda: full_month_step(inputs, curve_impl="plain", **kw), reps=3)
    step = full_month_step(inputs, **kw)
    xa = step.ctm_vcd
    u, valid = curve_inputs((xa * 50.0 / 100.0) ** 2, step.sat_error ** 2)
    u = u.reshape(-1).contiguous()
    regs = torch.as_tensor(regs_np, dtype=u.dtype, device=dev)
    month_err, _, _ = compare_curve(u, regs, int(valid.sum()), oi_scan, "month curve")
    k_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_kernel(u, regs), reps=50)
    p_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_plain(u, regs), reps=10)
    g_cells = int(np.prod(inputs.vcd.shape))
    log(f"full_month_step ({inputs.vcd.shape[0]} granules, {inputs.sat_pmid.dtype}/"
        f"{inputs.ctm_pc.dtype} inputs): kernel engine {step_ms:.2f} ms, plain engine "
        f"{step_plain_ms:.2f} ms ({g_cells / (step_ms * 1e-3):.4e} granule-cells/s)")
    log(f"month breakdown: host assembly (_fused_inputs: CTM matching, float64 partial "
        f"columns, H2D, stacking) {assemble_s:.3f} s; in the step: AMF recalculation "
        f"{amf_ms:.2f} ms, averaging + OI + diagnostics {step_ms - amf_ms:.2f} ms")
    log(f"ak_curve at the month's shape ({u.numel()} cells x {regs.numel()} factors, "
        f"{u.dtype}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, max_abs_err {month_err:.3e}")
    for key, (err, ms, pms, _) in kres.items():
        log(f"ak_curve at {HEADLINE[0] * HEADLINE[1]} cells {key}: kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, max_abs_err {err:.3e}")
    log(f"oi() {HEADLINE[0]}x{HEADLINE[1]} float32: kernel engine {oi_ms:.4f} ms, "
        f"plain engine {oi_plain_ms:.4f} ms; regrid {regrid_steady:.4f} s/orbit; "
        f"analyze_month_fused {month_s:.3f} s")

    n_valid = int(valid.sum())
    curve_bound, curve_by = ak_curve_bound(n_valid, u.numel(), regs.numel(), u.dtype)
    curve_floor = division_floor_ms(n_valid, regs.numel(), max_sm_mhz)
    log(f"ak_curve bound at the month's shape ({n_valid} valid): {curve_bound:.4f} ms "
        f"({curve_by}), kernel at {curve_bound / k_ms:.1%} of it; division floor "
        f"{curve_floor:.4f} ms, kernel at {curve_floor / k_ms:.1%} of it")
    for key, (err, ms, pms, count) in kres.items():
        dt = torch.float32 if "float32" in key else torch.float64
        b, by = ak_curve_bound(count, HEADLINE[0] * HEADLINE[1], regs.numel(), dt)
        fl = division_floor_ms(count, regs.numel(), max_sm_mhz)
        log(f"ak_curve bound at {HEADLINE[0] * HEADLINE[1]} cells {key} ({count} valid): "
            f"{b:.4f} ms ({by}), kernel at {b / ms:.1%} of it; division floor {fl:.4f} ms, "
            f"kernel at {fl / ms:.1%} of it")

    curve_entry = {
        "name": "ak_curve",
        "route": "cuda",
        "source": "oisat_tpu_torch/csrc/ak_curve.cu",
        "replaces": "oisat_tpu/ops/kernels/oi_scan.py:46",
        "launches": launches,
        "max_abs_err": month_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": curve_bound,
        "bound_by": curve_by,
        "library_ms": None,  # no single PyTorch call computes the curve sums
        "cells": u.numel(),
        "factors": regs.numel(),
        "dtype": str(u.dtype).replace("torch.", ""),
    }
    # the global month's tensors (~20 GB) are not needed again
    del inputs, step, xa, u, valid, grans, obj, ref
    torch.cuda.empty_cache()
    cov_times = phase_covariance(dev, cov)
    full = phase_full_month(dev, cov, oi_scan, native)
    mopitt, mopitt_launches, mopitt_shape = phase_mopitt(dev, oi_scan, regs_np)
    by_path = {"omi_fused_month": launches, "mopitt_staged_and_fused": mopitt_launches}
    by_path["desroziers_mopitt"], cov_desroziers = phase_desroziers(oi_scan, cov, mopitt,
                                                                    full["reader"])
    del mopitt
    torch.cuda.empty_cache()
    _, by_path["gosat_staged_and_fused"], gosat_shape = phase_gosat(dev, oi_scan, regs_np)
    torch.cuda.empty_cache()
    _, by_path["ssmis_staged_and_fused"], ssmis_shape = phase_ssmis(dev, oi_scan, regs_np)
    curve_entry["launches"] = sum(by_path.values())
    curve_entry["launches_by_path"] = by_path
    # the same kernel held against its plain version at the other months' shapes
    curve_entry["other_shapes"] = [mopitt_shape, gosat_shape, ssmis_shape]
    log(f"ak_curve launches on the driven paths: {by_path}")
    for n, (ms, pms, bms, by) in cov_times.items():
        log(f"covariance at n={n}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")

    log(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": [curve_entry, {
        "name": "covariance",
        "route": "cuda",
        "source": "oisat_tpu_torch/csrc/covariance.cu",
        "replaces": "oisat_tpu/ops/kernels/covariance.py:32",
        "launches": full["launches"] + cov_desroziers,
        "launches_by_path": {"omi_full_month": full["launches"],
                             "desroziers_full_month": cov_desroziers},
        "max_abs_err": full["err"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,  # no single PyTorch call builds B
        "cells": full["cells"],
        "dtype": "float32",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
