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

12. The job runner on the card: control dictionaries with the keys of
    ``run/control.yml`` go through ``oisat_tpu_torch.run.job._analyze``, on
    granules the earlier phases built: (a) phase 4's OMI month with
    ``fused_month: true``; (b) phase 8's MOPITT month with no ``fused_month``
    (the staged dispatch); (c) a ``fused_month: true`` month the fused step
    refuses (phase 7's CONUS orbits read without scattering weights,
    ``read_AK: false``), which prints the fallback line and finishes staged;
    (d) phase 7's CONUS month with ``oi_method: full``, ``length_scale_km:
    300``.  Each is held to the direct driver call on the same granules (the
    same factor; fields within that phase's tolerance: rtol 1e-5, the
    staged bound, 1e-9), the two kernels' launch counts rise by exactly what
    the path launches, and the wall seconds stand beside the direct call's.
    ``_diag_fields()`` of (a): the 11 names, float arrays of the grid's
    shape, the scaling factor equal to a numpy recomputation (NaN / inf / 0
    -> 1.0), no device->host copy for fields the month already pulled and
    exactly one for each field that is a tensor.  ``settle_device_granules``
    leaves ``sat_data`` as it is.  (e) (c)'s orbits regridded in a worker
    thread while the main thread launches the curve kernel, then analysed in
    the main thread, give (c)'s result bitwise (the campaign's prefetch).
    The file half (``write_to_nc`` -> ``read_diag_nc``, ``save_state`` ->
    ``load_state`` -> ``average`` -> ``oi``) runs where h5py is installed;
    where it is not, one line says that the CPU tests hold it.

13. The matrix-free full OI (L = 300 km; the branch of ``oi_full`` above
    the dense limits, which launches neither kernel: both counts are held
    at 0).  (a) Phase 8's staged MOPITT session through ``oi("MOPITT",
    method="full")``: 64,261 valid cells padded to 64,512, the SLQ knee,
    the Nystrom PCG (k = 2,048), the Woodbury diagonal, the sampled
    float64 residual; solver, preconditioner, finite residuals, a finite
    posterior, -0.05 < AK < 1.05 and err >= 0, and a warm repeat through
    ``oi_full`` bitwise equal, with its stage split.  (b) 60 orbits over
    North America (20-60 N x 140-60 W, 10,449 cells) through
    ``analyze_month_fused(oi_method="full")``: the SLQ knee and the exact
    float64 solve on the card ("direct_f64_dev", exact diagonal, residual
    under the gate), a warm repeat bitwise equal, and the float32 Nystrom
    PCG on the same inputs and factor within twice its ``resid_abs`` of the
    direct increment.  (c) The SLQ curve on phase 7's CONUS cells within
    rtol 0.04 of the dense scan's, and the Jacobi branch on a 64 x 64
    one-degree window against the dense solve (tests/test_oi_full.py's
    bounds).  Then one ``_b_matmat`` sweep at 13a's shape, K = 8 and 16,
    beside its operations bound.

14. The mesh path (``oisat_tpu_torch.parallel``), on logical shards of the
    card (a mesh whose positions all name ``cuda:0``): (a) the sharded curve
    (``ak_curve.cu`` once per grid shard, the sums added in shard order) at
    4,147,200 x 99 in float32 and float64 on 1 x 2, 2 x 2 and 2 x 4 meshes,
    against the sharded plain version (rtol 1e-5 / 1e-12) and the one-launch
    kernel with the same knee, one launch per grid shard, bitwise on repeat,
    an empty and an all-invalid shard, times beside the one-launch kernel
    and the bound; (b) phase 4's stacked month through
    ``make_full_month_step`` on 2 x 2 against ``full_month_step`` (the same
    ``reg_index``, fields within rtol 1e-5 / atol 1e-6, no copy of the
    inputs, peak memory, the time beside the step's, the curve at the
    month's shape against its plain version: the ``kernels`` line's
    numbers); (c) phase 8's MOPITT granules through
    ``analyze_month_fused(mesh=)`` against the mesh-less month (the same
    factor, STAGED_RTOL) and ``entry.dryrun_multichip(4)``; (d) the sharded
    ``_b_matmat`` at 13b's 11,264 cells, K = 8, over 4 shards within 1e-5 of
    the largest |Y| and bitwise on repeat, and 13c's Jacobi window with the
    mesh within atol 1e-4; (e) one OMI orbit's regrid over the mesh, bitwise
    the single-device regrid; (f) (a) and (b) over real cards where
    ``torch.cuda.device_count() > 1``, else one line says there is one card.
    On one card these times are the overhead of sharding, not a speed-up.

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
each kernel with its launches on its path, error, times and bound:
``ak_curve``, ``covariance`` and ``ak_curve_sharded`` (the same
``ak_curve.cu``, launched once per grid shard on phase 14's mesh paths).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
import tempfile
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
DIAG_NAMES = ("sat_averaged_vcd", "ctm_averaged_vcd_prior", "ctm_averaged_vcd_posterior",
              "sat_averaged_error", "ak_OI", "error_OI", "scaling_factor", "lon", "lat",
              "aux1", "aux2")  # the diag netCDF's variables, in the file's order
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
                bound_ms=bms, bound_by=by, cells=n, reader=reader, direct=obj,
                direct_s=again_s, orbits=orbits, ctm=ctm, grid=(lon2d, lat2d))


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
    kernel's times at this month's shape, what phase 12 needs to run the
    month again: the CTM, the unprocessed granules, the staged wall)."""
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
    shape_job = dict(ctm=ctm, grans=grans, staged_s=staged_s)
    return staged, staged_launches + fused_launches, shape, shape_job


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


def job_control(sensor: str, gas: str, **over) -> dict:
    """A control dictionary with the keys of ``run/control.yml`` (built here:
    a GPU host need not have yaml); ``over`` sets what a phase switches."""
    ctrl = {"python_bin": "python3", "debug": False, "save_daily": False, "num_job": 1,
            "ctm_name": "GMI", "ctm_dir": "", "mcip_dir": "", "ctm_freq": "3-hourly",
            "ctm_avg": True, "ctm_error": 50.0, "gas": gas, "sensor": sensor,
            "read_AK": True, "troposphere_only": False, "sat_dir": "",
            "start_date": "2019-07", "end_date": "2019-07", "output_pdf_dir": "report",
            "output_nc_dir": "diag"}
    ctrl.update(over)
    return ctrl


NO_WEIGHTS = "No scattering weights found"  # recal_amf says so once per granule


def quietly(fn, *args, **kw):
    """``fn(*args, **kw)`` with its prints captured: (result, the text).  The
    text is logged again with the per-granule ``NO_WEIGHTS`` lines counted
    instead of repeated."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = fn(*args, **kw)
    lines = text.getvalue().splitlines()
    repeated = sum(NO_WEIGHTS in line for line in lines)
    for line in lines:
        if NO_WEIGHTS not in line:
            log("  | " + line)
    if repeated:
        log(f"  | ({repeated} lines \"{NO_WEIGHTS} ...\", one per granule)")
    return out, text.getvalue()


def job_analyze(reader, ctrl, oi_scan, cov, want_curve: int, want_cov: int, what: str):
    """One batch of granules through the job runner's ``_analyze`` with both
    kernels' counts set to 0 just before and read just after: (session, wall
    seconds, what the run printed).  Fails unless the counts rose by exactly
    ``want_curve`` / ``want_cov``."""
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.run.job import _analyze

    obj = oisatgmi()
    obj.reader_obj = reader
    oi_scan.ak_curve_sums_kernel.launches = 0
    cov.build_covariance_kernel.launches = 0
    # ---- the main path of this slice: the job runner's dispatch ----
    t0 = time.perf_counter()
    _, said = quietly(_analyze, obj, ctrl, ctrl["sensor"], ctrl["gas"], *MONTH,
                      savedaily=("diag", "2019_07"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (oi_scan.ak_curve_sums_kernel.launches, cov.build_covariance_kernel.launches)
    # ---- end of the main path ----
    check(got == (want_curve, want_cov), f"{what}: (ak_curve, covariance) launches {got}, "
          f"the path should launch {(want_curve, want_cov)}")
    return obj, secs, said


def assert_job_equals_direct(job, direct, rtol: float, atol_scale: float, what: str) -> bool:
    """The nine driver fields of a job-runner session against the direct
    driver call on the same granules: identical NaN patterns, values within
    ``rtol`` plus ``atol_scale`` of the field's largest magnitude, the same
    innovation count.  Returns whether every field is bitwise equal."""
    bitwise = True
    for name in DRIVER_FIELDS:
        a, b = getattr(job, name), getattr(direct, name)
        check(a.shape == b.shape, f"{what} {name}: shapes {a.shape} vs {b.shape}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what} {name}: NaN patterns differ")
        fin = np.isfinite(b)
        if fin.any():
            np.testing.assert_allclose(a[fin], b[fin], rtol=rtol,
                                       atol=atol_scale * float(np.abs(b[fin]).max()),
                                       err_msg=f"{what} {name}")
        bitwise = bitwise and np.array_equal(a, b, equal_nan=True)
    check(set(job.oi_diagnostics) == set(direct.oi_diagnostics), f"{what}: diagnostics' names")
    check(job.oi_diagnostics["n"] == direct.oi_diagnostics["n"], f"{what}: n differs")
    return bitwise


def log_job(what: str, job_s: float, direct_s: float, bitwise: bool, launches) -> None:
    log(f"{what}: _analyze {job_s:.3f} s, the direct driver call {direct_s:.3f} s (host "
        f"clock); fields {'bitwise equal' if bitwise else 'within tolerance'}; (ak_curve, "
        f"covariance) launches {launches}")


def check_diag_fields(job, dev, hw) -> None:
    """``_diag_fields()`` of a session on the card, without h5py."""
    from oisat_tpu_torch import _device

    _device.COPIES.update(h2d=0, d2h=0)
    fields = job._diag_fields()
    check(_device.COPIES["d2h"] == 0, "_diag_fields copied a field the month's one pull "
          f"had brought to the host ({_device.COPIES['d2h']} copies)")
    check(tuple(fields) == DIAG_NAMES, f"diag names {tuple(fields)}")
    for name, v in fields.items():
        check(isinstance(v, np.ndarray) and v.dtype.kind == "f" and v.shape == tuple(hw),
              f"diag field {name}: {type(v)} {getattr(v, 'dtype', None)} "
              f"{getattr(v, 'shape', None)}")
    prior, post = fields["ctm_averaged_vcd_prior"], fields["ctm_averaged_vcd_posterior"]
    with np.errstate(invalid="ignore", divide="ignore"):
        sf = post / prior
    ruled = np.isnan(sf) | np.isinf(sf) | (sf == 0.0)
    check(np.array_equal(fields["scaling_factor"], np.where(ruled, 1.0, sf)),
          "scaling_factor differs from posterior / prior with NaN, inf, 0 -> 1.0")
    check(0 < int(ruled.sum()) < ruled.size, "the month must hold cells on both sides of "
          "the 1.0 rule")
    # a session whose fields are tensors on the card: one copy for each
    tensors = copy.copy(job)
    names = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
             "ctm_averaged_vcd_corrected", "ak_OI", "error_OI")
    for name in names:
        setattr(tensors, name, torch.as_tensor(getattr(job, name), device=dev))
    _device.COPIES.update(h2d=0, d2h=0)
    again = tensors._diag_fields()
    check(_device.COPIES["d2h"] == len(names), f"{_device.COPIES['d2h']} device->host "
          f"copies for {len(names)} tensor fields")
    for name in DIAG_NAMES:
        check(np.array_equal(again[name], fields[name], equal_nan=True),
              f"diag field {name} differs when pulled from the card")
    log(f"_diag_fields(): {len(fields)} names in the file's order, float arrays {tuple(hw)}; "
        f"scaling_factor == numpy's posterior / prior, {int(ruled.sum())} cells set to 1.0; "
        f"0 device->host copies (the month pulled its fields once), {len(names)} for "
        f"{len(names)} fields held as tensors on the card")


def phase_job_omi(dev, oi_scan, cov, direct, direct_s, reg_index, grid) -> int:
    """Phase 12a: phase 4's month through the job runner, ``fused_month: true``."""
    log("== phase 12: the job runner on the card (run.job._analyze on control dictionaries)")
    reader = direct.reader_obj
    ctrl = job_control("OMI", "NO2", fused_month=True)
    job, secs, _ = job_analyze(reader, ctrl, oi_scan, cov, 1, 0, "12a OMI fused month")
    bitwise = assert_job_equals_direct(job, direct, 1e-5, 0.0, "12a OMI fused month")
    check(implied_factor(job, "OMI", grid) == reg_index,
          "12a: the job's fields do not carry the direct call's factor")
    log_job("12a OMI fused month (fused_month: true)", secs, direct_s, bitwise, (1, 0))
    check_diag_fields(job, dev, direct.ctm_averaged_vcd.shape)
    before = list(reader.sat_data)
    job.settle_device_granules()
    check(len(before) == len(reader.sat_data)
          and all(a is b for a, b in zip(before, reader.sat_data)),
          "settle_device_granules changed sat_data")
    log("settle_device_granules(): sat_data unchanged (the regrid drops an off-domain "
        "granule when it regrids it)")
    return 1


def phase_job_mopitt(oi_scan, cov, direct, month, grid) -> int:
    """Phase 12b: phase 8's MOPITT month through the staged dispatch."""
    reader = SimpleNamespace(ctm_data=[month["ctm"]],
                             sat_data=[copy.copy(g) for g in month["grans"]])
    ctrl = job_control("MOPITT", "CO", ctm_name="ECCOH")
    job, secs, said = job_analyze(reader, ctrl, oi_scan, cov, 1, 0, "12b MOPITT staged month")
    check("fused month not applicable" not in said, "12b: a month without fused_month "
          "went through the fused path first")
    bitwise = assert_job_equals_direct(job, direct, STAGED_RTOL, STAGED_ATOL,
                                       "12b MOPITT staged month")
    check(implied_factor(job, "MOPITT", grid) == implied_factor(direct, "MOPITT", grid),
          "12b: the job and the direct staged call picked different factors")
    log_job("12b MOPITT month (no fused_month: conv_ak -> average -> bias_correct -> oi)",
            secs, month["staged_s"], bitwise, (1, 0))
    return 1


def file_round_trip(job, staged, folder: str, dev) -> None:
    """``write_to_nc`` -> ``read_diag_nc`` of one session, and ``save_state`` ->
    ``load_state`` -> ``average`` -> ``oi`` of a staged one, on the card."""
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.ncwriter import read_diag_nc

    job.write_to_nc("NO2_201907", folder)
    fields, tstr, attrs = read_diag_nc(f"{folder}/NO2_201907.nc", with_attrs=True)
    want = job._diag_fields()
    check(tstr == job.avg_time.strftime("%Y-%m-%d %H:%M:%S"), f"diag time {tstr!r}")
    check(set(fields) == set(DIAG_NAMES), f"diag variables {sorted(fields)}")
    for name in DIAG_NAMES:
        check(np.array_equal(fields[name], want[name].astype(np.float32), equal_nan=True),
              f"diag variable {name} read back differs")
    check(set(attrs) == set(job.oi_diagnostics), f"diag attributes {sorted(attrs)}")
    staged.save_state(f"{folder}/granules.h5")
    resumed = oisatgmi()
    resumed.load_state(f"{folder}/granules.h5", ctm_data=staged.reader_obj.ctm_data, device=dev)
    resumed.average(*MONTH, gasname="NO2")
    resumed.bias_correct("OMI", "NO2")
    resumed.oi("OMI", error_ctm=50.0)
    for name in DRIVER_FIELDS:
        check(np.array_equal(getattr(resumed, name), getattr(staged, name), equal_nan=True),
              f"save_state -> load_state -> average -> oi: {name} differs")
    log("file round trip on the card: write_to_nc -> read_diag_nc equal; save_state -> "
        "load_state -> average -> oi equal to the uninterrupted run")


def phase_job_conus(dev, oi_scan, cov, full, grid):
    """Phases 12c-e on the CONUS month; returns (ak_curve launches of the
    fallback month, covariance launches of the full month)."""
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.ops.oi import oi
    from oisat_tpu_torch.regridder import regrid_granule

    lon2d, lat2d = full["grid"]
    # 12d: the full-covariance month, oi_method: full
    ctrl = job_control("OMI", "NO2", fused_month=True, oi_method="full",
                       length_scale_km=LENGTH_SCALE_KM)
    job, secs, _ = job_analyze(full["reader"], ctrl, oi_scan, cov, 0, 1,
                               "12d CONUS full month")
    direct = full["direct"]
    bitwise = assert_job_equals_direct(job, direct, FULL_RTOL, 0.0, "12d CONUS full month")
    for key in ("reg", "solver"):
        check(job.oi_diagnostics[key] == direct.oi_diagnostics[key],
              f"12d: {key} {job.oi_diagnostics[key]} vs {direct.oi_diagnostics[key]}")
    log_job(f"12d CONUS month (oi_method: full, length_scale_km: {LENGTH_SCALE_KM:g})", secs,
            full["direct_s"], bitwise, (0, 1))

    # 12c: the same orbits as read with read_AK: false -- no scattering weights
    bare = [dataclasses.replace(o, scattering_weights=np.empty((1,))) for o in full["orbits"]]

    def regrid_all():
        return [regrid_granule(1, 0.25, o, lon2d, lat2d, dev, flag_thresh=0.5) for o in bare]

    def staged(obj):
        obj.recal_amf()
        obj.average(*MONTH, gasname="NO2")
        obj.bias_correct("OMI", "NO2")
        obj.oi("OMI", error_ctm=50.0)

    def staged_direct(grans):
        obj = oisatgmi()
        obj.reader_obj = SimpleNamespace(ctm_data=[full["ctm"]], sat_data=grans)
        t0 = time.perf_counter()
        quietly(staged, obj)
        torch.cuda.synchronize()
        return obj, time.perf_counter() - t0

    direct, direct_s = staged_direct(regrid_all())
    ctrl = job_control("OMI", "NO2", fused_month=True, read_AK=False)
    reader = SimpleNamespace(ctm_data=[full["ctm"]], sat_data=regrid_all())
    check(all(np.size(g.scattering_weights) == 1 for g in reader.sat_data),
          "12c: the granules must carry no scattering weights")
    job, secs, said = job_analyze(reader, ctrl, oi_scan, cov, 1, 0, "12c OMI fallback month")
    check("fused month not applicable (fused month path needs scattering weights); "
          "running staged pipeline" in said, "12c: the fallback line was not printed")
    bitwise = assert_job_equals_direct(job, direct, STAGED_RTOL, STAGED_ATOL,
                                       "12c OMI fallback month")
    check(implied_factor(job, "OMI", grid) == implied_factor(direct, "OMI", grid),
          "12c: the job and the direct staged call picked different factors")
    log_job("12c CONUS month without scattering weights (fused_month: true refused -> "
            "recal_amf -> average -> bias_correct -> oi)", secs, direct_s, bitwise, (1, 0))

    # 12e: the campaign's prefetch -- the regrid in a worker thread while this
    # thread keeps the curve kernel busy, the analysis here
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in oi_fields((1440, 720), seed=3)]
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(regrid_all)
        passes = 0
        while not pending.done():
            oi(*args)  # the curve kernel, on this thread
            passes += 1
        grans = pending.result()
    threaded, _ = staged_direct(grans)
    for name in DRIVER_FIELDS:
        check(np.array_equal(getattr(threaded, name), getattr(direct, name), equal_nan=True),
              f"12e: {name} of a month regridded in a worker thread differs")
    log(f"12e: {len(grans)} orbits regridded in a worker thread beside {passes} oi() passes "
        "of this thread, analysed here: bitwise the inline month")

    # the file half: h5py decides, in the open
    if importlib.util.find_spec("h5py") is not None:
        with tempfile.TemporaryDirectory() as folder:
            file_round_trip(job, direct, folder, dev)
    else:
        log("h5py is not installed here: the file round trip (write_to_nc -> read_diag_nc, "
            "save_state -> load_state -> average -> oi) is held by the CPU tests "
            "(tests/test_torch_job.py, tests/test_torch_ncwriter.py)")
    return 1, 1


def kernel_counts(oi_scan, cov) -> tuple:
    return oi_scan.ak_curve_sums_kernel.launches, cov.build_covariance_kernel.launches


@contextlib.contextmanager
def knees_picked():
    """The knee indices the matrix-free branch's SLQ curve gives while inside
    (its ``info`` has no factor, as in the JAX package): a list that
    ``oi_full.slq_knee`` appends to, restored on exit."""
    from oisat_tpu_torch.ops import oi_full as full_oi

    real = full_oi.slq_knee
    seen: list = []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0])
        return out

    full_oi.slq_knee = spy
    try:
        yield seen
    finally:
        full_oi.slq_knee = real


def log_matfree(what: str, info: dict, first_s: float, warm_s: float, warm_ms: dict,
                peak_gb: float, warned: bool, factor: float) -> None:
    """One matrix-free month's numbers: the factor, the solve, numerics
    against statistics, the wall and the stage split of the warm run."""
    log(f"{what}: factor {factor:.1f}; solver {info['solver']}, precond {info['precond']}, "
        f"cg_iters {info['cg_iters']}, cg_resid {info['cg_resid']:.3e}, f64_resid "
        f"{info['f64_resid']:.3e}, exact_diag {info['exact_diag']}; resid_abs "
        f"{info['resid_abs']:.3e} vs stat_norm {info['stat_norm']:.3e} "
        f"({info['resid_abs'] / info['stat_norm']:.2e} of it); convergence WARNING "
        f"{'printed' if warned else 'not printed'}")
    log(f"{what}: first call {first_s:.3f} s, warm {warm_s:.3f} s (host clock); warm "
        "oi_full = " + " + ".join(f"{k.split('.', 1)[1]} {v:.2f}" for k, v in warm_ms.items()
                                  if k.startswith("oi_full.")) + " ms; peak device memory "
        f"{peak_gb:.2f} GB")


def phase_matfree_mopitt(dev, oi_scan, cov, mopitt, grid):
    """Phase 13a: phase 8's staged MOPITT session (a copy: phases 11 and 12
    read the original) through ``oi("MOPITT", method="full")``: 64,261 valid
    cells padded to 64,512, above every dense limit and REFINE_MAX_CELLS, so
    the SLQ knee, the Nystrom PCG (k = 2,048), the Woodbury diagonal and the
    sampled float64 residual.  A warm repeat through ``oi_full`` gives its
    stage split, the same solve and bitwise-equal fields.  Returns the
    padded cells (``oi_full.Padded``) for the sweep's timing."""
    from oisat_tpu_torch.ops.oi_full import compact, oi_full, pad_for_matfree

    log("== phase 13: the matrix-free full OI (L = 300 km)")
    obj = copy.copy(mopitt)
    obj.stage_ms = {}
    torch.cuda.reset_peak_memory_stats()
    oi_scan.ak_curve_sums_kernel.launches = cov.build_covariance_kernel.launches = 0
    # ---- the main path of this slice: the staged OI with oi_method full ----
    with knees_picked() as knees:
        t0 = time.perf_counter()
        _, said = quietly(obj.oi, "MOPITT", error_ctm=50.0, method="full",
                          length_scale_km=LENGTH_SCALE_KM)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    counts = kernel_counts(oi_scan, cov)
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts == (0, 0), f"13a: the matrix-free path launched {counts} (ak_curve, "
          "covariance) kernels")
    d = obj.oi_diagnostics
    check(d.get("solver") == "pcg_f32" and d.get("precond") == "nystrom(k=2048)",
          f"13a: solver {d.get('solver')} precond {d.get('precond')}")
    check(np.isfinite(d["cg_resid"]) and np.isfinite(d["f64_resid"]),
          f"13a: cg_resid {d['cg_resid']} f64_resid {d['f64_resid']}")
    inputs = obj.full_oi_inputs(50.0, "MOPITT")
    cp = compact(*inputs)
    xa, y, err = obj.ctm_averaged_vcd, obj.sat_averaged_vcd, obj.sat_averaged_error
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(err) & (err > 0)
    check(int(both.sum()) == cp.idx.size, f"13a: {both.sum()} valid cells vs {cp.idx.size}")
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        check(np.isfinite(getattr(obj, name)[both]).all(),
              f"13a: {name} not finite where prior, observation and error are")
    ak = obj.ak_OI[both]
    check(((ak > -0.05) & (ak < 1.05)).all() and (obj.error_OI[both] >= 0).all(),
          f"13a: AK in [{ak.min():.4f}, {ak.max():.4f}], err min "
          f"{obj.error_OI[both].min():.3e}")
    warm_ms: dict = {}
    with knees_picked() as warm_knees:
        t0 = time.perf_counter()
        warm = quietly(oi_full, *inputs, LENGTH_SCALE_KM, regularization_on=True,
                       device=dev, stage_ms=warm_ms)[0]
        warm_s = time.perf_counter() - t0
    check(knees == warm_knees and len(knees) == 1, f"13a: knees {knees} then {warm_knees}")
    for name, field in (("ctm_averaged_vcd_corrected", "xb"), ("ak_OI", "averaging_kernel"),
                        ("increment_OI", "increment"), ("error_OI", "error")):
        check(np.array_equal(getattr(obj, name), getattr(warm, field), equal_nan=True),
              f"13a: the warm repeat's {field} is not bitwise the first call's")
    for key in ("cg_iters", "cg_resid", "f64_resid", "solver", "precond", "stat_norm"):
        check(warm.info[key] == d[key], f"13a: warm {key} {warm.info[key]} vs {d[key]}")
    pv = pad_for_matfree(cp)
    log(f"13a MOPITT month, oi_method full: {cp.idx.size} valid cells of {both.size}, padded "
        f"to {pv.xa.size}; (ak_curve, covariance) launches {counts}: the matrix-free path "
        "launches neither kernel; the warm repeat bitwise equal")
    log_matfree("13a MOPITT month", d, first_s, warm_s, warm_ms, peak_gb, "WARNING" in said,
                float(grid[knees[0]]))
    return pv


def phase_matfree_north_america(dev, oi_scan, cov):
    """Phase 13b: 60 OMI-shaped orbits over North America (TEMPO's field of
    regard, 20-60 N x 140-60 W, 81 x 129 = 10,449 cells) through
    ``analyze_month_fused(oi_method="full")``: above the scan's dense limit,
    under REFINE_MAX_CELLS once padded, so the SLQ knee and the exact float64
    solve on the card.  ``oi_full_matfree(refine=0)`` (the float32 Nystrom
    PCG) on the same compacted inputs and factor lands within twice its own
    ``resid_abs`` of the direct increment.  Returns the padded cells for
    phase 14d's sweep."""
    from oisat_tpu_torch.entry import NORTH_AMERICA, synthetic_regional_month
    from oisat_tpu_torch.ops.oi_full import (DENSE_SCAN_MAX_CELLS, DEVICE_EXACT_RESID_GATE,
                                             REFINE_MAX_CELLS, compact, oi_full_matfree,
                                             pad_for_matfree, regularization_grid)
    from oisat_tpu_torch.regridder import regrid_granule

    t0 = time.perf_counter()
    orbits, ctm, lon2d, lat2d = synthetic_regional_month(N_ORBITS, seed=0, window=NORTH_AMERICA)
    grans = [regrid_granule(1, 0.25, o, lon2d, lat2d, dev, flag_thresh=0.5) for o in orbits]
    torch.cuda.synchronize()
    del orbits
    log(f"13b North America month: {N_ORBITS} orbits built and regridded onto "
        f"{lat2d.shape} = {lat2d.size} cells in {time.perf_counter() - t0:.1f} s")
    check(all(g is not None for g in grans), "13b: an orbit missed the window")
    reader = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    torch.cuda.reset_peak_memory_stats()
    oi_scan.ak_curve_sums_kernel.launches = cov.build_covariance_kernel.launches = 0
    # ---- the main path of this slice: the fused month, oi_method full ----
    with knees_picked() as knees:
        obj, _, first_s, first_ms = full_month(reader, dev)
    counts = kernel_counts(oi_scan, cov)
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts == (0, 0), f"13b: the matrix-free path launched {counts} kernels")
    d = obj.oi_diagnostics
    cp = compact(*obj.full_oi_inputs())
    pv = pad_for_matfree(cp)
    check(DENSE_SCAN_MAX_CELLS < cp.idx.size and pv.xa.size <= REFINE_MAX_CELLS,
          f"13b: {cp.idx.size} cells (padded {pv.xa.size}) off the direct branch")
    check(d.get("solver") == "direct_f64_dev" and d.get("exact_diag") is True,
          f"13b: solver {d.get('solver')} exact_diag {d.get('exact_diag')}")
    check(d["f64_resid"] <= DEVICE_EXACT_RESID_GATE, f"13b: f64_resid {d['f64_resid']}")
    xa, y, so = obj.ctm_averaged_vcd, obj.sat_averaged_vcd, obj.sat_averaged_error
    both = np.isfinite(xa) & np.isfinite(y) & np.isfinite(so) & (so > 0)
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        check(np.isfinite(getattr(obj, name)[both]).all(), f"13b: {name} not finite")
    with knees_picked() as warm_knees:
        again, _, warm_s, warm_ms = full_month(reader, dev)
    check(knees == warm_knees and len(knees) == 1, f"13b: knees {knees} then {warm_knees}")
    for name in ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        check(np.array_equal(getattr(obj, name), getattr(again, name), equal_nan=True),
              f"13b: the warm repeat's {name} is not bitwise the first call's")
    r = float(regularization_grid()[knees[0]])
    ratio = 0.5 * xa[both] / so[both]
    log(f"13b North America month: {cp.idx.size} valid cells padded to {pv.xa.size}, "
        f"sigma_b/sigma_o median {np.median(ratio):.1f}; (ak_curve, covariance) launches "
        f"{counts}; the warm repeat bitwise equal")
    log_matfree("13b North America month", d, first_s, warm_s, warm_ms, peak_gb,
                False, r)
    log("13b first call: oi_full = " + " + ".join(
        f"{k.split('.', 1)[1]} {v:.2f}" for k, v in first_ms.items() if k.startswith("oi_full."))
        + " ms; analyze_month_fused stages " + " + ".join(
        f"{k} {v:.2f}" for k, v in first_ms.items() if "." not in k) + " ms")

    # the float32 Nystrom PCG on the same compacted inputs and factor
    t0 = time.perf_counter()
    _, _, inc_pcg, _, info = oi_full_matfree(
        pv.xa, pv.y, pv.sb * np.sqrt(r), pv.so, pv.lat, pv.lon, LENGTH_SCALE_KM,
        valid=pv.valid, refine=0, device=dev)
    pcg_s = time.perf_counter() - t0
    inc_direct = obj.increment_OI.ravel()[cp.idx] / cp.scale
    gap = float(np.linalg.norm(inc_pcg[:cp.idx.size] - inc_direct))
    check(gap <= 2.0 * info["resid_abs"], f"13b: the PCG increment is {gap:.3e} from the "
          f"direct one, over twice its resid_abs {info['resid_abs']:.3e}")
    log(f"13b cross-check: oi_full_matfree(refine=0) {info['solver']} {info['precond']}, "
        f"{info['cg_iters']} iterations, f64_resid {info['f64_resid']:.3e}, {pcg_s:.3f} s; "
        f"||inc_pcg - inc_direct|| {gap:.3e} <= 2 x resid_abs {info['resid_abs']:.3e}")
    return pv


def phase_matfree_vs_dense(dev, full, grid):
    """Phase 13c: (i) the SLQ curve on phase 7's compacted CONUS cells against
    the dense scan's curve (rtol 0.04; the two knees are logged, not held:
    that regime's knee is rounding-sensitive); (ii) the Jacobi branch against
    the dense solve on a 64 x 64 one-degree window with bench.bench_matfree's
    mild fields (tests/test_oi_full.py's bounds).  Returns the window's inputs
    and its Jacobi result for phase 14d."""
    from oisat_tpu_torch.ops.knee import kneedle_index_np
    from oisat_tpu_torch.ops.oi_full import (compact, mean_ak_curve_slq, oi_full_dense,
                                             oi_full_dense_scan, oi_full_matfree)

    cp = compact(*full["direct"].full_oi_inputs())
    vec = [torch.as_tensor(v.astype(np.float32), device=dev)
           for v in (cp.xa, cp.y, cp.sb, cp.so, cp.lat, cp.lon)]
    t0 = time.perf_counter()
    slq = mean_ak_curve_slq((cp.lat, cp.lon), cp.sb, cp.so, grid, LENGTH_SCALE_KM,
                            n_probes=64, device=dev)
    slq_s = time.perf_counter() - t0
    dense = oi_full_dense_scan(*vec, LENGTH_SCALE_KM, grid.astype(np.float32))[5]
    dense = dense.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(slq, dense, rtol=0.04, err_msg="13c SLQ vs dense scan curve")
    log(f"13c (i) SLQ curve on the CONUS month's {cp.idx.size} cells (64 probes, "
        f"{slq_s:.3f} s) within rtol 0.04 of the dense scan's (largest "
        f"{float(np.max(np.abs(slq / dense - 1.0))):.2e}); knees: SLQ "
        f"{grid[kneedle_index_np(grid, slq)]:.1f}, dense {grid[kneedle_index_np(grid, dense)]:.1f}")

    # 31.5 S-31.5 N: the grid pitch stays above the 75 km cluster radius,
    # so every cell is probed itself (as in tests/test_oi_full.py's domain)
    lon, lat = np.meshgrid(np.arange(0.5, 64.0, 1.0), np.arange(-31.5, 32.0, 1.0))
    rng = np.random.default_rng(0)
    xa = np.abs(rng.normal(3, 1, lat.shape))
    y = xa * rng.uniform(0.8, 1.3, lat.shape)
    sigb = np.abs(rng.normal(1.0, 0.2, lat.shape))
    sigo = np.abs(rng.normal(0.6, 0.1, lat.shape))
    args = [a.ravel() for a in (xa, y, sigb, sigo, lat, lon)]
    ref = oi_full_dense(*(torch.as_tensor(a.astype(np.float32), device=dev) for a in args),
                        LENGTH_SCALE_KM)
    ref = [r.cpu().numpy().astype(np.float64) for r in ref]
    t0 = time.perf_counter()
    xb, ak, inc, err, info = oi_full_matfree(*args, LENGTH_SCALE_KM, precond="jacobi",
                                             probe_sep_factor=6.0, cg_tol=1e-7, device=dev)
    jac_s = time.perf_counter() - t0
    np.testing.assert_allclose(xb, ref[0], rtol=2e-4, atol=2e-4, err_msg="13c xb")
    np.testing.assert_allclose(inc, ref[2], rtol=0, atol=5e-4, err_msg="13c increment")
    np.testing.assert_allclose(ak, ref[1], rtol=0, atol=2e-3, err_msg="13c AK")
    np.testing.assert_allclose(err, ref[3], rtol=0, atol=2e-3, err_msg="13c err")
    log(f"13c (ii) Jacobi matrix-free vs dense on {lat.size} cells: {info['ncolors']} colours "
        f"in {info['nchunks']} chunk(s), {info['cg_iters']} iterations, cg_resid "
        f"{info['cg_resid']:.2e}, {jac_s:.3f} s; largest |diff| xb "
        f"{np.max(np.abs(xb - ref[0])):.2e}, inc {np.max(np.abs(inc - ref[2])):.2e}, AK "
        f"{np.max(np.abs(ak - ref[1])):.2e}, err {np.max(np.abs(err - ref[3])):.2e}")
    return args, (xb, ak, inc, err)


def phase_sweep(dev, pv) -> list:
    """One ``_b_matmat`` sweep on 13a's padded cells (N = 64,512), K = 8 and
    16 (CUDA events, warm) beside its operations bound: N^2 * 10 elementwise
    operations (3 sub, 3 mul, 2 add, 1 scale, 1 exp) + 2 N^2 K for the
    contraction, over the card's float32 peak."""
    from oisat_tpu_torch.ops.oi_full_matfree import _b_matmat, _unit_vectors

    n = pv.xa.size
    rng = np.random.default_rng(4)
    u3 = _unit_vectors(pv.lat, pv.lon, dev)
    sbt = torch.as_tensor(pv.sb.astype(np.float32), device=dev)
    out = []
    for k in (8, 16):
        v = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024), reps=3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bms, by = bound_ms(4 * (3 * n + n + 2 * n * k), 10.0 * n * n + 2.0 * n * n * k,
                           torch.float32)
        out.append((k, ms, bms, by))
        log(f"_b_matmat sweep N={n}, K={k}, block 1024 (CUDA events, warm): {ms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}), {ms / bms:.1f}x the bound; peak device memory "
            f"{peak_gb:.2f} GB; nvidia-smi {smi_line()}")
    return out

# ---------------------------------------------------------------------------
# phase 14: the mesh path (logical shards of one card; real cards where there
# are several)
# ---------------------------------------------------------------------------

def sharded_curve_bound(n_valid: int, n: int, nfac: int, dtype, shards: int) -> tuple:
    """ak_curve_bound for the work of the sharded curve: u read once, the
    factors read and the (R,) float64 sums written once per shard, the
    shards' sums added (R adds per extra shard)."""
    item = torch.tensor([], dtype=dtype).element_size()
    return bound_ms(n * item + shards * nfac * (item + 8),
                    3.0 * n_valid * nfac + (shards - 1) * nfac, dtype)


def logical_meshes(dev):
    """(name, mesh) of the 1 x 2, 2 x 2 and 2 x 4 meshes of logical shards
    of ``dev``."""
    from oisat_tpu_torch.parallel.mesh import make_mesh

    return [(name, make_mesh(n, devices=[dev] * n)) for name, n in
            (("1x2", 2), ("2x2", 4), ("2x4", 8))]


def grid_shards(u2d, mesh) -> list:
    """The rows of a 2-D ``u`` split over the mesh's grid axis, each shard
    flattened on its device (a view when it is there already)."""
    from oisat_tpu_torch.parallel.mesh import split

    return [s.reshape(-1).contiguous() for s in split(u2d, mesh.axis_devices("grid"), 0)]


def compare_sharded(shards, regs, count, oi_scan, what: str):
    """The sharded kernel (one launch per shard, counted) against the sharded
    plain version (to FACTORS_RTOL), bitwise on repeat; returns (max_abs_err,
    kernel curve)."""
    before = oi_scan.ak_curve_sums_kernel.launches
    k = oi_scan.ak_curve_sums_sharded(shards, regs)
    launched = oi_scan.ak_curve_sums_kernel.launches - before
    check(launched == len(shards), f"{what}: {launched} launches for {len(shards)} shards")
    p = oi_scan.ak_curve_sums_sharded_plain(shards, regs)
    k2 = oi_scan.ak_curve_sums_sharded(shards, regs)
    torch.cuda.synchronize()
    check(torch.equal(k, k2), f"{what}: two sharded runs differ")
    kc = k.cpu().numpy() / count if count else np.full(regs.numel(), np.nan)
    pc = p.double().cpu().numpy() / count if count else np.full(regs.numel(), np.nan)
    check(np.array_equal(np.isnan(kc), np.isnan(pc)), f"{what}: NaN patterns differ")
    err = float(np.nanmax(np.abs(kc - pc))) if np.isfinite(kc).any() else 0.0
    if np.isfinite(kc).any():
        np.testing.assert_allclose(kc, pc, rtol=FACTORS_RTOL[regs.dtype], atol=0, err_msg=what)
    return err, kc


def phase_mesh_curve(dev, oi_scan, curve_inputs, kneedle_index_np, regs_np, meshes) -> dict:
    """Phase 14a: the sharded curve at 4,147,200 x 99 (phase 2's variances,
    1440 rows split over the grid axis) in float32 and float64 on each mesh:
    against the sharded plain version and the one-launch kernel (knee
    equal), one launch per grid shard, bitwise on repeat, CUDA-event times
    beside the one-launch kernel and the bound; then 3 rows over 4 grid
    shards (one empty) with an all-invalid row, and an all-invalid grid."""
    from oisat_tpu_torch.parallel.mesh import make_mesh

    n = HEADLINE[0] * HEADLINE[1]
    sa, so = variances(n, seed=0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        u2, valid = curve_inputs(torch.as_tensor(sa.reshape(HEADLINE), dtype=dtype, device=dev),
                                 torch.as_tensor(so.reshape(HEADLINE), dtype=dtype, device=dev))
        regs = torch.as_tensor(regs_np, dtype=dtype, device=dev)
        count = int(valid.sum())
        flat = u2.reshape(-1).contiguous()
        one = oi_scan.ak_curve_sums_kernel(flat, regs).cpu().numpy() / count
        one_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_kernel(flat, regs), reps=20)
        for name, mesh in meshes:
            shards = grid_shards(u2, mesh)
            what = f"14a {name} {dtype}"
            err, kc = compare_sharded(shards, regs, count, oi_scan, what)
            np.testing.assert_allclose(kc, one, rtol=FACTORS_RTOL[dtype], atol=0, err_msg=what)
            knees = {kneedle_index_np(regs_np, kc), kneedle_index_np(regs_np, one)}
            check(len(knees) == 1, f"{what}: knees {knees}")
            ms = cuda_ms(lambda: oi_scan.ak_curve_sums_sharded(shards, regs), reps=20)
            pms = cuda_ms(lambda: oi_scan.ak_curve_sums_sharded_plain(shards, regs), reps=3)
            b, by = sharded_curve_bound(count, n, regs.numel(), dtype, len(shards))
            out[(name, str(dtype))] = dict(err=err, ms=ms, plain_ms=pms, one_ms=one_ms,
                                           bound_ms=b, bound_by=by, shards=len(shards))
            log(f"{what}: {len(shards)} grid shards, max_abs_err {err:.3e}, knee "
                f"{knees.pop()}; sharded kernel {ms:.4f} ms, one-launch kernel {one_ms:.4f} ms, "
                f"sharded plain {pms:.4f} ms, bound {b:.4f} ms ({by}); nvidia-smi {smi_line()}")
    mesh = make_mesh(8, devices=[meshes[0][1].devices[0][0]] * 8)  # 2 x 4: 4 grid shards
    sa_e, so_e = variances(3 * 4099, seed=3, nan_frac=0.1)
    sa_e, so_e = sa_e.reshape(3, 4099), so_e.reshape(3, 4099)
    sa_e[1] = np.nan
    for name, sa_x in (("3 rows over 4 grid shards, row 1 all invalid", sa_e),
                       ("all invalid", np.full_like(sa_e, np.nan))):
        u2, valid = curve_inputs(torch.as_tensor(sa_x, device=dev), torch.as_tensor(so_e, device=dev))
        regs = torch.as_tensor(regs_np, device=dev)
        shards = grid_shards(u2, mesh)
        check(shards[-1].numel() == 0, "14a: the last grid shard should be empty")
        count = int(valid.sum())
        _, kc = compare_sharded(shards, regs, count, oi_scan, f"14a {name}")
        if count:
            one = oi_scan.ak_curve_sums_kernel(u2.reshape(-1).contiguous(), regs).cpu().numpy()
            np.testing.assert_allclose(kc, one / count, rtol=1e-12, atol=0, err_msg=name)
        else:
            check(np.isnan(kc).all(), "14a: an all-invalid grid must give a NaN curve")
        log(f"14a edge case {name}: sharded kernel == plain == one launch")
    return out


def phase_mesh_month(inputs, step, kw, step_ms, oi_scan, regs_np, mesh, what: str) -> dict:
    """Phase 14b: phase 4's stacked OMI month through ``make_full_month_step``
    on ``mesh`` against ``full_month_step``: the same reg_index, fields within
    rtol 1e-5 / atol 1e-6, one curve launch per grid shard, no copy of the
    inputs when the mesh is one card's logical shards, the peak memory and
    the CUDA-event time beside the step's; then the sharded curve against
    its plain version at the month's shape (the ``kernels`` line's
    numbers)."""
    from oisat_tpu_torch.ops.oi import curve_inputs
    from oisat_tpu_torch.parallel.analysis import full_month_step, make_full_month_step

    log(f"== phase {what}: phase 4's month through make_full_month_step")
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    full_month_step(inputs, curve_impl="kernel", **kw)
    torch.cuda.synchronize()
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    fn, shard = make_full_month_step(mesh, curve_impl="kernel", **kw)
    sharded = shard(inputs)
    one_card = len(set(mesh.flat_devices())) == 1
    if one_card:
        for row in sharded.blocks:
            for block in row:
                for part, whole in zip(block, inputs):
                    check(part.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr(),
                          f"{what}: shard_inputs copied a field")
    n_grid = mesh.shape["grid"]
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of phase 14: the month step over the mesh ----
    got = fn(sharded)
    torch.cuda.synchronize()
    launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == n_grid, f"{what}: {launches} curve launches for {n_grid} grid shards")
    check(int(got.oi.reg_index) == int(step.oi.reg_index),
          f"{what}: reg_index {int(got.oi.reg_index)} vs {int(step.oi.reg_index)}")
    for name in ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2", "scaling_factor"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(step, name).cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{what} {name}")
    for name in ("xb", "averaging_kernel", "increment", "error", "curve"):
        np.testing.assert_allclose(getattr(got.oi, name).cpu().numpy(),
                                   getattr(step.oi, name).cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{what} oi.{name}")
    ms = cuda_ms(lambda: fn(sharded), reps=3)
    # the sharded curve at the month's shape (the step's own sa / so)
    u, valid = curve_inputs((step.ctm_vcd * 50.0 / 100.0) ** 2, step.sat_error ** 2)
    regs = torch.as_tensor(regs_np, dtype=u.dtype, device=u.device)
    shards = grid_shards(u, mesh)
    count = int(valid.sum())
    err, _ = compare_sharded(shards, regs, count, oi_scan, f"{what} curve")
    k_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_sharded(shards, regs), reps=50)
    p_ms = cuda_ms(lambda: oi_scan.ak_curve_sums_sharded_plain(shards, regs), reps=10)
    b, by = sharded_curve_bound(count, u.numel(), regs.numel(), u.dtype, len(shards))
    log(f"{what}: {mesh.shape} over {len(set(mesh.flat_devices()))} card(s), "
        f"{'no copy of the inputs, ' if one_card else ''}{launches} curve launches, "
        f"reg_index {int(got.oi.reg_index)} as the unsharded step, fields within rtol 1e-5; "
        f"sharded step {ms:.2f} ms vs full_month_step {step_ms:.2f} ms (CUDA events); peak "
        f"device memory {peak_gb:.2f} GB sharded, {step_peak_gb:.2f} GB unsharded "
        f"({base_gb:.2f} GB held before both); nvidia-smi {smi_line()}")
    log(f"{what} curve at the month's shape ({u.numel()} cells x {regs.numel()}, {u.dtype}, "
        f"{len(shards)} grid shards): sharded kernel {k_ms:.4f} ms, sharded plain "
        f"{p_ms:.4f} ms, bound {b:.4f} ms ({by}), max_abs_err {err:.3e}")
    return dict(launches=launches, err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b, bound_by=by,
                step_ms=ms, unsharded_step_ms=step_ms, peak_gb=peak_gb,
                unsharded_peak_gb=step_peak_gb, cells=u.numel(),
                dtype=str(u.dtype).replace("torch.", ""), shards=len(shards))


def phase_mesh_mopitt(dev, oi_scan, month, grid, mesh) -> dict:
    """Phase 14c: phase 8's MOPITT granules through ``analyze_month_fused(
    mesh=)`` against the mesh-less fused month (the same factor, the nine
    fields within STAGED_RTOL / STAGED_ATOL; one curve launch per grid
    shard), then ``entry.dryrun_multichip(4)``: every maker on non-divisible
    shapes, a regrid and the matrix-free solve over 4 logical shards."""
    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.entry import dryrun_multichip

    log("== phase 14c: the MOPITT month and every maker over a 2 x 2 mesh of logical shards")
    reader = SimpleNamespace(ctm_data=[month["ctm"]], sat_data=month["grans"])
    ref = oisatgmi()
    ref.reader_obj = reader
    ref_out = ref.analyze_month_fused("MOPITT", "CO", *MONTH, error_ctm=50.0)
    meshed = oisatgmi()
    meshed.reader_obj = reader
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of phase 14: the fused month over the mesh ----
    t0 = time.perf_counter()
    out = meshed.analyze_month_fused("MOPITT", "CO", *MONTH, error_ctm=50.0, mesh=mesh)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the main path ----
    n_grid = mesh.shape["grid"]
    check(launches == n_grid, f"14c: {launches} curve launches for {n_grid} grid shards")
    check(int(out.oi.reg_index) == int(ref_out.oi.reg_index),
          f"14c: reg_index {int(out.oi.reg_index)} vs {int(ref_out.oi.reg_index)}")
    worst = assert_fused_equals_staged(meshed, ref, "14c MOPITT month over the mesh")
    check(implied_factor(meshed, "MOPITT", grid) == int(out.oi.reg_index),
          "14c: the fields do not carry the factor")
    log(f"14c MOPITT month, analyze_month_fused(mesh={mesh.shape}): {mesh_s:.3f} s, "
        f"{launches} curve launches, factor {grid[int(out.oi.reg_index)]:.1f} as without "
        f"the mesh, {len(DRIVER_FIELDS)} fields within rtol {STAGED_RTOL:g} (largest scaled "
        f"difference {worst:.2e})")
    oi_scan.ak_curve_sums_kernel.launches = 0
    # ---- the main path of phase 14: every maker through the entry point ----
    t0 = time.perf_counter()
    dryrun_multichip(4, device=dev)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry = oi_scan.ak_curve_sums_kernel.launches
    # ---- end of the main path ----
    check(dry == 4 * 2, f"14c: dryrun_multichip(4) launched the curve {dry} times, not 4 x 2")
    log(f"14c entry.dryrun_multichip(4) on logical shards of {dev}: {dry_s:.3f} s, "
        f"{dry} curve launches (4 makers x 2 grid shards)")
    return {"mopitt_fused_month_mesh": launches, "dryrun_multichip_4": dry}


def phase_mesh_sweep(dev, pv, jacobi, mesh) -> dict:
    """Phase 14d: ``_b_matmat`` over 4 logical shards at 13b's padded cells
    (11,264, K = 8): within 1e-5 of the largest |Y| of the unsharded sweep,
    bitwise on repeat, CUDA-event times of both; then 13c's Jacobi window
    through ``oi_full_matfree(mesh=)`` within atol 1e-4 of 13c's result."""
    from oisat_tpu_torch.ops.oi_full_matfree import _b_matmat, _unit_vectors, oi_full_matfree

    n = pv.xa.size
    u3 = _unit_vectors(pv.lat, pv.lon, dev)
    sbt = torch.as_tensor(pv.sb.astype(np.float32), device=dev)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32),
                        device=dev)
    ref = _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024)
    got = _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024, mesh)
    again = _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024, mesh)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "14d: two sharded sweeps differ")
    gap = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(gap <= 1e-5 * scale, f"14d: sharded sweep {gap:.3e} from the unsharded one "
          f"(max |Y| {scale:.3e})")
    ms = cuda_ms(lambda: _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024), reps=5)
    mesh_ms = cuda_ms(lambda: _b_matmat(u3, sbt, v, LENGTH_SCALE_KM, 1024, mesh), reps=5)
    log(f"14d _b_matmat N={n}, K=8 over {mesh.size} logical shards: max |diff| {gap:.3e} "
        f"({gap / scale:.2e} of max |Y|), bitwise on repeat; sharded {mesh_ms:.3f} ms vs "
        f"unsharded {ms:.3f} ms (CUDA events, warm); nvidia-smi {smi_line()}")
    args, want = jacobi
    t0 = time.perf_counter()
    res = oi_full_matfree(*args, LENGTH_SCALE_KM, precond="jacobi", probe_sep_factor=6.0,
                          cg_tol=1e-7, device=dev, mesh=mesh)
    jac_s = time.perf_counter() - t0
    for name, a, b in zip(("xb", "ak", "increment", "err"), res[:4], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=f"14d Jacobi {name}")
    log(f"14d Jacobi window over the mesh: {res[4]['cg_iters']} iterations, cg_resid "
        f"{res[4]['cg_resid']:.2e}, {jac_s:.3f} s; within atol 1e-4 of 13c's (largest "
        f"|diff| xb {np.max(np.abs(res[0] - want[0])):.2e})")
    return dict(cells=n, ms=ms, mesh_ms=mesh_ms, gap=gap)


def phase_mesh_regrid(dev, orbit, lon2d, lat2d, mesh) -> None:
    """Phase 14e: one OMI orbit regridded over the mesh (fine-grid rows over
    every position with the box filter's halo) against the single-device
    regrid: bitwise."""
    from oisat_tpu_torch.regridder import regrid_granule, regrid_mesh

    regrid_granule(1, 0.25, orbit, lon2d, lat2d, dev, flag_thresh=0.5)  # warm the plan caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = regrid_granule(1, 0.25, orbit, lon2d, lat2d, dev, flag_thresh=0.5)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with regrid_mesh(mesh):
        spmd = regrid_granule(1, 0.25, orbit, lon2d, lat2d, dev, flag_thresh=0.5)
    torch.cuda.synchronize()
    spmd_s = time.perf_counter() - t0
    for name in ("vcd", "amf", "uncertainty", "tropopause", "pressure_mid",
                 "scattering_weights"):
        a, b = getattr(spmd, name), getattr(base, name)
        check(torch.equal(torch.isnan(a), torch.isnan(b))
              and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)),
              f"14e: the sharded regrid's {name} is not the single-device one's")
    log(f"14e one OMI orbit regridded over {mesh.size} logical shards: bitwise the "
        f"single-device regrid (6 fields); {spmd_s:.3f} s vs {base_s:.3f} s (host clock, "
        "both with the plan caches warm)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if importlib.util.find_spec("oisat_tpu_torch") is None:
        print("chip_smoke: the port (oisat_tpu_torch) is not importable here: run it from "
              "the root of the repository", file=sys.stderr)
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
    from oisat_tpu_torch.parallel.mesh import make_mesh
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
    # phase 14b, while the month's inputs are on the card
    mesh2 = make_mesh(4, devices=[dev] * 4)  # 2 x 2 logical shards of the card
    mesh_month = phase_mesh_month(inputs, step, kw, step_ms, oi_scan, regs_np, mesh2, "14b")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        phase_mesh_month(inputs, step, kw, step_ms, oi_scan, regs_np,
                         make_mesh(min(4, n_cards)), "14f (real cards)")
    # the month's stacked inputs (~20 GB) go before the job runner repeats it
    del inputs, step, xa, u, valid
    torch.cuda.empty_cache()
    job_paths = {"job_omi_fused_month": phase_job_omi(dev, oi_scan, cov, obj, month_s,
                                                      reg_index, regs_np)}
    # the global month's granules are not needed again
    del grans, obj, ref
    torch.cuda.empty_cache()
    cov_times = phase_covariance(dev, cov)
    full = phase_full_month(dev, cov, oi_scan, native)
    mopitt, mopitt_launches, mopitt_shape, mopitt_job = phase_mopitt(dev, oi_scan, regs_np)
    by_path = {"omi_fused_month": launches, "mopitt_staged_and_fused": mopitt_launches}
    by_path.update(job_paths)
    # before phase 11 re-runs the OI of the staged session this is held to
    by_path["job_mopitt_staged"] = phase_job_mopitt(oi_scan, cov, mopitt, mopitt_job, regs_np)
    mesh_paths = {"omi_month_step_2x2": mesh_month["launches"]}
    mesh_paths.update(phase_mesh_mopitt(dev, oi_scan, mopitt_job, regs_np, mesh2))
    del mopitt_job
    mopitt_cells = phase_matfree_mopitt(dev, oi_scan, cov, mopitt, regs_np)
    by_path["desroziers_mopitt"], cov_desroziers = phase_desroziers(oi_scan, cov, mopitt,
                                                                    full["reader"])
    del mopitt
    torch.cuda.empty_cache()
    _, by_path["gosat_staged_and_fused"], gosat_shape, _ = phase_gosat(dev, oi_scan, regs_np)
    torch.cuda.empty_cache()
    _, by_path["ssmis_staged_and_fused"], ssmis_shape, _ = phase_ssmis(dev, oi_scan, regs_np)
    torch.cuda.empty_cache()
    by_path["job_omi_fallback_staged"], cov_job = phase_job_conus(dev, oi_scan, cov, full,
                                                                  regs_np)
    north_america_cells = phase_matfree_north_america(dev, oi_scan, cov)
    jacobi = phase_matfree_vs_dense(dev, full, regs_np)
    phase_sweep(dev, mopitt_cells)

    log("== phase 14 (a, d, e, f): the mesh path on logical shards of the card")
    t0 = time.perf_counter()
    headline = phase_mesh_curve(dev, oi_scan, curve_inputs, kneedle_index_np, regs_np,
                                logical_meshes(dev))
    phase_mesh_sweep(dev, north_america_cells, jacobi, mesh2)
    phase_mesh_regrid(dev, orbits[0], lon2d, lat2d, mesh2)
    if n_cards > 1:
        phase_mesh_curve(dev, oi_scan, curve_inputs, kneedle_index_np, regs_np,
                         [(f"{n} cards", make_mesh(n)) for n in (2, 4, 8) if n <= n_cards])
    else:
        log("14f: torch.cuda.device_count() is 1: the mesh ran as logical shards of one "
            "card only; no mesh over real cards, and no speed-up across cards, is measured")
    log(f"phase 14 (a, d, e, f) took {time.perf_counter() - t0:.1f} s")
    curve_entry["launches"] = sum(by_path.values())
    curve_entry["launches_by_path"] = by_path
    # the same kernel held against its plain version at the other months' shapes
    curve_entry["other_shapes"] = [mopitt_shape, gosat_shape, ssmis_shape]
    log(f"ak_curve launches on the driven paths: {by_path}")
    for n, (ms, pms, bms, by) in cov_times.items():
        log(f"covariance at n={n}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")

    log(f"ak_curve_sharded launches on the mesh paths: {mesh_paths}")
    sharded_entry = {
        "name": "ak_curve_sharded",
        "route": "cuda",
        "source": "oisat_tpu_torch/csrc/ak_curve.cu",
        "replaces": "oisat_tpu/ops/kernels/oi_scan.py:120",
        "launches": sum(mesh_paths.values()),
        "launches_by_path": mesh_paths,
        "max_abs_err": mesh_month["err"],
        "ms": mesh_month["ms"],
        "plain_ms": mesh_month["plain_ms"],
        "bound_ms": mesh_month["bound_ms"],
        "bound_by": mesh_month["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the curve sums
        "cells": mesh_month["cells"],
        "factors": int(regs_np.size),
        "dtype": mesh_month["dtype"],
        "grid_shards": mesh_month["shards"],
        "headline": {f"{name} {dt.replace('torch.', '')}": {
            k: v[k] for k in ("ms", "one_ms", "plain_ms", "bound_ms", "shards")}
            for (name, dt), v in headline.items()},
    }
    log(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": [curve_entry, {
        "name": "covariance",
        "route": "cuda",
        "source": "oisat_tpu_torch/csrc/covariance.cu",
        "replaces": "oisat_tpu/ops/kernels/covariance.py:32",
        "launches": full["launches"] + cov_desroziers + cov_job,
        "launches_by_path": {"omi_full_month": full["launches"],
                             "desroziers_full_month": cov_desroziers,
                             "job_omi_full_month": cov_job},
        "max_abs_err": full["err"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,  # no single PyTorch call builds B
        "cells": full["cells"],
        "dtype": "float32",
    }, sharded_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
