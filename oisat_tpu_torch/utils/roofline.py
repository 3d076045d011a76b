"""The card's ceilings, the bounds computed from them, and the timers.

One copy of what ``chip_smoke.py`` and :mod:`oisat_tpu_torch.bench` time and
compare with:

* the published peaks of one NVIDIA H100 SXM at its 700 W power limit
  (NVIDIA's data sheet): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
  tensor cores, 34 TFLOP/s float64, 989 TFLOP/s dense bf16 on the tensor
  cores.  A card set below 700 W runs slower
  under load, so every time is printed beside ``nvidia-smi``'s name and
  power limit (:func:`smi_line`);
* :func:`bound_ms`: the least time for a function, the larger of its bytes
  over the HBM rate and its operations over the peak of its type, and the
  bounds of the two kernels (:func:`ak_curve_bound`,
  :func:`covariance_bound`, :func:`b_matmat_bound`,
  :func:`division_floor_ms`);
* the timers: :func:`cuda_ms` (CUDA events around a run of launches, the
  mean), :func:`median_ms` (several such estimates: median, min, max) and
  :func:`host_s` (the host clock around work that ends in a device
  synchronise).  On a CPU device the two device timers fall back to the host
  clock and say so in ``"timer"``: a CPU number is never a device number.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

__all__ = ["PEAK_BYTES_S", "PEAK_FLOPS", "PEAK_TENSOR_BF16_FLOPS", "COV_OPS_PER_ELEMENT",
           "SWEEP_OPS_PER_ELEMENT", "BF16_PRODUCTS_PER_F32_PRODUCT", "MUFU_PER_SM_CLOCK",
           "cuda_ms", "median_ms", "host_s", "spread", "bound_ms", "ak_curve_bound",
           "covariance_bound", "b_matmat_bound", "division_floor_ms", "smi_query", "smi_line"]

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FLOP/s outside the
# tensor cores; the card's power limit is printed beside every time
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_TENSOR_BF16_FLOPS = 989e12  # dense, the tensor cores
COV_OPS_PER_ELEMENT = 19  # covariance.cu: 2 sub, 1 add, 9 mul, 1 div, 1 neg,
# 2 compares (the clip), 2 sin, 1 exp -- each sin / exp counted once
SWEEP_OPS_PER_ELEMENT = 10  # b_matmat.cu: 3 sub, 3 mul, 2 add, 1 scale, 1 exp
# the card's fastest float32-accurate product: six bf16 products of the
# three-piece split (the same rate as 3xTF32's three at 495 TFLOP/s)
BF16_PRODUCTS_PER_F32_PRODUCT = 6
MUFU_PER_SM_CLOCK = 16  # Hopper's special-function unit: reciprocals per SM per clock
MIN_REPEATS = 5


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


def spread(values: list, timer: str) -> dict:
    """Median, min, max, count and the values themselves, with the timer's name."""
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "repeats": len(values), "values": values, "timer": timer}


def median_ms(fn, reps: int, repeats: int = MIN_REPEATS, device="cuda") -> dict:
    """``repeats`` estimates of ``fn``'s milliseconds, each the mean over
    ``reps`` launches between CUDA events (:func:`cuda_ms`, one warm-up
    launch before the first): ``{"median", "min", "max", "repeats",
    "values", "timer"}``.  On a CPU ``device`` each estimate is the host
    clock around the ``reps`` calls (``"timer": "host_clock"``)."""
    if torch.device(device).type == "cuda":
        values = [cuda_ms(fn, reps, warmup=1 if k == 0 else 0) for k in range(repeats)]
        return spread(values, "cuda_events")
    fn()
    values = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        values.append((time.perf_counter() - t0) / reps * 1e3)
    return spread(values, "host_clock")


def host_s(fn, repeats: int = MIN_REPEATS, device="cuda") -> dict:
    """``repeats`` host-clock seconds of ``fn()``, each closed by a device
    synchronise on a CUDA ``device`` (so the device's work is inside it):
    ``{"median", "min", "max", "repeats", "values", "timer"}``."""
    cuda = torch.device(device).type == "cuda"
    values = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        values.append(time.perf_counter() - t0)
    return spread(values, "host_clock")


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


def b_matmat_bound(n: int, k: int) -> tuple:
    """One B.V sweep of ``_b_matmat`` at N = ``n``, K = ``k``, the same work
    whatever computes it: u3 (N, 3), sigma_b (N,) and V (N, K) read once,
    Y (N, K) written once, all float32; the operations are the build of C,
    ``SWEEP_OPS_PER_ELEMENT`` for each of its N^2 elements at the float32
    peak, plus the float32-accurate contraction's N^2 K products at the
    card's fastest float32-accurate rate, ``BF16_PRODUCTS_PER_F32_PRODUCT``
    bf16 products each at ``PEAK_TENSOR_BF16_FLOPS``: 0.67 ms at N = 64,512,
    K = 1, and 104 ms at K = 2,048."""
    t_bytes = 4 * (3 * n + n + 2 * n * k) / PEAK_BYTES_S * 1e3
    t_ops = (SWEEP_OPS_PER_ELEMENT * n * n / PEAK_FLOPS[torch.float32]
             + BF16_PRODUCTS_PER_F32_PRODUCT * 2.0 * n * n * k / PEAK_TENSOR_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
