"""Share of its roofline that the dense full-OI scan's float64 correlation
kernel reaches, in %: ``csrc/covariance.cu``'s ``symmetric_upper<Whitened>``
(the C entry ``correlation_f64``), which builds C = D^-1 B D^-1 once a
month on the card:

    100 x (least seconds of its launches) / (their seconds in the device trace)

A launch at n cells takes at least the larger of :func:`launch_bytes` over
3.35 TB/s and :func:`launch_flops` over 34 TFLOP/s (the H100 SXM's HBM rate
and float64 peak outside the tensor cores, NVIDIA's data sheet).  n is the
program's counter ``oi_full.dense_cells`` over the traced window divided by
the kernel's launches in it (one a dense scan; the mean n stands for each,
which puts the bytes of months whose n differ by a few % low by less than
0.1%).  None where the trace holds no launch of the kernel (a program
without it) or the program no such counter."""

from benchmark.program_trace import counter

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores


def launch_bytes(n: float) -> float:
    """C (n, n) float64 written once; the unit vectors (n, 3) and s (n,)
    read once."""
    return 8.0 * n * n + 32.0 * n


def launch_flops(n: float) -> float:
    """12 float64 operations for each of the n (n + 1) / 2 distinct
    elements: a product and two FMAs (5), the clip, a subtraction, the
    product by kappa, the floor, exp (counted once) and two products."""
    return 12.0 * n * (n + 1) / 2.0


def _ours(name: str) -> bool:
    return "symmetric_upper" in name and "Whitened" in name


def read(ctx):
    if ctx.trace is None:
        return None
    times = [e - s for name, s, e in ctx.trace.ops if _ours(name)]
    cells = counter(ctx, "oi_full.dense_cells")
    if not times or not cells:
        return None
    n = cells / len(times)
    least = max(launch_bytes(n) / PEAK_BYTES_S, launch_flops(n) / PEAK_FLOPS)
    return 100.0 * len(times) * least / sum(times)
