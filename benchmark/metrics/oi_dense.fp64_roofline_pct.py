"""Share of the H100's float64 tensor-core peak that the dense scan's
``eigh`` reaches, in %:

    100 x (10 n^3 / 3 per month) / (eigh seconds per month) / 67e12

``n`` is the valid cells of a month's dense branch (the program's counter
``oi_full.dense_cells`` over the traced months, divided by the months whose
OI ran the dense scan, one call each), the seconds the session's
``stage_ms["oi_full.eigh"]``, and 67 TFLOP/s the H100 SXM's FP64
tensor-core peak.  The count, :func:`eigh_flops`, is LAPACK's for a
symmetric eigendecomposition with its vectors, fixed work whatever
implements it.  None where the program has no such counter or stage."""

from benchmark.program_trace import counter

PEAK_FLOPS = 67e12  # H100 SXM, FP64 tensor cores


def eigh_flops(n: float) -> float:
    """4 n^3 / 3 for the reduction to tridiagonal form plus 2 n^3 for the
    back-transformation of the eigenvectors."""
    return 4.0 * n ** 3 / 3.0 + 2.0 * n ** 3


def read(ctx):
    cells = counter(ctx, "oi_full.dense_cells")
    secs = [1e-3 * m["stage_ms"]["oi_full.eigh"] for m in ctx.months
            if "oi_full.eigh" in m["stage_ms"]]
    if not cells or not secs:
        return None
    n = cells / len(secs)
    return 100.0 * len(secs) * eigh_flops(n) / sum(secs) / PEAK_FLOPS
