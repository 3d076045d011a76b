"""Share of the H100's float64 tensor-core peak that the exact float64
branch's factor and posterior diagonal reach, in %:

    100 x (2 n^3 / 3 per month) / (factor + diagonal seconds per month) / 67e12

``n`` is the valid cells factored a month (the program's counter
``oi_full.exact_cells`` over the traced months, one solve a month), the
seconds are the session's ``stage_ms["oi_full.factor"]`` and
``stage_ms["oi_full.diag"]``, and 67 TFLOP/s is the H100 SXM's FP64
tensor-core peak.  The count is fixed work, whatever implements it: n^3/3
for the Cholesky factor and n^3/3 for the trailing triangular solves of
diag(A^-1).  None where the program has no such counter or stages."""

from benchmark.program_trace import counter

PEAK_FLOPS = 67e12  # H100 SXM, FP64 tensor cores


def read(ctx):
    cells = counter(ctx, "oi_full.exact_cells")
    secs = [1e-3 * (m["stage_ms"]["oi_full.factor"] + m["stage_ms"]["oi_full.diag"])
            for m in ctx.months
            if "oi_full.factor" in m["stage_ms"] and "oi_full.diag" in m["stage_ms"]]
    if not cells or not secs or len(secs) != len(ctx.months):
        return None
    n = cells / len(ctx.months)
    return 100.0 * len(secs) * (2.0 * n ** 3 / 3.0) / sum(secs) / PEAK_FLOPS
