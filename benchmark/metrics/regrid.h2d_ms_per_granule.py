"""Host milliseconds of a regrid's copy of its value batch and error row to
the device (the program's span ``regrid.h2d``), over the traced window's
granules (its ``regrid`` spans)."""

from benchmark.program_trace import span_count, span_seconds


def read(ctx):
    total, n = span_seconds(ctx, "regrid.h2d"), span_count(ctx, "regrid")
    return 1e3 * total / n if total is not None and n else None
