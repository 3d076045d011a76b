"""Host milliseconds of a regrid's plan phase (the program's span
``regrid.plan``: geometry keys, cache lookups, the builds on a miss and the
plans' copies to the device), over the traced window's granules (its
``regrid`` spans)."""

from benchmark.program_trace import span_count, span_seconds


def read(ctx):
    total, n = span_seconds(ctx, "regrid.plan"), span_count(ctx, "regrid")
    return 1e3 * total / n if total is not None and n else None
