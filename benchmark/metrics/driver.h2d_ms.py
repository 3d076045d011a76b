"""Host milliseconds a month spends copying the assembly's CTM slices to
the device (the program's span ``assemble.h2d``, the float64 concatenate
before an upscaled copy included), summed a month and averaged over the
traced months."""

from benchmark.program_trace import span_seconds


def read(ctx):
    total = span_seconds(ctx, "assemble.h2d")
    return 1e3 * total / len(ctx.months) if total is not None and ctx.months else None
