"""GB (1e9 bytes) copied host to device a month: the program's counter
``h2d.bytes`` over the traced window, averaged over its months."""

from benchmark.program_trace import counter


def read(ctx):
    total = counter(ctx, "h2d.bytes")
    return total / 1e9 / len(ctx.months) if total is not None and ctx.months else None
