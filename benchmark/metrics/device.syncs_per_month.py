"""Times a month makes the host wait on the device (the program's counter
``syncs``: blocking copies either way and host reads of device values, the
measurement's own synchronises aside), averaged over the traced months."""

from benchmark.program_trace import counter


def read(ctx):
    total = counter(ctx, "syncs")
    return total / len(ctx.months) if total is not None and ctx.months else None
