"""Share of the traced window in which no operation ran on the device:
100 x (1 - the union of the trace's kernel, copy and set intervals over the
window).  Nothing when the trace holds no device activity."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_seconds()
    lo, hi = ctx.trace.window
    if busy <= 0 or hi <= lo:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
