"""Milliseconds of the month step on the device (observation operator,
averaging, bias, and on scalar months the OI), the session's
``stage_ms["step"]``, averaged over the traced months."""


def read(ctx):
    vals = [m["stage_ms"]["step"] for m in ctx.months if "step" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
