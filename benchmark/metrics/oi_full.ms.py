"""Milliseconds of a month's full-covariance OI (``driver._oi_full``'s
``oi_full`` call: compaction, the knee, the solve, the posterior diagonal
and the scatter-back), the session's ``stage_ms["oi_full"]``, averaged over
the traced months."""


def read(ctx):
    vals = [m["stage_ms"]["oi_full"] for m in ctx.months if "oi_full" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
