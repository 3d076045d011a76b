"""Milliseconds of the driver's host assembly of a month
(``driver._fused_inputs``: CTM matching, slicing and time-collapse, H2D),
the session's ``stage_ms["assemble"]``, averaged over the traced months."""


def read(ctx):
    vals = [m["stage_ms"]["assemble"] for m in ctx.months if "assemble" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
