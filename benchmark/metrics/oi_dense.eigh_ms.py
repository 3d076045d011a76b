"""Milliseconds a month's dense full-OI scan spends in its one ``eigh`` of
``R^-1/2 B R^-1/2`` (with its eigenvectors), the session's
``stage_ms["oi_full.eigh"]``, averaged over the traced months that have
that stage.  None where none has."""


def read(ctx):
    vals = [m["stage_ms"]["oi_full.eigh"] for m in ctx.months
            if "oi_full.eigh" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
