"""Milliseconds of a month's full-covariance OI on the dense branch
(``driver._oi_full``'s ``oi_full`` call: compaction, the covariance, the
``eigh``, the 99-factor curve and its knee, the update, the pull, the
conditioning-gated float64 tail and the scatter-back), the session's
``stage_ms["oi_full"]``, averaged over the traced months whose OI ran the
dense scan (an ``oi_full.eigh`` stage).  None where no month did."""


def read(ctx):
    vals = [m["stage_ms"]["oi_full"] for m in ctx.months
            if "oi_full" in m["stage_ms"] and "oi_full.eigh" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
