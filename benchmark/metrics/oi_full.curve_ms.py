"""Milliseconds a month spends on the exact float64 branch's curve: the
N x N correlation built on the device, the float64 SLQ mean-AK curve on it
and the knee, the session's ``stage_ms["oi_full.curve"]``, averaged over
the traced months.  None where the program has no such stage."""


def read(ctx):
    vals = [m["stage_ms"]["oi_full.curve"] for m in ctx.months
            if "oi_full.curve" in m["stage_ms"]]
    return sum(vals) / len(vals) if vals else None
