"""Host milliseconds a month spends making the CTM fields of the assembly
(the program's span ``assemble.ctm_fields``: slicing, the time-collapse and
the float64 air and partial columns), summed a month and averaged over the
traced months."""

from benchmark.program_trace import span_seconds


def read(ctx):
    total = span_seconds(ctx, "assemble.ctm_fields")
    return 1e3 * total / len(ctx.months) if total is not None and ctx.months else None
