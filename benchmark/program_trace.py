"""The port's own spans and counters over a traced window, for the
per-layer metric readers.

The port's tracing module (``oisat_tpu_torch.utils.profiling``) records its
spans and counters while a ``torch.profiler`` window is open, which the
harness opens around the measured months of a ``--trace 1`` run.
:func:`recorded` takes them from the port's registry once, after the window
has closed, and keeps them on the readers' context as ``ctx.program``:
``{"spans": [(name, start_s, end_s)], "counters": {name: total}}`` over
every traced month.  It imports nothing of the program: it reads the
registry of the program this process loaded, and gives None where that
program has none (one older than its spans), so every reader of it returns
None there.

Span names: ``regrid`` (one granule) and its ``regrid.plan``,
``regrid.stack``, ``regrid.h2d``, ``regrid.apply``, ``regrid.domain_check``;
the fused month's stages (``assemble``, ``step``, ``pull``) and the assembly's
``assemble.ctm_fields``, ``assemble.h2d``, ``assemble.map``,
``assemble.stack``.  Counters: ``h2d.bytes``, ``syncs``.
"""

from __future__ import annotations

import sys

__all__ = ["PROFILING", "recorded", "span_seconds", "span_count", "counter"]

PROFILING = "oisat_tpu_torch.utils.profiling"


def recorded(ctx):
    """The program's spans and counters of the traced window, or None."""
    if not hasattr(ctx, "program"):
        take = getattr(sys.modules.get(PROFILING), "take", None)
        spans, counters = take() if take is not None else ([], {})
        ctx.program = {"spans": spans, "counters": counters} if spans or counters else None
    return ctx.program


def span_seconds(ctx, name: str):
    """Seconds of every span ``name`` in the window, or None without one."""
    rec = recorded(ctx)
    times = [e - s for n, s, e in rec["spans"] if n == name] if rec else []
    return sum(times) if times else None


def span_count(ctx, name: str) -> int:
    rec = recorded(ctx)
    return sum(1 for n, _, _ in rec["spans"] if n == name) if rec else 0


def counter(ctx, name: str):
    """The counter ``name`` summed over the window, or None without it."""
    rec = recorded(ctx)
    return rec["counters"].get(name) if rec else None
