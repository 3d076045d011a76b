"""Structured per-stage timing + optional device tracing (twin of
:mod:`oisat_tpu.utils.profiling`).

Every pipeline stage of a job is timed through one registry that can emit a
JSON report, and a whole run can be wrapped in a ``torch.profiler`` window.

Usage::

    from oisat_tpu_torch.utils.profiling import stage, report, device_trace

    with stage("regrid", granule=fname):
        ...
    print(report())                     # JSON summary per stage
    with device_trace("/tmp/trace"):    # chrome trace of the host and the card
        run_month(...)

The stage times of one driver call (``stage_ms``) come from
:class:`oisat_tpu_torch.utils.stages.StageClock`; this registry sums over a
process.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

__all__ = ["stage", "report", "reset", "device_trace", "log"]

_lock = threading.Lock()
_stats = defaultdict(lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0})


def log(msg: str, **fields):
    """One structured log line (stdout, JSON when fields present)."""
    if fields:
        print(msg + " " + json.dumps(fields, default=str))
    else:
        print(msg)


@contextlib.contextmanager
def stage(name: str, sync=None, **fields):
    """Time a pipeline stage.  ``sync``: a CUDA device (or a tensor on one)
    to synchronise before stopping the clock, since device work is
    asynchronous; a CPU device or tensor needs none."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            import torch

            dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s["count"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)


def report() -> str:
    """JSON report of all recorded stages (sorted by total time)."""
    with _lock:
        items = sorted(_stats.items(), key=lambda kv: -kv[1]["total_s"])
        return json.dumps(
            {k: {**v, "total_s": round(v["total_s"], 4), "max_s": round(v["max_s"], 4)}
             for k, v in items}, indent=2)


def reset():
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Wrap a block in a ``torch.profiler`` window (host activity, and the
    card's when there is one); the chrome trace lands in
    ``logdir/trace.json`` (view in Perfetto / chrome://tracing).  Yields the
    profiler, whose ``key_averages()`` can be read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
