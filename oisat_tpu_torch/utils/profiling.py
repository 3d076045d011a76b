"""The port's one tracing module: stage sums, spans, counters, the stage
clock and a device trace window (twin of :mod:`oisat_tpu.utils.profiling`,
which has the stage sums only).

One registry holds four kinds of record:

- :func:`stage`: wall seconds summed per name over the process, always on;
  :func:`report` prints them (the campaign runner's report).
- :func:`span` and :func:`count`: off by default.  Tracing is on after
  ``enable(True)`` and while a ``torch.profiler`` window is open.  Then a
  span records ``(name, start_s, end_s)`` on ``time.perf_counter`` and a
  counter adds up; :func:`take` returns and clears both.  Enabled tracing
  also makes each span a ``record_function`` range in an open profiler
  window, so it lands on the device trace's clock (:func:`device_trace`
  enables it for its window).  A window that tracing was not enabled for
  gets the spans and counters in the registry only, and its trace holds
  what it would hold without them: the profiler draws each range on the
  device's timeline too, where it would read as device time.  Off,
  :func:`span` returns one shared no-op context manager and :func:`count`
  returns at once: nothing allocates.  A span never synchronises: it times
  the host, which is what an idle gap on the device is put down to.
- :class:`StageClock`: the milliseconds of one call's consecutive stages
  (the ``stage_ms`` of an ``oisatgmi`` call), synchronised at each mark; with tracing on
  each mark also records its stage as a span.

The month path's spans: ``regrid`` (one granule) with ``regrid.plan``,
``regrid.h2d``, ``regrid.stack``, ``regrid.apply`` and
``regrid.domain_check``; ``assemble.ctm_fields``, ``assemble.h2d``,
``assemble.map`` and ``assemble.stack`` inside the fused month's ``assemble``
stage; ``oi.scalar`` (the scalar OI: the curve, its pull, the knee) inside
``step``; the fused month's stages, and the full OI's ``oi_full.*`` stages
(on its exact float64 branch ``oi_full.curve``, ``oi_full.factor``,
``oi_full.solve``, ``oi_full.diag``).  Its counters:
``h2d.bytes`` (every host->device copy, :func:`oisat_tpu_torch._device.to_device`),
``syncs`` (each time the host waits on the device, measurement's own
synchronises aside), ``regrid.plan_builds_device`` /
``regrid.plan_builds_host`` (each regrid plan built on a cache miss, by the
card's kernel or on the host), ``regrid.batches_device`` (each granule whose
value batch was built on its device from the raw fields),
``assemble.slices_device`` (each matched CTM
slice whose operator fields were derived on the device),
``oi_full.exact_cells`` /
``oi_full.exact_bytes`` (the cells the full OI's exact float64 branch
factors, and its N x N buffer's bytes), and ``oi_full.dense_cells`` /
``oi_full.dense_tails`` (the valid cells of each full OI on the dense
branch, whose stages are ``oi_full.covariance``, ``.eigh``,
``.scan_gemms``, ``.knee``, ``.update``, ``.pull``, ``.tail`` and
``.tail_resid``; and 1 for each such call whose conditioning-gated float64
tail ran).

Usage::

    from oisat_tpu_torch.utils import profiling

    with profiling.stage("regrid", granule=fname):
        ...
    print(profiling.report())           # JSON summary per stage
    profiling.enable(True)
    run_month(...)
    spans, counters = profiling.take()
    with profiling.device_trace("trace_dir"):   # host, card and spans
        run_month(...)
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _torch_profiler

__all__ = ["stage", "report", "reset", "device_trace", "log", "enable", "enabled", "span",
           "count", "take", "StageClock"]

_lock = threading.Lock()
_stats = defaultdict(lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0})
_spans: list = []
_counters: dict = defaultdict(int)
_on = False
_NOOP = contextlib.nullcontext()


def log(msg: str, **fields):
    """One structured log line (stdout, JSON when fields present)."""
    if fields:
        print(msg + " " + json.dumps(fields, default=str))
    else:
        print(msg)


def enable(on: bool) -> None:
    """Turn the spans and counters, and the spans' profiler ranges, on or
    off for the process (an open profiler window records the spans and
    counters whatever this says)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on or _torch_profiler._is_profiler_enabled


def _record(name: str, start: float, end: float) -> None:
    with _lock:
        _spans.append((name, start, end))


class _Span:
    __slots__ = ("name", "start", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _on and _torch_profiler._is_profiler_enabled:
            self.range = _torch_profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _record(self.name, self.start, end)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` when
    tracing is on; the shared no-op otherwise."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when tracing is on."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] += n


def take():
    """(spans, counters) recorded since the last call, and clear them:
    spans as ``(name, start_s, end_s)`` on ``time.perf_counter`` in the
    order they ended, counters as {name: total}."""
    with _lock:
        spans, counters = list(_spans), dict(_counters)
        _spans.clear()
        _counters.clear()
    return spans, counters


@contextlib.contextmanager
def stage(name: str, sync=None, **fields):
    """Time a pipeline stage into the process's sums (and, with tracing on,
    as the span ``name``).  ``sync``: a CUDA device (or a tensor on one) to
    synchronise before stopping the clock, since device work is
    asynchronous; a CPU device or tensor needs none."""
    with span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
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
    """Clear the stage sums, the spans and the counters."""
    with _lock:
        _stats.clear()
        _spans.clear()
        _counters.clear()


class StageClock:
    """Milliseconds of consecutive stages of one call, summed into
    ``out[prefix + name]``.  Each :meth:`mark` closes the stage that began at
    the previous mark (or at construction) once the device has finished its
    work (``torch.cuda.synchronize`` on a CUDA device), so device and host
    stages add up to the call's wall time.  With tracing on, each mark also
    records its stage as the span ``prefix + name``.

    With ``out`` None a mark synchronises nothing and adds nothing: an
    untimed call pays a flag check (and, tracing, the span)."""

    def __init__(self, out: dict | None, device, prefix: str = ""):
        self.out = out
        self.device = torch.device(device)
        self.prefix = prefix
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        tracing = enabled()
        if self.out is None and not tracing:
            return
        if self.out is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        key = self.prefix + name
        if self.out is not None:
            self.out[key] = self.out.get(key, 0.0) + (now - self.t) * 1e3
        if tracing:
            _record(key, self.t, now)
        self.t = now


@contextlib.contextmanager
def device_trace(logdir: str):
    """Wrap a block in a ``torch.profiler`` window (host activity, and the
    card's when there is one); the chrome trace, with the program's spans
    beside the device's operations, lands in ``logdir/trace.json`` (view in
    Perfetto / chrome://tracing).  Yields the profiler, whose
    ``key_averages()`` can be read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was_on)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
