"""The traced run's window: host spans, the device trace, and what both give.

The benchmark keeps its own ``torch.profiler`` window (CUPTI) over the
measured months of a ``--trace 1`` run.  From it come the device's busy
intervals (every kernel, copy and set), the kernels' time by name, and the
idle gaps between busy intervals, each labelled by the host span that was
open at its midpoint.  Host spans are the benchmark's own (one per regrid
call) and the driver's stages, laid end to end from each analysis' start in
the order the session recorded them.  Host spans are taken with
``time.perf_counter``; two ``record_function`` anchors tie that clock to the
trace's.

The arithmetic (:func:`union_seconds`, :func:`idle_gaps`, :func:`label_of`)
takes plain (start, end) second pairs, so it is tested on the CPU with
hand-made intervals.
"""

from __future__ import annotations

import time
from collections import defaultdict

__all__ = ["Span", "union_seconds", "idle_gaps", "label_of", "stage_spans", "DeviceTrace",
           "Window"]

# the marks the driver's StageClock writes, in the order a month runs them;
# names with a dot are sub-stages inside one of these
ANCHOR = "benchmark.anchor"


class Span:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end

    def __repr__(self):
        return f"Span({self.name!r}, {self.start:.6f}, {self.end:.6f})"


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_of(t: float, spans) -> str:
    """The name of the innermost (latest-starting) span open at ``t``, or
    "other"."""
    best = None
    for sp in spans:
        if sp.start <= t < sp.end and (best is None or sp.start >= best.start):
            best = sp
    return best.name if best is not None else "other"


def stage_spans(start: float, stage_ms: dict):
    """The driver's top-level stages of one analysis as host spans laid end
    to end from ``start``, in the order the session recorded them (a
    StageClock mark closes the stage opened by the one before); dotted
    sub-stages are left out."""
    out, t = [], start
    for name, ms in stage_ms.items():
        if "." in name:
            continue
        out.append(Span(name, t, t + ms / 1e3))
        t += ms / 1e3
    return out


class DeviceTrace:
    """Device intervals of a profiler run, in host perf_counter seconds."""

    def __init__(self, ops, window):
        self.ops = ops  # [(name, start, end)]
        self.window = window  # (start, end)

    def busy_seconds(self) -> float:
        lo, hi = self.window
        return union_seconds((max(s, lo), min(e, hi)) for _, s, e in self.ops)

    def seconds_by_name(self) -> dict:
        out = defaultdict(float)
        for name, s, e in self.ops:
            out[name] += e - s
        return dict(out)

    def gaps(self):
        return idle_gaps([(s, e) for _, s, e in self.ops], *self.window)


def _kineto_ops(prof):
    """(name, start_ns, end_ns, is_anchor) of the device activities and the
    anchors in a finished profiler."""
    ops, anchors = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
        dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
        if name == ANCHOR:
            anchors.append(start)
        elif str(ev.device_type()).endswith("CUDA"):
            ops.append((name, start, start + dur))
    return ops, anchors


class Window:
    """A profiler window with two anchors that tie its clock to
    ``time.perf_counter``.  ``with Window(): ...``; then :meth:`trace`."""

    def __init__(self):
        self._prof = None
        self._marks = []

    def _anchor(self):
        from torch.profiler import record_function

        with record_function(ANCHOR):
            self._marks.append(time.perf_counter())

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._anchor()
        return self

    def close(self):
        self._anchor()
        self._prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        if self._prof is not None and len(self._marks) < 2:
            self.close()
        return False

    def trace(self) -> DeviceTrace:
        """The device activities between the two anchors, in perf_counter
        seconds (offset and rate fitted on the two anchors)."""
        ops, anchors = _kineto_ops(self._prof)
        if len(anchors) < 2:
            raise RuntimeError("the profiler recorded no anchors: no trace to read")
        a0, a1 = min(anchors), max(anchors)
        h0, h1 = self._marks[0], self._marks[-1]
        rate = (h1 - h0) / ((a1 - a0) * 1e-9) if a1 > a0 else 1.0

        def host(ns):
            return h0 + (ns - a0) * 1e-9 * rate

        return DeviceTrace([(n, host(s), host(e)) for n, s, e in ops], (h0, h1))
