"""One run of one cell: inputs from the seed, a warm-up month, the measured
window of back-to-back months, the traced readings, then the check.

:func:`measure` does everything but the printing and is what ``run.py``
calls on the card; the CPU rehearsal (``tests/test_harness_rehearsal.py``)
calls it with ``device="cpu"`` at a tiny size, where it refuses to write a
device metric.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np

from benchmark import generators
from benchmark.spec import metric_reader
from benchmark.tracing import Span, Window, label_of, stage_spans

__all__ = ["FORBIDDEN_MODULES", "process_age_s", "forbidden_loaded", "host_state", "measure",
           "Context"]

# top-level module names that may not be loaded in the process that prints a
# result: the JAX package the port was made from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "oisat_tpu")
_IMPORTED_AT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(after[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return time.perf_counter() - _IMPORTED_AT


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole: ``oisat_tpu_torch`` is not
    ``oisat_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def host_state() -> str:
    """One line on the host's CPUs as this process sees them: the cores it
    may run on, the load average, and the spread of the cores' clocks."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count()
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except OSError:
        mhz = []
    clock = (f"MHz min {min(mhz):.0f} median {sorted(mhz)[len(mhz) // 2]:.0f} "
             f"max {max(mhz):.0f} over {len(mhz)} cpus" if mhz else "MHz unknown")
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"host: {cores} usable cores of {os.cpu_count()}, load {load}, {clock}"


class Context:
    """What the per-layer metric readers read: the traced months (their
    regrid spans, stage milliseconds and solver diagnostics), the device
    trace and the window's peak device memory."""

    def __init__(self, months, trace, peak_bytes):
        self.months = months
        self.trace = trace
        self.peak_bytes = peak_bytes


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _breakdown(trace, host_spans) -> dict:
    """The ten device operations that took most time, and the idle seconds
    summed by the host span open at each gap's midpoint (the ten largest)."""
    ops = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
    idle: dict = {}
    for s, e in trace.gaps():
        name = label_of(0.5 * (s + e), host_spans)
        idle[name] = idle.get(name, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda", check=None) -> dict:
    """Run ``cell`` once: returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and ``checks``).  ``check(cell, seed, raw, ctm_raw,
    month, device)`` judges the window's last month and returns
    {name: (value, limit)}; None leaves ``correct`` false.  Device metrics
    are measured only on a CUDA ``device``: elsewhere this raises before it
    would write one."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from benchmark import program

    config, mix = cell.config, cell.mix
    raw, ctm_raw, lon2d, lat2d = generators.make_month(config, seed)
    ctm = program.to_ctm(ctm_raw)
    ctrl = program.control_dict(config, mix, dev)
    moving = bool(config["granules"].get("moving_geometry"))
    offsets = (generators.month_offsets(mix, seed, 4096) if moving
               else np.zeros((4096, 2)))

    def month_granules(k):
        return [generators.offset_granule(g, offsets[k]) for g in raw]

    # set-up: one untimed month warms every shape the window uses
    warm = program.run_month(month_granules(0), ctm, lon2d, lat2d, config, ctrl, dev)
    _sync(dev)
    del warm
    gc.collect()
    if not cuda:
        raise RuntimeError(f"no CUDA device ({dev}): the measurement path runs on the card "
                           "only and writes no metric from another device")
    setup_s = process_age_s()

    print(host_state() + " (window opens)", file=sys.stderr)
    torch.cuda.reset_peak_memory_stats()
    months, host_spans = [], []
    window = Window() if trace else None
    last = last_k = None
    if window is not None:
        window.__enter__()  # the profiler's start-up stays outside the window
    t0 = time.perf_counter()
    k = 1
    try:
        while True:
            grans = month_granules(k)
            spans = [] if trace else None
            stage_ms = {} if trace else None
            last = None  # free the previous month before the next one runs
            t_a = time.perf_counter()
            last = program.run_month(grans, ctm, lon2d, lat2d, config, ctrl, dev,
                                     spans=spans, stage_ms=stage_ms)
            last_k = k
            if trace:
                host_spans += [Span("regrid", s, e) for s, e in spans]
                host_spans += stage_spans(spans[-1][1] if spans else t_a, stage_ms)
                months.append({"regrid_spans": spans, "stage_ms": stage_ms,
                               "diag": last.diagnostics()})
                stages = " ".join(f"{n} {v:.1f}" for n, v in stage_ms.items())
                print(f"month {k}: regrid {1e3 * sum(e - s for s, e in spans):.1f} ms, "
                      f"stages ms: {stages}", file=sys.stderr)
            else:
                months.append(time.perf_counter() - t_a)
                # the regrid loop's host seconds, unsynchronised: the rest of
                # the month is the analysis
                print(f"month {k}: {months[-1]:.3f} s, regrid loop {last.regrid_s:.3f} s",
                      file=sys.stderr)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    finally:
        if window is not None:
            window.close()
    peak = int(torch.cuda.max_memory_allocated())
    print(host_state() + " (window closed)", file=sys.stderr)
    n_months = len(months)
    result = {"attempted": n_months, "failed": 0, "metrics": {},
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": 1, "memory_peak_bytes": peak}}
    if trace:
        dtrace = window.trace()
        ctx = Context(months, dtrace, peak)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        lo, hi = dtrace.window
        result["device"]["busy_s"] = dtrace.busy_seconds()
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = _breakdown(dtrace, host_spans)
    else:
        print("month seconds: " + " ".join(f"{m:.3f}" for m in months), file=sys.stderr)
        values = {"month_s": (t1 - t0) / n_months, "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                            "unit": m["unit"]}

    checks = {}
    if check is not None:
        checks = check(cell, seed, month_granules(last_k), ctm_raw, last, dev)
    result["correct"] = bool(checks) and all(v <= lim for v, lim in checks.values())  # NaN fails
    result["failed"] = 0 if result["correct"] else 1
    # a number that could not be formed (inf, NaN) is printed as 1e300: valid
    # JSON, and above every limit
    result["checks"] = {n: {"value": v if math.isfinite(v) else 1e300, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result

