"""What a cell is made of, found by name: ``BENCHMARK.json``, then the
configuration's file, the traffic mix's file, the per-layer metrics' readers
and the cell's limits, each a file of its own under ``benchmark/``.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "load_cell", "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, workload: dict, config: dict, mix: dict, end_to_end: list,
                 per_layer: list, limits: dict, run_seconds: int):
        self.workload = workload
        self.name = workload["name"]
        self.config = config
        self.mix = mix
        self.end_to_end = end_to_end
        self.per_layer = per_layer
        self.limits = limits
        self.run_seconds = run_seconds


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name``: its configuration's ``file`` from BENCHMARK.json,
    the mix ``benchmark/mixes/<traffic>.json``, the end-to-end and per-layer
    metrics that apply to it, and ``benchmark/limits/<cell>.json``."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    limits_file = root / "benchmark" / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(w, config, mix,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                limits, int(bench["run_seconds"]))


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
