"""Tiny copies of the two configurations for the CPU tests: the granule,
CTM and grid sizes cut until a month takes a fraction of a second, every
other key as in the real file."""

from __future__ import annotations

import copy

from benchmark.spec import Cell, load_cell

TINY = {
    "omi_no2.scalar_month": dict(
        granules_per_month=4, granules=dict(ny=200, nx=12, nz=6),
        ctm=dict(levels=10, dlat=4.0, dlon=5.0), regrid=dict(grid_size=2.0)),
    "mopitt_co.scalar_month": dict(
        granules_per_month=3, granules=dict(pitch=8.0),
        ctm=dict(levels=10, dlat=4.0, dlon=5.0), regrid=dict(grid_size=8.0)),
}


def tiny_cell(name: str) -> Cell:
    """The cell at a tiny size."""
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    for key, value in TINY[name].items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    cell.config = cfg
    return cell
