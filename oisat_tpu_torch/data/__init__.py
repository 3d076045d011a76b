"""Vendored geographic context data for the PDF report maps (a copy of
:mod:`oisat_tpu.data`, the data unchanged).

:func:`coastline_segments` returns the coastline as a list of (N, 2)
float64 arrays of [lon, lat] vertices (degrees, lon in [-180, 180]),
one array per polyline.  Resolution order:

1. an explicit path in the ``OISAT_COASTLINES`` environment variable,
2. ``oisat_tpu_torch/data/coastlines.npz`` — a survey-grade dataset produced by
   ``tools/make_coastlines.py`` from public-domain GSHHS / Natural Earth
   sources on a networked machine (this offline build cannot fetch it),
3. the built-in approximate world coastline
   (:mod:`oisat_tpu_torch.data.coastlines_builtin`, ~1-2 degree fidelity).

The npz format is trivial on purpose: a single pair of 1-D arrays ``lon``
and ``lat`` with NaN separators between polylines (what the reference's
Basemap ``drawcoastlines`` consumed internally — reference
oisatgmi/report.py:13-59 draws every panel on a coastline Basemap).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["coastline_segments", "coastlines_source"]

_cache: dict = {}


def _split_nan(lon: np.ndarray, lat: np.ndarray):
    """NaN-separated 1-D track -> list of (N, 2) segments."""
    lon = np.asarray(lon, np.float64).ravel()
    lat = np.asarray(lat, np.float64).ravel()
    good = np.isfinite(lon) & np.isfinite(lat)
    segs = []
    start = None
    for i, g in enumerate(good):
        if g and start is None:
            start = i
        elif not g and start is not None:
            if i - start > 1:
                segs.append(np.column_stack([lon[start:i], lat[start:i]]))
            start = None
    if start is not None and len(lon) - start > 1:
        segs.append(np.column_stack([lon[start:], lat[start:]]))
    return segs


def coastlines_source() -> str:
    """Which dataset :func:`coastline_segments` resolved ("env", "npz" or
    "builtin-approximate")."""
    coastline_segments()
    return _cache["source"]


def coastline_segments():
    """The coastline polylines (cached after the first call)."""
    if "segs" in _cache:
        return _cache["segs"]
    env = os.environ.get("OISAT_COASTLINES")
    npz = Path(env) if env else Path(__file__).parent / "coastlines.npz"
    if npz.exists():
        with np.load(npz) as d:
            _cache["segs"] = _split_nan(d["lon"], d["lat"])
            _cache["source"] = "env" if env else "npz"
            return _cache["segs"]
    from oisat_tpu_torch.data.coastlines_builtin import SEGMENTS

    _cache["segs"] = [np.asarray(s, np.float64) for s in SEGMENTS]
    _cache["source"] = "builtin-approximate"
    return _cache["segs"]
