"""Granule kind ``omi_orbit_conus``: OMI-NO2-shaped L2 orbits cut to a
regional window, as a regional user downloads them (the bounding-box subset
of each orbit, padded by a margin), with the observation operator of
``omi_orbit``.

The configuration's ``granules`` block gives the window as ``window``
(south, north, west, east in degrees) and its padding as ``margin_deg``
(latitude, longitude): each orbit's ``ny`` scanlines run from the padded
box's south to its north edge, and every pixel west or east of it gets
quality flag 0, so the regrid drops it.  The valid cells of a month, and so
the full-covariance OI's size, then follow the box.  The clipped orbits'
edges lose about one CTM row and column to the triangulation and the
regrid's box filter, and the mix's offsets move the box; the margin keeps
at least the window's own count of cells valid in every month.  Orbit
centres are spread over the window's longitudes 4 degrees in from each
edge, days 1-28, as ``synthetic_regional_month`` of
``oisat_tpu_torch/entry.py`` spreads them.  ``orbit()``, the container, the
fields and the operator are ``omi_orbit``'s own, taken from that file.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import granule_kind

_omi = granule_kind("omi_orbit")
CONTAINER, FIELDS2, FIELDS3 = _omi.CONTAINER, _omi.FIELDS2, _omi.FIELDS3
container_fields, operator = _omi.container_fields, _omi.operator


def make(seeds, block: dict, month) -> list:
    """The month's orbits over ``block["window"]`` padded by
    ``block["margin_deg"]``."""
    south, north, west, east = (float(v) for v in block["window"])
    mlat, mlon = (float(v) for v in block["margin_deg"])
    centers = np.linspace(west + 4.0, east - 4.0, len(seeds))
    out = []
    for i, (s, ctr) in enumerate(zip(seeds, centers)):
        g = _omi.orbit(s, ctr, ny=block["ny"], nx=block["nx"], nz=block["nz"], day=1 + i % 28,
                       month=month, lat_range=(south - mlat, north + mlat),
                       width_deg=block["width_deg"], error_mean=block["error_mean"])
        lon = g["longitude_center"]
        g["quality_flag"][(lon < west - mlon) | (lon > east + mlon)] = 0.0
        g["kind"] = "omi_orbit_conus"
        out.append(g)
    return out
