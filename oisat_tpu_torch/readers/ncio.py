"""netCDF/HDF5 access helpers built on h5py (twin of
:mod:`oisat_tpu.readers.ncio`; reference oisatgmi/reader.py:20-93).

netCDF4 files are HDF5 files, so h5py reads the products the reference reads
with netCDF4.Dataset.  Semantics mirrored: automatic scale_factor/add_offset
application and fill-value masking (netCDF4's auto-maskandscale); masked
entries become NaN for float output.

h5py is imported inside the functions that open a file: the package imports
where h5py is absent, and a call there raises ImportError naming h5py.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "read_nc",
    "read_nc_raw",
    "read_group_nc",
    "get_nc_attrs",
    "remove_empty_files",
]


def _node(f, group):
    """The group of an open file that ``group`` names: None, a "/" path or a
    list of nested group names."""
    node = f
    if group:
        if isinstance(group, str):
            group = group.split("/")
        for g in group:
            node = node[g]
    return node


def read_nc_raw(filename, var):
    """Read one variable RAW: no scale_factor/add_offset/fill handling (the
    reference's ``_read_ssmi``, reader.py:28-34).  SSMIS needs this: its flag
    values 250-254 and the manual x0.3 scaling are defined on the raw counts."""
    import h5py

    with h5py.File(filename, "r") as f:
        return np.squeeze(np.array(f[var]))


def _apply_maskandscale(ds, raw):
    out = np.asarray(raw)
    fill = None
    if "_FillValue" in ds.attrs:
        fill = np.asarray(ds.attrs["_FillValue"]).ravel()[0]
    scale = np.asarray(ds.attrs.get("scale_factor", 1.0)).ravel()[0]
    offset = np.asarray(ds.attrs.get("add_offset", 0.0)).ravel()[0]
    if np.issubdtype(out.dtype, np.floating) or scale != 1.0 or offset != 0.0:
        mask = None
        if fill is not None:
            mask = out == fill
        out = out.astype(np.float64) * scale + offset
        if mask is not None:
            out[mask] = np.nan
    return out


def read_nc(filename, var, group=None):
    """Read one variable (squeezed), group-aware (reference reader.py:20-26,
    :70-86).  ``group`` may be None, a string path or a list of nested group
    names."""
    import h5py

    with h5py.File(filename, "r") as f:
        ds = _node(f, group)[var]
        out = _apply_maskandscale(ds, ds[...])
    return np.squeeze(out)


def read_group_nc(filename, group, var):
    """Reference ``_read_group_nc`` signature (reader.py:70-86)."""
    return read_nc(filename, var, group=group)


def get_nc_attrs(filename, var=None, group=None):
    """Attribute dict of a variable or group (reference reader.py:36-67)."""
    import h5py

    with h5py.File(filename, "r") as f:
        node = _node(f, group)
        if var is not None:
            node = node[var]
        out = {}
        for k, v in node.attrs.items():
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            out[k] = v
    return out


def remove_empty_files(filelist: list, min_bytes: int = 100) -> list:
    """Drop tiny/corrupt files (reference reader.py:88-93, without its
    mutate-while-iterating skip)."""
    return [f for f in filelist if os.path.getsize(f) >= min_bytes]
