"""Diagnostic netCDF output via h5py (twin of :mod:`oisat_tpu.ncwriter`: the same
HDF5 layout, so either package reads the other's files).

Writes netCDF-4-compatible HDF5: dimension-scale datasets attached to each
variable, so downstream netCDF tooling (including the reference's
``tools/`` post-processors) reads the file as a normal ``.nc``.  Schema
matches the reference's 12-variable diag file (reference
oisatgmi/driver.py:156-227) byte-for-name.

h5py is imported inside the functions that open a file: the package imports
where h5py is absent, and a call there raises ImportError naming h5py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_diag_nc", "read_diag_nc", "write_nc"]


def write_nc(path, dims: dict, variables: dict, global_attrs: dict | None = None):
    """Generic netCDF4-compatible writer.

    ``dims``: name -> 1-D coordinate values (or int size for a bare dim).
    ``variables``: name -> (dim_names tuple, data array, attrs dict).
    Used for ExtData-style outputs (scaling factors, OH fields, emissions)
    consumed by GMI runs (reference tools/convert2EXT.py:45-124 etc.).
    """
    import h5py

    with h5py.File(path, "w") as f:
        scales = {}
        for name, vals in dims.items():
            if np.isscalar(vals):
                data = np.arange(int(vals), dtype=np.float64)
            else:
                data = np.asarray(vals)
            d = f.create_dataset(name, data=data)
            d.make_scale(name)
            scales[name] = d
        for name, (dnames, data, attrs) in variables.items():
            if name in scales:
                ds = scales[name]
            else:
                ds = f.create_dataset(name, data=np.asarray(data))
                for i, dn in enumerate(dnames):
                    ds.dims[i].attach_scale(scales[dn])
            for k, v in (attrs or {}).items():
                ds.attrs[k] = v
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = v


def write_diag_nc(path, fields: dict, time_string: str, global_attrs=None):
    """Write the diag file.  ``fields``: name -> 2-D float array (x, y).
    ``global_attrs``: optional scalar metadata (e.g. OI diagnostics)."""
    import h5py

    first = next(iter(fields.values()))
    nx, ny = np.shape(first)
    with h5py.File(path, "w") as f:
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = v
        # dimension scales
        dx = f.create_dataset("x", data=np.arange(nx, dtype=np.float64))
        dx.make_scale("x")
        dy = f.create_dataset("y", data=np.arange(ny, dtype=np.float64))
        dy.make_scale("y")
        tchars = np.array(list(time_string), dtype="S1")
        dt = f.create_dataset("t", data=np.arange(len(tchars), dtype=np.float64),
                              maxshape=(None,))
        dt.make_scale("t")
        tv = f.create_dataset("time", data=tchars, maxshape=(None,))
        tv.dims[0].attach_scale(dt)
        for name, arr in fields.items():
            ds = f.create_dataset(name, data=np.asarray(arr, np.float32))
            ds.dims[0].attach_scale(dx)
            ds.dims[1].attach_scale(dy)


def read_diag_nc(path, with_attrs: bool = False):
    """Read a diag file back -> (fields dict, time string).

    ``with_attrs=True`` additionally returns the global attributes dict
    (the persisted OI diagnostics) as a third element — read-modify-write
    tools must pass it through ``write_diag_nc(global_attrs=...)`` or the
    diagnostics silently vanish from the rewritten file."""
    import h5py

    out = {}
    time_string = None
    attrs = {}
    with h5py.File(path, "r") as f:
        attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                 for k, v in f.attrs.items()}
        for k in f:
            if k in ("x", "y", "t"):
                continue
            if k == "time":
                time_string = b"".join(np.asarray(f[k]).tolist()).decode()
                continue
            out[k] = np.asarray(f[k])
    if time_string is None:
        raise KeyError(f"{path} has no 'time' variable — not a diag file "
                       "written by write_diag_nc")
    if with_attrs:
        return out, time_string, attrs
    return out, time_string
