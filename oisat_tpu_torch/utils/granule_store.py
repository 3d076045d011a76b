"""Stage-boundary checkpointing: persist gridded granules to one HDF5 store
(twin of :mod:`oisat_tpu.utils.granule_store`, the same file format).

The reference's de-facto checkpoints are per-granule ``.mat`` dumps and the
final diag netCDF (SURVEY.md §5); ``tools/readjust_OI.py`` shows re-running
*only* the OI stage from saved outputs.  This module generalizes that: the
regridded (+operator-processed) granule list is saved after ``read_data`` /
``recal_amf`` etc., so averaging→bias→OI can be re-run — or a crashed month
resumed — without re-decoding any L2 file.

Format: one HDF5 file, one group per granule ("g000", "g001", ...); array
fields are datasets, metadata (time, sensor, flags, class) attributes.
``None`` granules (failed files) round-trip as empty groups.  Tensor leaves are
pulled to the host on save; a loaded granule has host numpy leaves
(:func:`oisat_tpu_torch.convert.granule_to` moves it onto a device).

h5py is imported inside the two functions.
"""

from __future__ import annotations

import datetime

import numpy as np

from oisat_tpu_torch._device import d2h
from oisat_tpu_torch.datamodel import satellite_amf, satellite_opt, satellite_ssmis

__all__ = ["save_granules", "load_granules"]

_CLASSES = {"satellite_amf": satellite_amf, "satellite_opt": satellite_opt,
            "satellite_ssmis": satellite_ssmis}


def save_granules(path, granules):
    """Write a granule list (entries may be None)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["n"] = len(granules)
        for i, g in enumerate(granules):
            grp = f.create_group(f"g{i:04d}")
            if g is None:
                grp.attrs["class"] = "none"
                continue
            grp.attrs["class"] = type(g).__name__
            for name, v in vars(g).items():
                if name.startswith("_"):
                    # bookkeeping attributes are derived state, not granule data
                    continue
                if isinstance(v, datetime.datetime):
                    grp.attrs["dt:" + name] = v.isoformat()
                elif isinstance(v, (bool, np.bool_)):
                    grp.attrs["b:" + name] = bool(v)
                elif isinstance(v, str):
                    grp.attrs["s:" + name] = v
                elif v is None or (isinstance(v, list) and not v):
                    grp.attrs["empty:" + name] = 1
                else:
                    grp.create_dataset(name, data=d2h(v))


def load_granules(path):
    """Read a granule list back (inverse of :func:`save_granules`)."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        n = int(f.attrs["n"])
        for i in range(n):
            grp = f[f"g{i:04d}"]
            cls_name = grp.attrs["class"]
            if cls_name == "none":
                out.append(None)
                continue
            cls = _CLASSES[cls_name]
            kwargs = {}
            for k, v in grp.attrs.items():
                if k.startswith("dt:"):
                    kwargs[k[3:]] = datetime.datetime.fromisoformat(v)
                elif k.startswith("b:"):
                    kwargs[k[2:]] = bool(v)
                elif k.startswith("s:"):
                    kwargs[k[2:]] = str(v)
                elif k.startswith("empty:"):
                    kwargs[k[6:]] = []
            for name in grp:
                kwargs[name] = np.asarray(grp[name])
            out.append(cls(**kwargs))
    return out
