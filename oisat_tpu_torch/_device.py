"""Device resolution: every tensor-creating entry point names its device.

Every host->device copy of the month path goes through :func:`to_device`,
which counts its bytes (``h2d.bytes``) and the host's wait (``syncs``: a
copy from pageable memory waits for the stream) in
:mod:`oisat_tpu_torch.utils.profiling` when tracing is on; :func:`to_host`
counts a pull's wait likewise.  The staged driver
path also counts its host<->device copies here (:data:`COPIES`): every array
it moves goes through :func:`h2d` / :func:`d2h`.
"""

from __future__ import annotations

import numpy as np
import torch

from oisat_tpu_torch.utils.profiling import count

__all__ = ["resolve_device", "default_device", "COPIES", "positive_strides", "to_device", "to_host",
           "h2d", "d2h", "size", "granule_device"]

# copies made by the staged path since the caller last reset them
COPIES = {"h2d": 0, "d2h": 0}


def positive_strides(x) -> np.ndarray:
    """``x`` as a numpy array torch can wrap: a view with a negative stride
    (the CTM readers flip the level axis with ``np.flip``) is copied, and an
    array in the other byte order (as an HDF5 file may store it) is copied
    into the machine's, with its values and type kept."""
    a = np.asarray(x)
    if not a.dtype.isnative:
        return a.astype(a.dtype.newbyteorder("="))
    return a.copy() if any(s < 0 for s in a.strides) else a


def to_device(x, device, dtype=None) -> torch.Tensor:
    """The host array ``x`` as a tensor on ``device`` (cast to ``dtype`` on
    the host first, as a blocking copy casts), its bytes counted as
    ``h2d.bytes`` and its wait as one of ``syncs``."""
    t = torch.as_tensor(positive_strides(x))
    if dtype is not None:
        t = t.to(dtype)
    count("h2d.bytes", t.nbytes)
    count("syncs")
    return t.to(device)


def to_host(t) -> np.ndarray:
    """The tensor ``t`` as a host numpy array, the host's wait counted as
    one of ``syncs``."""
    count("syncs")
    return t.detach().cpu().numpy()


def h2d(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a host array is copied (and counted
    in :data:`COPIES`), a tensor already there is passed through."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype) if dtype is not None else x.to(device)
    COPIES["h2d"] += 1
    return to_device(x, device, dtype)


def d2h(t) -> np.ndarray:
    """A tensor as a host numpy array (counted in :data:`COPIES`); a host
    array is passed through."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    COPIES["d2h"] += 1
    return to_host(t)


def size(x) -> int:
    """Element count of a tensor, an array or a ``[]`` / size-1 placeholder."""
    return x.numel() if torch.is_tensor(x) else int(np.size(x))


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) as a torch.device.

    There is no implicit choice: a CUDA device that is not present raises
    instead of quietly running on the CPU."""
    if device is None:
        raise ValueError("device must be given explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_device(device=None) -> torch.device:
    """The device of an entry point that reads files or runs a job: the card
    unless the caller names another (``None`` -> ``"cuda"``, which raises when
    there is none; the CPU is used only when asked for)."""
    return resolve_device("cuda" if device is None else device)


def granule_device(granule) -> torch.device:
    """The device a gridded granule's fields live on (that of its ``vcd``)."""
    if not torch.is_tensor(granule.vcd):
        raise TypeError("granule fields must be tensors on one device: the output of "
                        "regrid_granule, or of convert.granule_to for a host granule")
    return granule.vcd.device
