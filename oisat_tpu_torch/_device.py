"""Device resolution: every tensor-creating entry point names its device.

The staged driver path also counts its host<->device copies here
(:data:`COPIES`): every array it moves goes through :func:`h2d` / :func:`d2h`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "COPIES", "h2d", "d2h", "size", "granule_device"]

# copies made by the staged path since the caller last reset them
COPIES = {"h2d": 0, "d2h": 0}


def h2d(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a host array is copied (and counted
    in :data:`COPIES`), a tensor already there is passed through."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype) if dtype is not None else x.to(device)
    COPIES["h2d"] += 1
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def d2h(t) -> np.ndarray:
    """A tensor as a host numpy array (counted in :data:`COPIES`); a host
    array is passed through."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    COPIES["d2h"] += 1
    return t.detach().cpu().numpy()


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


def granule_device(granule) -> torch.device:
    """The device a gridded granule's fields live on (that of its ``vcd``)."""
    if not torch.is_tensor(granule.vcd):
        raise TypeError("granule fields must be tensors on one device: the output of "
                        "regrid_granule, or of convert.granule_to for a host granule")
    return granule.vcd.device
