"""Device resolution: every tensor-creating entry point names its device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
