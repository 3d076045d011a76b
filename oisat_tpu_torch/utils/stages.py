"""Wall-clock times of the stages of one call, for callers that ask for them."""

from __future__ import annotations

import time

import torch

__all__ = ["StageClock"]


class StageClock:
    """Milliseconds of consecutive stages of one call, summed into
    ``out[prefix + name]``.  Each :meth:`mark` closes the stage that began at
    the previous mark (or at construction) once the device has finished its
    work (``torch.cuda.synchronize`` on a CUDA device), so device and host
    stages add up to the call's wall time.

    With ``out`` None every mark is a no-op: an untimed call pays nothing
    and synchronises nothing extra."""

    def __init__(self, out: dict | None, device, prefix: str = ""):
        self.out = out
        self.device = torch.device(device)
        self.prefix = prefix
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        key = self.prefix + name
        self.out[key] = self.out.get(key, 0.0) + (now - self.t) * 1e3
        self.t = now
