"""Device meshes of the port: an (obs, grid) grid of torch devices.

Counterpart of :mod:`oisat_tpu.parallel.mesh`.  A :class:`Mesh` is a plain
(a, b) array of ``torch.device`` over which the sharded makers of
:mod:`oisat_tpu_torch.parallel.analysis` split a month: granules over the
first axis ('obs'), grid rows over the second ('grid').  The mesh runs in one
process, as JAX's single controller does; no ``torch.distributed``.  A device
may appear more than once: several mesh positions on one device are logical
shards (how the CPU tests and a one-card host run the mesh path, as the JAX
tests use virtual CPU devices).

:func:`split` and :func:`gather` are the shard helpers every mesh path uses:
an uneven ``torch.tensor_split`` (no padding), and a concatenation on one
device.  When every shard lies on one device, :func:`split` makes views and
copies nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device

__all__ = ["Mesh", "make_mesh", "factor2", "split", "gather", "sum_in_order"]


def factor2(n: int):
    """Split n devices into the most-square (a, b) factorization, a*b = n."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` holds mesh position (i, j); ``axis_names`` names the
    two axes (granules, grid rows).  Hashable: equal devices and names give
    equal meshes."""

    devices: tuple
    axis_names: tuple = ("obs", "grid")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at position 0 of the other axis: for the
        grid axis the devices of ``devices[0]``, where the reduction over the
        granule axis lands."""
        if axis == self.axis_names[1]:
            return list(self.devices[0])
        if axis == self.axis_names[0]:
            return [row[0] for row in self.devices]
        raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")

    def flat_devices(self) -> list:
        """Every position's device, row by row."""
        return [d for row in self.devices for d in row]


def make_mesh(n_devices: int | None = None, axis_names=("obs", "grid"),
              devices=None) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device), factored by :func:`factor2` into (obs, grid).

    An explicit ``devices`` list may repeat a device: repeated positions are
    logical shards on it.  Asking for more devices than the list holds
    raises."""
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [resolve_device(d) for d in devices])
    n = len(devs) if n_devices is None else int(n_devices)
    if n > len(devs) or n < 1:
        raise RuntimeError(
            f"mesh requested {n} devices but the host has {len(devs)} "
            f"(check the mesh_devices control key)")
    a, b = factor2(n)
    return Mesh(tuple(tuple(devs[i * b:(i + 1) * b]) for i in range(a)), tuple(axis_names))


def split(t: torch.Tensor, devices, dim: int) -> list:
    """``t`` cut into ``len(devices)`` pieces along ``dim`` (uneven when the
    size does not divide; a piece may be empty), piece k on ``devices[k]``.
    A piece already on its device is a view of ``t``."""
    return [p.to(d) for p, d in zip(torch.tensor_split(t, len(devices), dim=dim), devices)]


def gather(parts, device, dim: int) -> torch.Tensor:
    """The pieces concatenated along ``dim`` on ``device``; a single piece
    already there is returned as it is."""
    if len(parts) == 1 and parts[0].device == torch.device(device):
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _add(a, b):
    if torch.is_tensor(a):
        return a + b.to(a.device)
    vals = [_add(x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def sum_in_order(parts):
    """``parts[0] + parts[1] + ...`` on the first part's device, in that
    order (a fixed order, so the sum repeats bitwise).  Works on tensors and,
    leaf by leaf, on (nested) tuples of tensors."""
    total = parts[0]
    for p in parts[1:]:
        total = _add(total, p)
    return total
