"""Structured-swath regrid plans built on the card: CUDA kernel and wrapper.

:func:`build_plan_structured_kernel` builds the :class:`SparsePlan` of
:func:`oisat_tpu_torch.ops.weights.build_plan_structured` (methods 1, 2 and
4) with ``csrc/swath_plan.cu``, its ``idx`` (int64), ``w`` and ``mask``
written straight into device memory, bitwise equal to
``plan_to_torch(build_plan_structured(...), device)``.  The host builder
(``csrc/swath_weights.cpp``) is its plain version: the CPU device takes it,
and the tests hold the kernel to it.

The host keeps what is O(pixels) and decides whether there is a plan at
all: the shape checks here, then the library's host function
``swath_plan_bins``: the non-finite-coordinate reject (the C++ returns 2),
the swath's box and bin grid in the C++'s double operations, and the number
of (quad, bin) entries of the quad hash, so every buffer is allocated before
the launch and nothing waits on the device.  One copy moves the swath's
coordinates to the device through :func:`oisat_tpu_torch._device.to_device`,
with the targets' unless the caller holds those on the device already (the
regrid's fine grid, copied once).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from oisat_tpu_torch._device import to_device
from oisat_tpu_torch.ops.kernels._build import load_library
from oisat_tpu_torch.ops.weights import SparsePlan

__all__ = ["build_plan_structured_kernel", "targets_on"]

_SOURCE = "swath_plan"


def targets_on(tgt_lon2d, tgt_lat2d, device) -> torch.Tensor:
    """The targets as the kernel reads them: a (2, T) float64 tensor on
    ``device``, the flattened longitudes then latitudes."""
    return to_device(np.stack([np.asarray(tgt_lon2d, np.float64).ravel(),
                               np.asarray(tgt_lat2d, np.float64).ravel()]), device)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p: ctypes would cut them to 32-bit ints)."""
    lib = load_library(_SOURCE)
    ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.swath_plan_bins.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.swath_plan_bins.restype = ctypes.c_int
    lib.swath_plan_f64.argtypes = [ptr, i32, i32, ptr, i64, ptr, ptr, i64, f64, i32, ptr, ptr,
                                   ptr, ptr, ptr]
    lib.swath_plan_f64.restype = ctypes.c_int
    lib.swath_plan_workspace.argtypes = [i32, i64, i64]
    lib.swath_plan_workspace.restype = ctypes.c_longlong
    lib.swath_plan_error_string.argtypes = [ctypes.c_int]
    lib.swath_plan_error_string.restype = ctypes.c_char_p
    return lib


def build_plan_structured_kernel(pix_lon2d, pix_lat2d, tgt_lon2d, tgt_lat2d,
                                 threshold: float, far_factor: float = 2.0, method: int = 1,
                                 *, device: torch.device, targets: torch.Tensor | None = None):
    """The structured-swath :class:`SparsePlan` of ``build_plan_structured``
    built on the CUDA ``device`` (leaves there), or None where the host
    builder returns None: a method other than 1, 2 or 4, pixels that are not
    a 2-D grid of at least 2 x 2, no targets, or a non-finite pixel
    coordinate.  ``targets``, where given, is :func:`targets_on` of the
    target grid, already on ``device``; else the targets are copied with the
    pixels.  Launches on the current stream without synchronising; counts
    its launches in ``build_plan_structured_kernel.launches``."""
    if device.type != "cuda":
        raise ValueError(f"the swath plan kernel builds on a CUDA device, got {device}")
    if method not in (1, 2, 4):
        return None
    lon = np.ascontiguousarray(pix_lon2d, np.float64)
    lat = np.ascontiguousarray(pix_lat2d, np.float64)
    if lon.ndim != 2 or min(lon.shape) < 2 or lat.shape != lon.shape:
        return None
    out_shape = tuple(np.shape(tgt_lon2d))
    nt = int(np.prod(out_shape))
    if np.shape(tgt_lat2d) != out_shape:
        raise ValueError("the swath plan kernel needs matching target arrays")
    if targets is not None and (targets.shape != (2, nt) or targets.dtype != torch.float64
                                or targets.device.type != "cuda"
                                or not targets.is_contiguous()):
        raise ValueError("targets must be the target grid's targets_on(..., device)")
    if nt == 0:
        return None
    lib = _library()
    need_tri = method == 1
    ny, nx = lon.shape
    box, nb, n_quad = (ctypes.c_double * 6)(), (ctypes.c_int * 2)(), ctypes.c_longlong()
    if lib.swath_plan_bins(lon.ctypes.data, lat.ctypes.data, ny, nx, int(need_tri), box, nb,
                           ctypes.byref(n_quad)) != 0:
        return None  # a non-finite pixel coordinate, as on the host
    if targets is None:
        coords = to_device(np.concatenate([lon.ravel(), lat.ravel(),
                                           np.asarray(tgt_lon2d, np.float64).ravel(),
                                           np.asarray(tgt_lat2d, np.float64).ravel()]), device)
        tptr = coords.data_ptr() + 16 * lon.size
    else:
        coords = to_device(np.concatenate([lon.ravel(), lat.ravel()]), device)
        tptr = targets.data_ptr()
    work = torch.empty(lib.swath_plan_workspace(nb[0] * nb[1], lon.size, n_quad.value),
                       dtype=torch.int32, device=device)
    k = 3 if need_tri else 1
    idx = torch.empty((nt, k), dtype=torch.int64, device=device)
    w = torch.empty((nt, k), dtype=torch.float64, device=device)
    mask = torch.empty(nt, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.swath_plan_f64(coords.data_ptr(), ny, nx, tptr, nt, box, nb, n_quad.value,
                                far_factor * threshold, int(need_tri), work.data_ptr(),
                                idx.data_ptr(), w.data_ptr(), mask.data_ptr(), stream)
    if rc != 0:
        msg = lib.swath_plan_error_string(rc).decode()
        raise RuntimeError(f"swath plan kernel launch failed: CUDA error {rc} ({msg})")
    build_plan_structured_kernel.launches += 1
    return SparsePlan(idx=idx, w=w, mask=mask, out_shape=out_shape, npix=lon.size)


build_plan_structured_kernel.launches = 0
