"""Mean-AK regularization-curve sums: CUDA kernel, plain version, wrapper.

Counterpart of :mod:`oisat_tpu.ops.kernels.oi_scan`.  Given the hoisted
``u = So/Sa`` of :func:`oisat_tpu_torch.ops.oi.curve_inputs` (invalid cells
carry ``+inf``), each engine returns the per-factor sums
``S_i = sum_cells r_i / (r_i + u)``; the caller divides by the valid count.

* :func:`ak_curve_sums_kernel` launches ``csrc/ak_curve.cu`` (CUDA tensors
  only), one launch per call.  It counts its launches in
  ``ak_curve_sums_kernel.launches``.
* :func:`ak_curve_sums_plain` is the same function in plain PyTorch.
* :func:`ak_curve_sums` picks by the tensor's device: plain on the CPU, the
  kernel on CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from oisat_tpu_torch.ops.kernels._build import load_library

__all__ = ["ak_curve_sums", "ak_curve_sums_kernel", "ak_curve_sums_plain",
           "MAX_FACTORS", "TILE_CELLS"]

MAX_FACTORS = 128  # the kernel's factor limit (ak_curve_max_factors)
TILE_CELLS = 512  # cells the kernel stages per step (ak_curve_tile_cells)
_SOURCE = "ak_curve"


def ak_curve_sums_plain(u: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
    """(R,) sums in ``u``'s dtype; a Python loop over the factors in place of
    the JAX ``lax.scan`` (no (R, N) intermediate)."""
    return torch.stack([torch.sum(r / (r + u)) for r in regs.unbind()])


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared (pointers and
    the stream as c_void_p: ctypes would cut them to 32-bit ints)."""
    lib = load_library(_SOURCE)
    args = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
    for fn in (lib.ak_curve_sums_f32, lib.ak_curve_sums_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ak_curve_num_blocks.argtypes = [ctypes.c_longlong]
    lib.ak_curve_num_blocks.restype = ctypes.c_int
    for fn in (lib.ak_curve_max_factors, lib.ak_curve_tile_cells):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.ak_curve_error_string.argtypes = [ctypes.c_int]
    lib.ak_curve_error_string.restype = ctypes.c_char_p
    if (lib.ak_curve_max_factors(), lib.ak_curve_tile_cells()) != (MAX_FACTORS, TILE_CELLS):
        raise RuntimeError("ak_curve.cu and oi_scan.py disagree on the factor limit "
                           "or the tile size")
    return lib


_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(stream: int) -> torch.Tensor:
    """The kernel's zeroed ticket counter for ``stream`` on the current
    device.  Each launch's last block resets it to 0, so launches on one
    stream, which run in order, share it; launches on two streams never do."""
    key = (torch.cuda.current_device(), stream)
    hit = _tickets.get(key)
    if hit is None:
        hit = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=key[0])
    return hit


def ak_curve_sums_kernel(u: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
    """(R,) float64 sums from the CUDA kernel.

    ``u``: contiguous 1-D float32/float64 CUDA tensor; ``regs``: 1-D tensor
    of the same dtype and device with 1 <= R <= 128 entries.  Raises on
    anything else; launches on the current stream without synchronising."""
    if u.device.type != "cuda":
        raise ValueError(f"ak_curve kernel needs a CUDA tensor, got one on {u.device}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ak_curve kernel takes float32/float64, got {u.dtype}")
    if u.dim() != 1 or not u.is_contiguous():
        raise ValueError("ak_curve kernel needs a contiguous 1-D u")
    if regs.device != u.device or regs.dtype != u.dtype:
        raise ValueError("regs must share u's device and dtype")
    if regs.dim() != 1 or not regs.is_contiguous():
        raise ValueError("ak_curve kernel needs a contiguous 1-D regs")
    nfac = regs.numel()
    if not 1 <= nfac <= MAX_FACTORS:
        raise ValueError(f"ak_curve kernel takes 1..{MAX_FACTORS} factors, got {nfac}")
    lib = _library()
    n = u.numel()
    nblocks = lib.ak_curve_num_blocks(n)
    partials = torch.empty((nblocks, nfac), dtype=torch.float64, device=u.device)
    out = torch.empty((nfac,), dtype=torch.float64, device=u.device)
    fn = lib.ak_curve_sums_f32 if u.dtype == torch.float32 else lib.ak_curve_sums_f64
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        ticket = _ticket(stream)
        rc = fn(u.data_ptr(), n, regs.data_ptr(), nfac, partials.data_ptr(),
                nblocks, ticket.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        msg = lib.ak_curve_error_string(rc).decode()
        raise RuntimeError(f"ak_curve kernel launch failed: CUDA error {rc} ({msg})")
    ak_curve_sums_kernel.launches += 1
    return out


ak_curve_sums_kernel.launches = 0


def ak_curve_sums(u: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
    """(R,) sums: the plain version for a CPU tensor, the kernel otherwise."""
    if u.device.type == "cpu":
        return ak_curve_sums_plain(u, regs)
    return ak_curve_sums_kernel(u, regs)
