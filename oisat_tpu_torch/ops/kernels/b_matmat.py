"""The matrix-free B.V sweep's column-chunk contraction: CUDA kernel, plain version.

Counterpart of the inner part of :func:`oisat_tpu.ops.oi_full._b_matmat`
(XLA in the JAX package, not Pallas).  For float32 unit vectors ``u3``
(N, 3), ``dv = sigma_b[:, None] * v`` (N, K) and a range [c0, c1) of
``block``-wide column chunks, both engines return the (N, K) float32

    P = sum over c in [c0, c1), in chunk order, of C[:, chunk c] @ dv[chunk c]
    C_ij = exp(-kappa |u_i - u_j|^2 / 2),   kappa = (R / L)^2

each C_ij from explicit coordinate differences, each chunk's partial
accumulated in float32 over at most ``block`` terms.

* :func:`b_matmat_kernel` launches ``csrc/b_matmat.cu`` (CUDA tensors only)
  and counts its launches in ``b_matmat_kernel.launches``.
* :func:`b_matmat_plain` is the same contraction as torch ops (the CPU
  tests use it; ``chip_smoke.py`` compares the kernel with it on the card).
* :func:`b_matmat_reference` is the float64 golden of the same P, on the
  tensors' device.
* :func:`split_bf16x3` is the split of float32 into three bf16 pieces that
  the kernel's wide shape (K > 32) contracts on the tensor cores: six
  products of pieces, each exact in float32, in place of one float32
  product (the TPU's HIGHEST precision built the same way).
* :func:`b_matmat` picks by the tensors' device: the plain version for CPU
  tensors, the kernel for CUDA tensors, never a fallback; no caller picks
  the engine.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from oisat_tpu_torch.ops.kernels._build import load_library
from oisat_tpu_torch.ops.kernels.covariance import EARTH_RADIUS_KM

__all__ = ["SLAB", "MAX_BLOCK", "C_SPLIT_SCALE", "b_matmat", "b_matmat_kernel",
           "b_matmat_plain", "b_matmat_reference", "declare_abi", "neg_half_kappa",
           "split_bf16x3"]

_SOURCE = "b_matmat"
SLAB = 128  # the kernel's column tile: ``block`` must be a multiple of it
MAX_BLOCK = 2048  # the widest chunk the kernel takes
NARROW_MAX_K = 32  # wider V goes to the tensor cores, in steps of WIDE_GRANULE columns
WIDE_GRANULE = 16  # two of mma.sync's 8-column tiles
C_SPLIT_SCALE = 2.0 ** 24  # the kernel splits C_SPLIT_SCALE * C: every piece a normal bf16


def _kappa(length_scale_km: float) -> float:
    return (EARTH_RADIUS_KM / length_scale_km) ** 2


def neg_half_kappa(length_scale_km: float) -> float:
    """float32(-0.5 kappa): the constant torch's ``mul_(-0.5 * kappa)``
    applies to a float32 tensor, and the one the kernel multiplies by."""
    return float(np.float32(-0.5 * _kappa(length_scale_km)))


def split_bf16x3(x: torch.Tensor) -> tuple:
    """The three bf16 pieces (x0, x1, x2) of float32 ``x`` that
    ``csrc/b_matmat.cu``'s wide shape contracts: x0 = bf16_rn(x),
    x1 = bf16_rn(x - x0), x2 = bf16_rn(x - x0 - x1), each difference exact
    in float32.

    x0 + x1 + x2 == x bitwise for every float32 that is a multiple of
    2^-133, bf16's smallest subnormal: 0, every normal |x| >= 2^-110 and
    every float32 times :data:`C_SPLIT_SCALE` (2^24, the scale at which the
    kernel splits C).  Below that the bits under 2^-133 are lost: the sum
    is within 2^-134 of x (a float32 subnormal keeps its multiple of
    2^-133 nearest to it).  Infinities and NaNs give NaN pieces."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {x.dtype}")
    x0 = x.to(torch.bfloat16)
    r1 = x - x0.float()
    x1 = r1.to(torch.bfloat16)
    x2 = (r1 - x1.float()).to(torch.bfloat16)
    return x0, x1, x2


def b_matmat_plain(u3: torch.Tensor, dv: torch.Tensor, length_scale_km: float, block: int,
                   c0: int, c1: int) -> torch.Tensor:
    """P (N, K) for chunks [c0, c1) as torch ops on ``u3``'s device: for each
    ``block`` rows the tile is generated in (chunk, row, column) layout, the
    difference and square in place (two (c1 - c0, block, block) temporaries
    at a time), and contracted by one ``torch.bmm`` whose chunk partials are
    summed after."""
    kappa = _kappa(length_scale_km)
    n = u3.shape[0]
    nchunks = n // block
    u3c_d = u3.reshape(nchunks, block, 3)[c0:c1]
    dv3_d = dv.reshape(nchunks, block, -1)[c0:c1]
    rows = []
    for s in range(0, n, block):
        ub = u3[s:s + block]
        d2 = None
        for k in range(3):
            t = (ub[None, :, None, k] - u3c_d[:, None, :, k]).square_()
            d2 = t if d2 is None else d2.add_(t)
        c = d2.mul_(-0.5 * kappa).exp_()  # (chunks, block_row, block_col)
        rows.append(torch.bmm(c, dv3_d).sum(dim=0))
        del c, d2, t
    return torch.cat(rows)


def b_matmat_reference(u3: torch.Tensor, dv: torch.Tensor, length_scale_km: float,
                       block: int, c0: int, c1: int, rows: int = 1024) -> torch.Tensor:
    """P (N, K) in float64 on ``u3``'s device: the float64 values of ``u3``
    and ``dv``, C in float64 from the same differences, ``rows`` rows of C at
    a time against chunks [c0, c1) in one float64 product."""
    kappa = _kappa(length_scale_km)
    u = u3.to(torch.float64)
    cols = u[c0 * block:c1 * block]
    d = dv.to(torch.float64)[c0 * block:c1 * block]
    out = []
    for s in range(0, u.shape[0], rows):
        d2 = ((u[s:s + rows, None, :] - cols[None, :, :]) ** 2).sum(-1)
        out.append(torch.exp(-0.5 * kappa * d2) @ d)
    return torch.cat(out)


def declare_abi(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with ``csrc/b_matmat.cu``'s C signature declared (pointers
    and the stream as c_void_p: ctypes would cut them to 32-bit ints)."""
    lib.b_matmat_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.b_matmat_f32.restype = ctypes.c_int
    lib.b_matmat_error_string.argtypes = [ctypes.c_int]
    lib.b_matmat_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signature declared."""
    return declare_abi(load_library(_SOURCE))


def b_matmat_kernel(u3: torch.Tensor, dv: torch.Tensor, length_scale_km: float, block: int,
                    c0: int, c1: int) -> torch.Tensor:
    """P (N, K) for chunks [c0, c1) from ``csrc/b_matmat.cu``.

    ``u3`` (N, 3) and ``dv`` (N, K): contiguous float32 tensors on one CUDA
    device, N a multiple of ``block``, ``block`` a multiple of :data:`SLAB`
    and at most :data:`MAX_BLOCK`, 0 <= c0 < c1 <= N / block.  Raises on
    anything else; launches on the current stream without synchronising.
    K > 32 columns are padded to a multiple of :data:`WIDE_GRANULE` with
    zero columns, and the kernel's split pre-pass writes dv's bf16 pieces
    over chunks [c0, c1) into a scratch tensor of 6 (c1 - c0) block K bytes."""
    for name, t, dim in (("u3", u3, 2), ("dv", dv, 2)):
        if t.device.type != "cuda":
            raise ValueError(f"b_matmat kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"b_matmat kernel takes float32, got {name} {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"b_matmat kernel needs a contiguous 2-D {name}")
    if u3.device != dv.device:
        raise ValueError("u3 and dv must share one device")
    n, k = dv.shape
    if u3.shape != (n, 3):
        raise ValueError(f"u3 must be ({n}, 3), got {tuple(u3.shape)}")
    if block % SLAB or not 0 < block <= MAX_BLOCK:
        raise ValueError(f"b_matmat kernel: block={block} must be a multiple of {SLAB} "
                         f"and at most {MAX_BLOCK}")
    if n % block:
        raise ValueError(f"b_matmat kernel: N={n} must be a multiple of block={block}")
    if not 0 <= c0 < c1 <= n // block:
        raise ValueError(f"b_matmat kernel: chunk range [{c0}, {c1}) outside [0, {n // block})")
    if k == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=dv.device)
    kp = k if k <= NARROW_MAX_K else -(-k // WIDE_GRANULE) * WIDE_GRANULE
    if kp != k:
        dv = torch.nn.functional.pad(dv, (0, kp - k))
    out = torch.empty((n, kp), dtype=torch.float32, device=dv.device)
    scratch = None
    if kp > NARROW_MAX_K:
        scratch = torch.empty((3, (c1 - c0) * block, kp), dtype=torch.bfloat16,
                              device=dv.device)
    lib = _library()
    with torch.cuda.device(dv.device):
        stream = torch.cuda.current_stream(dv.device).cuda_stream
        rc = lib.b_matmat_f32(u3.data_ptr(), dv.data_ptr(), n, kp, block, c0, c1,
                              neg_half_kappa(length_scale_km), out.data_ptr(), stream,
                              None if scratch is None else scratch.data_ptr())
    if rc != 0:
        msg = lib.b_matmat_error_string(rc).decode()
        raise RuntimeError(f"b_matmat kernel launch failed: CUDA error {rc} ({msg})")
    b_matmat_kernel.launches += 1
    return out if kp == k else out[:, :k].contiguous()


b_matmat_kernel.launches = 0


def b_matmat(u3: torch.Tensor, dv: torch.Tensor, length_scale_km: float, block: int,
             c0: int, c1: int) -> torch.Tensor:
    """P of chunks [c0, c1): the plain version for CPU tensors, the kernel
    otherwise."""
    if u3.device.type == "cpu":
        return b_matmat_plain(u3, dv, length_scale_km, block, c0, c1)
    return b_matmat_kernel(u3, dv, length_scale_km, block, c0, c1)
