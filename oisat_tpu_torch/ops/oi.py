"""Optimal-interpolation (OI) analysis update on torch tensors.

Counterpart of :mod:`oisat_tpu.ops.oi` (reference
oisatgmi/optimal_interpolation.py:6-52):

    for each regularization factor r in 0.1..9.9 (99 values):
        curve[r] = nanmean(AK_r),  AK_r = Sa*r / (Sa*r + So) = r / (r + So/Sa)
    r* = Kneedle knee of (r, curve)   (fallback: first r)
    K = Sa*r*/(Sa*r* + So); increment = K (Y - Xa); Xb = Xa + increment

with the same semantics: negative observations clamp to 0 (NaN stays NaN),
``Sa == 0`` cells give a NaN averaging kernel, ``So == inf`` cells keep
``K = 0, AK = 0``, and the grid is ``np.arange(0.1, 10, 0.1)`` in float64.

The curve's engine is the hand-written CUDA kernel
(:mod:`oisat_tpu_torch.ops.kernels.oi_scan`) for CUDA tensors and its plain
version for CPU tensors; the knee is picked on the host from one 99-float
pull.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from oisat_tpu_torch.ops.kernels.oi_scan import (
    ak_curve_sums,
    ak_curve_sums_kernel,
    ak_curve_sums_plain,
)
from oisat_tpu_torch.ops.knee import kneedle_index_np

__all__ = ["OIResult", "regularization_grid", "curve_inputs", "ak_curve", "oi",
           "CURVE_IMPLS"]

# "auto": the kernel for CUDA tensors, the plain version for CPU tensors;
# "kernel": the CUDA kernel only (raises on a CPU tensor);
# "plain": the plain PyTorch version (tests and kernel comparisons).
CURVE_IMPLS = {"auto": ak_curve_sums, "kernel": ak_curve_sums_kernel,
               "plain": ak_curve_sums_plain}


def regularization_grid() -> np.ndarray:
    """The reference's 99-point regularization scan grid (float64)."""
    return np.arange(0.1, 10.0, 0.1)


class OIResult(NamedTuple):
    """Outputs of the OI update (field shapes match the inputs)."""

    xb: torch.Tensor  # posterior state
    averaging_kernel: torch.Tensor  # AK at the chosen factor
    increment: torch.Tensor  # K * (Y - Xa)
    error: torch.Tensor  # sqrt(posterior variance)
    reg_index: torch.Tensor  # int32 index into the regularization grid
    reg_factor: torch.Tensor  # the chosen factor value
    curve: torch.Tensor  # mean-AK curve over the grid (for diagnostics)


def _kalman_terms(sa: torch.Tensor, so: torch.Tensor, reg):
    """K, Sb, AK for one factor; ``Sb`` in the stable product form
    ``Sa*r*So/(Sa*r + So)``, with the ``So == inf`` guard that keeps the
    reference's ``K = 0, Sb = Sa*r, AK = 0`` (see oisat_tpu.ops.oi)."""
    sar = sa * reg
    denom = sar + so
    k = sar / denom
    ratio = torch.where(torch.isinf(so), torch.ones_like(so), so / denom)
    sb = sar * ratio
    ak = 1.0 - sb / sar
    return k, sb, ak


def curve_inputs(sa: torch.Tensor, so: torch.Tensor):
    """``(u, valid)``: ``u = So/Sa`` on valid cells and ``+inf`` elsewhere
    (NaN ``Sa``/``So``, ``Sa == 0``, ``Sa == inf``), so invalid cells add 0 to
    every factor's sum and are left out of the count.  Variances must be
    ``>= 0`` (or NaN/inf), as in :func:`oisat_tpu.ops.oi.curve_inputs`."""
    valid = torch.isfinite(sa) & (sa != 0) & ~torch.isnan(so)
    u = torch.where(valid, so / sa, torch.full_like(so, math.inf))
    return u, valid


def ak_curve(sa: torch.Tensor, so: torch.Tensor, regs: torch.Tensor,
             curve_impl: str = "auto") -> torch.Tensor:
    """Mean-AK-vs-regularization curve (R,) in ``regs``' dtype: the factor
    sums of the chosen engine over the valid count, NaN when no cell is
    valid."""
    u, valid = curve_inputs(sa, so)
    count = valid.sum()
    sums = CURVE_IMPLS[curve_impl](u.reshape(-1).contiguous(), regs)
    curve = torch.where(count > 0, sums / count, torch.full_like(sums, math.nan))
    return curve.to(regs.dtype)


def oi(xa: torch.Tensor, y: torch.Tensor, sa: torch.Tensor, so: torch.Tensor,
       regularization_on: bool = True, curve_impl: str = "auto") -> OIResult:
    """OI update. ``xa``: prior, ``y``: obs, ``sa``/``so``: error variances.

    All inputs share one shape and device; NaN marks missing cells and
    propagates.  The result dtype follows the inputs (float32 or float64).
    ``curve_impl`` picks the curve engine (see :data:`CURVE_IMPLS`)."""
    if curve_impl not in CURVE_IMPLS:
        raise ValueError(f"curve_impl must be one of {sorted(CURVE_IMPLS)}, got {curve_impl!r}")
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in (xa, y, sa, so)))
    xa, y, sa, so = (t.to(dtype) for t in (xa, y, sa, so))

    # CTM-meaningless negative observations -> 0 (NaN preserved).
    y = torch.where(y < 0, torch.zeros_like(y), y)

    regs_np = regularization_grid() if regularization_on else np.array([1.0])
    regs = torch.as_tensor(regs_np, dtype=dtype, device=xa.device)
    curve = ak_curve(sa, so, regs, curve_impl)
    if regularization_on:
        # one 99-float device->host pull; the knee is host numpy
        reg_index = kneedle_index_np(regs_np, curve.cpu().numpy(), fallback=0)
    else:
        reg_index = 0
    reg = regs[reg_index]

    k, sb, ak = _kalman_terms(sa, so, reg)
    increment = k * (y - xa)
    xb = xa + increment
    return OIResult(
        xb=xb,
        averaging_kernel=ak,
        increment=increment,
        error=torch.sqrt(sb),
        reg_index=torch.tensor(reg_index, dtype=torch.int32, device=xa.device),
        reg_factor=reg,
        curve=curve,
    )
