"""Device-side regrid application: gather + weighted sum, box filters.

Counterpart of :mod:`oisat_tpu.ops.regrid` (reference
oisatgmi/interpolator.py:44-97, :100-291).  A host-built
:class:`oisat_tpu.ops.weights.SparsePlan`, moved to the device by
:func:`oisat_tpu_torch.convert.plan_to_torch`, moves every row of a
(F, Npix) field batch onto the target grid in one gather + weighted sum.
The box filter reproduces scipy ``convolve2d(mode='same', boundary='symm')``
(even kernels included); error fields use the squared kernel
``1/(ky*kx)^2`` (reference ``_boxfilter2``).

``pad_to_bucket`` and plan compaction are TPU/tunnel workarounds and are not
ported: :func:`apply_plan` applies the plan to the batch as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["apply_plan_arrays", "apply_plan", "boxfilter_same_symm", "box_halo_rows",
           "boxfilter_rows_padded"]


def apply_plan_arrays(z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``out[..., t] = sum_k w[t, k] * z[..., idx[t, k]]``; NaN where ``mask``.

    ``z``: (..., Npix) source values (NaN = bad, propagates); ``idx`` (T, K)
    int64, ``w`` (T, K), ``mask`` (T,) bool.  Returns (..., T).  The K terms
    are added in order k = 0..K-1, one (..., T) gather at a time (no
    (..., T, K) intermediate)."""
    wz = w.to(z.dtype)
    out = z[..., idx[:, 0]] * wz[:, 0]
    for k in range(1, idx.shape[1]):
        out = out + z[..., idx[:, k]] * wz[:, k]
    return torch.where(mask, torch.full_like(out, math.nan), out)


def apply_plan(plan, z: torch.Tensor) -> torch.Tensor:
    """Apply a SparsePlan whose ``idx`` / ``w`` / ``mask`` are tensors on
    ``z``'s device (:func:`oisat_tpu_torch.convert.plan_to_torch`) to ``z``
    (..., Npix) -> (..., Ny, Nx)."""
    out = apply_plan_arrays(z, plan.idx, plan.w, plan.mask)
    return out.reshape(z.shape[:-1] + tuple(plan.out_shape))


def _symmetric_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source rows of numpy's ``mode='symmetric'`` padding (edge repeated)."""
    return torch.as_tensor(np.pad(np.arange(n), (lo, hi), mode="symmetric"),
                           device=device)


def boxfilter_same_symm(z: torch.Tensor, ky: int, kx: int,
                        squared: bool = False) -> torch.Tensor:
    """Box filter with scipy ``convolve2d(mode='same', boundary='symm')``
    semantics over the last two axes of ``z`` (..., H, W).

    ``squared=True`` uses the error-variance kernel ``ones/(ky*kx)**2``.
    NaNs spread over the window exactly like the reference's convolution."""
    # 'same' centering of a full convolution: pad_lo = k//2, pad_hi = (k-1)//2
    rows = box_halo_rows(z.shape[-2], ky, z.device)
    return boxfilter_rows_padded(z.index_select(-2, rows), ky, kx, squared)


def box_halo_rows(h: int, ky: int, device) -> torch.Tensor:
    """The source rows of the row-padded input :func:`boxfilter_same_symm`
    filters: ``h + ky - 1`` indices, the symmetric boundary at both ends.
    Output rows [r0, r1) read padded rows [r0, r1 + ky - 1), so a row shard
    with that halo filters to the same values as the whole grid."""
    return _symmetric_index(h, ky // 2, (ky - 1) // 2, device)


def boxfilter_rows_padded(zp: torch.Tensor, ky: int, kx: int,
                          squared: bool = False) -> torch.Tensor:
    """:func:`boxfilter_same_symm` of an input whose rows already carry the
    ``ky - 1`` halo rows (see :func:`box_halo_rows`): the columns are padded
    symmetrically and the ky x kx windows summed in order, so the result
    equals the unpadded filter's rows bitwise."""
    h, w = zp.shape[-2] - (ky - 1), zp.shape[-1]
    cols = _symmetric_index(w, kx // 2, (kx - 1) // 2, zp.device)
    zp = zp.index_select(-1, cols)
    s = None
    for dy in range(ky):
        for dx in range(kx):
            win = zp[..., dy:dy + h, dx:dx + w]
            s = win if s is None else s + win
    denom = (ky * kx) ** 2 if squared else ky * kx
    return s / denom
