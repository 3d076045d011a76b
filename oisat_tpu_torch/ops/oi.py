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

:func:`oi_sharded` runs the update over grid shards (lists of per-shard
fields, each shard on its own device): each shard's curve sums, one
fixed-order total with the summed valid count, one pull for the knee, then
the Kalman terms per shard on its device.  :func:`oi` is its one-shard case,
or, given a ``mesh``, splits the rows over the mesh's grid axis and gathers
the result.
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
    ak_curve_sums_sharded,
)
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.parallel.mesh import gather, split, sum_in_order

__all__ = ["OIResult", "regularization_grid", "curve_inputs", "ak_curve", "oi",
           "oi_sharded", "gather_oi", "CURVE_IMPLS"]

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
    return curve_of_shards([sa], [so], regs, CURVE_IMPLS[curve_impl])


def curve_of_shards(sa, so, regs: torch.Tensor, engine) -> torch.Tensor:
    """The curve over lists of per-shard ``sa`` / ``so``: each shard's sums
    by ``engine`` on its own device, added in shard order
    (:func:`ak_curve_sums_sharded`), over the summed valid count."""
    pairs = [curve_inputs(a, o) for a, o in zip(sa, so)]
    sums = ak_curve_sums_sharded([u.reshape(-1).contiguous() for u, _ in pairs], regs, engine)
    count = sum_in_order([valid.sum() for _, valid in pairs])
    curve = torch.where(count > 0, sums / count, torch.full_like(sums, math.nan))
    return curve.to(regs.dtype)


def oi(xa: torch.Tensor, y: torch.Tensor, sa: torch.Tensor, so: torch.Tensor,
       regularization_on: bool = True, curve_impl: str = "auto", curve_fn=None,
       mesh=None) -> OIResult:
    """OI update. ``xa``: prior, ``y``: obs, ``sa``/``so``: error variances.

    All inputs share one shape and device; NaN marks missing cells and
    propagates.  The result dtype follows the inputs (float32 or float64).
    ``curve_impl`` picks the curve engine (see :data:`CURVE_IMPLS`);
    ``curve_fn`` ``(sa, so, regs) -> curve`` replaces it, as the JAX hook
    does.  ``mesh`` (a :class:`~oisat_tpu_torch.parallel.mesh.Mesh` whose
    grid axis holds more than one position): the rows are split over that
    axis, the update runs as :func:`oi_sharded` and the result is gathered
    on ``xa``'s device."""
    if mesh is None or len(mesh.axis_devices("grid")) == 1:
        return oi_sharded([xa], [y], [sa], [so], regularization_on, curve_impl, curve_fn)[0]
    if curve_fn is not None:
        raise ValueError("curve_fn replaces the curve of one shard; it takes no mesh")
    devices = mesh.axis_devices("grid")
    parts = oi_sharded(*(split(t, devices, 0) for t in (xa, y, sa, so)),
                       regularization_on=regularization_on, curve_impl=curve_impl)
    return gather_oi(parts, xa.device)


def oi_sharded(xa, y, sa, so, regularization_on: bool = True, curve_impl: str = "auto",
               curve_fn=None) -> list:
    """The OI update over grid shards: ``xa``, ``y``, ``sa``, ``so`` are
    lists of per-shard tensors, shard k's four on one device.  The curve is
    the shards' sums added in shard order over the summed valid count
    (:func:`ak_curve_sums_sharded`: one engine launch per shard on its
    device), pulled to the host once for the knee; the Kalman terms then run
    per shard.  Returns one :class:`OIResult` per shard, each on its shard's
    device with the same factor and curve."""
    if curve_impl not in CURVE_IMPLS:
        raise ValueError(f"curve_impl must be one of {sorted(CURVE_IMPLS)}, got {curve_impl!r}")
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in (xa[0], y[0], sa[0], so[0])))
    shards = []
    for fields in zip(xa, y, sa, so):
        a, b, c, d = (t.to(dtype) for t in fields)
        # CTM-meaningless negative observations -> 0 (NaN preserved).
        shards.append((a, torch.where(b < 0, torch.zeros_like(b), b), c, d))

    regs_np = regularization_grid() if regularization_on else np.array([1.0])
    regs = torch.as_tensor(regs_np, dtype=dtype, device=shards[0][0].device)
    if curve_fn is not None:
        if len(shards) != 1:
            raise ValueError("curve_fn replaces the curve of one shard")
        curve = curve_fn(shards[0][2], shards[0][3], regs).to(dtype)
    else:
        curve = curve_of_shards([s[2] for s in shards], [s[3] for s in shards], regs,
                                CURVE_IMPLS[curve_impl])
    if regularization_on:
        # one 99-float device->host pull; the knee is host numpy
        reg_index = kneedle_index_np(regs_np, curve.cpu().numpy(), fallback=0)
    else:
        reg_index = 0

    out = []
    for xa_s, y_s, sa_s, so_s in shards:
        dev = xa_s.device
        reg = regs.to(dev)[reg_index]
        k, sb, ak = _kalman_terms(sa_s, so_s, reg)
        increment = k * (y_s - xa_s)
        out.append(OIResult(
            xb=xa_s + increment,
            averaging_kernel=ak,
            increment=increment,
            error=torch.sqrt(sb),
            reg_index=torch.tensor(reg_index, dtype=torch.int32, device=dev),
            reg_factor=reg,
            curve=curve.to(dev),
        ))
    return out


def gather_oi(parts, device) -> OIResult:
    """Per-shard results of :func:`oi_sharded` as one :class:`OIResult` on
    ``device``: the fields concatenated along their first dimension (rows),
    the factor and the curve from the first shard."""
    head = parts[0]

    def rows(name):
        return gather([getattr(p, name) for p in parts], device, 0)

    return OIResult(xb=rows("xb"), averaging_kernel=rows("averaging_kernel"),
                    increment=rows("increment"), error=rows("error"),
                    reg_index=head.reg_index.to(device), reg_factor=head.reg_factor.to(device),
                    curve=head.curve.to(device))
