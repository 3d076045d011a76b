"""Observation-space analysis diagnostics, on torch tensors.

Counterpart of :func:`oisat_tpu.ops.diagnostics.innovation_stats`: innovation
(O-B) and residual (O-A) statistics and the chi-square consistency ratio

    chi2 = mean( (y - xa)^2 / (Sa + So) )

which should be ~1 when the prescribed error variances are consistent (each
a masked sum over a count: :func:`innovation_partials` gives the sums of a
block of cells, :func:`innovation_finish` the statistics), and
the Desroziers et al. (2005) estimators of the error variances, global
(:func:`desroziers_estimates`) and per region label
(:func:`desroziers_binned`, labels from :func:`lat_band_index`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["InnovationStats", "InnovationPartials", "innovation_stats",
           "innovation_partials", "innovation_finish", "DesroziersEstimate",
           "desroziers_estimates", "lat_band_index", "desroziers_binned"]


class InnovationStats(NamedTuple):
    n: torch.Tensor  # cells with all inputs finite
    omb_mean: torch.Tensor  # mean(y - xa)        (bias of the prior)
    omb_rms: torch.Tensor  # rms(y - xa)
    oma_mean: torch.Tensor  # mean(y - xb)        (bias of the posterior)
    oma_rms: torch.Tensor  # rms(y - xb)
    chi2: torch.Tensor  # mean((y-xa)^2 / (Sa+So)) -- expect ~1


def _masked_sum(x, m):
    return torch.where(m, x, torch.zeros_like(x)).sum()


def _mean(s, c):
    mean = s / c
    return torch.where(c > 0, mean, torch.full_like(mean, math.nan))


def _masked_mean(x, m):
    return _mean(_masked_sum(x, m), m.sum())


class InnovationPartials(NamedTuple):
    """The sums behind :class:`InnovationStats` over a block of cells: the
    count of cells with all inputs finite, the sums of omb, omb^2, oma,
    oma^2 over them, and the count and sum of the finite chi terms.  Blocks
    add leaf by leaf (:func:`oisat_tpu_torch.parallel.mesh.sum_in_order`)."""

    n: torch.Tensor
    omb: torch.Tensor
    omb2: torch.Tensor
    oma: torch.Tensor
    oma2: torch.Tensor
    n_chi: torch.Tensor
    chi: torch.Tensor


def innovation_partials(xa, y, xb, sa, so) -> InnovationPartials:
    """The sums of :func:`innovation_stats` over one block of cells."""
    m = _all_finite(xa, y, xb, sa, so)
    omb = y - xa
    oma = y - xb
    denom = sa + so
    ratio = omb * omb / denom
    chi = torch.where(denom > 0, ratio, torch.full_like(ratio, math.nan))
    mchi = m & torch.isfinite(chi)
    return InnovationPartials(n=m.sum(), omb=_masked_sum(omb, m),
                              omb2=_masked_sum(omb * omb, m), oma=_masked_sum(oma, m),
                              oma2=_masked_sum(oma * oma, m), n_chi=mchi.sum(),
                              chi=_masked_sum(chi, mchi))


def innovation_finish(p: InnovationPartials) -> InnovationStats:
    """:class:`InnovationStats` from the sums: means over the counts (NaN
    where a count is 0), the rms as the root of the mean square."""
    return InnovationStats(n=p.n, omb_mean=_mean(p.omb, p.n),
                           omb_rms=torch.sqrt(_mean(p.omb2, p.n)),
                           oma_mean=_mean(p.oma, p.n),
                           oma_rms=torch.sqrt(_mean(p.oma2, p.n)),
                           chi2=_mean(p.chi, p.n_chi))


def innovation_stats(xa, y, xb, sa, so) -> InnovationStats:
    """All inputs one shape; NaN cells excluded from every statistic."""
    return innovation_finish(innovation_partials(xa, y, xb, sa, so))


class DesroziersEstimate(NamedTuple):
    so_hat: torch.Tensor  # diagnosed mean observation-error variance E[d_oa d_ob]
    sa_hat: torch.Tensor  # diagnosed mean background-error variance E[d_ab d_ob]
    so_scale: torch.Tensor  # so_hat / mean(prescribed So)
    sa_scale: torch.Tensor  # sa_hat / mean(prescribed Sa)
    n: torch.Tensor


def _all_finite(xa, y, xb, sa, so):
    return (torch.isfinite(xa) & torch.isfinite(y) & torch.isfinite(xb)
            & torch.isfinite(sa) & torch.isfinite(so))


def _variance_scale(hat, mean):
    """hat / mean clipped to [1e-4, 1e4]; 1 where the ratio is not a
    positive finite number (the raw moments can go negative on small or
    biased samples)."""
    s = hat / mean
    ok = torch.isfinite(s) & (s > 0)
    return torch.clamp(torch.where(ok, s, torch.ones_like(s)), 1e-4, 1e4)


def desroziers_estimates(xa, y, xb, sa, so) -> DesroziersEstimate:
    """Desroziers et al. (2005, QJRMS 131:3385) observation-space error
    diagnostics for the per-cell scalar analysis (H = I), as
    :func:`oisat_tpu.ops.diagnostics.desroziers_estimates`:

        E[(y - xb)(y - xa)] = R    ->  so_hat
        E[(xb - xa)(y - xa)] = B   ->  sa_hat

    The expectations are grid means over the cells where every input is
    finite, so the diagnosed values rescale the mean prescribed variances."""
    m = _all_finite(xa, y, xb, sa, so)
    d_ob = y - xa
    so_hat = _masked_mean((y - xb) * d_ob, m)
    sa_hat = _masked_mean((xb - xa) * d_ob, m)
    return DesroziersEstimate(so_hat=so_hat, sa_hat=sa_hat,
                              so_scale=_variance_scale(so_hat, _masked_mean(so, m)),
                              sa_scale=_variance_scale(sa_hat, _masked_mean(sa, m)),
                              n=m.sum())


def lat_band_index(lat2d, n_bins: int) -> np.ndarray:
    """Uniform latitude-band labels (int32, same shape as ``lat2d``) for
    :func:`desroziers_binned`: host numpy, built once per analysis.
    Non-finite latitudes get the label -1 ("no band"), which
    :func:`desroziers_binned` leaves out of every statistic."""
    lat = np.asarray(lat2d, np.float64)
    finite = np.isfinite(lat)
    if not finite.any():
        return np.full(lat.shape, -1, np.int32)
    lo = float(np.nanmin(lat))
    span = max(float(np.nanmax(lat)) - lo, 1e-12)
    idx = np.floor((np.where(finite, lat, lo) - lo) / span * n_bins).astype(np.int32)
    return np.where(finite, np.clip(idx, 0, n_bins - 1), -1).astype(np.int32)


def desroziers_binned(xa, y, xb, sa, so, bins, n_bins: int) -> DesroziersEstimate:
    """The cross-moments of :func:`desroziers_estimates` per region label
    (``bins``: integer tensor shaped like the fields, negative = no band);
    returns per-bin (n_bins,) variances, scale factors and counts.

    Each bin's mean is one masked row sum of an (n_bins, N) selection,
    accumulated in float64 in a fixed order: no atomic scatter, so a repeat
    on the card is bitwise equal."""
    dt = xa.dtype
    bins = bins.reshape(-1)
    m = _all_finite(xa, y, xb, sa, so).reshape(-1) & (bins >= 0)
    labels = torch.arange(n_bins, device=bins.device, dtype=bins.dtype)
    member = (bins[None, :] == labels[:, None]) & m[None, :]  # (n_bins, N)
    c = member.sum(1)

    def bmean(v):
        v = v.reshape(-1).to(torch.float64)
        s = torch.where(member, v[None, :], torch.zeros((), dtype=v.dtype,
                                                        device=v.device)).sum(1)
        mean = s / c
        return torch.where(c > 0, mean, torch.full_like(mean, math.nan)).to(dt)

    d_ob = y - xa
    so_hat = bmean((y - xb) * d_ob)
    sa_hat = bmean((xb - xa) * d_ob)
    return DesroziersEstimate(so_hat=so_hat, sa_hat=sa_hat,
                              so_scale=_variance_scale(so_hat, bmean(so)),
                              sa_scale=_variance_scale(sa_hat, bmean(sa)),
                              n=c.to(dt))
