"""Temporal (monthly) statistics of granule stacks, on torch tensors.

Counterpart of :func:`oisat_tpu.ops.averaging.monthly_stats` and
:func:`~oisat_tpu.ops.averaging.monthly_stats_weighted` (reference
oisatgmi/averaging.py:11-24, :97-108): masked reductions over the leading
granule axis G of (G, H, W) stacks.

  * vcd:    inf->NaN scrub then nanmean
  * error:  sqrt( nansum(err^2) / N^2 )   (N = finite err^2 per cell)
  * ctm/aux fields: plain nanmean

The staged, date-bucketing ``averaging()`` driver is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["MonthlyAverage", "monthly_stats", "monthly_stats_weighted"]


class MonthlyAverage(NamedTuple):
    sat_vcd: torch.Tensor
    sat_error: torch.Tensor
    ctm_vcd: torch.Tensor
    aux1: torch.Tensor
    aux2: torch.Tensor


def _nan_like(x):
    return torch.full_like(x, math.nan)


def _nanmean0(x):
    valid = ~torch.isnan(x)
    c = valid.sum(0)
    s = torch.where(valid, x, torch.zeros_like(x)).sum(0)
    m = s / c
    return torch.where(c > 0, m, _nan_like(m))


def _inf_to_nan(x):
    return torch.where(torch.isinf(x), _nan_like(x), x)


def monthly_stats(vcd, err, ctm, aux1, aux2) -> MonthlyAverage:
    """All inputs (G, H, W); returns per-cell monthly statistics (H, W)."""
    vcd = _inf_to_nan(vcd)
    err2 = _inf_to_nan(err**2)
    valid = ~torch.isnan(err2)
    n = valid.sum(0)
    s = torch.where(valid, err2, torch.zeros_like(err2)).sum(0)
    q = s / (n * n)
    sat_error = torch.sqrt(torch.where(n > 0, q, _nan_like(q)))
    return MonthlyAverage(
        sat_vcd=_nanmean0(vcd),
        sat_error=sat_error,
        ctm_vcd=_nanmean0(ctm),
        aux1=_nanmean0(aux1),
        aux2=_nanmean0(aux2),
    )


def monthly_stats_weighted(vcd, err, ctm, aux1, aux2, w) -> MonthlyAverage:
    """Weighted temporal statistics; ``w`` (G, H, W) >= 0 per-granule
    per-cell weights.  Means are weighted; the error is the standard error
    of a weighted mean of independent errors, ``sqrt(sum(w^2 sigma^2)) /
    sum(w)``."""
    vcd = _inf_to_nan(vcd)
    err2 = _inf_to_nan(err**2)
    w = torch.where(torch.isfinite(w) & (w > 0), w, _nan_like(w))

    def wmean(x):
        m = ~(torch.isnan(x) | torch.isnan(w))
        sw = torch.where(m, w, torch.zeros_like(w)).sum(0)
        wx = w * x
        sx = torch.where(m, wx, torch.zeros_like(wx)).sum(0)
        r = sx / sw
        return torch.where(sw > 0, r, _nan_like(r))

    m = ~(torch.isnan(err2) | torch.isnan(w))
    sw = torch.where(m, w, torch.zeros_like(w)).sum(0)
    w2e = w * w * err2
    sw2e = torch.where(m, w2e, torch.zeros_like(w2e)).sum(0)
    e = torch.sqrt(sw2e) / sw
    sat_error = torch.where(sw > 0, e, _nan_like(e))
    return MonthlyAverage(sat_vcd=wmean(vcd), sat_error=sat_error,
                          ctm_vcd=wmean(ctm), aux1=wmean(aux1),
                          aux2=wmean(aux2))
