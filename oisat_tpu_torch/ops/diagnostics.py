"""Observation-space analysis diagnostics, on torch tensors.

Counterpart of :func:`oisat_tpu.ops.diagnostics.innovation_stats`: innovation
(O-B) and residual (O-A) statistics and the chi-square consistency ratio

    chi2 = mean( (y - xa)^2 / (Sa + So) )

which should be ~1 when the prescribed error variances are consistent.
The Desroziers estimators are not ported (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["InnovationStats", "innovation_stats"]


class InnovationStats(NamedTuple):
    n: torch.Tensor  # cells with all inputs finite
    omb_mean: torch.Tensor  # mean(y - xa)        (bias of the prior)
    omb_rms: torch.Tensor  # rms(y - xa)
    oma_mean: torch.Tensor  # mean(y - xb)        (bias of the posterior)
    oma_rms: torch.Tensor  # rms(y - xb)
    chi2: torch.Tensor  # mean((y-xa)^2 / (Sa+So)) -- expect ~1


def _masked_mean(x, m):
    c = m.sum()
    mean = torch.where(m, x, torch.zeros_like(x)).sum() / c
    return torch.where(c > 0, mean, torch.full_like(mean, math.nan))


def innovation_stats(xa, y, xb, sa, so) -> InnovationStats:
    """All inputs one shape; NaN cells excluded from every statistic."""
    m = (torch.isfinite(xa) & torch.isfinite(y) & torch.isfinite(xb)
         & torch.isfinite(sa) & torch.isfinite(so))
    omb = y - xa
    oma = y - xb
    denom = sa + so
    ratio = omb * omb / denom
    chi = torch.where(denom > 0, ratio, torch.full_like(ratio, math.nan))
    mchi = m & torch.isfinite(chi)
    return InnovationStats(
        n=m.sum(),
        omb_mean=_masked_mean(omb, m),
        omb_rms=torch.sqrt(_masked_mean(omb * omb, m)),
        oma_mean=_masked_mean(oma, m),
        oma_rms=torch.sqrt(_masked_mean(oma * oma, m)),
        chi2=_masked_mean(chi, mchi),
    )
