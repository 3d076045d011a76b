"""Temporal (monthly) statistics of granule stacks, on torch tensors.

Counterpart of :func:`oisat_tpu.ops.averaging.monthly_stats` and
:func:`~oisat_tpu.ops.averaging.monthly_stats_weighted` (reference
oisatgmi/averaging.py:11-24, :97-108): masked reductions over the leading
granule axis G of (G, H, W) stacks.

  * vcd:    inf->NaN scrub then nanmean
  * error:  sqrt( nansum(err^2) / N^2 )   (N = finite err^2 per cell)
  * ctm/aux fields: plain nanmean

Each statistic is a NaN-masked sum and a count (or weight sum) finished by a
division: :func:`monthly_partials` / :func:`monthly_partials_weighted` give
the sums of a block of granules, :func:`monthly_finish` /
:func:`monthly_finish_weighted` the statistics, and the single-device
functions are the two in turn, so a month split over granule blocks
(:mod:`oisat_tpu_torch.parallel.analysis`) shares their code.

:func:`averaging` is the staged, date-bucketing driver over a granule list
(reference averaging.py:26-120): the float64 granule stacks and every
reduction stay on the granules' device, and each month bucket's five fields
come back to the host in one copy.
"""

from __future__ import annotations

import datetime
import math
from typing import NamedTuple

import numpy as np
import torch

from oisat_tpu_torch._device import d2h, granule_device, h2d, size
from oisat_tpu_torch.datamodel import satellite_amf, satellite_opt

__all__ = ["MonthlyAverage", "StatsPartials", "monthly_stats", "monthly_stats_weighted",
           "monthly_partials", "monthly_partials_weighted", "monthly_finish",
           "monthly_finish_weighted", "averaging"]


class MonthlyAverage(NamedTuple):
    sat_vcd: torch.Tensor
    sat_error: torch.Tensor
    ctm_vcd: torch.Tensor
    aux1: torch.Tensor
    aux2: torch.Tensor


def _nan_like(x):
    return torch.full_like(x, math.nan)


def _inf_to_nan(x):
    return torch.where(torch.isinf(x), _nan_like(x), x)


class StatsPartials(NamedTuple):
    """Per-cell sums over a block of granules, the monthly statistics before
    their division: for each field of :class:`MonthlyAverage` its masked sum
    ``s`` and its norm ``n`` (the count, or with weights the weight sum).
    For the error ``s`` sums err^2 (weighted: w^2 err^2).  Blocks of one
    month's granules add leaf by leaf
    (:func:`oisat_tpu_torch.parallel.mesh.sum_in_order`)."""

    s: tuple
    n: tuple


def _masked_sum0(x, m):
    return torch.where(m, x, torch.zeros_like(x)).sum(0)


def monthly_partials(vcd, err, ctm, aux1, aux2) -> StatsPartials:
    """The sums of :func:`monthly_stats` over the granules of (G, H, W)
    stacks: NaN-masked sums and counts, vcd scrubbed of inf, the error as
    err^2."""
    s, n = [], []
    for x in (_inf_to_nan(vcd), _inf_to_nan(err**2), ctm, aux1, aux2):
        valid = ~torch.isnan(x)
        n.append(valid.sum(0))
        s.append(_masked_sum0(x, valid))
    return StatsPartials(tuple(s), tuple(n))


def monthly_finish(p: StatsPartials) -> MonthlyAverage:
    """:func:`monthly_stats` from the sums: means s / n, the error
    sqrt(s / n^2); NaN where n = 0."""
    def mean(s, c):
        m = s / c
        return torch.where(c > 0, m, _nan_like(m))

    s, n = p
    q = s[1] / (n[1] * n[1])
    sat_error = torch.sqrt(torch.where(n[1] > 0, q, _nan_like(q)))
    return MonthlyAverage(sat_vcd=mean(s[0], n[0]), sat_error=sat_error,
                          ctm_vcd=mean(s[2], n[2]), aux1=mean(s[3], n[3]),
                          aux2=mean(s[4], n[4]))


def monthly_stats(vcd, err, ctm, aux1, aux2) -> MonthlyAverage:
    """All inputs (G, H, W); returns per-cell monthly statistics (H, W)."""
    return monthly_finish(monthly_partials(vcd, err, ctm, aux1, aux2))


def monthly_partials_weighted(vcd, err, ctm, aux1, aux2, w) -> StatsPartials:
    """The sums of :func:`monthly_stats_weighted` over the granules: for
    each mean the weight sum and the weighted sum of the cells where value
    and weight exist, for the error the weight sum and sum(w^2 err^2)."""
    w = torch.where(torch.isfinite(w) & (w > 0), w, _nan_like(w))
    err2 = _inf_to_nan(err**2)
    s, n = [], []
    for i, x in enumerate((_inf_to_nan(vcd), err2, ctm, aux1, aux2)):
        m = ~(torch.isnan(x) | torch.isnan(w))
        n.append(_masked_sum0(w, m))
        s.append(_masked_sum0(w * w * err2 if i == 1 else w * x, m))
    return StatsPartials(tuple(s), tuple(n))


def monthly_finish_weighted(p: StatsPartials) -> MonthlyAverage:
    """:func:`monthly_stats_weighted` from the sums: means s / sw, the error
    sqrt(sum(w^2 err^2)) / sw; NaN where sw = 0."""
    def wmean(sx, sw):
        r = sx / sw
        return torch.where(sw > 0, r, _nan_like(r))

    s, n = p
    e = torch.sqrt(s[1]) / n[1]
    sat_error = torch.where(n[1] > 0, e, _nan_like(e))
    return MonthlyAverage(sat_vcd=wmean(s[0], n[0]), sat_error=sat_error,
                          ctm_vcd=wmean(s[2], n[2]), aux1=wmean(s[3], n[3]),
                          aux2=wmean(s[4], n[4]))


def monthly_stats_weighted(vcd, err, ctm, aux1, aux2, w) -> MonthlyAverage:
    """Weighted temporal statistics; ``w`` (G, H, W) >= 0 per-granule
    per-cell weights.  Means are weighted; the error is the standard error
    of a weighted mean of independent errors, ``sqrt(sum(w^2 sigma^2)) /
    sum(w)``."""
    return monthly_finish_weighted(monthly_partials_weighted(vcd, err, ctm, aux1, aux2, w))


def nanmean(x, dim: int):
    """numpy ``nanmean`` along ``dim``: NaN where every entry is NaN."""
    valid = ~torch.isnan(x)
    c = valid.sum(dim)
    m = torch.where(valid, x, torch.zeros_like(x)).sum(dim) / c
    return torch.where(c > 0, m, _nan_like(m))


def _granule_weights(sel, weighting: str, err):
    """Per-granule per-cell weights (G, H, W) for the weighted temporal mean,
    as :func:`oisat_tpu.ops.averaging._granule_weights`.

    "inverse_variance": w = 1/sigma^2 from the stacked ``err``; cells with
    sigma <= 0 (no retrieval error available) get a NaN weight and drop out
    of the weighted mean.  "ak": the vertical mean of |averaging kernel| per
    cell, for optimal-estimation granules only."""
    if weighting == "inverse_variance":
        err2 = err**2
        return torch.where(err2 > 0, 1.0 / err2, _nan_like(err2))
    if weighting == "ak":
        if not all(isinstance(g, satellite_opt) for g in sel):
            raise ValueError("weighting='ak' needs averaging-kernel granules "
                             "(MOPITT/GOSAT); use 'inverse_variance' otherwise")
        return torch.stack([
            nanmean(torch.abs(h2d(g.averaging_kernels, err.device, torch.float64)), 0)
            for g in sel])
    raise ValueError(f"unknown weighting {weighting!r}")


def averaging(startdate: str, enddate: str, reader_obj, weighting=None):
    """Monthly averaging driver (reference averaging.py:26-120).

    Buckets the granules of ``reader_obj.sat_data`` by (year, month) of
    ``granule.time`` over the months of ``[startdate, enddate)``, stacks
    their fields in float64 on the granules' device and reduces there.
    Returns ``(sat_vcd, sat_error, ctm_vcd, aux1, aux2, avg_datetime)`` as
    host numpy, squeezed like the reference (a single month gives 2-D fields).

    aux1/aux2 are (new_amf, old_amf) for two-step granules and
    (x_col, ctm_xcol) for optimal-estimation granules (reference :82-87);
    otherwise NaN fields.  ``weighting`` ("inverse_variance" or "ak")
    selects :func:`monthly_stats_weighted`."""
    start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), int(startdate[8:10]))
    end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), int(enddate[8:10]))
    days = [start + datetime.timedelta(n) for n in range((end - start).days)]
    months = np.array([d.month for d in days])
    years = np.array([d.year for d in days])

    granules = [g for g in reader_obj.sat_data if g is not None]
    if not granules:
        raise ValueError("no valid satellite granules to average")
    hw = np.shape(granules[0].latitude_center)
    device = granule_device(granules[0])

    m0, m1 = months.min(), months.max()
    y0, y1 = years.min(), years.max()
    nm, ny = m1 - m0 + 1, y1 - y0 + 1
    # reference init: vcd zeros, the rest NaN (averaging.py:52-63)
    out = np.full((5,) + hw + (nm, ny), np.nan)
    out[0] = 0.0

    time_chosen = []
    for year in range(y0, y1 + 1):
        for month in range(m0, m1 + 1):
            sel = [g for g in granules if g.time.year == year and g.time.month == month]
            if not sel:
                continue
            # the returned time is the mean over every bucket's granules
            time_chosen.extend(g.time for g in sel)

            def f(name):
                return torch.stack([h2d(getattr(g, name), device, torch.float64)
                                    for g in sel])

            vcd, err, ctm = f("vcd"), f("uncertainty"), f("ctm_vcd")
            # > 1, not != 1: a granule that never went through recal_amf
            # carries the [] placeholder (size 0), not an AMF field
            if isinstance(sel[0], satellite_amf) and size(sel[0].new_amf) > 1:
                a1, a2 = f("new_amf"), f("old_amf")
            elif isinstance(sel[0], satellite_opt):
                a1, a2 = f("x_col"), f("ctm_xcol")
            else:
                a1 = a2 = _nan_like(vcd)
            if weighting is None:
                stats = monthly_stats(vcd, err, ctm, a1, a2)
            else:
                stats = monthly_stats_weighted(vcd, err, ctm, a1, a2,
                                               _granule_weights(sel, weighting, err))
            out[:, :, :, month - m0, year - y0] = d2h(torch.stack(stats))

    if not time_chosen:
        raise ValueError("no granules fall inside the averaging window")
    avg_ts = sum(t.timestamp() for t in time_chosen) / len(time_chosen)
    return tuple(o.squeeze() for o in out) + (datetime.datetime.fromtimestamp(avg_ts),)
