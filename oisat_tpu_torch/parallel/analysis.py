"""The end-to-end month analysis (operator -> averaging -> bias -> OI).

Counterpart of :mod:`oisat_tpu.parallel.analysis` for one device: a month
step takes a month of stacked granule fields and the matched CTM slices and
returns the whole analysis, the on-device compute of a reference month job:
:func:`full_month_step` for an AMF sensor, :func:`mopitt_month_step` and
:func:`gosat_month_step` for the averaging-kernel sensors,
:func:`ssmis_month_step` for SSMIS water vapour.  No mesh, padding or jit
caches: PyTorch runs the step eagerly on the tensors' device.  The input
tuples carry the dense fields only (no carrier-level tables).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from oisat_tpu_torch.ops.averaging import monthly_stats, monthly_stats_weighted, nanmean
from oisat_tpu_torch.ops.diagnostics import InnovationStats, innovation_stats
from oisat_tpu_torch.ops.oi import OIResult, oi, regularization_grid
from oisat_tpu_torch.ops.vertical import (
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    amf_recal_fields,
    pwv_fields,
)

__all__ = ["AnalysisInputs", "AnalysisOutputs", "DailyGranules", "FullMonthInputs",
           "MopittMonthInputs", "GosatMonthInputs", "SsmisMonthInputs",
           "analysis_step", "full_month_step", "mopitt_month_step",
           "gosat_month_step", "ssmis_month_step", "over_granule_chunks"]

# Cell-levels of one chunk of a vertical operator.  The interpolation holds a
# few (chunk, H, W, Lc) temporaries (int64 brackets + four gathers); a whole
# 60-orbit month on the 0.5x0.625 deg global grid is 60 * 207,936 * 72 ~ 9e8
# cell-levels, so the granule axis is processed in chunks of at most this
# many (~8 granules there), bounding the temporaries to a few GB.
_AMF_CHUNK_CELL_LEVELS = 1 << 27


class AnalysisInputs(NamedTuple):
    """Stacked monthly granule fields, all (G, H, W)."""

    vcd: torch.Tensor
    uncertainty: torch.Tensor
    ctm_vcd: torch.Tensor
    aux1: torch.Tensor
    aux2: torch.Tensor


class AnalysisOutputs(NamedTuple):
    sat_vcd: torch.Tensor  # bias-corrected monthly mean observation
    sat_error: torch.Tensor
    ctm_vcd: torch.Tensor  # prior
    aux1: torch.Tensor
    aux2: torch.Tensor
    oi: OIResult
    scaling_factor: torch.Tensor
    # innovation/chi2 diagnostics on the same clipped y the OI assimilated
    innovation: InnovationStats


class DailyGranules(NamedTuple):
    """Per-granule operator outputs (G, H, W), returned by the month steps
    with ``return_granules=True``: the fields the driver's daily files hold
    (reference driver.py:127-146): the post-operator satellite VCD, the
    matched model VCD and the retrieval error."""

    vcd: torch.Tensor
    ctm_vcd: torch.Tensor
    uncertainty: torch.Tensor


class FullMonthInputs(NamedTuple):
    """A whole month of gridded granules + the matched CTM slices; every
    field carries a leading granule axis G."""

    sat_pmid: torch.Tensor  # (G, Ls, H, W)
    sat_sw: torch.Tensor  # (G, Ls, H, W)
    vcd: torch.Tensor  # (G, H, W)
    amf: torch.Tensor  # (G, H, W)
    uncertainty: torch.Tensor  # (G, H, W)
    tropopause: torch.Tensor  # (G, H, W)
    ctm_pmid: torch.Tensor  # (G, Lc, H, W)
    ctm_pc: torch.Tensor  # (G, Lc, H, W)


class MopittMonthInputs(NamedTuple):
    """A month of gridded MOPITT granules + the matched daily CTM slices
    (reference ak_conv_mopitt.py:8-149 at month scale)."""

    ctm_pmid: torch.Tensor  # (G, Lc, H, W)
    ctm_profile: torch.Tensor  # (G, Lc, H, W)
    ctm_airpc: torch.Tensor  # (G, Lc, H, W)
    sat_pmid: torch.Tensor  # (G, Ls, H, W)
    aks: torch.Tensor  # (G, Ls+1, H, W)  surface row first
    apriori_profile: torch.Tensor  # (G, Ls, H, W)
    aprior_col: torch.Tensor  # (G, H, W)
    apriori_surface: torch.Tensor  # (G, H, W)
    vcd: torch.Tensor  # (G, H, W)
    x_col: torch.Tensor  # (G, H, W)
    uncertainty: torch.Tensor  # (G, H, W)


class GosatMonthInputs(NamedTuple):
    """A month of gridded GOSAT granules + the matched daily CTM slices.  The
    OI runs on the XCH4 pair (reference driver.py:112-114)."""

    ctm_pmid: torch.Tensor  # (G, Lc, H, W)
    ctm_profile: torch.Tensor  # (G, Lc, H, W)
    sat_pmid: torch.Tensor  # (G, Ls, H, W)
    aks: torch.Tensor  # (G, Ls, H, W)
    apriori_profile: torch.Tensor  # (G, Ls, H, W)
    pressure_weight: torch.Tensor  # (G, Ls, H, W)
    vcd: torch.Tensor  # (G, H, W)
    x_col: torch.Tensor  # (G, H, W)
    uncertainty: torch.Tensor  # (G, H, W)


class SsmisMonthInputs(NamedTuple):
    """A month of gridded SSMIS granules + the matched water partial columns
    (reference pwv_cal.py:7-101 at month scale)."""

    water_pc: torch.Tensor  # (G, Lc, H, W)  dp*q/g/1e4 on the analysis grid
    vcd: torch.Tensor  # (G, H, W)
    uncertainty: torch.Tensor  # (G, H, W)


def _granule_weights_traced(weighting, uncertainty, aks=None):
    """Per-granule per-cell weights from the stacked month: the formulas of
    :func:`oisat_tpu.parallel.analysis._granule_weights_traced`.

    "inverse_variance": w = 1/sigma^2 where sigma > 0, else NaN (excluded).
    "ak": the vertical nanmean of |averaging kernels| (G, L, H, W), for the
    averaging-kernel sensors only."""
    if weighting is None:
        return None
    if weighting == "inverse_variance":
        err2 = uncertainty.to(torch.float32) ** 2
        inv = 1.0 / err2
        return torch.where(err2 > 0, inv, torch.full_like(inv, math.nan))
    if weighting == "ak":
        if aks is None:
            raise ValueError("weighting='ak' needs averaging-kernel granules "
                             "(MOPITT/GOSAT); use 'inverse_variance' otherwise")
        return nanmean(torch.abs(aks.to(torch.float32)), 1)
    raise ValueError(f"unknown weighting {weighting!r}")


def analysis_step(inputs: AnalysisInputs, bias_offset: float = 0.0,
                  bias_slope: float = 1.0, error_ctm: float = 50.0,
                  gosat_mode: bool = False, ctm_scale: float = 1.0, weights=None,
                  curve_impl: str = "auto", run_oi: bool = True) -> AnalysisOutputs:
    """Monthly average + bias correction + OI update + innovation stats.

    ``gosat_mode``: the OI and the innovation statistics run on the xcol
    pair (prior ``aux2``, observation ``aux1``; reference driver.py:112-114).

    ``ctm_scale`` rescales the averaged CTM column before the OI (the O3
    DU conversion); ``weights`` (G, H, W) selects the weighted temporal
    statistics; ``curve_impl`` is passed to :func:`~oisat_tpu_torch.ops.oi.oi`.

    ``run_oi=False`` skips the OI stage for callers that run their own OI
    afterwards (``oi_method="full"``): the ``oi`` slot carries NaN fields
    with ``reg_index`` -1 and ``reg_factor`` NaN, the innovation statistics
    are NaN with n = 0 and the scaling factor is all ones, as in
    :func:`oisat_tpu.parallel.analysis.analysis_step`."""
    if weights is None:
        stats = monthly_stats(inputs.vcd, inputs.uncertainty, inputs.ctm_vcd,
                              inputs.aux1, inputs.aux2)
    else:
        stats = monthly_stats_weighted(inputs.vcd, inputs.uncertainty,
                                       inputs.ctm_vcd, inputs.aux1,
                                       inputs.aux2, weights)
    sat_vcd = (stats.sat_vcd - bias_offset) / bias_slope
    ctm_vcd = stats.ctm_vcd * ctm_scale
    xa, y = (stats.aux2, stats.aux1) if gosat_mode else (ctm_vcd, sat_vcd)
    sa = (xa * error_ctm / 100.0) ** 2
    so = stats.sat_error**2
    if run_oi:
        res = oi(xa, y, sa, so, regularization_on=True, curve_impl=curve_impl)
        sf = res.xb / xa
        sf = torch.where(torch.isnan(sf) | torch.isinf(sf) | (sf == 0.0),
                         torch.ones_like(sf), sf)
        # diagnostics on the y the OI actually assimilated (its y<0 -> 0 clamp)
        y_assim = torch.where(y < 0, torch.zeros_like(y), y)
        innov = innovation_stats(xa, y_assim, res.xb, sa, so)
    else:
        nanf = torch.full_like(xa, math.nan)
        z = torch.tensor(math.nan, dtype=xa.dtype, device=xa.device)
        res = OIResult(xb=nanf, averaging_kernel=nanf, increment=nanf, error=nanf,
                       reg_index=torch.tensor(-1, dtype=torch.int32, device=xa.device),
                       reg_factor=z,
                       curve=torch.full(regularization_grid().shape, math.nan,
                                        dtype=xa.dtype, device=xa.device))
        sf = torch.ones_like(xa)
        innov = InnovationStats(n=torch.tensor(0, device=xa.device), omb_mean=z,
                                omb_rms=z, oma_mean=z, oma_rms=z, chi2=z)
    return AnalysisOutputs(sat_vcd=sat_vcd, sat_error=stats.sat_error,
                           ctm_vcd=ctm_vcd, aux1=stats.aux1, aux2=stats.aux2,
                           oi=res, scaling_factor=sf, innovation=innov)


def over_granule_chunks(fn, tensors, extra=()):
    """``fn(*chunk_of_each_tensor, *extra)`` over the leading granule axis in
    chunks of at most ``_AMF_CHUNK_CELL_LEVELS`` elements of the largest
    tensor; ``fn`` returns a tensor or a tuple of tensors, concatenated back
    along the granule axis."""
    g = tensors[0].shape[0]
    per_granule = max(t[0].numel() for t in tensors) if g else 1
    step = max(1, _AMF_CHUNK_CELL_LEVELS // max(per_granule, 1))
    parts = [fn(*(t[s:s + step] for t in tensors), *extra) for s in range(0, g, step)]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _amf_recal_month(inputs: FullMonthInputs, has_trop: bool = True):
    """amf_recal_fields over the granule axis, in chunks; returns (new_amf,
    vcd_corr, model_vcd)."""
    return over_granule_chunks(
        amf_recal_fields,
        (inputs.sat_pmid, inputs.sat_sw, inputs.ctm_pmid, inputs.ctm_pc,
         inputs.tropopause, inputs.vcd, inputs.amf), (has_trop,))


def _finish_month(ai: AnalysisInputs, daily_vcd, return_granules: bool, **kw):
    """The shared tail of the month steps: :func:`analysis_step`, with the
    per-granule :class:`DailyGranules` beside it when asked for."""
    out = analysis_step(ai, **kw)
    if return_granules:
        return out, DailyGranules(vcd=daily_vcd, ctm_vcd=ai.ctm_vcd,
                                  uncertainty=ai.uncertainty)
    return out


def full_month_step(inputs: FullMonthInputs, bias_offset: float = 0.0,
                    bias_slope: float = 1.0, error_ctm: float = 50.0,
                    ctm_scale: float = 1.0, weighting=None,
                    curve_impl: str = "auto", return_granules: bool = False,
                    run_oi: bool = True):
    """AMF recalculation per granule + monthly statistics + bias correction
    + OI for a whole month (:func:`oisat_tpu.parallel.analysis.full_month_step`).

    ``weighting`` ("inverse_variance" or None) enables the weighted
    temporal mean; ``run_oi`` as in :func:`analysis_step`;
    ``return_granules=True`` returns ``(outputs, DailyGranules)``.  Granules
    without a tropopause pass zeros, which never mask a level (pmid < 0
    never holds)."""
    new_amf, vcd_corr, model_vcd = _amf_recal_month(inputs)
    ai = AnalysisInputs(vcd=vcd_corr, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=new_amf, aux2=inputs.amf)
    return _finish_month(ai, vcd_corr, return_granules,
                         bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale,
                         weights=_granule_weights_traced(weighting, inputs.uncertainty),
                         curve_impl=curve_impl, run_oi=run_oi)


def mopitt_month_step(inputs: MopittMonthInputs, bias_offset: float = 0.0,
                      bias_slope: float = 1.0, error_ctm: float = 50.0,
                      ctm_scale: float = 1.0, weighting=None,
                      curve_impl: str = "auto", return_granules: bool = False,
                      run_oi: bool = True):
    """AK convolution + averaging + OI for a MOPITT month (reference
    driver.py:45-51 conv_ak + :108-111 oi); aux1/aux2 are the retrieved and
    the model xcol.  ``weighting`` may also be "ak"."""
    model_vcd, model_xcol = over_granule_chunks(
        ak_conv_mopitt_fields,
        (inputs.ctm_pmid, inputs.ctm_profile, inputs.ctm_airpc, inputs.sat_pmid,
         inputs.aks, inputs.aprior_col, inputs.apriori_profile,
         inputs.apriori_surface, inputs.vcd))
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=inputs.x_col, aux2=model_xcol)
    return _finish_month(ai, inputs.vcd, return_granules,
                         bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale,
                         weights=_granule_weights_traced(weighting, inputs.uncertainty,
                                                         aks=inputs.aks),
                         curve_impl=curve_impl, run_oi=run_oi)


def gosat_month_step(inputs: GosatMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     curve_impl: str = "auto", return_granules: bool = False,
                     run_oi: bool = True):
    """AK convolution + averaging + xcol-pair OI for a GOSAT month (reference
    ak_conv_gosat.py:8-146); the model VCD stays NaN (:138), in the daily
    granules too."""
    model_xcol = over_granule_chunks(
        ak_conv_gosat_fields,
        (inputs.ctm_pmid, inputs.ctm_profile, inputs.sat_pmid, inputs.aks,
         inputs.apriori_profile, inputs.pressure_weight, inputs.x_col))
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=torch.full_like(inputs.vcd, math.nan),
                        aux1=inputs.x_col, aux2=model_xcol)
    return _finish_month(ai, inputs.vcd, return_granules,
                         bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, gosat_mode=True, ctm_scale=ctm_scale,
                         weights=_granule_weights_traced(weighting, inputs.uncertainty,
                                                         aks=inputs.aks),
                         curve_impl=curve_impl, run_oi=run_oi)


def ssmis_month_step(inputs: SsmisMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     curve_impl: str = "auto", return_granules: bool = False,
                     run_oi: bool = True):
    """PWV + averaging + OI for an SSMIS month; aux1/aux2 are NaN."""
    pwv = over_granule_chunks(pwv_fields, (inputs.water_pc, inputs.vcd))
    nanlike = torch.full_like(inputs.vcd, math.nan)
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=pwv, aux1=nanlike, aux2=nanlike)
    return _finish_month(ai, inputs.vcd, return_granules,
                         bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale,
                         weights=_granule_weights_traced(weighting, inputs.uncertainty),
                         curve_impl=curve_impl, run_oi=run_oi)
