"""The end-to-end month analysis (operator -> averaging -> bias -> OI).

Counterpart of :mod:`oisat_tpu.parallel.analysis` for one device:
:func:`full_month_step` takes a month of stacked granule fields and the
matched CTM slices and returns the whole analysis, the on-device compute of
a reference month job for an AMF sensor.  No mesh, padding or jit caches:
PyTorch runs the step eagerly on the tensors' device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from oisat_tpu_torch.ops.averaging import monthly_stats, monthly_stats_weighted
from oisat_tpu_torch.ops.diagnostics import InnovationStats, innovation_stats
from oisat_tpu_torch.ops.oi import OIResult, oi, regularization_grid
from oisat_tpu_torch.ops.vertical import amf_recal_fields

__all__ = ["AnalysisInputs", "AnalysisOutputs", "FullMonthInputs",
           "analysis_step", "full_month_step"]

# Cell-levels of one AMF-recal chunk.  The interpolation holds a few
# (chunk, H, W, Lc) temporaries (int64 brackets + four gathers); a whole
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


def _granule_weights_traced(weighting, uncertainty):
    """Per-granule per-cell weights from the stacked month: the formulas of
    :func:`oisat_tpu.parallel.analysis._granule_weights_traced`.

    "inverse_variance": w = 1/sigma^2 where sigma > 0, else NaN (excluded).
    "ak" needs averaging-kernel granules, which the port does not carry yet
    (ROADMAP queue 1 item 9)."""
    if weighting is None:
        return None
    if weighting == "inverse_variance":
        err2 = uncertainty.to(torch.float32) ** 2
        inv = 1.0 / err2
        return torch.where(err2 > 0, inv, torch.full_like(inv, math.nan))
    if weighting == "ak":
        raise NotImplementedError("weighting='ak' needs averaging-kernel granules "
                                  "(MOPITT/GOSAT), not ported yet: ROADMAP queue 1 item 9")
    raise ValueError(f"unknown weighting {weighting!r}")


def analysis_step(inputs: AnalysisInputs, bias_offset: float = 0.0,
                  bias_slope: float = 1.0, error_ctm: float = 50.0,
                  ctm_scale: float = 1.0, weights=None,
                  curve_impl: str = "auto", run_oi: bool = True) -> AnalysisOutputs:
    """Monthly average + bias correction + OI update + innovation stats.

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
    xa, y = ctm_vcd, sat_vcd
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


def _amf_recal_month(inputs: FullMonthInputs):
    """amf_recal_fields over the granule axis, in chunks (see
    ``_AMF_CHUNK_CELL_LEVELS``); returns (new_amf, vcd_corr, model_vcd)."""
    g = inputs.vcd.shape[0]
    per_granule = inputs.ctm_pmid[0].numel() if g else 1
    step = max(1, _AMF_CHUNK_CELL_LEVELS // max(per_granule, 1))
    parts = []
    for s in range(0, g, step):
        sl = slice(s, s + step)
        parts.append(amf_recal_fields(inputs.sat_pmid[sl], inputs.sat_sw[sl],
                                      inputs.ctm_pmid[sl], inputs.ctm_pc[sl],
                                      inputs.tropopause[sl], inputs.vcd[sl],
                                      inputs.amf[sl], True))
    return tuple(torch.cat(p) for p in zip(*parts))


def full_month_step(inputs: FullMonthInputs, bias_offset: float = 0.0,
                    bias_slope: float = 1.0, error_ctm: float = 50.0,
                    ctm_scale: float = 1.0, weighting=None,
                    curve_impl: str = "auto", run_oi: bool = True) -> AnalysisOutputs:
    """AMF recalculation per granule + monthly statistics + bias correction
    + OI for a whole month (:func:`oisat_tpu.parallel.analysis.full_month_step`).

    ``weighting`` ("inverse_variance" or None) enables the weighted
    temporal mean; ``run_oi`` as in :func:`analysis_step`.  Granules without
    a tropopause pass zeros, which never mask a level (pmid < 0 never
    holds)."""
    new_amf, vcd_corr, model_vcd = _amf_recal_month(inputs)
    ai = AnalysisInputs(vcd=vcd_corr, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=new_amf, aux2=inputs.amf)
    return analysis_step(ai, bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale,
                         weights=_granule_weights_traced(weighting,
                                                         inputs.uncertainty),
                         curve_impl=curve_impl, run_oi=run_oi)
