"""The end-to-end month analysis (operator -> averaging -> bias -> OI).

Counterpart of :mod:`oisat_tpu.parallel.analysis`: a month step takes a
month of stacked granule fields and the matched CTM slices and returns the
whole analysis, the on-device compute of a reference month job:
:func:`full_month_step` for an AMF sensor, :func:`mopitt_month_step` and
:func:`gosat_month_step` for the averaging-kernel sensors,
:func:`ssmis_month_step` for SSMIS water vapour.  PyTorch runs the step
eagerly on the tensors' device; the input tuples carry the dense fields only
(no carrier-level tables).

The makers (:func:`make_full_month_step`, ...) run the same steps over a
:class:`~oisat_tpu_torch.parallel.mesh.Mesh` of (obs, grid) positions: block
(i, j) holds granules i and grid rows j on ``mesh.devices[i][j]``, split
unevenly with no padding.  The observation operator and the averaging sums
run per block; the sums are added over 'obs' in order onto
``devices[0][j]``; the bias correction and the OI run per grid shard (one
curve launch per shard, one fixed-order total, one knee); the outputs, and
the daily granules in granule order, are concatenated on
``devices[0][0]``.  A single-device step is the one-block case of the same
code, so a 1 x 1 mesh gives it bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from oisat_tpu_torch.ops.averaging import (
    monthly_finish,
    monthly_finish_weighted,
    monthly_partials,
    monthly_partials_weighted,
    nanmean,
)
from oisat_tpu_torch.ops.diagnostics import (
    InnovationStats,
    innovation_finish,
    innovation_partials,
)
from oisat_tpu_torch.ops.oi import OIResult, gather_oi, oi_sharded, regularization_grid
from oisat_tpu_torch.parallel.mesh import gather, sum_in_order
from oisat_tpu_torch.ops.vertical import (
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    amf_recal_fields,
    pwv_fields,
)

__all__ = ["AnalysisInputs", "AnalysisOutputs", "DailyGranules", "FullMonthInputs",
           "MopittMonthInputs", "GosatMonthInputs", "SsmisMonthInputs",
           "analysis_step", "full_month_step", "mopitt_month_step",
           "gosat_month_step", "ssmis_month_step", "over_granule_chunks",
           "make_analysis_step", "make_full_month_step", "make_mopitt_month_step",
           "make_gosat_month_step", "make_ssmis_month_step", "MONTH_MAKERS"]

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


def _analyze_blocks(blocks, out_device, bias_offset: float = 0.0, bias_slope: float = 1.0,
                    error_ctm: float = 50.0, gosat_mode: bool = False, ctm_scale: float = 1.0,
                    run_oi: bool = True) -> AnalysisOutputs:
    """Averaging + bias + OI + innovation statistics of a month split into
    blocks: ``blocks[i][j]`` is ``(AnalysisInputs, weights or None)`` for
    granule block i and grid-row shard j, all on one device.  The averaging
    sums of each shard are added over i in order on block (0, j)'s device;
    the OI and the innovation sums run per shard (the sums added in shard
    order); the outputs are concatenated along the rows on ``out_device``."""
    weighted = blocks[0][0][1] is not None
    stats = []
    for j in range(len(blocks[0])):
        if weighted:
            parts = [monthly_partials_weighted(*row[j][0], row[j][1]) for row in blocks]
            stats.append(monthly_finish_weighted(sum_in_order(parts)))
        else:
            parts = [monthly_partials(*row[j][0]) for row in blocks]
            stats.append(monthly_finish(sum_in_order(parts)))
    sat_vcd = [(st.sat_vcd - bias_offset) / bias_slope for st in stats]
    ctm_vcd = [st.ctm_vcd * ctm_scale for st in stats]
    if gosat_mode:
        xa, y = [st.aux2 for st in stats], [st.aux1 for st in stats]
    else:
        xa, y = ctm_vcd, sat_vcd
    sa = [(x * error_ctm / 100.0) ** 2 for x in xa]
    so = [st.sat_error**2 for st in stats]

    def rows(fields):
        return gather(fields, out_device, 0)

    if run_oi:
        shards = oi_sharded(xa, y, sa, so, regularization_on=True)
        sf, innov = [], []
        for xa_s, y_s, sa_s, so_s, res in zip(xa, y, sa, so, shards):
            f = res.xb / xa_s
            sf.append(torch.where(torch.isnan(f) | torch.isinf(f) | (f == 0.0),
                                  torch.ones_like(f), f))
            # diagnostics on the y the OI actually assimilated (its y<0 -> 0 clamp)
            y_assim = torch.where(y_s < 0, torch.zeros_like(y_s), y_s)
            innov.append(innovation_partials(xa_s, y_assim, res.xb, sa_s, so_s))
        res = gather_oi(shards, out_device)
        sf = rows(sf)
        innov = InnovationStats(*(v.to(out_device)
                                  for v in innovation_finish(sum_in_order(innov))))
    else:
        xa_all = rows(xa)
        nanf = torch.full_like(xa_all, math.nan)
        z = torch.tensor(math.nan, dtype=xa_all.dtype, device=out_device)
        res = OIResult(xb=nanf, averaging_kernel=nanf, increment=nanf, error=nanf,
                       reg_index=torch.tensor(-1, dtype=torch.int32, device=out_device),
                       reg_factor=z,
                       curve=torch.full(regularization_grid().shape, math.nan,
                                        dtype=xa_all.dtype, device=out_device))
        sf = torch.ones_like(xa_all)
        innov = InnovationStats(n=torch.tensor(0, device=out_device), omb_mean=z,
                                omb_rms=z, oma_mean=z, oma_rms=z, chi2=z)
    return AnalysisOutputs(sat_vcd=rows(sat_vcd), sat_error=rows([st.sat_error for st in stats]),
                           ctm_vcd=rows(ctm_vcd), aux1=rows([st.aux1 for st in stats]),
                           aux2=rows([st.aux2 for st in stats]), oi=res,
                           scaling_factor=sf, innovation=innov)


def analysis_step(inputs: AnalysisInputs, bias_offset: float = 0.0,
                  bias_slope: float = 1.0, error_ctm: float = 50.0,
                  gosat_mode: bool = False, ctm_scale: float = 1.0, weights=None,
                  run_oi: bool = True) -> AnalysisOutputs:
    """Monthly average + bias correction + OI update + innovation stats.

    ``gosat_mode``: the OI and the innovation statistics run on the xcol
    pair (prior ``aux2``, observation ``aux1``; reference driver.py:112-114).

    ``ctm_scale`` rescales the averaged CTM column before the OI (the O3
    DU conversion); ``weights`` (G, H, W) selects the weighted temporal
    statistics.

    ``run_oi=False`` skips the OI stage for callers that run their own OI
    afterwards (``oi_method="full"``): the ``oi`` slot carries NaN fields
    with ``reg_index`` -1 and ``reg_factor`` NaN, the innovation statistics
    are NaN with n = 0 and the scaling factor is all ones, as in
    :func:`oisat_tpu.parallel.analysis.analysis_step`."""
    return _analyze_blocks([[(inputs, weights)]], inputs.vcd.device, bias_offset=bias_offset,
                           bias_slope=bias_slope, error_ctm=error_ctm, gosat_mode=gosat_mode,
                           ctm_scale=ctm_scale, run_oi=run_oi)


def over_granule_chunks(fn, tensors, extra=()):
    """``fn(*chunk_of_each_tensor, *extra)`` over the leading granule axis in
    chunks of at most ``_AMF_CHUNK_CELL_LEVELS`` elements of the largest
    tensor; ``fn`` returns a tensor or a tuple of tensors, concatenated back
    along the granule axis.  No granules: one call on the empty tensors."""
    g = tensors[0].shape[0]
    per_granule = max(t[0].numel() for t in tensors) if g else 1
    step = max(1, _AMF_CHUNK_CELL_LEVELS // max(per_granule, 1))
    parts = [fn(*(t[s:s + step] for t in tensors), *extra) for s in range(0, max(g, 1), step)]
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


# Each operator takes one block of a month and the weighting and returns
# (AnalysisInputs, the daily files' satellite VCD, the temporal weights).

def _analysis_operator(inputs: AnalysisInputs, weighting):
    return inputs, inputs.vcd, _granule_weights_traced(weighting, inputs.uncertainty)


def _full_operator(inputs: FullMonthInputs, weighting):
    new_amf, vcd_corr, model_vcd = _amf_recal_month(inputs)
    ai = AnalysisInputs(vcd=vcd_corr, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=new_amf, aux2=inputs.amf)
    return ai, vcd_corr, _granule_weights_traced(weighting, inputs.uncertainty)


def _mopitt_operator(inputs: MopittMonthInputs, weighting):
    model_vcd, model_xcol = over_granule_chunks(
        ak_conv_mopitt_fields,
        (inputs.ctm_pmid, inputs.ctm_profile, inputs.ctm_airpc, inputs.sat_pmid,
         inputs.aks, inputs.aprior_col, inputs.apriori_profile,
         inputs.apriori_surface, inputs.vcd))
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=inputs.x_col, aux2=model_xcol)
    return ai, inputs.vcd, _granule_weights_traced(weighting, inputs.uncertainty,
                                                   aks=inputs.aks)


def _gosat_operator(inputs: GosatMonthInputs, weighting):
    model_xcol = over_granule_chunks(
        ak_conv_gosat_fields,
        (inputs.ctm_pmid, inputs.ctm_profile, inputs.sat_pmid, inputs.aks,
         inputs.apriori_profile, inputs.pressure_weight, inputs.x_col))
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=torch.full_like(inputs.vcd, math.nan),
                        aux1=inputs.x_col, aux2=model_xcol)
    return ai, inputs.vcd, _granule_weights_traced(weighting, inputs.uncertainty,
                                                   aks=inputs.aks)


def _ssmis_operator(inputs: SsmisMonthInputs, weighting):
    pwv = over_granule_chunks(pwv_fields, (inputs.water_pc, inputs.vcd))
    nanlike = torch.full_like(inputs.vcd, math.nan)
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=pwv, aux1=nanlike, aux2=nanlike)
    return ai, inputs.vcd, _granule_weights_traced(weighting, inputs.uncertainty)


def _month_blocks(operator, blocks, out_device, weighting=None,
                  return_granules: bool = False, **analysis_kw):
    """The operator on every block, then :func:`_analyze_blocks`; with
    ``return_granules`` also the :class:`DailyGranules` of every block,
    concatenated on ``out_device`` in granule order."""
    ops = [[operator(b, weighting) for b in row] for row in blocks]
    out = _analyze_blocks([[(ai, w) for ai, _, w in row] for row in ops], out_device,
                          **analysis_kw)
    if not return_granules:
        return out

    def whole(pick):
        return gather([gather([pick(o) for o in row], out_device, -2) for row in ops],
                      out_device, 0)

    return out, DailyGranules(vcd=whole(lambda o: o[1]), ctm_vcd=whole(lambda o: o[0].ctm_vcd),
                              uncertainty=whole(lambda o: o[0].uncertainty))


def full_month_step(inputs: FullMonthInputs, bias_offset: float = 0.0,
                    bias_slope: float = 1.0, error_ctm: float = 50.0,
                    ctm_scale: float = 1.0, weighting=None,
                    return_granules: bool = False, run_oi: bool = True):
    """AMF recalculation per granule + monthly statistics + bias correction
    + OI for a whole month (:func:`oisat_tpu.parallel.analysis.full_month_step`).

    ``weighting`` ("inverse_variance" or None) enables the weighted
    temporal mean; ``run_oi`` as in :func:`analysis_step`;
    ``return_granules=True`` returns ``(outputs, DailyGranules)``.  Granules
    without a tropopause pass zeros, which never mask a level (pmid < 0
    never holds)."""
    return _month_blocks(_full_operator, [[inputs]], inputs.vcd.device, weighting,
                         return_granules, bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale, run_oi=run_oi)


def mopitt_month_step(inputs: MopittMonthInputs, bias_offset: float = 0.0,
                      bias_slope: float = 1.0, error_ctm: float = 50.0,
                      ctm_scale: float = 1.0, weighting=None,
                      return_granules: bool = False, run_oi: bool = True):
    """AK convolution + averaging + OI for a MOPITT month (reference
    driver.py:45-51 conv_ak + :108-111 oi); aux1/aux2 are the retrieved and
    the model xcol.  ``weighting`` may also be "ak"."""
    return _month_blocks(_mopitt_operator, [[inputs]], inputs.vcd.device, weighting,
                         return_granules, bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale, run_oi=run_oi)


def gosat_month_step(inputs: GosatMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     return_granules: bool = False, run_oi: bool = True):
    """AK convolution + averaging + xcol-pair OI for a GOSAT month (reference
    ak_conv_gosat.py:8-146); the model VCD stays NaN (:138), in the daily
    granules too."""
    return _month_blocks(_gosat_operator, [[inputs]], inputs.vcd.device, weighting,
                         return_granules, bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, gosat_mode=True, ctm_scale=ctm_scale,
                         run_oi=run_oi)


def ssmis_month_step(inputs: SsmisMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     return_granules: bool = False, run_oi: bool = True):
    """PWV + averaging + OI for an SSMIS month; aux1/aux2 are NaN."""
    return _month_blocks(_ssmis_operator, [[inputs]], inputs.vcd.device, weighting,
                         return_granules, bias_offset=bias_offset, bias_slope=bias_slope,
                         error_ctm=error_ctm, ctm_scale=ctm_scale, run_oi=run_oi)


# ---------------------------------------------------------------------------
# the makers: the steps over a mesh
# ---------------------------------------------------------------------------

class _ShardedMonth(NamedTuple):
    """``shard_inputs`` output: ``blocks[i][j]`` is the month-input tuple of
    granule block i and grid-row shard j, on the mesh's device (i, j)."""

    blocks: tuple


def _make_month_step(operator, fields_cls, mesh, gosat_mode: bool, kwargs):
    """``(fn, shard_inputs)`` of a month step over ``mesh``, as the JAX
    maker returns.  ``shard_inputs`` splits every field's granule axis (0)
    over 'obs' and its row axis (-2) over 'grid' with ``torch.tensor_split``
    (uneven, no padding) and puts block (i, j) on ``mesh.devices[i][j]``: a
    block already there is a view of the input.  ``fn`` takes the sharded
    month (or an unsharded one, which it shards first) and returns what the
    single-device step returns, on ``mesh.devices[0][0]``.  Each grid
    shard's curve runs on its device's engine (the kernel on a CUDA shard,
    the plain version on a CPU shard)."""
    kwargs = dict(kwargs)
    weighting = kwargs.pop("weighting", None)
    return_granules = kwargs.pop("return_granules", False)
    kwargs.setdefault("gosat_mode", gosat_mode)
    n_obs, n_grid = mesh.shape[mesh.axis_names[0]], mesh.shape[mesh.axis_names[1]]

    def shard_inputs(inputs) -> _ShardedMonth:
        split = [[torch.tensor_split(part, n_grid, dim=-2)
                  for part in torch.tensor_split(f, n_obs, dim=0)] for f in inputs]
        return _ShardedMonth(tuple(
            tuple(fields_cls(*(split[k][i][j].to(mesh.devices[i][j])
                               for k in range(len(split))))
                  for j in range(n_grid))
            for i in range(n_obs)))

    def fn(inputs):
        if not isinstance(inputs, _ShardedMonth):
            inputs = shard_inputs(inputs)
        return _month_blocks(operator, inputs.blocks, mesh.devices[0][0], weighting,
                             return_granules, **kwargs)

    return fn, shard_inputs


def make_analysis_step(mesh, **kwargs):
    """:func:`analysis_step` over ``mesh``: ``(fn, shard_inputs)`` (see
    :func:`_make_month_step`); ``kwargs`` are the step's scalar keywords."""
    return _make_month_step(_analysis_operator, AnalysisInputs, mesh, False, kwargs)


def make_full_month_step(mesh, **kwargs):
    """:func:`full_month_step` over ``mesh``: granules split on 'obs', grid
    rows on 'grid', levels whole.  ``kwargs`` are the step's keywords."""
    return _make_month_step(_full_operator, FullMonthInputs, mesh, False, kwargs)


def make_mopitt_month_step(mesh, **kwargs):
    """:func:`mopitt_month_step` over ``mesh``."""
    return _make_month_step(_mopitt_operator, MopittMonthInputs, mesh, False, kwargs)


def make_gosat_month_step(mesh, **kwargs):
    """:func:`gosat_month_step` over ``mesh`` (the xcol-pair OI)."""
    return _make_month_step(_gosat_operator, GosatMonthInputs, mesh, True, kwargs)


def make_ssmis_month_step(mesh, **kwargs):
    """:func:`ssmis_month_step` over ``mesh``."""
    return _make_month_step(_ssmis_operator, SsmisMonthInputs, mesh, False, kwargs)


# the maker of each single-device month step (the driver's mesh path)
MONTH_MAKERS = {full_month_step: make_full_month_step,
                mopitt_month_step: make_mopitt_month_step,
                gosat_month_step: make_gosat_month_step,
                ssmis_month_step: make_ssmis_month_step}
