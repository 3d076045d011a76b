"""Vertical observation operators, batched over grid cells, on torch tensors.

Counterpart of :mod:`oisat_tpu.ops.vertical` (reference
oisatgmi/amf_recal.py:51-56, :93-119, :160-183, ak_conv_mopitt.py:118-146,
ak_conv_gosat.py:118-141, pwv_cal.py:64-98): the per-pixel scipy
``interp1d`` loop becomes one column-wise log-pressure interpolation over the
whole grid, and the level sums are NaN-masked reductions.

Level stacks carry the level axis third from last: (L, H, W) for one
granule, (G, L, H, W) for a granule batch (the JAX package's ``vmap``
becomes that explicit leading axis); 2-D fields are (H, W) / (G, H, W).

Physical constants match the reference: Mair = 28.97e-3 kg/mol,
g = 9.80665 m/s^2, N_A = 6.02214076e23.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MAIR", "GRAV", "N_A", "partial_column", "air_partial_column",
           "interp_linear_batched", "amf_recal_fields", "amf_recal_noak_fields",
           "ak_conv_mopitt_fields", "ak_conv_gosat_fields", "pwv_fields"]

MAIR = 28.97e-3
GRAV = 9.80665
N_A = 6.02214076e23


def _div(x, d: float):
    """``x / d`` as an IEEE quotient on every device.  torch divides a CUDA
    tensor by a Python number as a product with the number's reciprocal,
    which can be an ulp off numpy's quotient; a 0-dim divisor on the
    tensor's own device takes the true division (and no copy)."""
    if torch.is_tensor(x):
        return x / torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d


def partial_column(delta_p, profile_ppbv):
    """CTM gas partial column [1e15 molec/cm^2] from delta-p [hPa] and ppbv
    (numpy arrays or tensors; reference amf_recal.py:51-56).  The same IEEE
    operations in the same order on either: float64 tensors give numpy's
    float64 result bitwise, on the CPU and on the card."""
    return _div(_div(delta_p * profile_ppbv, GRAV), MAIR) * N_A * 1e-4 * 1e-15 * 100.0 * 1e-9


def air_partial_column(delta_p):
    """Air partial column [1e15 molec/cm^2] from delta-p [hPa] (numpy arrays
    or tensors; reference ak_conv_mopitt.py:66), bitwise numpy's on any
    device as :func:`partial_column`."""
    return _div(_div(delta_p, GRAV), MAIR) * N_A * 1e-4 * 1e-15 * 100.0


def _nan_like(x):
    return torch.full_like(x, math.nan)


def interp_linear_batched(xp, fp, xq, extrapolate: bool):
    """Column-wise linear interpolation, batched over trailing grid axes.

    ``xp``/``fp``: (Ls, ...) source abscissae/values; ``xq``: (Lt, ...)
    query abscissae.  scipy ``interp1d`` semantics as in the JAX twin:
    columns in either monotonic order, ``extrapolate=True`` extends the end
    segments, ``False`` fills NaN outside the data range.  A column with any
    non-finite or non-monotonic abscissa is NaN as a whole -- the documented
    deviation of oisat_tpu/ops/vertical.py:102-115.

    Bracketing is ``searchsorted`` on the ascending copy of each column (a
    descending column is flipped first) plus ``gather``.
    """
    dt = torch.promote_types(xp.dtype, xq.dtype)
    xp = torch.movedim(xp, 0, -1).to(dt)  # (..., Ls)
    fp = torch.movedim(fp, 0, -1)
    xq = torch.movedim(xq, 0, -1).to(dt)  # (..., Lt)
    ls = xp.shape[-1]
    desc = xp[..., :1] > xp[..., -1:]
    xs = torch.where(desc, xp.flip(-1), xp).contiguous()
    fs = torch.where(desc, fp.flip(-1), fp)
    # searchsorted(right) on the ascending column: the number of xp <= xq
    cnt = torch.searchsorted(xs, xq.contiguous(), right=True)
    hi = cnt.clamp(1, ls - 1)
    lo = hi - 1
    x0 = xs.gather(-1, lo)
    x1 = xs.gather(-1, hi)
    f0 = fs.gather(-1, lo)
    f1 = fs.gather(-1, hi)
    t = (xq - x0) / (x1 - x0)
    out = f0 + t * (f1 - f0)
    if not extrapolate:
        # data range = the endpoint pair, whichever order the column runs
        lo_end = torch.minimum(xp[..., :1], xp[..., -1:])
        hi_end = torch.maximum(xp[..., :1], xp[..., -1:])
        out = torch.where((xq < lo_end) | (xq > hi_end), _nan_like(out), out)
    step = torch.diff(xp, dim=-1)
    colbad = ~((step >= 0).all(-1, keepdim=True) | (step <= 0).all(-1, keepdim=True))
    colbad |= ~torch.isfinite(xp).all(-1, keepdim=True)
    out = torch.where(colbad, _nan_like(out), out)
    return torch.movedim(out, -1, 0)


def _nansum_levels(x):
    """nansum over the level axis (-3) with numpy semantics (all-NaN -> 0)."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x).sum(-3)


def amf_recal_fields(sat_pmid, sat_sw, ctm_pmid, ctm_pc, tropopause, vcd,
                     amf_old, has_trop: bool):
    """AMF recalculation over the grid (reference amf_recal.py:93-119, :173-183).

    sat_pmid/sat_sw: ([G,] Ls, H, W); ctm_pmid/ctm_pc: ([G,] Lc, H, W);
    tropopause/vcd/amf_old: ([G,] H, W).  Returns (new_amf, vcd_corrected,
    model_vcd) with the reference's NaN masking applied."""
    sw_i = interp_linear_batched(torch.log(sat_pmid).movedim(-3, 0),
                                 sat_sw.movedim(-3, 0),
                                 torch.log(ctm_pmid).movedim(-3, 0),
                                 extrapolate=True).movedim(0, -3)
    sw_i = torch.where(torch.isinf(sw_i), torch.zeros_like(sw_i), sw_i)
    pc = ctm_pc
    if has_trop:
        above = ctm_pmid < tropopause.unsqueeze(-3)
        sw_i = torch.where(above, _nan_like(sw_i), sw_i)
        pc = torch.where(above, _nan_like(pc), pc)
    scd = _nansum_levels(sw_i * pc)
    model_vcd = _nansum_levels(pc)
    ratio = scd / model_vcd
    new_amf = torch.where(model_vcd != 0, ratio, _nan_like(ratio))
    new_amf = torch.where(torch.isnan(vcd), _nan_like(new_amf), new_amf)
    vcd_corr = amf_old * vcd / new_amf
    # NaN vcd is subsumed: vcd NaN -> vcd_corr NaN -> masked here
    model_vcd = torch.where(torch.isnan(vcd_corr) | torch.isinf(vcd_corr),
                            _nan_like(model_vcd), model_vcd)
    return new_amf, vcd_corr, model_vcd


def amf_recal_noak_fields(ctm_pmid, ctm_pc, tropopause, vcd, has_trop: bool):
    """No-scattering-weights branch (reference amf_recal.py:160-171):
    tropopause-mask the partial columns, sum, NaN where the retrieval is NaN."""
    pc = ctm_pc
    if has_trop:
        pc = torch.where(ctm_pmid < tropopause.unsqueeze(-3), _nan_like(pc), pc)
    model_vcd = _nansum_levels(pc)
    return torch.where(torch.isnan(vcd), _nan_like(model_vcd), model_vcd)


def _at_least_f32(*tensors):
    """float16 inputs computed in float32; float32 and float64 stay."""
    return tuple(t.to(torch.float32) if t.dtype == torch.float16 else t for t in tensors)


def _interp_levels(xp, fp, xq, extrapolate: bool):
    """:func:`interp_linear_batched` for stacks whose level axis is -3."""
    return interp_linear_batched(xp.movedim(-3, 0), fp.movedim(-3, 0), xq.movedim(-3, 0),
                                 extrapolate).movedim(0, -3)


def ak_conv_mopitt_fields(ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks, aprior_col,
                          apriori_profile, apriori_surface, vcd):
    """MOPITT averaging-kernel convolution (reference ak_conv_mopitt.py:118-146).

    ctm_pmid/ctm_profile/ctm_airpc: ([G,] Lc, H, W); sat_pmid/apriori_profile:
    ([G,] Ls, H, W); aks: ([G,] Ls+1, H, W) with the surface row first;
    aprior_col/apriori_surface/vcd: ([G,] H, W).  Returns (model_vcd,
    model_xcol [ppmv]): ``model_vcd`` is NaN where ``vcd`` is NaN or inf,
    ``model_xcol`` only where it is NaN, as in the reference."""
    (ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks,
     apriori_profile) = _at_least_f32(ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks,
                                      apriori_profile)
    prof_i = _interp_levels(torch.log(ctm_pmid), ctm_profile, torch.log(sat_pmid),
                            extrapolate=False)
    dlog = torch.log10(prof_i) - torch.log10(apriori_profile)
    profile_component = aprior_col + _nansum_levels(aks[..., 1:, :, :] * dlog)
    surface_component = aks[..., 0, :, :] * (torch.log10(ctm_profile[..., 0, :, :])
                                             - torch.log10(apriori_surface))
    model_vcd = profile_component + surface_component
    model_xcol = 1e6 * model_vcd / _nansum_levels(ctm_airpc)
    model_vcd = torch.where(torch.isnan(vcd) | torch.isinf(vcd), _nan_like(model_vcd),
                            model_vcd)
    model_xcol = torch.where(torch.isnan(vcd), _nan_like(model_xcol), model_xcol)
    return model_vcd, model_xcol


def ak_conv_gosat_fields(ctm_pmid, ctm_profile, sat_pmid, aks, apriori_profile,
                         pressure_weight, x_col):
    """GOSAT XCH4 averaging-kernel convolution (reference ak_conv_gosat.py:118-141).

    ctm_pmid/ctm_profile: ([G,] Lc, H, W); sat_pmid/aks/apriori_profile/
    pressure_weight: ([G,] Ls, H, W); x_col: ([G,] H, W).  Returns
    model_xcol [ppbv], NaN where the retrieval ``x_col`` is NaN or inf; a
    column whose every level is masked (``<= 0`` or NaN) sums to 0."""
    (ctm_pmid, ctm_profile, sat_pmid, aks, apriori_profile,
     pressure_weight) = _at_least_f32(ctm_pmid, ctm_profile, sat_pmid, aks,
                                      apriori_profile, pressure_weight)
    prof_i = _interp_levels(torch.log(ctm_pmid), ctm_profile, torch.log(sat_pmid),
                            extrapolate=True)
    temp = apriori_profile + (prof_i - apriori_profile) * aks
    temp = temp * pressure_weight
    temp = torch.where(temp <= 0, _nan_like(temp), temp)
    model_xcol = _nansum_levels(temp)
    return torch.where(torch.isinf(x_col) | torch.isnan(x_col), _nan_like(model_xcol),
                       model_xcol)


def pwv_fields(pc, vcd):
    """Precipitable water vapor [mm] (reference pwv_cal.py:64-98): ``pc``
    ([G,] Lc, H, W) is the water partial column ``dp * q / g / 1e4``;
    PWV = nansum(pc / 1e3), NaN where the satellite ``vcd`` is NaN or inf."""
    (pc,) = _at_least_f32(pc)
    pwv = _nansum_levels(pc / 1000.0)
    return torch.where(torch.isnan(vcd) | torch.isinf(vcd), _nan_like(pwv), pwv)
