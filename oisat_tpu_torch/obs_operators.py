"""Observation operators: CTM<->satellite matching (host) + batched operators (device).

Counterpart of :mod:`oisat_tpu.obs_operators` (reference ``amf_recal``
amf_recal.py:121-185, ``ak_conv_mopitt`` ak_conv_mopitt.py:8-149,
``ak_conv_gosat`` ak_conv_gosat.py:8-146, ``pwv_calculator``
pwv_cal.py:7-101): the same call signature (list of CTM granules, list of
gridded satellite granules, mutated in place and returned).  The CTM fields
are host numpy; the granules' fields are tensors on one device (the output
of the port's regrid).  Each distinct matched CTM slice is prepared once: its
arrays are copied to the granules' device as the reader hands them over, the
operator's float64 columns are derived from them there (bitwise the host's
numpy, :func:`_prepared`), and they are mapped onto the satellite grid there
when the granule is flagged ``ctm_upscaled_needed``.  Granules that share a
shape signature run through one batched call of
:mod:`oisat_tpu_torch.ops.vertical`.  The results are written back onto the
granules as tensors on that device.

Full precision end to end, as the JAX package under ``OISAT_F16_TRANSFER=0``:
no float16 narrowing, no carrier-level compression, and every level of an
upscaled field goes through the upscaler.
"""

from __future__ import annotations

import numpy as np
import torch

from oisat_tpu_torch._device import granule_device, h2d, size
from oisat_tpu_torch.ops.vertical import (
    air_partial_column,
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    amf_recal_fields,
    amf_recal_noak_fields,
    partial_column,
    pwv_fields,
)
from oisat_tpu_torch.ops.weights import diag_threshold
from oisat_tpu_torch.parallel.analysis import over_granule_chunks
from oisat_tpu_torch.regridder import _geom_key, make_upscaler
from oisat_tpu_torch.utils.lru import LockedLRU
from oisat_tpu_torch.utils.profiling import count, span

__all__ = ["amf_recal", "ak_conv_mopitt", "ak_conv_gosat", "pwv_calculator"]


# -- time matching (host; reference amf_recal.py:8-37, ak_conv_mopitt.py:10-52)

def _flatten_time(t):
    return (t.year * 10000 + t.month * 100 + t.day + t.hour / 24.0
            + t.minute / 60.0 / 24.0 + t.second / 3600.0 / 24.0)


def _hour_only(t):
    return t.hour / 24.0 + t.minute / 60.0 / 24.0 + t.second / 3600.0 / 24.0


def _ctm_times(ctm_data):
    time_ctm, time_hour = [], []
    for g in ctm_data:
        for t in g.time:
            time_ctm.append(_flatten_time(t))
            time_hour.append(_hour_only(t))
    return np.array(time_ctm), np.array(time_hour)


def _match_amf(time_sat, ctm_data, time_ctm, time_hour):
    """3-hourly day/hour matching (reference amf_recal.py:26-37):
    (closest snapshot, day index, hour index)."""
    if not ctm_data[0].averaged:
        closest = int(np.argmin(np.abs(_flatten_time(time_sat) - time_ctm)))
        return closest, int(np.floor(closest / 8.0)), int(closest % 8)
    closest = int(np.argmin(np.abs(_hour_only(time_sat) - time_hour)))
    return closest, 0, int(closest)


def _match_daily(time_sat, ctm_data, time_ctm):
    """Day-resolution matching (reference ak_conv_mopitt.py:41-51):
    (closest, day index)."""
    if not ctm_data[0].averaged:
        t = time_sat.year * 10000 + time_sat.month * 100 + time_sat.day
        closest = int(np.argmin(np.abs(t - time_ctm)))
        return closest, closest
    return 0, 0


# -- CTM slicing / upscaling helpers

def _amf_ctm_slice(ctm_data, day, hour):
    """(pmid, profile, dp) at the matched time (reference amf_recal.py:39-49)."""
    g = ctm_data[day]
    if g.ctmtype == "FREE":
        return (np.squeeze(g.pressure_mid), np.squeeze(g.gas_profile),
                np.squeeze(g.delta_p))
    return (np.squeeze(g.pressure_mid[hour]), np.squeeze(g.gas_profile[hour]),
            np.squeeze(g.delta_p[hour]))


def _time_collapsed(ctm, names):
    """The named fields of one CTM day without a time axis: ECCOH and FREE
    carry none, GMI's sub-daily axis is averaged (reference
    ak_conv_mopitt.py:59-77).  The average stays on the host: a ``nanmean``
    on the card would not be bitwise numpy's."""
    if ctm.ctmtype in ("ECCOH", "FREE"):
        return tuple(np.squeeze(getattr(ctm, n)) for n in names)
    return tuple(np.squeeze(np.nanmean(getattr(ctm, n), axis=0)) for n in names)


def _daily_ctm_slice(ctm_data, day):
    """(pmid, profile, dp) of one day, time-collapsed."""
    return _time_collapsed(ctm_data[day], ("pressure_mid", "gas_profile", "delta_p"))


# regular-grid sensors collapse to one entry; per-granule geometries churn
_upscaler_cache = LockedLRU(32)


def _ctm_to_sat_upscaler(ctm_data, granule, device):
    """The Upscaler that maps CTM-grid (L, H, W) fields onto the satellite
    grid (reference amf_recal.py:58-83: KD-nearest, 2x cutoff), cached per
    geometry pair and device."""
    key = (_geom_key(ctm_data[0].longitude, ctm_data[0].latitude),
           _geom_key(granule.longitude_center, granule.latitude_center), str(device))
    hit = _upscaler_cache.get(key)
    if hit is not None:
        return hit
    sat_lon, sat_lat = granule.longitude_center, granule.latitude_center
    up = make_upscaler(ctm_data[0].longitude, ctm_data[0].latitude, sat_lon, sat_lat,
                       diag_threshold(ctm_data[0].longitude, ctm_data[0].latitude),
                       diag_threshold(sat_lon, sat_lat), device, method=4, far_factor=2.0)
    _upscaler_cache.put(key, up)
    return up


def _maybe_upscale(ctm_data, granule, fields, device):
    """The (L, H, W) (or single-level (H, W)) tensors ``fields`` on
    ``device`` as they are, or, when the granule is flagged, mapped onto the
    satellite grid: cast to float64 into one stack and mapped through one
    upscaler call."""
    if not granule.ctm_upscaled_needed:
        return fields
    with span("assemble.map"):
        levels = [1 if f.ndim == 2 else f.shape[0] for f in fields]
        whole = torch.empty((sum(levels),) + tuple(fields[0].shape[-2:]),
                            dtype=torch.float64, device=device)
        for part, f in zip(whole.split(levels), fields):
            part.copy_(f.reshape(part.shape))  # the exact cast to float64
        out = _ctm_to_sat_upscaler(ctm_data, granule, device).apply(whole)
    return [r[0] if f.ndim == 2 else r for r, f in zip(out.split(levels), fields)]


def _slice_key(granule, matched):
    """Identity of a granule's prepared CTM slice: the matched time index,
    plus the granule grid when the slice was upscaled onto it."""
    if granule.ctm_upscaled_needed:
        return (matched, _geom_key(np.atleast_2d(np.asarray(granule.longitude_center)),
                                   np.atleast_2d(np.asarray(granule.latitude_center))))
    return matched


def _prepared(cache: dict, ctm_data, granule, matched, device, host_fields, derive=None):
    """The device tensors of the CTM slice ``matched`` for ``granule``, made
    once per distinct slice and kept in ``cache``: the host arrays of
    ``host_fields()`` are copied as they are, ``derive`` (tensors ->
    tensors; None keeps them) computes the operator's fields from them on
    ``device``, and a flagged granule gets them upscaled.  The spans time the
    host: ``assemble.ctm_fields`` the slicing and the derivation's launch,
    ``assemble.h2d`` the copies."""
    key = _slice_key(granule, matched)
    if key not in cache:
        with span("assemble.ctm_fields"):
            arrays = host_fields()
        with span("assemble.h2d"):
            fields = [h2d(a, device) for a in arrays]
        if derive is not None:
            with span("assemble.ctm_fields"):
                fields = derive(*fields)
            count("assemble.slices_device")
        cache[key] = _maybe_upscale(ctm_data, granule, fields, device)
    return cache[key]


def _amf_columns(pmid, profile, dp):
    """(pmid, float64 gas partial column) of an AMF slice's tensors."""
    return [pmid, partial_column(dp.to(torch.float64), profile.to(torch.float64))]


def _mopitt_columns(pmid, profile, dp):
    """(pmid, profile, float64 air partial column) of a MOPITT slice's
    tensors.  The reference also builds and upscales the gas partial column
    (ak_conv_mopitt.py:67,103) but never reads it: skipped, as in the twin."""
    return [pmid, profile, air_partial_column(dp.to(torch.float64))]


def _amf_one(ctm_data, granule, time_ctm, time_hour, device, cache: dict):
    """One granule's matched CTM fields on ``device``: (closest, pmid, pc,
    tropopause, has_trop).  The partial columns are computed in float64 on
    the device; a granule without a tropopause gets zeros, which never mask
    a level (pmid < 0 never holds)."""
    closest, day, hour = _match_amf(granule.time, ctm_data, time_ctm, time_hour)
    pmid, pc = _prepared(cache, ctm_data, granule, closest, device,
                         lambda: _amf_ctm_slice(ctm_data, day, hour), _amf_columns)
    has_trop = size(granule.tropopause) != 1
    trop = granule.tropopause if has_trop else torch.zeros_like(granule.vcd)
    return closest, pmid, pc, trop, has_trop


def _stack(granules, name):
    return torch.stack([getattr(g, name) for g in granules])


def _shape(x):
    return tuple(x.shape) if torch.is_tensor(x) else np.shape(x)


# -- public operators

def amf_recal(ctm_data: list, sat_data: list):
    """Recalculate AMFs / model VCDs for every granule (reference
    amf_recal.py:121-185).  Granules sharing a (shape, tropopause) signature
    run through one batched call; a granule without scattering weights only
    gets its model VCD."""
    print("AMF Recal begins...")
    time_ctm, time_hour = _ctm_times(ctm_data)
    cache: dict = {}
    groups: dict = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        closest, pmid, pc, trop, has_trop = _amf_one(
            ctm_data, granule, time_ctm, time_hour, granule_device(granule), cache)
        if size(granule.scattering_weights) == 1:
            print("No scattering weights found, recalculation is not possible.."
                  "just grabbing VCDs")
            granule.ctm_vcd = amf_recal_noak_fields(pmid, pc, trop, granule.vcd, has_trop)
            granule.ctm_time_at_sat = time_ctm[closest]
            granule.old_amf = np.empty((1,))
            granule.new_amf = np.empty((1,))
            continue
        key = (_shape(granule.vcd), _shape(granule.pressure_mid), _shape(pmid), has_trop)
        groups.setdefault(key, []).append((gi, closest, pmid, pc, trop))

    for (_, _, _, has_trop), items in groups.items():
        grans = [sat_data[it[0]] for it in items]
        new_amf, vcd_corr, model_vcd = over_granule_chunks(
            amf_recal_fields,
            (_stack(grans, "pressure_mid"), _stack(grans, "scattering_weights"),
             torch.stack([it[2] for it in items]), torch.stack([it[3] for it in items]),
             torch.stack([it[4] for it in items]), _stack(grans, "vcd"),
             _stack(grans, "amf")), (has_trop,))
        for k, (g, (_, closest, *_rest)) in enumerate(zip(grans, items)):
            g.old_amf = g.amf
            g.new_amf = new_amf[k]
            g.vcd = vcd_corr[k]
            g.ctm_vcd = model_vcd[k]
            g.ctm_time_at_sat = time_ctm[closest]
    return sat_data


def _daily_groups(ctm_data, sat_data, time_ctm, shape_field, host_fields, derive=None):
    """Match every granule to its CTM day and group the granules by shape
    signature: {key: [(granule index, closest, *device slice tensors)]}.
    ``host_fields(day)`` gives the host arrays of one day's slice, ``derive``
    the fields made from them on the device (:func:`_prepared`)."""
    cache: dict = {}
    groups: dict = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        closest, day = _match_daily(granule.time, ctm_data, time_ctm)
        fields = _prepared(cache, ctm_data, granule, day, granule_device(granule),
                           lambda: host_fields(day), derive)
        key = (_shape(getattr(granule, shape_field)), _shape(granule.pressure_mid)
               if hasattr(granule, "pressure_mid") else None, _shape(fields[0]))
        groups.setdefault(key, []).append((gi, closest, *fields))
    return groups


def ak_conv_mopitt(ctm_data: list, sat_data: list):
    """MOPITT CO averaging-kernel convolution (reference
    ak_conv_mopitt.py:8-149); granules with a common shape signature run
    through one batched call."""
    print("Averaging Kernel Conv begins...")
    time_ctm, _ = _ctm_times(ctm_data)
    groups = _daily_groups(ctm_data, sat_data, time_ctm, "vcd",
                           lambda day: _daily_ctm_slice(ctm_data, day), _mopitt_columns)
    for items in groups.values():
        grans = [sat_data[it[0]] for it in items]
        model_vcd, model_xcol = over_granule_chunks(
            ak_conv_mopitt_fields,
            (torch.stack([it[2] for it in items]), torch.stack([it[3] for it in items]),
             torch.stack([it[4] for it in items]), _stack(grans, "pressure_mid"),
             _stack(grans, "averaging_kernels"), _stack(grans, "aprior_column"),
             _stack(grans, "apriori_profile"), _stack(grans, "apriori_surface"),
             _stack(grans, "vcd")))
        for k, (g, (_, closest, *_rest)) in enumerate(zip(grans, items)):
            g.ctm_vcd = model_vcd[k]
            g.ctm_xcol = model_xcol[k]
            g.ctm_time_at_sat = time_ctm[closest]
    return sat_data


def ak_conv_gosat(ctm_data: list, sat_data: list):
    """GOSAT XCH4 averaging-kernel convolution (reference
    ak_conv_gosat.py:8-146); granules with a common shape signature run
    through one batched call."""
    print("Averaging Kernel Conv begins...")
    time_ctm, _ = _ctm_times(ctm_data)

    def host_fields(day):
        return list(_time_collapsed(ctm_data[day], ("pressure_mid", "gas_profile")))

    for items in _daily_groups(ctm_data, sat_data, time_ctm, "x_col", host_fields).values():
        grans = [sat_data[it[0]] for it in items]
        model_xcol = over_granule_chunks(
            ak_conv_gosat_fields,
            (torch.stack([it[2] for it in items]), torch.stack([it[3] for it in items]),
             _stack(grans, "pressure_mid"), _stack(grans, "averaging_kernels"),
             _stack(grans, "apriori_profile"), _stack(grans, "pressure_weight"),
             _stack(grans, "x_col")))
        for k, (g, (_, closest, *_rest)) in enumerate(zip(grans, items)):
            # XCH4 only: the model VCD stays NaN (reference ak_conv_gosat.py:138)
            g.ctm_vcd = torch.full_like(g.vcd, float("nan"))
            g.ctm_xcol = model_xcol[k]
            g.ctm_time_at_sat = time_ctm[closest]
    return sat_data


def _water_partial_column(ctm_data, day):
    """dp * q / g / 1e4 of one CTM day, time-collapsed (reference
    pwv_cal.py:64-75).  Computed on the host, in the reader's precision: no
    cell runs it, and it follows the host time-collapse."""
    dp, q = _time_collapsed(ctm_data[day], ("delta_p", "gas_profile"))
    return dp * q / 9.80665 / 10000.0


def pwv_calculator(ctm_data: list, sat_data: list):
    """Model precipitable water vapor for SSMIS (reference pwv_cal.py:7-101);
    granules sharing a shape signature run through one batched call."""
    print("PWV begins...")
    time_ctm, _ = _ctm_times(ctm_data)
    groups = _daily_groups(ctm_data, sat_data, time_ctm, "vcd",
                           lambda day: [_water_partial_column(ctm_data, day)])
    for items in groups.values():
        grans = [sat_data[it[0]] for it in items]
        # float32 after any upscaling, as the twin stacks it
        pwv = over_granule_chunks(
            pwv_fields, (torch.stack([it[2] for it in items]).to(torch.float32),
                         _stack(grans, "vcd")))
        for k, g in enumerate(grans):
            g.ctm_vcd = pwv[k]
    return sat_data
