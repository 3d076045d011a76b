"""The ``oisatgmi`` session API of the port: the fused month analysis.

Counterpart of :meth:`oisat_tpu.driver.oisatgmi.analyze_month_fused` for
months of ``satellite_amf`` granules (AMF recalculation): the matched CTM
slices are assembled on the host, the whole month runs as
:func:`oisat_tpu_torch.parallel.analysis.full_month_step` on the granules'
device, and every host-bound result comes back in one pull.  With
``oi_method="full"`` the step skips its scalar OI and the full-covariance
OI (:func:`oisat_tpu_torch.ops.oi_full.oi_full`) runs on the averaged
fields, as the ``method == "full"`` branch of the JAX ``_oi_impl`` does.
State attribute names match the JAX driver (and the reference).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from oisat_tpu_torch.datamodel import satellite_amf
from oisat_tpu_torch.ops.diagnostics import innovation_stats
from oisat_tpu_torch.ops.oi_full import oi_full
from oisat_tpu_torch.ops.vertical import partial_column
from oisat_tpu_torch.parallel.analysis import FullMonthInputs, full_month_step
from oisat_tpu_torch.utils.stages import StageClock

__all__ = ["oisatgmi", "BIAS_CORRECTIONS"]


# (sensor, gas) -> (offset, slope): corrected = (vcd - offset) / slope.
# Regression coefficients from the validation studies cited in the reference
# (reference driver.py:68-99).
BIAS_CORRECTIONS = {
    ("TROPOMI", "NO2"): (0.32, 0.66),
    ("TROPOMI", "HCHO"): (0.90, 0.59),
    ("OMI", "NO2"): (0.32, 0.63),
    ("OMI", "HCHO"): (0.821, 0.79),
}


# -- CTM time matching (host; oisat_tpu.obs_operators, reference amf_recal.py:8-49)

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


def _amf_ctm_slice(ctm_data, day, hour):
    """(pmid, profile, dp) at the matched time (reference amf_recal.py:39-49)."""
    g = ctm_data[day]
    if g.ctmtype == "FREE":
        return (np.squeeze(g.pressure_mid), np.squeeze(g.gas_profile),
                np.squeeze(g.delta_p))
    return (np.squeeze(g.pressure_mid[hour]), np.squeeze(g.gas_profile[hour]),
            np.squeeze(g.delta_p[hour]))


def _size(x) -> int:
    return x.numel() if torch.is_tensor(x) else int(np.size(x))


def _pack_month_pull(out, with_oi: bool) -> np.ndarray:
    """Every host-bound result of the month as ONE (K+1, H, W) float64 array:
    the five averaged fields (and, ``with_oi``, the four OI fields), then a
    plane whose first entries are reg_factor and the innovation statistics
    (NaN-padded; all NaN without the OI).  One device->host copy."""
    fields = [out.sat_vcd, out.sat_error, out.ctm_vcd, out.aux1, out.aux2]
    dt = torch.float64
    hw = fields[0].shape
    pad = torch.full((hw[0] * hw[1],), float("nan"), dtype=dt, device=fields[0].device)
    if with_oi:
        fields += [out.oi.xb, out.oi.averaging_kernel, out.oi.increment, out.oi.error]
        scal = torch.stack([out.oi.reg_factor.to(dt)]
                           + [torch.as_tensor(v).to(dt) for v in out.innovation])
        pad[: scal.numel()] = scal
    return torch.stack([f.to(dt) for f in fields] + [pad.reshape(hw)]).cpu().numpy()


class oisatgmi:
    """One analysis session (one sensor, one gas, one month).

    Set ``reader_obj`` (``ctm_data``: list of ctm_model, ``sat_data``: list of
    regridded satellite_amf granules on one device) before calling
    :meth:`analyze_month_fused`."""

    def analyze_month_fused(self, sensor: str, gasname: str, startdate: str,
                            enddate: str, error_ctm=50.0, weighting=None,
                            oi_method="scalar", length_scale_km=300.0,
                            desroziers_iterations=0, curve_impl="auto",
                            cov_impl="auto", stage_ms=None):
        """The month analysis on the granules' device: AMF recalculation per
        granule + monthly statistics + bias correction + OI + innovation
        diagnostics.  Sets ``sat_averaged_vcd``, ``sat_averaged_error``,
        ``ctm_averaged_vcd``, ``aux1``, ``aux2``, ``ctm_averaged_vcd_corrected``,
        ``ak_OI``, ``increment_OI``, ``error_OI`` (numpy), ``avg_time`` and
        ``oi_diagnostics``, and returns the device ``AnalysisOutputs``.

        ``weighting``: None or "inverse_variance".  ``oi_method``: "scalar"
        (the reference's per-cell update, in the step) or "full" (the
        distance-decay covariance with ``length_scale_km``, run after the
        step, whose ``oi`` slot then holds NaN placeholders with
        ``reg_index`` -1 and whose scaling factor is all ones: read the
        attributes for the OI results).  ``curve_impl`` / ``cov_impl`` pick
        the scalar OI's curve engine and the full OI's covariance engine
        (see :func:`oisat_tpu_torch.ops.oi.oi`,
        :func:`oisat_tpu_torch.ops.oi_full.oi_full`).  With a ``stage_ms``
        dict, the wall milliseconds of the stages "assemble" (host CTM
        matching and H2D), "step", "pull", and on full months "oi_full" (split
        further under "oi_full.<stage>") and "innovation_stats" are added to
        it; the unprefixed ones sum to the call's wall time.
        Raises ValueError for an unfusable month (no granules, no scattering
        weights, mixed shapes) and NotImplementedError for what the port
        does not cover yet."""
        if oi_method not in ("scalar", "full"):
            raise ValueError(f"oi_method must be 'scalar' or 'full', got {oi_method!r}")
        if int(desroziers_iterations) > 0:
            raise NotImplementedError("Desroziers re-estimation is not ported yet: "
                                      "ROADMAP queue 1 item 11")
        ctm_data = self.reader_obj.ctm_data
        start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), int(startdate[8:10]))
        end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), int(enddate[8:10]))
        grans = [g for g in self.reader_obj.sat_data
                 if g is not None and start <= g.time.date() < end]
        if not grans:
            raise ValueError("no valid satellite granules to fuse")
        if not all(isinstance(g, satellite_amf) for g in grans):
            raise NotImplementedError("the port's fused month takes satellite_amf "
                                      "granules only: ROADMAP queue 1 item 9")
        if any(_size(g.scattering_weights) == 1 for g in grans):
            raise ValueError("fused month path needs scattering weights")
        shapes = {(tuple(g.vcd.shape), tuple(g.pressure_mid.shape)) for g in grans}
        if len(shapes) != 1:
            raise ValueError(f"fused month path needs one granule shape, got {shapes}")
        if any(g.ctm_upscaled_needed for g in grans):
            raise NotImplementedError("months whose CTM must be upscaled onto the "
                                      "granule grid are not ported yet: ROADMAP queue 1 item 8")
        offset, slope = BIAS_CORRECTIONS.get((sensor, gasname), (0.0, 1.0))
        if (sensor, gasname) in BIAS_CORRECTIONS:
            print(f"applying the bias correction for {sensor} {gasname}")
        # CTM O3 columns convert to DU between averaging and OI (reference
        # driver.py:62-63)
        ctm_scale = 1.0 / (2.69e16 * 1e-15) if gasname == "O3" else 1.0

        full = oi_method == "full"
        clock = StageClock(stage_ms, grans[0].vcd.device)
        inputs = self._fused_inputs(ctm_data, grans)
        clock.mark("assemble")
        out = full_month_step(inputs, bias_offset=offset, bias_slope=slope,
                              error_ctm=float(error_ctm), ctm_scale=float(ctm_scale),
                              weighting=weighting, curve_impl=curve_impl,
                              run_oi=not full)
        del inputs
        clock.mark("step")

        packed = _pack_month_pull(out, not full)
        (self.sat_averaged_vcd, self.sat_averaged_error, self.ctm_averaged_vcd,
         self.aux1, self.aux2) = (p.copy() for p in packed[:5])
        avg_ts = sum(g.time.timestamp() for g in grans) / len(grans)
        self.avg_time = datetime.datetime.fromtimestamp(avg_ts)
        clock.mark("pull")
        if full:
            self._oi_full(error_ctm, length_scale_km, grans[0].vcd.device, cov_impl,
                          clock)
            return out
        (self.ctm_averaged_vcd_corrected, self.ak_OI, self.increment_OI,
         self.error_OI) = (p.copy() for p in packed[5:9])
        scal = packed[-1].ravel()
        print("The regularization factor is " + str(float(scal[0])))
        names = type(out.innovation)._fields
        self.oi_diagnostics = {k: float(v) for k, v in zip(names, scal[1:1 + len(names)])}
        return out

    def _first_valid(self):
        return next(i for i, s in enumerate(self.reader_obj.sat_data) if s is not None)

    def full_oi_inputs(self, error_ctm=50.0):
        """(xa, y, sigma_b, sigma_o, lat, lon): the fields the full OI takes
        after the month's averaging -- sigma_b = xa * error_ctm / 100, sigma_o
        the averaged observation error, the first valid granule's grid."""
        xa, y = self.ctm_averaged_vcd, self.sat_averaged_vcd
        sat = self.reader_obj.sat_data[self._first_valid()]
        return (xa, y, np.asarray(xa) * error_ctm / 100.0,
                np.asarray(self.sat_averaged_error), sat.latitude_center,
                sat.longitude_center)

    def _oi_full(self, error_ctm, length_scale_km, device, cov_impl, clock=None):
        """The ``method == "full"`` branch of the JAX ``_oi_impl`` (without
        Desroziers): the full-covariance OI with the regularization scan on
        :meth:`full_oi_inputs`; the innovation statistics on the clamped y
        the OI assimilated, merged with the solver's info."""
        clock = clock or StageClock(None, device)
        xa, y, sigma_b, sigma_o, lat, lon = self.full_oi_inputs(error_ctm)
        res = oi_full(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km,
                      regularization_on=True, device=device, cov_impl=cov_impl,
                      stage_ms=clock.out)
        clock.mark("oi_full")
        self.ctm_averaged_vcd_corrected = res.xb
        self.ak_OI = res.averaging_kernel
        self.increment_OI = res.increment
        self.error_OI = res.error
        y_clip = np.where(np.asarray(y, np.float64) < 0, 0.0, np.asarray(y, np.float64))

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        st = innovation_stats(t64(xa), t64(y_clip), t64(res.xb), t64(sigma_b) ** 2,
                              t64(sigma_o) ** 2)
        self.oi_diagnostics = {k: float(v) for k, v in st._asdict().items()}
        self.oi_diagnostics.update({k: v for k, v in (res.info or {}).items()
                                    if v is not None})
        clock.mark("innovation_stats")

    @staticmethod
    def _fused_inputs(ctm_data, grans) -> FullMonthInputs:
        """Stack the month on the granules' device with each granule's
        closest CTM snapshot (as oisat_tpu.driver._fused_inputs does for AMF
        granules in full-precision mode: the partial columns are computed in
        float64 on the host and stay float64).  Each distinct snapshot is
        moved to the device once and gathered per granule there."""
        device = grans[0].vcd.device
        time_ctm, time_hour = _ctm_times(ctm_data)
        slices: dict = {}
        keys, trops = [], []
        for g in grans:
            closest, day, hour = _match_amf(g.time, ctm_data, time_ctm, time_hour)
            if closest not in slices:
                pmid, profile, dp = _amf_ctm_slice(ctm_data, day, hour)
                pc = partial_column(np.asarray(dp, np.float64),
                                    np.asarray(profile, np.float64))
                slices[closest] = (torch.as_tensor(np.asarray(pmid), device=device),
                                   torch.as_tensor(pc, device=device))
            keys.append(closest)
            # no-tropopause granules pass zeros: pmid < 0 never holds
            trops.append(g.tropopause if _size(g.tropopause) != 1
                         else torch.zeros_like(g.vcd))
        return FullMonthInputs(
            sat_pmid=torch.stack([g.pressure_mid for g in grans]),
            sat_sw=torch.stack([g.scattering_weights for g in grans]),
            vcd=torch.stack([g.vcd for g in grans]),
            amf=torch.stack([g.amf for g in grans]),
            uncertainty=torch.stack([g.uncertainty for g in grans]),
            tropopause=torch.stack(trops),
            ctm_pmid=torch.stack([slices[k][0] for k in keys]),
            ctm_pc=torch.stack([slices[k][1] for k in keys]),
        )
