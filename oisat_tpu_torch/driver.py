"""The ``oisatgmi`` session API of the port.

Counterpart of :class:`oisat_tpu.driver.oisatgmi` (reference
oisatgmi/driver.py:17-227): ``read_data`` -> the staged path
``recal_amf / conv_ak / cal_pwv -> average -> bias_correct -> oi ->
savedaily`` or the fused month :meth:`oisatgmi.analyze_month_fused` ->
``reporting`` / ``write_to_nc``, with ``save_state`` / ``load_state``
checkpoints, for
``satellite_amf`` (AMF recalculation), ``satellite_opt`` (MOPITT / GOSAT
averaging-kernel convolution; GOSAT assimilates the xcol pair) and
``satellite_ssmis`` (precipitable water) granules.  State attribute names
match the JAX driver (and the reference).

Where the state lives.  The CTM fields are host numpy.  The gridded
granules' fields are tensors on one device (the output of the port's
regrid), and the observation operators keep their results there, on the
granules.  ``average`` stacks the month in float64 on that device and pulls
the five averaged fields once per month bucket; from then on the driver
attributes (``sat_averaged_vcd`` ... ``error_OI``) are host numpy, as
``analyze_month_fused`` sets them.  ``oi`` pushes the three fields it reads
once, runs every pass (the Desroziers loop included) on the device and pulls
its results once.  The fused month assembles on the host, runs as one month
step of :mod:`oisat_tpu_torch.parallel.analysis` on the device and pulls
every result in one copy.  The staged path's copies are counted in
:data:`oisat_tpu_torch._device.COPIES`.

``mesh=`` (a :class:`~oisat_tpu_torch.parallel.mesh.Mesh`) on :meth:`oisatgmi.oi`
and :meth:`oisatgmi.analyze_month_fused` runs the month step through its
sharded maker and the OI over the mesh's grid shards; None or a mesh of one
position takes the single-device path.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np
import torch

from oisat_tpu_torch._device import d2h, default_device, granule_device, h2d, size
from oisat_tpu_torch.datamodel import satellite_amf, satellite_opt, satellite_ssmis
from oisat_tpu_torch.obs_operators import (
    _amf_one,
    _ctm_times,
    _daily_ctm_slice,
    _match_daily,
    _mopitt_columns,
    _prepared,
    _time_collapsed,
    _water_partial_column,
    ak_conv_gosat,
    ak_conv_mopitt,
    amf_recal,
    pwv_calculator,
)
from oisat_tpu_torch.ops.averaging import averaging
from oisat_tpu_torch.ops.diagnostics import (
    desroziers_binned,
    desroziers_estimates,
    innovation_stats,
    lat_band_index,
)
from oisat_tpu_torch.ops.oi import oi as oi_op
from oisat_tpu_torch.ops.oi_full import oi_full
from oisat_tpu_torch.parallel.analysis import (
    MONTH_MAKERS,
    FullMonthInputs,
    GosatMonthInputs,
    MopittMonthInputs,
    SsmisMonthInputs,
    full_month_step,
    gosat_month_step,
    mopitt_month_step,
    ssmis_month_step,
)
from oisat_tpu_torch.utils.profiling import StageClock, count, span, stage

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

# CTM O3 columns convert to DU between averaging and OI (reference
# driver.py:62-63)
_O3_DU = 2.69e16 * 1e-15

_KINDS = {satellite_amf: "amf", satellite_opt: "opt", satellite_ssmis: "ssmis"}


def _scalar_plane(scalars, hw, device):
    """A NaN (H, W) float64 plane whose first entries are ``scalars``."""
    pad = torch.full((hw[0] * hw[1],), float("nan"), dtype=torch.float64, device=device)
    if scalars:
        pad[: len(scalars)] = torch.stack([torch.as_tensor(v, device=device)
                                           .to(torch.float64) for v in scalars])
    return pad.reshape(tuple(hw))


def _pack_month_pull(out, with_oi: bool) -> np.ndarray:
    """Every host-bound result of the month as ONE (K+1, H, W) float64 array:
    the five averaged fields (and, ``with_oi``, the four OI fields), then a
    plane whose first entries are reg_factor and the innovation statistics
    (NaN-padded; all NaN without the OI).  One device->host copy."""
    fields = [out.sat_vcd, out.sat_error, out.ctm_vcd, out.aux1, out.aux2]
    scalars = []
    if with_oi:
        fields += [out.oi.xb, out.oi.averaging_kernel, out.oi.increment, out.oi.error]
        scalars = [out.oi.reg_factor, *out.innovation]
    plane = _scalar_plane(scalars, fields[0].shape, fields[0].device)
    count("syncs")
    return torch.stack([f.to(torch.float64) for f in fields] + [plane]).cpu().numpy()


def _desroziers_step(xa, y_clip, xb, sa, so, bins, nb: int):
    """One Desroziers (re-)estimation pass on tensors: (sa_step, so_step)
    scale factors, 0-d for the global estimator (``bins`` None), per-cell
    maps for the binned one.  Cells labelled -1 ("no band": a non-finite
    latitude) keep scale 1."""
    if bins is None:
        est = desroziers_estimates(xa, y_clip, xb, sa, so)
        return est.sa_scale, est.so_scale
    est = desroziers_binned(xa, y_clip, xb, sa, so, bins, nb)
    safe = bins.clamp(0, nb - 1).long()

    def bcast(scale):
        s = scale.to(torch.float64)[safe]
        return torch.where(bins >= 0, s, torch.ones_like(s))

    return bcast(est.sa_scale), bcast(est.so_scale)


def _desroziers_diag(nb, binned: bool, sa_total, so_total, iterations):
    """The oi_diagnostics entries of a Desroziers sweep (host numpy totals;
    the per-bin scale spread is added when binned)."""
    d = {"desroziers_sa_scale": float(np.nanmean(sa_total)),
         "desroziers_so_scale": float(np.nanmean(so_total)),
         "desroziers_iterations": int(iterations)}
    if binned:
        d.update({"desroziers_bins": nb,
                  "desroziers_sa_scale_min": float(np.nanmin(sa_total)),
                  "desroziers_sa_scale_max": float(np.nanmax(sa_total)),
                  "desroziers_so_scale_min": float(np.nanmin(so_total)),
                  "desroziers_so_scale_max": float(np.nanmax(so_total))})
    return d


def _clip_negative(y64: np.ndarray) -> np.ndarray:
    return np.where(y64 < 0, 0.0, y64)


class oisatgmi:
    """One analysis session (one sensor, one gas, one month).

    :meth:`read_data` or :meth:`load_state` sets ``reader_obj`` (``ctm_data``:
    list of ctm_model with host numpy leaves, ``sat_data``: list of regridded
    granules whose fields are tensors on one device, None for a skipped
    file); a caller with gridded granules of its own sets it itself before
    calling the staged methods or :meth:`analyze_month_fused`.  With a
    ``stage_ms`` dict every staged method adds its wall milliseconds (the
    device synchronised at its end) under its own name."""

    def __init__(self, stage_ms: dict | None = None) -> None:
        self.stage_ms = stage_ms

    def _device(self) -> torch.device:
        return granule_device(self.reader_obj.sat_data[self._first_valid()])

    def _clock(self) -> StageClock:
        out = self.stage_ms
        return StageClock(out, self._device() if out is not None else "cpu")

    def _oi_pair(self, sensor):
        """(prior, observation) the OI runs on: GOSAT assimilates the xcol
        pair instead of the VCD pair (reference driver.py:112-114)."""
        if sensor == "GOSAT":
            return self.aux2, self.aux1
        return self.ctm_averaged_vcd, self.sat_averaged_vcd

    # -- ingestion (reference driver.py:22-34) --------------------------------
    def read_data(self, ctm_type: str, ctm_path: Path, ctm_gas_name: str,
                  ctm_frequency: str, sat_type: str, sat_path: Path, YYYYMM: str,
                  averaging=False, read_ak=True, trop=False, num_job=1,
                  mcip_dir=None, tempo_hour=None, control_free="control_free.yml",
                  device=None, fast_swath=True):
        """Read the month's CTM files (host numpy) and satellite files, every
        granule regridded onto the CTM grid on ``device`` (None: the card; it
        raises when there is none).  ``fast_swath=False`` takes the scipy
        weight builders of the JAX package's parity mode."""
        from oisat_tpu_torch.readers import readers

        # the reference job runner passes read_AK as the *string* "False"
        # for FREE runs (reference run/job.py:21-23) and compares with
        # `== True` downstream; normalize to a real bool here.
        if isinstance(read_ak, str):
            read_ak = read_ak.lower() == "true"
        device = default_device(device)
        reader_obj = readers()
        reader_obj.add_ctm_data(ctm_type, Path(ctm_path), mcip_dir=mcip_dir)
        with stage("read_ctm"):
            reader_obj.read_ctm_data(YYYYMM, ctm_gas_name, frequency_opt=ctm_frequency,
                                     averaging=averaging, num_job=num_job,
                                     control_free=control_free)
        reader_obj.add_satellite_data(sat_type, Path(sat_path))
        with stage("read_satellite", sync=device):
            reader_obj.read_satellite_data(YYYYMM, read_ak=read_ak, trop=trop,
                                           num_job=num_job, tempo_hour=tempo_hour,
                                           device=device, fast_swath=fast_swath)
        self.reader_obj = reader_obj
        self.gasname = ctm_gas_name[0]

    # -- observation operators (reference driver.py:36-51) -------------------
    def recal_amf(self):
        clock = self._clock()
        self.reader_obj.sat_data = amf_recal(self.reader_obj.ctm_data,
                                             self.reader_obj.sat_data)
        clock.mark("recal_amf")

    def cal_pwv(self):
        clock = self._clock()
        self.reader_obj.sat_data = pwv_calculator(self.reader_obj.ctm_data,
                                                  self.reader_obj.sat_data)
        clock.mark("cal_pwv")

    def conv_ak(self, sensor: str):
        clock = self._clock()
        if sensor == "MOPITT":
            self.reader_obj.sat_data = ak_conv_mopitt(self.reader_obj.ctm_data,
                                                      self.reader_obj.sat_data)
        if sensor == "GOSAT":
            self.reader_obj.sat_data = ak_conv_gosat(self.reader_obj.ctm_data,
                                                     self.reader_obj.sat_data)
        clock.mark("conv_ak")

    # -- analysis (reference driver.py:53-114) -------------------------------
    def average(self, startdate: str, enddate: str, gasname=None, weighting=None):
        """Monthly averaging.  ``weighting``: None (the reference's plain
        mean), "inverse_variance" (granules weighted by 1/sigma^2) or "ak"
        (by averaging-kernel information content; MOPITT / GOSAT)."""
        clock = self._clock()
        self._average_impl(startdate, enddate, gasname, weighting)
        clock.mark("average")

    def _average_impl(self, startdate, enddate, gasname, weighting=None):
        (self.sat_averaged_vcd, self.sat_averaged_error, self.ctm_averaged_vcd,
         self.aux1, self.aux2, self.avg_time) = averaging(startdate, enddate,
                                                          self.reader_obj,
                                                          weighting=weighting)
        if gasname == "O3":
            self.ctm_averaged_vcd = self.ctm_averaged_vcd / _O3_DU

    def bias_correct(self, sat_type, gasname):
        clock = self._clock()
        key = (sat_type, gasname)
        if key in BIAS_CORRECTIONS:
            print(f"applying the bias correction for {sat_type} {gasname}")
            offset, slope = BIAS_CORRECTIONS[key]
            self.sat_averaged_vcd = (self.sat_averaged_vcd - offset) / slope
        else:
            print("NOT applying the bias correction for satellite VCDs")
        clock.mark("bias_correct")

    def oi(self, sensor: str, error_ctm=50.0, method="scalar", length_scale_km=300.0,
           desroziers_iterations=0, desroziers_bins=1, mesh=None):
        """The analysis update on the averaged fields.

        ``method="scalar"`` is the reference's per-cell update with the
        99-factor regularization scan; ``method="full"`` the distance-decay
        background covariance with ``length_scale_km``
        (:func:`oisat_tpu_torch.ops.oi_full.oi_full`).  GOSAT assimilates
        the xcol pair (``aux2``, ``aux1``) instead of the VCD pair.

        ``desroziers_iterations``: re-estimate the So / Sa error variances
        from the innovation / residual cross-moments (Desroziers 2005) and
        re-run the update that many times; the diagnosed scales land in
        ``oi_diagnostics``.  ``desroziers_bins`` > 1 estimates them per
        latitude band: the per-cell scale maps are then kept as
        ``desroziers_sa_scale_map`` / ``desroziers_so_scale_map``.  ``mesh``:
        the scalar OI runs over the mesh's grid shards (one curve launch per
        shard, one knee), the full OI's matrix-free sweeps over all of its
        positions."""
        clock = self._clock()
        self._oi_impl(sensor, error_ctm, method, length_scale_km,
                      desroziers_iterations, desroziers_bins, mesh=mesh)
        clock.mark("oi")

    def _oi_impl(self, sensor, error_ctm, method="scalar", length_scale_km=300.0,
                 desroziers_iterations=0, desroziers_bins=1, clock=None, mesh=None):
        if method not in ("scalar", "full"):
            raise ValueError(f"method must be 'scalar' or 'full', got {method!r}")
        # a previous run's binned scale maps must not outlive it on this object
        self.desroziers_sa_scale_map = None
        self.desroziers_so_scale_map = None
        nb = int(desroziers_bins)
        iterations = int(desroziers_iterations)
        sat = self.reader_obj.sat_data[self._first_valid()]
        bins = lat_band_index(sat.latitude_center, nb) if iterations and nb > 1 else None
        device = self._device()
        if method == "full":
            self._oi_full(sensor, error_ctm, length_scale_km, iterations, nb, bins,
                          device, clock, mesh)
        else:
            self._oi_scalar(sensor, error_ctm, iterations, nb, bins, device, mesh)

    def _oi_scalar(self, sensor, error_ctm, iterations, nb, bins, device, mesh=None):
        """The scalar OI with its Desroziers loop on ``device``: one push of
        (xa, y, sigma_o), one pull of the four fields, the scale maps when
        binned, and a plane of scalars."""
        xa, y = self._oi_pair(sensor)
        xa, y, err = h2d(np.stack([np.asarray(xa), np.asarray(y),
                                   np.asarray(self.sat_averaged_error)]), device)
        sa = (xa * error_ctm / 100.0) ** 2
        so = err**2
        res = oi_op(xa, y, sa, so, regularization_on=True, mesh=mesh)
        # every moment sees the innovation the OI assimilated (its y < 0 -> 0)
        y_clip = torch.where(y < 0, torch.zeros_like(y), y)
        totals = []
        if iterations:
            bins_t = None if bins is None else h2d(bins, device)
            one = torch.ones((), dtype=torch.float64, device=device)
            sa_total = one if bins is None else torch.ones_like(xa, dtype=torch.float64)
            so_total = sa_total
            for _ in range(iterations):
                sa_step, so_step = _desroziers_step(xa, y_clip, res.xb, sa, so, bins_t, nb)
                sa, so = sa * sa_step, so * so_step
                sa_total, so_total = sa_total * sa_step, so_total * so_step
                res = oi_op(xa, y, sa, so, regularization_on=True, mesh=mesh)
            totals = [sa_total, so_total]
        st = innovation_stats(xa, y_clip, res.xb, sa, so)
        fields = [res.xb, res.averaging_kernel, res.increment, res.error]
        scalars = [res.reg_factor, *st]
        if bins is None:
            scalars += totals
        else:
            fields += totals
        plane = _scalar_plane(scalars, xa.shape, device)
        packed = d2h(torch.stack([f.to(torch.float64) for f in fields] + [plane]))
        (self.ctm_averaged_vcd_corrected, self.ak_OI, self.increment_OI,
         self.error_OI) = (p.copy() for p in packed[:4])
        scal = packed[-1].ravel()
        names = type(st)._fields
        self.oi_diagnostics = {k: float(v) for k, v in zip(names, scal[1:1 + len(names)])}
        if iterations:
            if bins is None:
                sa_np, so_np = scal[1 + len(names)], scal[2 + len(names)]
            else:
                sa_np, so_np = packed[4].copy(), packed[5].copy()
                self.desroziers_sa_scale_map = sa_np
                self.desroziers_so_scale_map = so_np
            self.oi_diagnostics.update(_desroziers_diag(nb, bins is not None, sa_np,
                                                        so_np, iterations))
            print(f"Desroziers re-estimation ({nb} bin(s)): "
                  f"Sa x{float(np.nanmean(sa_np)):.3g}, So x{float(np.nanmean(so_np)):.3g}")
        print("The regularization factor is " + str(float(scal[0])))
        d = self.oi_diagnostics
        print(f"OI diagnostics: n={int(d['n'])} OmB={d['omb_mean']:+.3g}/{d['omb_rms']:.3g} "
              f"OmA={d['oma_mean']:+.3g}/{d['oma_rms']:.3g} chi2={d['chi2']:.3g}")

    def _first_valid(self):
        return next(i for i, s in enumerate(self.reader_obj.sat_data) if s is not None)

    def full_oi_inputs(self, error_ctm=50.0, sensor=None):
        """(xa, y, sigma_b, sigma_o, lat, lon): the fields the full OI takes
        after the month's averaging -- sigma_b = xa * error_ctm / 100, sigma_o
        the averaged observation error, the first valid granule's grid (GOSAT:
        the xcol pair)."""
        xa, y = self._oi_pair(sensor)
        sat = self.reader_obj.sat_data[self._first_valid()]
        return (xa, y, np.asarray(xa) * error_ctm / 100.0,
                np.asarray(self.sat_averaged_error), sat.latitude_center,
                sat.longitude_center)

    def _oi_full(self, sensor, error_ctm, length_scale_km, iterations, nb, bins,
                 device, clock=None, mesh=None):
        """The ``method == "full"`` branch of the JAX ``_oi_impl``: the
        full-covariance OI with the regularization scan, re-solved after
        each Desroziers pass with the rescaled error standard deviations
        (the moments are gain-agnostic); the innovation statistics on the
        clamped y the OI assimilated, merged with the solver's info."""
        clock = clock or StageClock(None, device)
        xa, y, sigma_b, sigma_o, lat, lon = self.full_oi_inputs(error_ctm, sensor)

        def solve():
            return oi_full(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km,
                           regularization_on=True, device=device, stage_ms=clock.out,
                           mesh=mesh)

        def t64(a):
            return h2d(np.asarray(a, np.float64), device)

        res = solve()
        clock.mark("oi_full")
        y_clip = _clip_negative(np.asarray(y, np.float64))
        sa_total = so_total = 1.0
        if bins is not None:
            sa_total = np.ones_like(np.asarray(xa, np.float64))
            so_total = np.ones_like(sa_total)
        for _ in range(iterations):
            sa_step, so_step = (d2h(s) for s in _desroziers_step(
                t64(xa), t64(y_clip), t64(res.xb), t64(sigma_b) ** 2, t64(sigma_o) ** 2,
                None if bins is None else h2d(bins, device), nb))
            if bins is None:
                sa_step, so_step = float(sa_step), float(so_step)
            sigma_b = sigma_b * np.sqrt(sa_step)
            sigma_o = sigma_o * np.sqrt(so_step)
            sa_total = sa_total * sa_step
            so_total = so_total * so_step
            res = solve()
            clock.mark("oi_full")
        self.ctm_averaged_vcd_corrected = res.xb
        self.ak_OI = res.averaging_kernel
        self.increment_OI = res.increment
        self.error_OI = res.error
        st = innovation_stats(t64(xa), t64(y_clip), t64(res.xb), t64(sigma_b) ** 2,
                              t64(sigma_o) ** 2)
        # always rewritten: a previous run's dict must not leak into this one
        self.oi_diagnostics = {k: float(v) for k, v in st._asdict().items()}
        self.oi_diagnostics.update({k: v for k, v in (res.info or {}).items()
                                    if v is not None})
        if iterations:
            self.oi_diagnostics.update(_desroziers_diag(nb, bins is not None, sa_total,
                                                        so_total, iterations))
            if bins is not None:
                self.desroziers_sa_scale_map = sa_total
                self.desroziers_so_scale_map = so_total
        clock.mark("innovation_stats")

    # -- the fused month ------------------------------------------------------
    def analyze_month_fused(self, sensor: str, gasname: str, startdate: str,
                            enddate: str, error_ctm=50.0, weighting=None,
                            save_daily=None, oi_method="scalar", length_scale_km=300.0,
                            desroziers_iterations=0, desroziers_bins=1, stage_ms=None,
                            mesh=None):
        """The month analysis on the granules' device: the observation
        operator per granule + monthly statistics + bias correction + OI +
        innovation diagnostics, for months whose granules share one kind and
        shape: satellite_amf (AMF recalculation), MOPITT / GOSAT (AK
        convolution; GOSAT assimilates the xcol pair) and SSMIS (PWV).
        Replaces ``recal_amf / conv_ak / cal_pwv -> average -> bias_correct
        -> oi``.  O3 months apply the DU conversion in the step; months whose
        CTM must be mapped onto the granule grid (``ctm_upscaled_needed``)
        upscale the matched slices through the cached plans.

        Sets ``sat_averaged_vcd``, ``sat_averaged_error``,
        ``ctm_averaged_vcd``, ``aux1``, ``aux2``,
        ``ctm_averaged_vcd_corrected``, ``ak_OI``, ``increment_OI``,
        ``error_OI`` (numpy), ``avg_time`` and ``oi_diagnostics``, and
        returns the device ``AnalysisOutputs``.

        ``weighting``: None, "inverse_variance" or (opt kinds) "ak".
        ``save_daily=(folder, datestr)``: the per-granule operator outputs
        come back in one copy and are written as the ``sat_data_*.mat``
        files of :meth:`savedaily`.  ``oi_method`` "full" and
        ``desroziers_iterations`` > 0 skip the step's scalar OI and run the
        OI tail of :meth:`oi` on the averaged fields: the returned ``oi``
        slot then holds NaN placeholders with ``reg_index`` -1 and a scaling
        factor of ones, so read the attributes for the OI results.  ``mesh``
        (more than one position): the month step runs through its maker
        (:data:`~oisat_tpu_torch.parallel.analysis.MONTH_MAKERS`), granules
        split over 'obs' and rows over 'grid', with the result on the mesh's
        first device; the OI tail gets the mesh too.  With a ``stage_ms`` dict (the
        session's own when None), the wall milliseconds of the stages
        "assemble" (host CTM matching and H2D), "step", "pull", and on
        tail months "oi_full" (split further under "oi_full.<stage>") and
        "innovation_stats", or "oi_tail", are added to it; the unprefixed
        ones sum to the call's wall time.
        Raises ValueError for an unfusable month (no granules, mixed kinds
        or shapes, no scattering weights, "ak" weights without averaging
        kernels)."""
        if oi_method not in ("scalar", "full"):
            raise ValueError(f"oi_method must be 'scalar' or 'full', got {oi_method!r}")
        ctm_data = self.reader_obj.ctm_data
        start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), int(startdate[8:10]))
        end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), int(enddate[8:10]))
        # each granule keeps its position in sat_data: the daily files are
        # named by that counter, as in the staged walk
        pairs = [(i, g) for i, g in enumerate(self.reader_obj.sat_data)
                 if g is not None and start <= g.time.date() < end]
        grans = [g for _, g in pairs]
        if not grans:
            raise ValueError("no valid satellite granules to fuse")
        kind = _KINDS.get(type(grans[0]))
        if kind is None or not all(type(g) is type(grans[0]) for g in grans):
            raise ValueError("fused month path needs one granule kind")
        if kind == "amf":
            if any(size(g.scattering_weights) == 1 for g in grans):
                raise ValueError("fused month path needs scattering weights")
            shapes = {(tuple(g.vcd.shape), tuple(g.pressure_mid.shape)) for g in grans}
        else:
            shapes = {tuple(g.vcd.shape) for g in grans}
        if len(shapes) != 1:
            raise ValueError(f"fused month path needs one granule shape, got {shapes}")
        if weighting == "ak" and kind != "opt":
            raise ValueError("weighting='ak' needs averaging-kernel granules "
                             "(MOPITT/GOSAT); use 'inverse_variance' otherwise")
        offset, slope = BIAS_CORRECTIONS.get((sensor, gasname), (0.0, 1.0))
        if (sensor, gasname) in BIAS_CORRECTIONS:
            print(f"applying the bias correction for {sensor} {gasname}")
        ctm_scale = 1.0 / _O3_DU if gasname == "O3" else 1.0

        # full-covariance and Desroziers months run the OI tail afterwards
        oi_tail = oi_method == "full" or int(desroziers_iterations) > 0
        clock = StageClock(stage_ms if stage_ms is not None
                           else self.stage_ms, granule_device(grans[0]))
        inputs, step = self._fused_inputs(kind, sensor, ctm_data, grans)
        clock.mark("assemble")
        kw = dict(bias_offset=offset, bias_slope=slope, error_ctm=float(error_ctm),
                  ctm_scale=float(ctm_scale), weighting=weighting,
                  return_granules=save_daily is not None, run_oi=not oi_tail)
        if mesh is not None and mesh.size > 1:
            fn, shard = MONTH_MAKERS[step](mesh, **kw)
            out = fn(shard(inputs))
        else:
            out = step(inputs, **kw)
        del inputs
        clock.mark("step")
        if save_daily is not None:
            out, daily = out
            self._write_daily_mats(save_daily[0], gasname, pairs, daily)
            del daily

        packed = _pack_month_pull(out, not oi_tail)
        (self.sat_averaged_vcd, self.sat_averaged_error, self.ctm_averaged_vcd,
         self.aux1, self.aux2) = (p.copy() for p in packed[:5])
        avg_ts = sum(g.time.timestamp() for g in grans) / len(grans)
        self.avg_time = datetime.datetime.fromtimestamp(avg_ts)
        clock.mark("pull")
        if oi_tail:
            self._oi_impl(sensor, error_ctm, oi_method, length_scale_km,
                          desroziers_iterations, desroziers_bins, clock, mesh)
            if oi_method != "full":
                clock.mark("oi_tail")
            return out
        self.desroziers_sa_scale_map = None
        self.desroziers_so_scale_map = None
        (self.ctm_averaged_vcd_corrected, self.ak_OI, self.increment_OI,
         self.error_OI) = (p.copy() for p in packed[5:9])
        scal = packed[-1].ravel()
        print("The regularization factor is " + str(float(scal[0])))
        names = type(out.innovation)._fields
        self.oi_diagnostics = {k: float(v) for k, v in zip(names, scal[1:1 + len(names)])}
        return out

    @staticmethod
    def _fused_inputs(kind: str, sensor: str, ctm_data, grans):
        """(stacked month inputs, month step) for one granule kind on the
        granules' device, with the per-granule CTM matching and slicing of
        the staged operators (:mod:`oisat_tpu_torch.obs_operators`): each
        distinct matched slice is prepared once and gathered per granule."""
        device = granule_device(grans[0])
        time_ctm, time_hour = _ctm_times(ctm_data)
        cache: dict = {}

        def stacked(tensors):
            with span("assemble.stack"):
                return torch.stack(tensors)

        def stack(name):
            return stacked([getattr(g, name) for g in grans])

        if kind == "amf":
            items = [_amf_one(ctm_data, g, time_ctm, time_hour, device, cache)
                     for g in grans]
            return FullMonthInputs(
                sat_pmid=stack("pressure_mid"), sat_sw=stack("scattering_weights"),
                vcd=stack("vcd"), amf=stack("amf"), uncertainty=stack("uncertainty"),
                tropopause=stacked([it[3] for it in items]),
                ctm_pmid=stacked([it[1] for it in items]),
                ctm_pc=stacked([it[2] for it in items])), full_month_step

        def daily(host_fields, derive=None):
            """Each granule's prepared daily CTM slice: a list of tuples."""
            out = []
            for g in grans:
                _, day = _match_daily(g.time, ctm_data, time_ctm)
                out.append(_prepared(cache, ctm_data, g, day, device,
                                     lambda day=day: host_fields(day), derive))
            return out

        if kind == "ssmis":
            pcw = daily(lambda day: [_water_partial_column(ctm_data, day)])
            return SsmisMonthInputs(
                water_pc=stacked([p[0] for p in pcw]), vcd=stack("vcd"),
                uncertainty=stack("uncertainty")), ssmis_month_step

        # opt sensors: MOPITT (VCD OI) vs GOSAT (xcol-pair OI)
        if sensor == "GOSAT":
            slices = daily(lambda day: list(_time_collapsed(
                ctm_data[day], ("pressure_mid", "gas_profile"))))
            return GosatMonthInputs(
                ctm_pmid=stacked([s[0] for s in slices]),
                ctm_profile=stacked([s[1] for s in slices]),
                sat_pmid=stack("pressure_mid"), aks=stack("averaging_kernels"),
                apriori_profile=stack("apriori_profile"),
                pressure_weight=stack("pressure_weight"), vcd=stack("vcd"),
                x_col=stack("x_col"), uncertainty=stack("uncertainty")), gosat_month_step

        slices = daily(lambda day: _daily_ctm_slice(ctm_data, day), _mopitt_columns)
        return MopittMonthInputs(
            ctm_pmid=stacked([s[0] for s in slices]),
            ctm_profile=stacked([s[1] for s in slices]),
            ctm_airpc=stacked([s[2] for s in slices]),
            sat_pmid=stack("pressure_mid"), aks=stack("averaging_kernels"),
            apriori_profile=stack("apriori_profile"), aprior_col=stack("aprior_column"),
            apriori_surface=stack("apriori_surface"), vcd=stack("vcd"),
            x_col=stack("x_col"), uncertainty=stack("uncertainty")), mopitt_month_step

    # -- daily files (reference driver.py:127-146) ----------------------------
    def _daily_latlon(self):
        """CTM lat/lon for the daily files.  The reference's hazard is kept
        (reference driver.py:140-142): the first-valid *satellite* index
        addresses the CTM list, so when the first ``len(ctm_data)`` granules
        of the month are all None this raises IndexError, as the reference
        does."""
        c = self.reader_obj.ctm_data[self._first_valid()]
        return c.latitude, c.longitude

    @staticmethod
    def _write_daily_mat(folder, gasname, counter, when, vcd, ctm_vcd, err, lat, lon):
        """One reference-format daily file: the timestamp formula, the
        ``sat_data_{gas}_{t}{counter}.mat`` name and the payload keys, shared
        by :meth:`savedaily` and the fused month."""
        from scipy.io import savemat

        t = 10000.0 * when.year + 100.0 * when.month + when.day + when.hour / 24.0
        savemat(os.path.join(folder, f"sat_data_{gasname}_{t}{counter}.mat"),
                {"vcd_sat": vcd, "vcd_ctm": ctm_vcd, "vcd_err": err,
                 "time_sat": t, "lat": lat, "lon": lon})

    def _write_daily_mats(self, folder, gasname, pairs, daily):
        """The per-granule ``sat_data_*.mat`` files from the fused month's
        :class:`DailyGranules`: one device->host copy for the whole month,
        the content and counter-based names of :meth:`savedaily`."""
        os.makedirs(folder, exist_ok=True)
        count("syncs")
        vcd, ctm, err = torch.stack([f.to(torch.float64) for f in daily]).cpu().numpy()
        latitude, longitude = (np.asarray(a) for a in self._daily_latlon())
        for (counter, g), v, c, e in zip(pairs, vcd, ctm, err):
            self._write_daily_mat(folder, gasname, counter, g.time, v, c, e,
                                  latitude, longitude)

    def savedaily(self, folder, gasname, date):
        os.makedirs(folder, exist_ok=True)
        latitude, longitude = self._daily_latlon()
        for counter, sat in enumerate(self.reader_obj.sat_data):
            if sat is None:
                continue
            self._write_daily_mat(folder, gasname, counter, sat.time, d2h(sat.vcd),
                                  d2h(sat.ctm_vcd), d2h(sat.uncertainty),
                                  latitude, longitude)

    # -- stage-boundary checkpointing ----------------------------------------
    def settle_device_granules(self):
        """Nothing to settle: the port's regrid drops a granule that misses
        the analysis domain when it regrids it (``regrid_granule`` returns
        None, reference interpolator.py:165-167), so no granule carries a
        deferred validity flag and ``sat_data`` stays as it is.  Kept so the
        job runner and callers of the JAX driver find the method."""
        return

    def save_state(self, path):
        """Persist the processed granule list (its tensors pulled to the
        host); ``average -> oi -> write_to_nc`` can later resume from it
        without re-reading L2."""
        from oisat_tpu_torch.utils.granule_store import save_granules

        save_granules(path, self.reader_obj.sat_data)

    def load_state(self, path, ctm_data=None, device=None):
        """Resume from a granule checkpoint (inverse of :meth:`save_state`):
        the granules' fields become tensors on ``device`` (None: the card)."""
        from types import SimpleNamespace

        from oisat_tpu_torch.convert import granule_to
        from oisat_tpu_torch.utils.granule_store import load_granules

        device = default_device(device)
        sat = [g if g is None else granule_to(g, device) for g in load_granules(path)]
        if getattr(self, "reader_obj", None) is None:
            self.reader_obj = SimpleNamespace(ctm_data=ctm_data or [], sat_data=sat)
        else:
            self.reader_obj.sat_data = sat

    # -- outputs (reference driver.py:115-227) ---------------------------------
    def reporting(self, fname: str, gasname, folder="report"):
        from oisat_tpu_torch.report import report

        sat = self.reader_obj.sat_data[self._first_valid()]
        ctm = self.reader_obj.ctm_data[0]
        # plot on the coarser of the two grids (reference driver.py:119-129)
        if np.size(ctm.latitude) * np.size(ctm.longitude) < \
           np.size(sat.latitude_center) * np.size(sat.longitude_center):
            lat, lon = sat.latitude_center, sat.longitude_center
        else:
            lat, lon = ctm.latitude, ctm.longitude
        fields = [d2h(getattr(self, name)) for name in (
            "ctm_averaged_vcd", "ctm_averaged_vcd_corrected", "sat_averaged_vcd",
            "sat_averaged_error", "increment_OI", "ak_OI", "error_OI", "aux1", "aux2")]
        report(lon, lat, *fields, fname, folder, gasname)

    def _diag_fields(self) -> dict:
        """The diag file's variables, name -> host numpy array, in the file's
        order: each field pulled to the host once (a field the month already
        pulled is passed through), the scaling factor computed there
        (posterior / prior; NaN, inf and 0 -> 1.0, reference
        driver.py:204-209), the two per-cell Desroziers scale maps after a
        binned run."""
        sat = self.reader_obj.sat_data[self._first_valid()]
        prior = d2h(self.ctm_averaged_vcd)
        posterior = d2h(self.ctm_averaged_vcd_corrected)
        with np.errstate(invalid="ignore", divide="ignore"):
            scaling_factor = posterior / prior
        scaling_factor = np.where(
            np.isnan(scaling_factor) | np.isinf(scaling_factor) | (scaling_factor == 0.0),
            1.0, scaling_factor)
        fields = {
            "sat_averaged_vcd": d2h(self.sat_averaged_vcd),
            "ctm_averaged_vcd_prior": prior,
            "ctm_averaged_vcd_posterior": posterior,
            "sat_averaged_error": d2h(self.sat_averaged_error),
            "ak_OI": d2h(self.ak_OI),
            "error_OI": d2h(self.error_OI),
            "scaling_factor": scaling_factor,
            "lon": d2h(sat.longitude_center),
            "lat": d2h(sat.latitude_center),
            "aux1": d2h(self.aux1),
            "aux2": d2h(self.aux2),
        }
        if getattr(self, "desroziers_sa_scale_map", None) is not None:
            fields["desroziers_sa_scale"] = d2h(self.desroziers_sa_scale_map)
            fields["desroziers_so_scale"] = d2h(self.desroziers_so_scale_map)
        return fields

    def write_to_nc(self, output_file, output_folder="diag"):
        from oisat_tpu_torch.ncwriter import write_diag_nc

        os.makedirs(output_folder, exist_ok=True)
        write_diag_nc(os.path.join(output_folder, output_file + ".nc"), self._diag_fields(),
                      self.avg_time.strftime("%Y-%m-%d %H:%M:%S"),
                      global_attrs=getattr(self, "oi_diagnostics", None))
