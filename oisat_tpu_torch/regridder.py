"""Granule regridding: host weight building + one device apply.

Counterpart of :mod:`oisat_tpu.regridder` (reference
oisatgmi/interpolator.py:100-291, interpolator_ssmis.py:96-168) for
``satellite_amf`` and ``satellite_opt`` granules (:func:`regrid_granule`) and
``satellite_ssmis`` granules (:func:`regrid_ssmis_granule`):

  host   build the SparsePlan pixels -> fine grid for the granule's geometry
         and the Upscaler fine grid -> CTM grid (the port's copies
         :mod:`oisat_tpu_torch.ops.weights` and :mod:`oisat_tpu_torch.native`:
         numpy/scipy/C++);
  device stack every 2-D field and every level of every 3-D field into one
         (F, Npix) batch -> gather + weighted sum -> box filter -> nearest
         map onto the CTM grid, and the uncertainty through the same path
         as a variance with the squared box kernel, sqrt at the end.

Under :class:`regrid_mesh` (or :func:`set_regrid_mesh`, which the job
runner calls when ``mesh_devices`` > 1) the device pipeline runs over the
mesh: the fine grid's rows are split over every position, each shard
interpolated with the box filter's halo rows and filtered on its device,
and the shards concatenated on the regrid's device for the map onto the CTM
grid; the values equal the single-device regrid's bitwise.

The TPU package's transfer workarounds are not ported: no f16 narrowing,
no plan compaction, no affine carrier level for the pressure stack, no
pixel-axis buckets, no lazy/pending collection.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.convert import plan_to_torch
from oisat_tpu_torch.datamodel import satellite_amf, satellite_opt, satellite_ssmis
from oisat_tpu_torch.ops.regrid import (
    apply_plan,
    apply_plan_arrays,
    box_halo_rows,
    boxfilter_rows_padded,
    boxfilter_same_symm,
)
from oisat_tpu_torch.ops.weights import (
    SparsePlan,
    build_plan,
    build_plan_structured,
    diag_threshold,
    fine_grid,
    grid_spacing,
)
from oisat_tpu_torch.utils.lru import LockedLRU

__all__ = ["Upscaler", "make_upscaler", "regrid_granule", "regrid_ssmis_granule",
           "regrid_mesh", "set_regrid_mesh"]


@dataclasses.dataclass(frozen=True)
class Upscaler:
    """Fine grid -> coarse target grid mapping (reference ``_upscaler``):
    a (ky, kx) box filter, then the nearest-neighbour ``plan`` (leaves on
    the device) onto the target grid.

    ``needed=True`` means the source is coarser than the target: fields pass
    through and the *model* would have to be upscaled instead (reference
    interpolator.py:92-97)."""

    needed: bool
    ky: int
    kx: int
    plan: Optional[SparsePlan]
    out_lon: np.ndarray
    out_lat: np.ndarray

    def apply(self, z: torch.Tensor, error: bool = False) -> torch.Tensor:
        """``z`` (..., H, W) on the source grid, on the plan's device ->
        (..., Ht, Wt) on the target grid; ``error`` takes the squared box
        kernel."""
        if self.needed:
            return z
        zf = boxfilter_same_symm(z, self.ky, self.kx, squared=error)
        return apply_plan(self.plan, zf.reshape(zf.shape[:-2] + (-1,)))


def _geom_key(lon2d, lat2d):
    """Content-derived cache key of a 2-D grid geometry: shape, corners and
    coordinate sums (as oisat_tpu.regridder._geom_key)."""
    lon2d = np.asarray(lon2d, np.float64)
    lat2d = np.asarray(lat2d, np.float64)
    return (lon2d.shape, float(lon2d.flat[0]), float(lon2d.flat[-1]),
            float(lat2d.flat[0]), float(lat2d.flat[-1]),
            float(lon2d.sum()), float(lat2d.sum()),
            float(np.abs(lon2d).sum()), float(np.abs(lat2d).sum()))


# the fine grid and the fine->CTM map depend only on the CTM geometry, which
# every granule of a run shares; fixed-geometry products (MOPITT L3, the GOSAT
# filler's map, SSMIS) repeat their pixel->fine-grid plan too, while swath
# sensors churn that small cache (its plans sit on the device)
_fine_grid_cache = LockedLRU(8)
_upscaler_cache = LockedLRU(16)
_plan_cache = LockedLRU(4)


def _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size):
    key = (_geom_key(ctm_lon2d, ctm_lat2d), float(grid_size))
    hit = _fine_grid_cache.get(key)
    if hit is None:
        hit = fine_grid(ctm_lon2d, ctm_lat2d, grid_size)
        _fine_grid_cache.put(key, hit)
    return hit


def make_upscaler(src_lon2d, src_lat2d, tgt_lon2d, tgt_lat2d, grid_size: float,
                  threshold: float, device, method: int = 4, far_factor: float = 2.0,
                  fast: bool = True) -> Upscaler:
    """The reference ``_upscaler`` decision + mapping (interpolator.py:48-97),
    its plan on ``device``.  ``grid_size`` is the source-grid pitch,
    ``threshold`` the distance cutoff: targets farther than ``far_factor`` x
    the threshold from the nearest source point are NaN.  The main pipeline
    maps KD-nearest with the 2x cutoff (``method=4``); the SSMIS variant
    Delaunay-linear with 1x (``method=1``, ``far_factor=1``).  ``fast``
    takes the native structured-grid builder; cached per (geometries,
    options, device)."""
    dev = resolve_device(device)
    tgt_dlon, tgt_dlat = grid_spacing(tgt_lon2d, tgt_lat2d)
    if not (tgt_dlon >= grid_size or tgt_dlat >= grid_size):
        return Upscaler(True, 1, 1, None, src_lon2d, src_lat2d)
    key = (_geom_key(src_lon2d, src_lat2d), _geom_key(tgt_lon2d, tgt_lat2d),
           float(grid_size), float(threshold), int(method), float(far_factor),
           fast, str(dev))
    cached = _upscaler_cache.get(key)
    if cached is not None:
        return cached
    kx = max(int(np.floor(tgt_dlon / grid_size)), 1)
    ky = max(int(np.floor(tgt_dlat / grid_size)), 1)
    plan = _build_plan(src_lon2d, src_lat2d, tgt_lon2d, tgt_lat2d, threshold,
                       method, far_factor, fast)
    if plan is None:
        raise RuntimeError("upscaler weight build failed for a regular grid "
                           "geometry (degenerate fine/CTM grid?)")
    up = Upscaler(False, ky, kx, plan_to_torch(plan, dev), tgt_lon2d, tgt_lat2d)
    _upscaler_cache.put(key, up)
    return up


def _build_plan(src_lon, src_lat, tgt_lon2d, tgt_lat2d, threshold: float,
                method: int, far_factor: float, fast: bool):
    """The source-pixel -> target-grid SparsePlan (host numpy) for one
    geometry, or None when the swath cannot be triangulated (the reference
    skips such granules, interpolator.py:151-155).  ``fast`` tries the native
    structured builder first (2-D pixel grids, methods 1/2/4)."""
    plan = None
    if fast and method in (1, 2, 4) and np.ndim(src_lon) == 2:
        plan = build_plan_structured(src_lon, src_lat, tgt_lon2d, tgt_lat2d,
                                     threshold=threshold, far_factor=far_factor,
                                     method=method)
    if plan is None:
        plan = build_plan(np.asarray(src_lon).ravel(), np.asarray(src_lat).ravel(),
                          tgt_lon2d, tgt_lat2d, method=method,
                          threshold=threshold, far_factor=far_factor)
    return plan


def _granule_plan(sat_lon, sat_lat, lons_fine, lats_fine, grid_size: float,
                  method: int, far_factor: float, fast: bool, device):
    """The pixel -> fine-grid SparsePlan of one granule geometry with its
    ``idx`` / ``w`` / ``mask`` on ``device``, or None for an untriangulatable
    granule (not cached).  Cached per (geometries, grid_size, method,
    far_factor, fast, device)."""
    key = (_geom_key(np.atleast_2d(np.asarray(sat_lon)), np.atleast_2d(np.asarray(sat_lat))),
           _geom_key(lons_fine, lats_fine), float(grid_size), int(method),
           float(far_factor), bool(fast), str(device))
    hit = _plan_cache.get(key)
    if hit is not None:
        return hit
    plan = _build_plan(sat_lon, sat_lat, lons_fine, lats_fine, grid_size, method,
                       far_factor, fast)
    if plan is None:
        return None
    plan = plan_to_torch(plan, device)
    _plan_cache.put(key, plan)
    return plan


def _quality_mask(quality_flag, flag_thresh: float, dtype=np.float32) -> np.ndarray:
    """QA mask as the reference builds it: 1.0 where flag > thresh else NaN
    (interpolator.py:124-127), in the regridded fields' ``dtype``."""
    m = (np.asarray(quality_flag) > flag_thresh).astype(dtype)
    m[m != 1.0] = np.nan
    return np.squeeze(m)


def _host_dtype(dtype):
    """The numpy type of the host stack for a regrid's ``dtype``: float64 or
    float32, as the JAX package's ``host_dtype``."""
    return np.float64 if dtype == np.float64 else np.float32


def _regrid_device_impl(batch, err, idx, w, mask, up_idx, up_w, up_mask,
                        fine_shape, ky: int, kx: int, passthrough: bool,
                        square_err: bool = True):
    """The per-granule device pipeline: the value batch and the error field
    onto the fine grid, box filter (the error with the squared kernel), map
    onto the CTM grid.  ``square_err``: ``err`` arrives as the raw
    uncertainty and is squared here (the SSMIS variant keeps it raw)."""
    if square_err:
        err = err * err
    fine = apply_plan_arrays(batch, idx, w, mask).reshape(batch.shape[:-1] + fine_shape)
    fine_err = apply_plan_arrays(err, idx, w, mask).reshape(err.shape[:-1] + fine_shape)
    if passthrough:
        return fine, fine_err
    zf = boxfilter_same_symm(fine, ky, kx)
    zef = boxfilter_same_symm(fine_err, ky, kx, squared=True)
    out = apply_plan_arrays(zf.reshape(zf.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    out_err = apply_plan_arrays(zef.reshape(zef.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    return out, out_err


# PROCESS-WIDE, not a threading.local: the readers regrid in worker threads
# (readers.sensors.common.fleet_map), which would never see a mesh the job
# runner's main thread set thread-locally.
_REGRID_MESH = {"mesh": None}


class regrid_mesh:
    """Context manager: regrids inside run over ``mesh`` (None or a mesh of
    one position: the single-device pipeline).  Process-wide scope."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = _REGRID_MESH["mesh"]
        _REGRID_MESH["mesh"] = self.mesh
        return self

    def __exit__(self, *exc):
        _REGRID_MESH["mesh"] = self._prev
        return False


def set_regrid_mesh(mesh) -> None:
    """Set the regrid mesh of the process (the job runner does, once per
    month); None restores the single-device pipeline."""
    _REGRID_MESH["mesh"] = mesh


def _regrid_mesh_default():
    m = _REGRID_MESH["mesh"]
    return m if (m is not None and m.size > 1) else None


def _sharded_regrid_fn(mesh):
    """The device pipeline with the fine grid's rows split over every
    position of ``mesh`` (:func:`_regrid_device_sharded`)."""
    return functools.partial(_regrid_device_sharded, devices=mesh.flat_devices())


def _regrid_device_sharded(batch, err, idx, w, mask, up_idx, up_w, up_mask,
                           fine_shape, ky: int, kx: int, passthrough: bool,
                           square_err: bool = True, *, devices):
    """:func:`_regrid_device_impl` over row shards of the fine grid: shard k
    (rows [r0, r1), on ``devices[k]``) interpolates its rows plus the box
    filter's halo (``ky // 2`` rows above, ``(ky - 1) // 2`` below, the
    symmetric boundary at the grid's edges) from the replicated batch and
    filters them there; the shards are concatenated on ``batch``'s device,
    where the upscale gather runs.  Every value is computed as the
    single-device pipeline computes it."""
    if square_err:
        err = err * err
    fh, fw = fine_shape
    halo = (np.arange(fh) if passthrough
            else box_halo_rows(fh, ky, "cpu").numpy())  # source row of each padded row
    pad = 0 if passthrough else ky - 1
    k = idx.shape[-1]
    idx3, w3, mask2 = idx.reshape(fh, fw, k), w.reshape(fh, fw, k), mask.reshape(fh, fw)
    fine, fine_err = [], []
    for dev, rows in zip(devices, np.array_split(np.arange(fh), len(devices))):
        if rows.size == 0:
            continue
        src = torch.as_tensor(halo[rows[0]:rows[-1] + 1 + pad], device=idx.device)
        sel = [t[src].to(dev) for t in (idx3, w3, mask2)]
        plan = (sel[0].reshape(-1, k), sel[1].reshape(-1, k), sel[2].reshape(-1))
        shape = (src.numel(), fw)
        z = apply_plan_arrays(batch.to(dev), *plan).reshape(batch.shape[:-1] + shape)
        ze = apply_plan_arrays(err.to(dev), *plan).reshape(err.shape[:-1] + shape)
        if not passthrough:
            z = boxfilter_rows_padded(z, ky, kx)
            ze = boxfilter_rows_padded(ze, ky, kx, squared=True)
        fine.append(z.to(batch.device))
        fine_err.append(ze.to(batch.device))
    zf, zef = torch.cat(fine, dim=-2), torch.cat(fine_err, dim=-2)
    if passthrough:
        return zf, zef
    out = apply_plan_arrays(zf.reshape(zf.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    out_err = apply_plan_arrays(zef.reshape(zef.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    return out, out_err


def _finish_device_fields(gridded, err_gridded, layout, hw):
    """Post-processing on the device: the (H, W) reshape, the error sqrt,
    the named 2-D row picks and the contiguous 3-D stack slices.  ``layout``
    is the batch row order: 2-D names, then ``"name:z"`` stack rows."""
    gridded = gridded.reshape(gridded.shape[:1] + tuple(hw))
    err_gridded = err_gridded.reshape(err_gridded.shape[:1] + tuple(hw))
    idx = {n: i for i, n in enumerate(layout)}
    out = {n: gridded[i] for n, i in idx.items() if ":" not in n}
    out["uncertainty"] = torch.sqrt(err_gridded[0])
    stacks: dict = {}
    for n in layout:
        if ":" in n:
            base = n.rsplit(":", 1)[0]
            stacks[base] = stacks.get(base, 0) + 1
    for base, n_lv in stacks.items():
        i0 = idx[f"{base}:0"]  # z-rows are contiguous in the batch
        out[base] = gridded[i0:i0 + n_lv]
    return out


def _run_regrid(plan, upsc, batch, err, device, square_err: bool):
    """One granule's (F, Npix) value batch and (1, Npix) error row through
    the device pipeline; returns (values, errors, (H, W) of the result)."""
    if upsc.needed:
        up = (None, None, None)
        hw = tuple(plan.out_shape)
    else:
        up = (upsc.plan.idx, upsc.plan.w, upsc.plan.mask)
        hw = tuple(upsc.out_lat.shape)
    mesh = _regrid_mesh_default()
    regrid_fn = _regrid_device_impl if mesh is None else _sharded_regrid_fn(mesh)
    out, out_err = regrid_fn(
        torch.as_tensor(batch, device=device), torch.as_tensor(err, device=device),
        plan.idx, plan.w, plan.mask, *up, tuple(plan.out_shape),
        upsc.ky, upsc.kx, upsc.needed, square_err)
    return out, out_err, hw


def regrid_granule(interpolator_type: int, grid_size: float, sat_data,
                   ctm_lon2d: np.ndarray, ctm_lat2d: np.ndarray, device,
                   flag_thresh: float = 0.75, fast_swath: bool = True,
                   dtype=np.float32):
    """Regrid one ``satellite_amf`` or ``satellite_opt`` granule (host numpy
    leaves) onto the CTM grid; returns a granule of the same kind whose
    fields are ``dtype`` (float32 or float64) tensors on ``device``, or None
    when the granule cannot be triangulated or misses the domain (reference
    interpolator.py:151-155, :165-167).  The host stack, the QA mask and the
    device batch all follow ``dtype``, as in the JAX ``regrid_granule``.

    ``fast_swath`` takes the native structured-swath weight builder
    (production); ``False`` takes the scipy qhull/cKDTree builders that
    bit-match the reference (the JAX package's ``OISAT_PARITY=1`` mode).
    """
    is_amf = isinstance(sat_data, satellite_amf)
    is_opt = isinstance(sat_data, satellite_opt)
    if not (is_amf or is_opt):
        raise TypeError(f"unsupported granule type {type(sat_data)!r}: regrid_granule "
                        "takes the port's satellite_amf and satellite_opt "
                        "(satellite_ssmis: regrid_ssmis_granule)")
    dev = resolve_device(device)
    threshold_ctm = diag_threshold(ctm_lon2d, ctm_lat2d)
    lons_fine, lats_fine = _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size)
    plan = _granule_plan(sat_data.longitude_center, sat_data.latitude_center,
                         lons_fine, lats_fine, grid_size, method=interpolator_type,
                         far_factor=2.0, fast=fast_swath, device=dev)
    if plan is None:
        return None
    upsc = make_upscaler(lons_fine, lats_fine, ctm_lon2d, ctm_lat2d, grid_size,
                         threshold_ctm, dev, method=4, far_factor=2.0, fast=fast_swath)
    host_dtype = _host_dtype(dtype)
    mask = _quality_mask(sat_data.quality_flag, flag_thresh, host_dtype)

    names: list = []
    rows: list = []

    def add2d(name, arr):
        names.append(name)
        rows.append(np.squeeze(np.asarray(arr)))

    def add3d(name, arr):
        a = np.asarray(arr)
        for z in range(a.shape[0]):
            names.append(f"{name}:{z}")
            rows.append(np.squeeze(a[z]))

    add2d("vcd", sat_data.vcd)
    if is_amf:
        add2d("amf", sat_data.amf)
    if np.size(sat_data.tropopause) != 1:
        add2d("tropopause", sat_data.tropopause)
    has_sw = is_amf and np.size(sat_data.scattering_weights) != 1
    if has_sw:
        add3d("scattering_weights", sat_data.scattering_weights)
        add3d("pressure_mid", sat_data.pressure_mid)
    if is_opt:
        gosat = sat_data.sensor == "GOSAT"
        # all-zero placeholders (np.zeros((1,)) of the readers) stay out
        for name in ("aprior_column", "surface_pressure", "apriori_surface"):
            if np.asarray(getattr(sat_data, name)).any():
                add2d(name, getattr(sat_data, name))
        add2d("x_col", sat_data.x_col)
        add3d("averaging_kernels", sat_data.averaging_kernels)
        if gosat:
            add3d("pressure_weight", sat_data.pressure_weight)
        add3d("pressure_mid", sat_data.pressure_mid)
        add3d("apriori_profile", sat_data.apriori_profile)

    # cast first, then the QA multiply (mask is exactly 1.0 or NaN)
    batch = np.stack([(np.asarray(r, host_dtype) * mask).ravel() for r in rows])
    err = (np.asarray(np.squeeze(sat_data.uncertainty), host_dtype) * mask).ravel()[None]
    out, out_err, hw = _run_regrid(plan, upsc, batch, err, dev, square_err=True)
    d = _finish_device_fields(out, out_err, tuple(names), hw)

    vcd = d["vcd"]
    if bool(torch.isnan(vcd).all()):
        return None  # granule misses the analysis domain
    common = dict(
        vcd=vcd, time=sat_data.time, tropopause=d.get("tropopause", np.empty((1,))),
        latitude_center=upsc.out_lat, longitude_center=upsc.out_lon,
        latitude_corner=[], longitude_corner=[], uncertainty=d["uncertainty"],
        quality_flag=[], ctm_upscaled_needed=upsc.needed, ctm_vcd=[], ctm_time_at_sat=[])
    if is_opt:
        return satellite_opt(
            profile=[], pressure_mid=d["pressure_mid"],
            averaging_kernels=d["averaging_kernels"], ctm_xcol=[],
            aprior_column=d.get("aprior_column", np.zeros((1,))),
            apriori_profile=d["apriori_profile"],
            surface_pressure=d.get("surface_pressure", np.zeros((1,))),
            apriori_surface=d.get("apriori_surface", np.zeros((1,))),
            x_col=d["x_col"],
            pressure_weight=d["pressure_weight"] if gosat else np.empty((1,)),
            sensor=sat_data.sensor, **common)
    nz = np.shape(sat_data.pressure_mid)[0] if np.size(sat_data.pressure_mid) > 1 else 0
    if has_sw:
        sw, pmid = d["scattering_weights"], d["pressure_mid"]
    else:
        sw = np.empty((1,))
        pmid = torch.zeros((nz,) + tuple(hw), dtype=vcd.dtype, device=dev)
    return satellite_amf(amf=d["amf"], pressure_mid=pmid, scattering_weights=sw,
                         old_amf=[], new_amf=[], **common)


def regrid_ssmis_granule(grid_size: float, sat_data, ctm_lon2d: np.ndarray,
                         ctm_lat2d: np.ndarray, device, fast_swath: bool = True,
                         dtype=np.float32):
    """The SSMIS variant (reference interpolator_ssmis.py:96-168): one
    ``satellite_ssmis`` granule (host numpy leaves) onto the CTM grid, its
    ``vcd`` and ``uncertainty`` ``dtype`` (float32 or float64) tensors on
    ``device``.

    Differences from :func:`regrid_granule`, as in the reference: no quality
    mask; the raw uncertainty (not its square) goes through the squared
    error kernel with no final sqrt; both the granule interpolation and the
    fine -> CTM map are Delaunay-linear with a 1x (not 2x) distance cutoff
    (interpolator_ssmis.py:18-28, :67-70, :88-89); no all-NaN check.  The
    geometry stays float64, as in the JAX package (the reference casts the
    fine-grid coordinates to float16)."""
    if not isinstance(sat_data, satellite_ssmis):
        raise TypeError(f"unsupported granule type {type(sat_data)!r}: "
                        "regrid_ssmis_granule takes the port's satellite_ssmis")
    dev = resolve_device(device)
    threshold_ctm = diag_threshold(ctm_lon2d, ctm_lat2d)
    lons_fine, lats_fine = _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size)
    plan = _granule_plan(sat_data.longitude_center, sat_data.latitude_center,
                         lons_fine, lats_fine, grid_size, method=1, far_factor=1.0,
                         fast=fast_swath, device=dev)
    if plan is None:
        return None
    upsc = make_upscaler(lons_fine, lats_fine, ctm_lon2d, ctm_lat2d, grid_size,
                         threshold_ctm, dev, method=1, far_factor=1.0, fast=fast_swath)
    host_dtype = _host_dtype(dtype)
    out, out_err, hw = _run_regrid(
        plan, upsc, np.asarray(sat_data.vcd, host_dtype).ravel()[None],
        np.asarray(sat_data.uncertainty, host_dtype).ravel()[None], dev, square_err=False)
    return satellite_ssmis(
        vcd=out[0].reshape(hw),
        # the raw value through the squared kernel, no sqrt
        uncertainty=out_err[0].reshape(hw), time=sat_data.time,
        latitude_center=upsc.out_lat, longitude_center=upsc.out_lon,
        ctm_upscaled_needed=upsc.needed, ctm_vcd=[], sensor="SSMIS")
