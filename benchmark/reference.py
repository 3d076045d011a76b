"""Plain reference of a month job, in PyTorch on the run's device.

Independent of the program: it imports neither ``oisat_tpu_torch`` nor
``oisat_tpu`` nor ``jax``, and reads only the benchmark's own inputs (the
generators' granules and CTM) and a configuration.  It follows the
semantics of the reference recipes (OI-SAT-GMI's interpolator, amf_recal,
ak_conv_mopitt, averaging and optimal_interpolation), written from their
definitions:

* regrid: linear interpolation of every QA-masked field on the swath's
  natural quad triangulation (each quad (i, j)..(i+1, j+1) split along that
  diagonal into (p00, p10, p11) and (p00, p11, p01); a target takes the
  first triangle that holds it in (quad, triangle) order; NaN where no
  triangle holds it or its nearest pixel is farther than twice the grid
  size), the error as a variance; then, unless the CTM grid is finer, a
  ky x kx box filter with ``convolve2d(mode='same', boundary='symm')``
  semantics (the error with the squared kernel) and the nearest fine point
  of each CTM cell (ties to the lowest flat index);
* observation operators: one per granule kind, in ``benchmark/kinds/``
  (found by the granule's ``kind``), with the helpers here;
* the monthly average (nanmean; error sqrt(nansum err^2) / N), the bias
  correction, and the OI the control keys name: the scalar OI (the
  99-factor mean-AK curve and its Kneedle knee) or, with ``oi_method:
  full``, the full-covariance OI of :mod:`benchmark.reference_full_oi`.

Every stage computes in the precision a :class:`Precision` gives it: the
reference runs all of them in float64; the control, one step below what the
configuration states.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

__all__ = ["Precision", "REGS", "kneedle_index", "fine_axes", "regrid", "ctm_on_grid",
           "granule_kind", "month_reference", "scalar_oi"]

f64 = torch.float64
MAIR, GRAV, N_A = 28.97e-3, 9.80665, 6.02214076e23
# the reference's regularization grid, np.arange(0.1, 10, 0.1)
REGS = np.arange(0.1, 10.0, 0.1)
_DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
# one step below a stated precision (the control's)
LOWER = {"float64": "float32", "float32": "bfloat16"}


# the granule kinds' files, one per kind, found by name
KINDS = Path(__file__).resolve().parent / "kinds"
_kinds: dict = {}


def granule_kind(name: str):
    """The module of a granule kind: ``benchmark/kinds/<name>.py`` (of
    ``KINDS``), loaded once."""
    path = KINDS / f"{name}.py"
    mod = _kinds.get(path)
    if mod is None:
        if not path.is_file():
            raise KeyError(f"no granule kind {name!r}: {path} is not there")
        spec = importlib.util.spec_from_file_location(f"benchmark.kinds.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _kinds[path] = mod
    return mod


class Precision:
    """The dtype of each stage.  ``Precision.reference()`` runs every stage
    in float64; ``Precision.control(stated)`` one step below ``stated``
    (float64 -> float32, float32 -> bfloat16)."""

    def __init__(self, stages: dict):
        self.stages = dict(stages)

    @classmethod
    def reference(cls):
        return cls({})

    @classmethod
    def control(cls, stated: dict):
        return cls({stage: LOWER[p] for stage, p in stated.items()})

    def name(self, stage: str) -> str:
        return self.stages.get(stage, "float64")

    def dtype(self, stage: str) -> torch.dtype:
        return _DTYPES[self.name(stage)]


def kneedle_index(x, y, fallback: int = 0) -> int:
    """Kneedle (Satopaa et al. 2011; concave, increasing, S = 1): index of
    the knee of (x, y), or ``fallback`` for a NaN, flat or knee-less curve."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.size
    if n < 2 or not np.all(np.isfinite(y)) or y.max() == y.min():
        return fallback
    xn = (x - x.min()) / (x.max() - x.min())
    yn = (y - y.min()) / (y.max() - y.min())
    d = yn - xn
    left = np.concatenate([d[:1], d[:-1]])
    right = np.concatenate([d[1:], d[-1:]])
    is_max = (d >= left) & (d >= right)
    is_min = (d <= left) & (d <= right)
    if not is_max.any():
        return fallback
    offset = np.abs(np.diff(xn).mean())
    threshold, index = 0.0, fallback
    for i in range(int(np.argmax(is_max)), n):
        if xn[i] == 1.0:
            break
        if is_max[i]:
            threshold, index = d[i] - offset, i
        if is_min[i]:
            threshold = 0.0
        if i + 1 >= n:
            break
        if d[i + 1] < threshold:
            return index
    return fallback


# ---------------------------------------------------------------------------
# regrid
# ---------------------------------------------------------------------------

def fine_axes(ctm_lon2d, ctm_lat2d, grid_size: float):
    """1-D longitudes and latitudes of the fine analysis mesh over the CTM
    domain: ``np.arange(min, max + grid_size, grid_size)``."""
    lon = np.arange(float(np.min(ctm_lon2d)), float(np.max(ctm_lon2d)) + grid_size, grid_size)
    lat = np.arange(float(np.min(ctm_lat2d)), float(np.max(ctm_lat2d)) + grid_size, grid_size)
    return lon, lat


def _spacing(lon2d, lat2d):
    return abs(float(lon2d[0, 0]) - float(lon2d[0, 1])), abs(float(lat2d[0, 0]) - float(lat2d[1, 0]))


def _nearest_axis(src_axis: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Index of the nearest point of a regular ascending axis to each q,
    ties to the lower index."""
    step = src_axis[1] - src_axis[0]
    t = (q - src_axis[0]) / step
    i = np.ceil(t - 0.5).astype(np.int64)
    return np.clip(i, 0, src_axis.size - 1)


def nearest_map(src_lon1d, src_lat1d, tgt_lon2d, tgt_lat2d, max_dist: float):
    """(flat source index, too-far mask) of the nearest point of a regular
    (lat, lon) mesh for every target, ties to the lowest flat index."""
    ix = _nearest_axis(src_lon1d, np.asarray(tgt_lon2d, np.float64).ravel())
    iy = _nearest_axis(src_lat1d, np.asarray(tgt_lat2d, np.float64).ravel())
    d = np.hypot(src_lon1d[ix] - np.asarray(tgt_lon2d).ravel(),
                 src_lat1d[iy] - np.asarray(tgt_lat2d).ravel())
    return iy * src_lon1d.size + ix, d > max_dist


def box_same_symm(z: torch.Tensor, ky: int, kx: int, squared: bool = False) -> torch.Tensor:
    """``scipy.signal.convolve2d(z, ones((ky, kx)) / denom, mode='same',
    boundary='symm')`` over the last two axes (denom ky kx, or its square)."""
    h, w = z.shape[-2:]
    rows = torch.as_tensor(np.pad(np.arange(h), (ky // 2, (ky - 1) // 2), mode="symmetric"),
                           device=z.device)
    cols = torch.as_tensor(np.pad(np.arange(w), (kx // 2, (kx - 1) // 2), mode="symmetric"),
                           device=z.device)
    zp = z.index_select(-2, rows).index_select(-1, cols)
    s = torch.zeros_like(z)
    for a in range(ky):
        for b in range(kx):
            s = s + zp[..., a:a + h, b:b + w]
    return s / ((ky * kx) ** 2 if squared else ky * kx)


class Triangulation:
    """Every fine-grid target inside a triangle of a swath's natural quad
    triangulation, with its three pixels and barycentric weights."""

    def __init__(self, lon2d, lat2d, lon_g, lat_g, max_dist: float, device):
        lon = np.asarray(lon2d, np.float64)
        lat = np.asarray(lat2d, np.float64)
        ny, nx = lon.shape
        qy, qx = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
        p00 = (qy * nx + qx).ravel()
        p01, p10 = p00 + 1, p00 + nx
        p11 = p10 + 1
        fl, ft = lon.ravel(), lat.ravel()
        quad = np.stack([p00, p10, p11, p01], 1)
        span = fl[quad].max(1) - fl[quad].min(1)
        keep = span <= 180.0  # quads across the antimeridian are not triangles of the swath
        tris = np.concatenate([np.stack([p00, p10, p11], 1), np.stack([p00, p11, p01], 1)])
        order = np.concatenate([2 * np.arange(p00.size), 2 * np.arange(p00.size) + 1])
        ok = np.concatenate([keep, keep])
        tris, order = tris[ok], order[ok]
        x0, dx = lon_g[0], lon_g[1] - lon_g[0]
        y0, dy = lat_g[0], lat_g[1] - lat_g[0]
        tx, ty = fl[tris], ft[tris]
        ix0 = np.clip(np.ceil((tx.min(1) - x0) / dx - 1e-9), 0, lon_g.size).astype(np.int64)
        ix1 = np.clip(np.floor((tx.max(1) - x0) / dx + 1e-9), -1, lon_g.size - 1).astype(np.int64)
        iy0 = np.clip(np.ceil((ty.min(1) - y0) / dy - 1e-9), 0, lat_g.size).astype(np.int64)
        iy1 = np.clip(np.floor((ty.max(1) - y0) / dy + 1e-9), -1, lat_g.size - 1).astype(np.int64)
        wx = np.maximum(ix1 - ix0 + 1, 0)
        wy = np.maximum(iy1 - iy0 + 1, 0)
        has = (wx > 0) & (wy > 0)
        tris, order, tx, ty = tris[has], order[has], tx[has], ty[has]
        ix0, iy0, wx, wy = ix0[has], iy0[has], wx[has], wy[has]
        parts = []
        for a in range(int(wy.max(initial=0))):
            for b in range(int(wx.max(initial=0))):
                sel = (a < wy) & (b < wx)
                if not sel.any():
                    continue
                gx, gy = ix0[sel] + b, iy0[sel] + a
                X, Y = lon_g[gx], lat_g[gy]
                x1, y1 = tx[sel, 0], ty[sel, 0]
                x2, y2 = tx[sel, 1], ty[sel, 1]
                x3, y3 = tx[sel, 2], ty[sel, 2]
                det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
                good = np.abs(det) >= 1e-300
                det = np.where(good, det, 1.0)
                l1 = ((y2 - y3) * (X - x3) + (x3 - x2) * (Y - y3)) / det
                l2 = ((y3 - y1) * (X - x3) + (x1 - x3) * (Y - y3)) / det
                l3 = 1.0 - l1 - l2
                inside = good & (l1 >= -1e-12) & (l2 >= -1e-12) & (l3 >= -1e-12)
                parts.append((gy[inside] * lon_g.size + gx[inside], order[sel][inside],
                              np.stack([l1, l2, l3], 1)[inside], tris[sel][inside]))
        if parts:
            t = np.concatenate([p[0] for p in parts])
            key = np.concatenate([p[1] for p in parts])
            w = np.concatenate([p[2] for p in parts])
            idx = np.concatenate([p[3] for p in parts])
        else:
            t, key = np.zeros(0, np.int64), np.zeros(0, np.int64)
            w, idx = np.zeros((0, 3)), np.zeros((0, 3), np.int64)
        # per target, the triangle of lowest (quad, triangle) order
        srt = np.lexsort((key, t))
        t, w, idx = t[srt], w[srt], idx[srt]
        first = np.ones(t.size, bool)
        first[1:] = t[1:] != t[:-1]
        t, w, idx = t[first], w[first], idx[first]
        # nearest-pixel cutoff: a vertex within reach settles it; the rest
        # are measured against every pixel
        X, Y = lon_g[t % lon_g.size], lat_g[t // lon_g.size]
        dv = np.hypot(fl[idx] - X[:, None], ft[idx] - Y[:, None]).min(1)
        far = dv > max_dist
        if far.any():
            from scipy.spatial import cKDTree

            dn, _ = cKDTree(np.column_stack([fl, ft])).query(np.column_stack([X[far], Y[far]]))
            drop = np.zeros(t.size, bool)
            drop[np.flatnonzero(far)[dn > max_dist]] = True
            t, w, idx = t[~drop], w[~drop], idx[~drop]
        self.shape = (lat_g.size, lon_g.size)
        self.targets = torch.as_tensor(t, device=device)
        self.idx = torch.as_tensor(idx, device=device)
        self.w = torch.as_tensor(w, device=device)

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """(F, Npix) values -> (F, H, W) on the fine mesh, NaN off the swath."""
        w = self.w.to(z.dtype)
        v = (z[:, self.idx[:, 0]] * w[:, 0] + z[:, self.idx[:, 1]] * w[:, 1]
             + z[:, self.idx[:, 2]] * w[:, 2])
        out = torch.full((z.shape[0], self.shape[0] * self.shape[1]), math.nan,
                         dtype=z.dtype, device=z.device)
        out[:, self.targets] = v
        return out.reshape(z.shape[0], *self.shape)


def regrid(gran: dict, ctm_lon2d, ctm_lat2d, reg: dict, device, dtype=f64) -> dict:
    """One granule regridded onto the analysis grid in ``dtype``: the 2-D and
    3-D fields its kind names, its uncertainty, and the grid's (lat2d,
    lon2d)."""
    gs = float(reg["grid_size"])
    lon_g, lat_g = fine_axes(ctm_lon2d, ctm_lat2d, gs)
    tri = Triangulation(gran["longitude_center"], gran["latitude_center"], lon_g, lat_g,
                        2.0 * gs, device)
    qa = np.asarray(gran["quality_flag"], np.float64)
    mask = np.where(qa > reg["flag_thresh"], 1.0, np.nan)
    kind = granule_kind(gran["kind"])
    two, three = kind.FIELDS2, kind.FIELDS3
    rows, layout = [], []
    for name in two:
        rows.append(np.asarray(gran[name], np.float64) * mask)
        layout.append((name, 1))
    for name in three:
        a = np.asarray(gran[name], np.float64)
        rows.extend(a[z] * mask for z in range(a.shape[0]))
        layout.append((name, a.shape[0]))
    rows.append(np.asarray(gran["uncertainty"], np.float64) ** 2 * mask)
    batch = torch.as_tensor(np.stack([r.ravel() for r in rows]), device=device).to(dtype)
    fine = tri.apply(batch)
    dlon, dlat = _spacing(ctm_lon2d, ctm_lat2d)
    if dlon >= gs or dlat >= gs:
        kx, ky = max(int(math.floor(dlon / gs)), 1), max(int(math.floor(dlat / gs)), 1)
        vals = box_same_symm(fine[:-1], ky, kx)
        err = box_same_symm(fine[-1:], ky, kx, squared=True)
        src, far = nearest_map(lon_g, lat_g, ctm_lon2d, ctm_lat2d,
                               2.0 * math.hypot(dlon, dlat))
        src = torch.as_tensor(src, device=device)
        farm = torch.as_tensor(far, device=device)
        hw = np.shape(ctm_lat2d)

        def pick(z):
            out = z.reshape(z.shape[0], -1)[:, src]
            out[:, farm] = math.nan
            return out.reshape(z.shape[0], *hw)

        vals, err = pick(vals), pick(err)
        grid = (np.asarray(ctm_lat2d, np.float64), np.asarray(ctm_lon2d, np.float64))
        upscaled = False
    else:
        vals, err = fine[:-1], fine[-1:]
        lon2, lat2 = np.meshgrid(lon_g, lat_g)
        grid = (lat2, lon2)
        upscaled = True
    out, i = {}, 0
    for name, n in layout:
        out[name] = vals[i] if n == 1 and name in two else vals[i:i + n]
        i += n
    out["uncertainty"] = torch.sqrt(err[0])
    out["grid"] = grid
    out["ctm_upscaled_needed"] = upscaled
    return out


# ---------------------------------------------------------------------------
# observation operators
# ---------------------------------------------------------------------------

def _interp_columns(xp, fp, xq, extrapolate: bool):
    """Linear interpolation along axis 0 of (L, N) columns, monotonic xp in
    either direction; outside the data range extended (``extrapolate``) or
    NaN."""
    desc = xp[0] > xp[-1]
    xs = torch.where(desc, xp.flip(0), xp).T.contiguous()
    fs = torch.where(desc, fp.flip(0), fp).T
    q = xq.T.contiguous()
    hi = torch.searchsorted(xs, q, right=True).clamp(1, xs.shape[1] - 1)
    lo = hi - 1
    x0, x1 = xs.gather(1, lo), xs.gather(1, hi)
    f0, f1 = fs.gather(1, lo), fs.gather(1, hi)
    out = f0 + (q - x0) / (x1 - x0) * (f1 - f0)
    if not extrapolate:
        out = torch.where((q < xs[:, :1]) | (q > xs[:, -1:]), torch.nan, out)
    return out.T


def _nansum0(x):
    return torch.nan_to_num(x, nan=0.0).sum(0) if x.dtype != torch.bfloat16 else \
        torch.where(torch.isnan(x), torch.zeros_like(x), x).sum(0)


def partial_column(dp, ppbv):
    return dp * ppbv / GRAV / MAIR * N_A * 1e-4 * 1e-15 * 100.0 * 1e-9


def ctm_on_grid(ctm: dict, grid, upscaled: bool, prec: Precision, device):
    """The CTM without its time axis (averaged over its snapshots by
    nanmean, where it has one), its air partial column, and each mapped onto
    the granule grid (box filter, then the nearest CTM cell) when the
    granule grid is coarser: (pmid, profile, air partial column), each
    (L, H, W)."""
    cd, an = prec.dtype("ctm_time_collapse"), prec.dtype("analysis")

    def collapse(name):
        a = torch.as_tensor(ctm[name], device=device)
        if a.dim() == 3:  # one snapshot, no time axis
            return a.to(an)
        a = a.to(cd)
        return torch.nanmean(a.float() if cd == torch.bfloat16 else a, 0).to(cd).to(an)

    pmid, prof, dp = collapse("pressure_mid"), collapse("gas_profile"), collapse("delta_p")
    airpc = dp / GRAV / MAIR * N_A * 1e-4 * 1e-15 * 100.0
    if not upscaled:
        return pmid, prof, airpc
    lat2, lon2 = grid
    clon, clat = np.asarray(ctm["longitude"], np.float64), np.asarray(ctm["latitude"], np.float64)
    dlon_c, dlat_c = _spacing(clon, clat)
    dlon_s, dlat_s = _spacing(lon2, lat2)
    gs = math.hypot(dlon_c, dlat_c)
    stack = torch.cat([pmid, prof, airpc])
    if dlon_s >= gs or dlat_s >= gs:
        kx, ky = max(int(math.floor(dlon_s / gs)), 1), max(int(math.floor(dlat_s / gs)), 1)
        stack = box_same_symm(stack, ky, kx)
        src, far = nearest_map(clon[0], clat[:, 0], lon2, lat2, 2.0 * math.hypot(dlon_s, dlat_s))
        out = stack.reshape(stack.shape[0], -1)[:, torch.as_tensor(src, device=device)]
        out[:, torch.as_tensor(far, device=device)] = math.nan
        stack = out.reshape(stack.shape[0], *lat2.shape)
    n = pmid.shape[0]
    return stack[:n], stack[n:2 * n], stack[2 * n:]


class _Average:
    """Running NaN-masked sums and counts of the monthly statistics."""

    def __init__(self):
        self.s, self.n = {}, {}

    def add(self, name, x):
        valid = ~torch.isnan(x)
        x0 = torch.where(valid, x, torch.zeros_like(x))
        self.s[name] = self.s.get(name, 0) + x0
        self.n[name] = self.n.get(name, 0) + valid.to(torch.int64)

    def mean(self, name):
        n = self.n[name]
        return torch.where(n > 0, self.s[name] / n, torch.nan)

    def error(self, name):
        n = self.n[name].to(self.s[name].dtype)
        return torch.sqrt(torch.where(n > 0, self.s[name] / (n * n), torch.nan))


def _no_inf(x):
    return torch.where(torch.isinf(x), torch.nan, x)


# ---------------------------------------------------------------------------
# the OI
# ---------------------------------------------------------------------------

def scalar_oi(xa, y, sa, so, dtype):
    """The reference's scalar OI with the regularization scan: (xb, ak,
    increment, error, knee index)."""
    xa, y, sa, so = (t.to(dtype) for t in (xa, y, sa, so))
    y = torch.where(y < 0, torch.zeros_like(y), y)
    regs = torch.as_tensor(REGS, device=xa.device).to(dtype)
    curve = []
    for r in regs:
        k = sa * r / (sa * r + so)
        sb = (1.0 - k) * sa * r
        ak = 1.0 - sb / (sa * r)
        curve.append(torch.nanmean(ak.float() if dtype == torch.bfloat16 else ak).item())
    idx = kneedle_index(REGS, np.array(curve), fallback=0)
    r = regs[idx]
    k = sa * r / (sa * r + so)
    sb = (1.0 - k) * sa * r
    ak = 1.0 - sb / (sa * r)
    inc = k * (y - xa)
    return xa + inc, ak, inc, torch.sqrt(sb), idx


# ---------------------------------------------------------------------------
# the month
# ---------------------------------------------------------------------------

def month_reference(grans, ctm: dict, ctm_lon2d, ctm_lat2d, config: dict, mix: dict,
                    prec: Precision, device, on_regrid=None):
    """The month's nine fields (host float64 numpy) from the raw granules and
    the CTM, every stage in ``prec``: each granule's regrid and its kind's
    observation operator, the average, the bias correction and the OI of
    the merged control keys' ``oi_method``: scalar (the default), or full
    with ``length_scale_km`` (default 300, the job runner's) on the first
    granule's grid.  ``on_regrid(i, fields)`` sees each granule's regridded
    fields as they are made (the check compares the program's with them).
    Returns (fields, info): ``info`` has the knee index ``knee``, and for
    the full OI its factor ``reg``, valid cells ``n`` and ``curve``."""
    ctrl = dict(config["control"])
    ctrl.update(mix.get("control", {}))
    method = ctrl.get("oi_method", "scalar")
    if method not in ("scalar", "full"):
        raise ValueError(f"oi_method must be 'scalar' or 'full', not {method!r}")
    reg = config["regrid"]
    an, oe = prec.dtype("analysis"), prec.dtype("observation_error")
    avg = _Average()
    state: dict = {}
    grid = None  # the first granule's (lat2d, lon2d): the full OI's cells
    for i, g in enumerate(grans):
        r = regrid(g, ctm_lon2d, ctm_lat2d, reg, device, prec.dtype("regrid"))
        if on_regrid is not None:
            on_regrid(i, r)
        grid = r["grid"] if grid is None else grid
        r.update(time=g["time"])
        err2 = _no_inf(r["uncertainty"].to(oe) ** 2)
        fields = granule_kind(g["kind"]).operator(r, ctm, state, prec, device)
        for name, x in zip(("vcd", "ctm", "aux1", "aux2"), fields):
            avg.add(name, x.to(an))
        avg.add("err2", err2)
        del r
    offset, slope = config.get("bias_correction", [0.0, 1.0])
    sat = (avg.mean("vcd") - offset) / slope
    err = avg.error("err2").to(an)
    xa = avg.mean("ctm")
    out = {"sat_averaged_vcd": sat, "sat_averaged_error": err, "ctm_averaged_vcd": xa,
           "aux1": avg.mean("aux1"), "aux2": avg.mean("aux2")}
    if method == "full":
        from benchmark.reference_full_oi import full_oi

        lat2d, lon2d = grid
        xb, ak, inc, eo, info = full_oi(xa, sat, xa * ctrl["ctm_error"] / 100.0, err.to(an),
                                        lat2d, lon2d, float(ctrl.get("length_scale_km", 300.0)),
                                        an)
    else:
        xb, ak, inc, eo, idx = scalar_oi(xa, sat, (xa * ctrl["ctm_error"] / 100.0) ** 2,
                                         err.to(an) ** 2, an)
        info = {"knee": idx}
    out.update(ctm_averaged_vcd_corrected=xb, ak_OI=ak, increment_OI=inc, error_OI=eo)
    return {k: v.double().cpu().numpy() for k, v in out.items()}, info
