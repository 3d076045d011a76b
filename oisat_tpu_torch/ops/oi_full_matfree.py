"""Matrix-free full-covariance OI on torch: the branch of
:func:`oisat_tpu_torch.ops.oi_full.oi_full` above the dense limits.

Counterpart of the matrix-free half of :mod:`oisat_tpu.ops.oi_full`
(``_b_matmat`` .. ``oi_full_matfree``).  It lives beside ``ops/oi_full.py``,
which keeps the dense solves, the exact float64 tail and the grid front end
and re-exports this module's public names, so both read in one sitting.
Nothing here forms the N x N covariance:

* :func:`_b_matmat` is B V from row blocks of ``exp(-kappa |u_i - u_j|^2 / 2)``
  built from explicit coordinate differences and contracted against all K
  columns as a chunk-leading ``torch.bmm`` whose chunk partials are summed
  afterwards -- both numerics choices of the JAX twin (the Gram form loses
  ~5e-5 per element at kappa ~ 450; one long float32 contraction raises CG's
  residual floor).  Every float32 product here runs in full float32, as
  ``Precision.HIGHEST`` does in JAX (torch's default; ``chip_smoke.py``
  asserts that TF32 is off).
* :func:`_cg_loop` is the multi-column PCG of the twin's ``while_loop`` as a
  Python loop: one host read of the live-column vector per iteration.
* :func:`_nystrom_factor` / :func:`_pcg_solve_nystrom` are the rank-k
  randomized Nystrom deflation.  The twin draws its Gaussian sketch from
  ``jax.random.key(0)``, which torch cannot reproduce: here the sketch is an
  argument, by default drawn from a ``torch.Generator`` seeded 0 on the
  tensors' device.
* :func:`mean_ak_curve_slq` is the stochastic-Lanczos-quadrature mean-AK
  curve; its probes come from ``np.random.default_rng(seed)`` over the
  block-padded n exactly as in the twin, so the curve and its knee can be
  held equal.
* :func:`_distance_coloring` and its helpers are host numpy / scipy copies
  of the twin's.
* :func:`oi_full_matfree` is the solver: the exact float64 tail of
  ``ops/oi_full.py`` at npad <= ``REFINE_MAX_CELLS``, else Nystrom PCG with
  the Woodbury posterior diagonal (or ``refine=p`` mixed-precision
  refinement passes), or Jacobi CG with R-scaled coloured probes.

``mesh=`` (a :class:`~oisat_tpu_torch.parallel.mesh.Mesh`) shards every
sweep: the column-chunk axis that ``torch.bmm(c, dv3).sum(dim=0)`` contracts
over is split over all of the mesh's positions, each position sums its own
chunks' partials on its device, and the (N, K) partials are added in
position order on the first device.  A mesh of one position is dropped, as
in the twin.

TPU workarounds dropped: the 128-lane padding of the probe columns and the
8-column padding of the innovation solve (zero columns start converged and
change nothing; only the Nystrom rank keeps its 128 rounding, which sets the
result).
"""

from __future__ import annotations

import hashlib
import operator

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.ops.kernels.covariance import EARTH_RADIUS_KM, radians_f32
from oisat_tpu_torch.parallel.mesh import sum_in_order
from oisat_tpu_torch.utils.lru import LockedLRU
from oisat_tpu_torch.utils.stages import StageClock

__all__ = ["oi_full_matfree", "mean_ak_curve_slq", "NYSTROM_MIN_CELLS", "REFINE_MAX_CELLS"]

LANES = 128  # the Nystrom rank is rounded up to it, as in the twin
# the JAX package's limits, kept so both packages take the same branch
NYSTROM_MIN_CELLS = 4096
REFINE_MAX_CELLS = 16384
REFINE_CACHE_BYTES = 8 << 30  # dense host float64 kernel cache of refinement
_BALL_CHUNK = 4096  # neighbour-list chunk of the host colouring
JACOBI_STALL = 50  # CG iterations without a 10% improvement before a column freezes
NYSTROM_STALL = 200
F32_EPS = 1.2e-7  # the twin's float32 epsilon in the Nystrom shift floor
_UNTIMED = StageClock(None, "cpu")
_f32 = torch.float32


def _unit_vectors(lat_deg, lon_deg, device) -> torch.Tensor:
    """(N, 3) float32 unit vectors on ``device`` from degrees (float32 radians
    in the JAX order: cast, then multiply by float32(pi / 180))."""
    lat = radians_f32(lat_deg, device)
    lon = radians_f32(lon_deg, device)
    cl = torch.cos(lat)
    return torch.stack([cl * torch.cos(lon), cl * torch.sin(lon), torch.sin(lat)], dim=-1)


def _b_matmat(u3, sigma_b, v, length_scale_km: float, block: int, mesh=None) -> torch.Tensor:
    """Y = B V without forming B: ``u3`` (N, 3), ``sigma_b`` (N,), ``v`` (N, K),
    N a multiple of ``block``.  For each ``block`` rows, the kernel tile
    ``exp(-kappa d^2 / 2)`` is generated in (chunk, row, column) layout from
    explicit coordinate differences (exact for nearby float32 coordinates, so
    each element's error is relative and B stays numerically PSD) and
    contracted against all K columns by one ``torch.bmm`` over the N / block
    column chunks, whose partials are summed after.  The difference and
    square run in place: two (N / block, block, block) temporaries at a time
    (2 x 268 MB at N = 65,536, block = 1,024).

    ``mesh``: the column chunks are split over the mesh's positions
    (unevenly; a position may get none), each position sweeps all rows
    against its chunks on its device, and the positions' (N, K) partials are
    added in position order on ``u3``'s device."""
    kappa = (EARTH_RADIUS_KM / length_scale_km) ** 2
    n = u3.shape[0]
    if n % block:
        raise ValueError(f"_b_matmat: N={n} must be a multiple of block={block}")
    nchunks = n // block
    dv3 = (sigma_b[:, None] * v).reshape(nchunks, block, -1)
    u3c = u3.reshape(nchunks, block, 3)
    devices = [u3.device] if mesh is None else mesh.flat_devices()
    parts = []
    for dev, chunks in zip(devices, torch.arange(nchunks).tensor_split(len(devices))):
        if chunks.numel() == 0:
            continue
        c0, c1 = int(chunks[0]), int(chunks[-1]) + 1
        u3_d, u3c_d, dv3_d = u3.to(dev), u3c[c0:c1].to(dev), dv3[c0:c1].to(dev)
        rows = []
        for s in range(0, n, block):
            ub = u3_d[s:s + block]
            d2 = None
            for k in range(3):
                t = (ub[None, :, None, k] - u3c_d[:, None, :, k]).square_()
                d2 = t if d2 is None else d2.add_(t)
            c = d2.mul_(-0.5 * kappa).exp_()  # (chunks, block_row, block_col)
            rows.append(torch.bmm(c, dv3_d).sum(dim=0))
            del c, d2, t
        parts.append(torch.cat(rows).to(u3.device))
    return sigma_b[:, None] * sum_in_order(parts)


def _cg_loop(amat, psolve, rhs, tol: float, maxiter: int, stall: int = JACOBI_STALL):
    """Preconditioned CG for A X = RHS, column-wise (A SPD, ``rhs`` (N, K)),
    one ``amat`` sweep per iteration whatever K.  Columns freeze when
    converged, after ``stall`` iterations without a 10% residual improvement
    or when their residual grows 1e4x past their best; each returns its
    minimum-residual iterate.  The loop reads the live-column vector on the
    host once per iteration.  Returns (X, iterations, max relative residual)."""
    bnorm2 = torch.sum(rhs * rhs, dim=0)
    tol2 = (tol * tol) * torch.clamp(bnorm2, min=1e-30)
    x = torch.zeros_like(rhs)
    r = rhs
    z = psolve(rhs)
    p = z
    anchor = bnorm2
    stalled = torch.zeros(rhs.shape[1], dtype=torch.int32, device=rhs.device)
    xbest = x
    best = bnorm2
    k = 0
    while k < maxiter:
        r2n = torch.sum(r * r, dim=0)
        live = (r2n > tol2) & (stalled < stall) & (r2n < 1e4 * best)
        if not bool(live.any()):
            break
        ap = amat(p)
        rz = torch.sum(r * z, dim=0)
        den = torch.sum(p * ap, dim=0)
        alpha = torch.where((den > 0) & live, rz / torch.where(den > 0, den, 1.0), 0.0)
        x = x + alpha[None, :] * p
        r2 = r - alpha[None, :] * ap
        z2 = psolve(r2)
        beta = torch.where(rz > 0, torch.sum(r2 * z2, dim=0) / torch.where(rz > 0, rz, 1.0),
                           0.0)
        p = z2 + beta[None, :] * p
        r2n_new = torch.sum(r2 * r2, dim=0)
        record = r2n_new < best
        xbest = torch.where(record[None, :], x, xbest)
        best = torch.where(record, r2n_new, best)
        # the stall window runs from the last 10% improvement, not the best
        improved = r2n_new < 0.81 * anchor
        anchor = torch.where(improved, r2n_new, anchor)
        stalled = torch.where(improved, 0, stalled + 1)
        r, z = r2, z2
        k += 1
    resid = torch.sqrt(torch.max(best / torch.clamp(bnorm2, min=1e-30)))
    return xbest, k, float(resid)


def _cg_solve_multi(u3, sigma_b, sigma_o2, rhs, length_scale_km: float, block: int,
                    tol: float, maxiter: int, mesh=None):
    """Jacobi-preconditioned CG for (B + diag(sigma_o^2)) X = RHS."""

    def amat(v):
        return _b_matmat(u3, sigma_b, v, length_scale_km, block, mesh) + sigma_o2[:, None] * v

    minv = (1.0 / (sigma_b ** 2 + sigma_o2))[:, None]
    return _cg_loop(amat, lambda r: minv * r, rhs, tol, maxiter)


def _sketch(n: int, k: int, device) -> torch.Tensor:
    """The default Gaussian sketch (n, k) float32: a ``torch.Generator`` on
    ``device`` seeded 0 (the twin draws ``jax.random.key(0)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.randn((n, k), generator=gen, device=device, dtype=_f32)


def _nystrom_factor(u3, sigma_b, omega, length_scale_km: float, block: int, mesh=None):
    """Rank-k randomized Nystrom eigenfactor (U, lam) of the unwhitened prior
    covariance, B ~= U diag(lam) U^T, from the sketch ``omega`` (N, k): one
    sweep of B against the k columns, two k x k eigendecompositions; modes
    under 3e-6 lam_max (float32 eigh noise) come out as lam = 0."""
    y = _b_matmat(u3, sigma_b, omega, length_scale_km, block, mesh)
    g = omega.T @ y
    g = 0.5 * (g + g.T)
    w, v = torch.linalg.eigh(g)  # ascending
    keep = w > torch.clamp(w[-1], min=0.0) * 3e-6
    wsafe = torch.where(keep, w, 1.0)
    z = y @ (v * (keep / torch.sqrt(wsafe))[None, :])
    # thin eigenform of Z Z^T through the k x k Gram Z^T Z = P diag(s) P^T
    zz = z.T @ z
    zz = 0.5 * (zz + zz.T)
    s, p = torch.linalg.eigh(zz)
    lam = torch.clamp(s, min=0.0)
    skeep = s > torch.clamp(s[-1], min=0.0) * 3e-6
    ssafe = torch.where(skeep, s, 1.0)
    u = z @ (p * (skeep / torch.sqrt(ssafe))[None, :])
    return u, torch.where(skeep, lam, 0.0)


def _pcg_solve_nystrom(u3, sigma_b, sigma_o2, rhs, nys_u, nys_lam, c2, dcomp,
                       length_scale_km: float, block: int, tol: float, maxiter: int,
                       mesh=None):
    """CG with the Nystrom deflation preconditioner (Frangella, Tropp & Udell,
    projector form): ``M^-1 = P D_c^-1 P + U diag(1 / (lam + c2)) U^T``,
    ``P = I - U U^T``, ``dcomp`` the per-cell complement diagonal (the prior
    variance the sketch missed plus sigma_o^2)."""

    def amat(v):
        return _b_matmat(u3, sigma_b, v, length_scale_km, block, mesh) + sigma_o2[:, None] * v

    dinv = (1.0 / dcomp)[:, None]
    dl = (1.0 / (nys_lam + c2))[:, None]

    def psolve(r):
        t = nys_u.T @ r
        z = dinv * (r - nys_u @ t)
        z = z - nys_u @ (nys_u.T @ z)
        return z + nys_u @ (dl * t)

    return _cg_loop(amat, psolve, rhs, tol, maxiter, stall=NYSTROM_STALL)


def _lanczos_tridiag_batch(u3, sigma_b, sigma_o, q0, length_scale_km: float, block: int,
                           m: int, mesh=None):
    """m-step Lanczos of the whitened covariance ``D_o^-1 B D_o^-1``, one
    recurrence per column of ``q0``, all sharing each sweep.  Returns
    (alpha (m, K), beta (m, K), norms (K,))."""
    oin = 1.0 / sigma_o

    def cmat(v):
        return oin[:, None] * _b_matmat(u3, sigma_b, oin[:, None] * v, length_scale_km, block,
                                        mesh)

    norms = torch.sqrt(torch.sum(q0 * q0, dim=0))
    q_cur = q0 / torch.where(norms > 0, norms, 1.0)
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros(q_cur.shape[1], dtype=q_cur.dtype, device=q_cur.device)
    alphas, betas = [], []
    for _ in range(m):
        w = cmat(q_cur) - beta_prev[None, :] * q_prev
        alpha = torch.sum(q_cur * w, dim=0)
        w = w - alpha[None, :] * q_cur
        beta = torch.sqrt(torch.sum(w * w, dim=0))
        q_next = w / torch.where(beta > 0, beta, 1.0)[None, :]
        alphas.append(alpha)
        betas.append(beta)
        q_prev, q_cur, beta_prev = q_cur, q_next, beta
    return torch.stack(alphas), torch.stack(betas), norms


def _drop_single(mesh):
    """None for a mesh of one position (the single-device sweep), as the
    twin drops a 1-device mesh."""
    return None if mesh is None or mesh.size == 1 else mesh


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device).to(_f32)


def mean_ak_curve_slq(u3_or_latlon, sigma_b, sigma_o, regs, length_scale_km: float,
                      block: int = 1024, n_probes: int = 8, m: int = 60, seed: int = 0,
                      valid=None, device="cuda", mesh=None) -> np.ndarray:
    """Full-domain mean-AK-vs-regularization curve by stochastic Lanczos
    quadrature, as :func:`oisat_tpu.ops.oi_full.mean_ak_curve_slq`:
    ``meanAK(r) = (r / Nv) tr(D_bd^-1 B (rB + R)^-1 B)``, every factor a
    resolvent of ``C = D_o^-1 B D_o^-1``; one batched Lanczos run of
    ``2 n_probes`` columns prices all factors through m x m tridiagonal
    eigenproblems on the host ((m + 1) sweeps in all).

    ``u3_or_latlon``: (lat, lon) in degrees (computed on ``device``, the
    card unless the caller asks for the CPU), or an (N, 3) unit-vector
    tensor (whose device is used).  Inputs are padded to a ``block`` multiple with
    sigma_b = 0 / sigma_o = 1 rows, as in the twin, so the Rademacher probes
    of ``np.random.default_rng(seed)`` line up.  ``mesh`` shards every
    sweep (see :func:`_b_matmat`).  Returns the (R,) float64 curve."""
    from scipy.linalg import eigh_tridiagonal

    mesh = _drop_single(mesh)
    if isinstance(u3_or_latlon, tuple):
        dev = resolve_device(device)
        u3 = _unit_vectors(*u3_or_latlon, dev)
    else:
        u3 = u3_or_latlon
        dev = u3.device
    n_in = u3.shape[0]
    n = int(np.ceil(max(n_in, 1) / block)) * block
    sb = np.asarray(sigma_b, np.float64).ravel()
    so = np.asarray(sigma_o, np.float64).ravel()
    if n != n_in:  # self-pad: sigma_b = 0 rows decouple, sigma_o = 1
        pad = n - n_in
        u3 = torch.cat([u3, torch.zeros((pad, 3), dtype=u3.dtype, device=dev)])
        sb = np.concatenate([sb, np.zeros(pad)])
        so = np.concatenate([so, np.ones(pad)])
        if valid is not None:
            valid = np.concatenate([np.asarray(valid, bool), np.zeros(pad, bool)])
    sigma_b = _as_f32(sb, dev)
    sigma_o = _as_f32(so, dev)
    # the variances the twin reads back from its float32 device copies
    bd = sb.astype(np.float32).astype(np.float64) ** 2
    valid = (bd > 0) if valid is None else (np.asarray(valid, bool) & (bd > 0))
    nv = max(int(valid.sum()), 1)

    rng = np.random.default_rng(seed)
    z = rng.choice([-1.0, 1.0], size=(n, n_probes)).astype(np.float32)
    z[~valid] = 0.0
    zd = z / np.where(valid, bd, 1.0)[:, None]  # D_bd^-1 z
    both = torch.as_tensor(np.concatenate([zd, z], axis=1).astype(np.float32), device=dev)
    bz = _b_matmat(u3, sigma_b, both, float(length_scale_km), block, mesh).cpu().numpy()
    a = bz[:, :n_probes].astype(np.float64)  # B D_bd^-1 z
    b = bz[:, n_probes:].astype(np.float64)  # B z
    oin = 1.0 / so.astype(np.float32).astype(np.float64)
    q0 = np.concatenate([(a + b) * oin[:, None], (a - b) * oin[:, None]], axis=1)
    alphas, betas, norms = _lanczos_tridiag_batch(
        u3, sigma_b, sigma_o, torch.as_tensor(q0.astype(np.float32), device=dev),
        float(length_scale_km), block, m, mesh)
    alphas = alphas.cpu().numpy().astype(np.float64)  # (m, 2 n_probes)
    betas = betas.cpu().numpy().astype(np.float64)
    norms = norms.cpu().numpy().astype(np.float64)

    regs = np.asarray(regs, np.float64)
    curve = np.zeros(regs.shape[0])
    for j in range(alphas.shape[1]):
        # Gauss quadrature: ||q||^2 sum_i w_i^2 / (r theta_i + 1)
        try:
            theta, vecs = eigh_tridiagonal(alphas[:, j], betas[:-1, j])
        except np.linalg.LinAlgError:
            t = (np.diag(alphas[:, j]) + np.diag(betas[:-1, j], 1)
                 + np.diag(betas[:-1, j], -1))
            theta, vecs = np.linalg.eigh(t)
        w2 = vecs[0, :] ** 2 * norms[j] ** 2
        g = (w2[None, :] / (regs[:, None] * np.maximum(theta, 0.0)[None, :] + 1.0)).sum(axis=1)
        curve += (1.0 if j < n_probes else -1.0) * 0.25 * g
    curve /= n_probes
    return regs * curve / nv


# ---------------------------------------------------------------------------
# distance colouring for the Jacobi branch's probes (host; a copy of the
# twin's _cluster_reps / _distance_coloring / _distance_coloring_cached)
# ---------------------------------------------------------------------------

def _sphere_points(lat, lon):
    """(N, 3) float64 unit vectors of degree coordinates (numpy)."""
    lat_r = np.deg2rad(np.asarray(lat, np.float64))
    lon_r = np.deg2rad(np.asarray(lon, np.float64))
    cl = np.cos(lat_r)
    return np.column_stack([cl * np.cos(lon_r), cl * np.sin(lon_r), np.sin(lat_r)])


def _cluster_reps(pts, radius_km: float, prefer=None):
    """Greedy geometric clustering: every point within ``radius_km`` of an
    earlier representative joins its cluster (candidates in ``prefer`` first,
    so a zero-variance cell never represents cells with variance)."""
    from scipy.spatial import cKDTree

    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    chord = min(radius_km / EARTH_RADIUS_KM, 2.0)
    tree = cKDTree(pts)
    order = (np.arange(n) if prefer is None
             else np.argsort(~np.asarray(prefer, bool), kind="stable"))
    rep = np.full(n, -1, np.int64)
    for s in range(0, n, _BALL_CHUNK):
        chunk = order[s:s + _BALL_CHUNK]
        balls = tree.query_ball_point(pts[chunk], chord)
        for i, ball in zip(chunk, balls):
            if rep[i] >= 0:
                continue
            members = [j for j in ball if rep[j] < 0]
            rep[members] = i
            rep[i] = i
    return rep


def _distance_coloring(lat, lon, sep_km: float, cluster_radius_km: float, prefer=None):
    """(rep, colors): each cell's cluster representative, and a greedy
    colour per representative (-1 on members) such that same-coloured
    representatives are at least ``sep_km`` apart (chordal)."""
    from scipy.spatial import cKDTree

    pts = _sphere_points(lat, lon)
    rep = _cluster_reps(pts, cluster_radius_km, prefer=prefer)
    rep_ids = np.flatnonzero(rep == np.arange(len(pts)))
    rpts = pts[rep_ids]
    chord = min(sep_km / EARTH_RADIUS_KM, 2.0)
    tree = cKDTree(rpts)
    rcolors = np.full(len(rpts), -1, np.int64)
    for s in range(0, len(rpts), _BALL_CHUNK):
        balls = tree.query_ball_point(rpts[s:s + _BALL_CHUNK], chord)
        for k, ball in enumerate(balls):
            used = {rcolors[j] for j in ball if rcolors[j] >= 0}
            c = 0
            while c in used:
                c += 1
            rcolors[s + k] = c
    colors = np.full(len(pts), -1, np.int64)
    colors[rep_ids] = rcolors
    return rep, colors


_coloring_cache = LockedLRU(8)


def _distance_coloring_cached(lat, lon, sep_km: float, cluster_radius_km: float,
                              prefer=None):
    """:func:`_distance_coloring` cached on a full-content digest of the
    geometry and the options."""
    lat = np.ascontiguousarray(lat)
    lon = np.ascontiguousarray(lon)
    h = hashlib.sha1()
    h.update(lat.tobytes())
    h.update(lon.tobytes())
    if prefer is not None:
        h.update(np.ascontiguousarray(prefer, np.uint8).tobytes())
    key = (lat.shape, h.hexdigest(), float(sep_km), float(cluster_radius_km))
    hit = _coloring_cache.get(key)
    if hit is not None:
        return hit
    out = _distance_coloring(lat, lon, sep_km, cluster_radius_km, prefer=prefer)
    _coloring_cache.put(key, out)
    return out


# ---------------------------------------------------------------------------
# mixed-precision iterative refinement (refine=p; host float64)
# ---------------------------------------------------------------------------

def _make_apply_a_f64(u3_64, sb_64, so2_64, kappa: float, row_block: int = 512):
    """Host float64 ``x -> (B + R) x`` with the true kernel, its exp'd rows
    cached densely across passes when they fit ``REFINE_CACHE_BYTES``."""
    from oisat_tpu_torch.ops.oi_full import _kernel_block_f64

    n = u3_64.shape[0]
    cache = [None]
    use_cache = n * n * 8 <= REFINE_CACHE_BYTES

    def apply_a(x_64):
        y = so2_64 * x_64
        dx = sb_64 * x_64
        if use_cache:
            if cache[0] is None:
                cache[0] = np.empty((n, n))
                for s in range(0, n, row_block):
                    e = min(s + row_block, n)
                    _kernel_block_f64(u3_64, s, e, kappa, out=cache[0][s:e])
            y += sb_64 * (cache[0] @ dx)
            return y
        for s in range(0, n, row_block):
            e = min(s + row_block, n)
            y[s:e] += sb_64[s:e] * (_kernel_block_f64(u3_64, s, e, kappa) @ dx)
        return y

    return apply_a


def _refine_f64(x0_f32, d64, apply_a, solve, max_passes: int, target: float = 0.0):
    """Mixed-precision iterative refinement: x in host float64, the residual
    with the true float64 operator, each correction by ``solve(rhs_f32) ->
    (dx, iterations)`` on the device.  Stops at ``target``, after
    ``max_passes`` corrections, or when a pass fails to halve the residual
    (a pass that does not improve it is undone).  Returns (x64, relative
    residual, extra iterations, passes applied)."""
    x64 = np.asarray(x0_f32, np.float64)
    dn = float(np.linalg.norm(d64))
    if dn == 0.0:
        return x64, 0.0, 0, 0
    extra = 0
    applied = 0
    rrel_prev = np.inf
    r64 = d64 - apply_a(x64)
    rrel = float(np.linalg.norm(r64)) / dn
    while applied < max_passes and rrel > max(target, 1e-9) and rrel < 0.5 * rrel_prev:
        s = float(np.max(np.abs(r64)))
        dx, it = solve(np.asarray(r64 / s, np.float32))
        extra += int(it)
        x64 += s * np.asarray(dx, np.float64)
        applied += 1
        rrel_prev = rrel
        r64 = d64 - apply_a(x64)
        rrel = float(np.linalg.norm(r64)) / dn
        if rrel >= rrel_prev:  # the floor: keep the better iterate
            x64 -= s * np.asarray(dx, np.float64)
            rrel = rrel_prev
            applied -= 1
            break
    return x64, rrel, extra, applied


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _woodbury_sb_diag(nys_u, nys_lam, sigma_o2, dtail, so2_np):
    """The posterior diagonal from the Nystrom factor: ``diag(U S U^T)`` with
    ``S = lam^1/2 (I + lam^1/2 W lam^1/2)^-1 lam^1/2``, ``W = U^T R^-1 U``
    (float32 on the device, the k x k Cholesky in float64 on the host; the
    eigen-clip form where it fails), plus the per-cell scalar-OI closure of
    the prior variance the sketch missed."""
    import scipy.linalg as sla

    k = nys_u.shape[1]
    w_small = (nys_u.T @ (nys_u / sigma_o2[:, None])).cpu().numpy().astype(np.float64)
    w_small = 0.5 * (w_small + w_small.T)
    lam_sqrt = np.sqrt(nys_lam.cpu().numpy().astype(np.float64))
    t_mat = np.eye(k) + lam_sqrt[:, None] * w_small * lam_sqrt[None, :]
    try:
        lt = sla.cholesky(t_mat, lower=True)
        m_right = sla.solve_triangular(lt, np.diag(lam_sqrt), lower=True).T
    except np.linalg.LinAlgError:
        # I + PSD has eigenvalues >= 1 exactly: 1 is the clip floor
        th, q = np.linalg.eigh(t_mat)
        m_right = (lam_sqrt[:, None] * q) / np.sqrt(np.maximum(th, 1.0))
    v_cols = nys_u @ torch.as_tensor(m_right.astype(np.float32), device=nys_u.device)
    sb_diag = torch.sum(v_cols * v_cols, dim=1).cpu().numpy().astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return sb_diag + np.where(dtail > 0, dtail * so2_np / (dtail + so2_np), 0.0)


def oi_full_matfree(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                    block: int = 1024, cg_tol: float = 1e-6, cg_maxiter: int = 400,
                    probe_sep_factor: float = 4.0, max_colors: int = 192,
                    cluster_radius_factor: float = 0.25, valid=None, precond: str = "auto",
                    nystrom_k: int = None, refine="auto", *, omega=None, device="cuda",
                    clock: StageClock = _UNTIMED, mesh=None):
    """Full-covariance OI without forming B, as
    :func:`oisat_tpu.ops.oi_full.oi_full_matfree`: 1-D finite host inputs of
    n cells (padded here to a ``block`` multiple with sigma_b = 0 /
    sigma_o = 1 rows) on ``device``.  Returns (xb, ak, increment, err, info),
    float64 numpy trimmed to n, and ``info`` with the twin's keys.

    ``precond`` "auto" takes the Nystrom deflation at npad >=
    ``NYSTROM_MIN_CELLS`` (rank ``nystrom_k``, default min(2048, npad // 4)
    rounded up to 128), else Jacobi CG with the posterior diagonal from
    distance-coloured probes at cluster representatives (``probe_sep_factor``
    x L apart, ``max_colors`` per CG chunk).  On the Nystrom branch ``refine``
    "auto" solves exactly in float64 on ``device`` at npad <=
    ``REFINE_MAX_CELLS`` (``ops/oi_full._exact_tail_solve``: the exact
    posterior diagonal too; it raises instead of falling back, and
    ``OISAT_EXACT_DEVICE=0`` takes the host LAPACK solve) and keeps the
    float32 PCG and the Woodbury diagonal beyond; an int p runs the PCG and
    then p refinement passes against the host float64 operator.  ``omega``
    (npad, k) is the Nystrom sketch (default :func:`_sketch`).  ``clock``
    marks "nystrom", "pcg", "refine", "tail", "tail_resid", "diag",
    "coloring" and "probe" as the branch reaches them.  ``mesh`` shards
    every sweep (see :func:`_b_matmat`)."""
    from oisat_tpu_torch.ops import oi_full as dense

    mesh = _drop_single(mesh)
    if refine != "auto":
        refine = operator.index(refine)  # numpy ints count; floats and strings raise
    dev = resolve_device(device)
    n_in = int(np.size(xa))
    npad = int(np.ceil(n_in / block)) * block
    if npad != n_in:
        pad = npad - n_in

        def _pad(a, fill):
            return np.concatenate([np.asarray(a, np.float64).ravel(), np.full(pad, fill)])

        xa, y = _pad(xa, 0.0), _pad(y, 0.0)
        sigma_b, sigma_o = _pad(sigma_b, 0.0), _pad(sigma_o, 1.0)
        lat, lon = _pad(lat, 0.0), _pad(lon, 0.0)
        valid = (np.arange(npad) < n_in if valid is None
                 else np.concatenate([np.asarray(valid, bool), np.zeros(pad, bool)]))

    n = npad
    lat = np.asarray(lat, np.float64).ravel()
    lon = np.asarray(lon, np.float64).ravel()
    u3 = _unit_vectors(lat, lon, dev)
    # the float64 paths read the caller's data, not the float32 device copies
    sb_f64 = np.asarray(sigma_b, np.float64).ravel()
    so_f64 = np.asarray(sigma_o, np.float64).ravel()
    sigma_b = _as_f32(sb_f64, dev)
    sigma_o2 = _as_f32(so_f64, dev) ** 2
    d64 = np.asarray(y, np.float64).ravel() - np.asarray(xa, np.float64).ravel()
    innov = _as_f32(d64, dev)
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    vidx = np.flatnonzero(valid)
    bd = sb_f64 ** 2
    so2_np = so_f64 ** 2
    L = float(length_scale_km)
    kappa = (EARTH_RADIUS_KM / L) ** 2

    use_nystrom = precond == "nystrom" or (precond == "auto" and n >= NYSTROM_MIN_CELLS)
    iters_total = 0
    resid_max = 0.0
    f64_resid = None
    applied = 0
    ncolors = nchunks = nreps = 0
    if use_nystrom:
        k = nystrom_k or min(2048, n // 4)
        k = max(LANES, int(np.ceil(k / LANES)) * LANES)
        solver = "pcg_f32"
        direct = diag_pack = None
        if refine == "auto" and n <= REFINE_MAX_CELLS:
            # the exact float64 solve and posterior diagonal (no sketch)
            direct, diag_pack, f64_resid, solver = dense._exact_tail_solve(
                sb_f64, so_f64, d64, lat, lon, L, dev, clock=clock)
            x64 = direct
            resid_max = f64_resid
        else:
            if omega is None:
                omega = _sketch(n, k, dev)
            nys_u, nys_lam = _nystrom_factor(u3, sigma_b, omega.to(dev, _f32), L, block, mesh)
            so2_min = float(np.float32(np.min(so2_np[valid])))
            c2 = torch.clamp(float(np.float32(4.0) * np.float32(F32_EPS)) * nys_lam[-1],
                             min=so2_min)
            dcap = torch.sum(nys_u * nys_u * nys_lam[None, :], dim=1)
            dtail = np.maximum(bd - dcap.cpu().numpy().astype(np.float64), 0.0)
            dcomp = _as_f32(dtail + so2_np, dev)
            clock.mark("nystrom")

            def pcg(rhs_col):
                return _pcg_solve_nystrom(u3, sigma_b, sigma_o2, rhs_col[:, None], nys_u,
                                          nys_lam, c2, dcomp, L, block, cg_tol, cg_maxiter,
                                          mesh)

            x, iters_total, resid_max = pcg(innov)
            x64 = x[:, 0].cpu().numpy().astype(np.float64)
            clock.mark("pcg")
            u3_64 = _sphere_points(lat, lon)
            if isinstance(refine, int) and refine > 0:
                def corr_solve(r32):
                    xc, itc, _ = pcg(torch.as_tensor(r32, device=dev))
                    return xc[:, 0].cpu().numpy(), itc

                x64, f64_resid, extra, applied = _refine_f64(
                    x64, d64, _make_apply_a_f64(u3_64, sb_f64, so2_np, kappa), corr_solve,
                    refine)
                iters_total += extra
                resid_max = f64_resid  # the true-operator residual of x
                clock.mark("refine")
            else:
                # the float32 CG residual can understate the true one by
                # orders: verify x against the float64 operator by row sampling
                f64_resid = dense._sampled_resid_f64(u3_64, sb_f64, so2_np, x64, d64, kappa)
                resid_max = max(resid_max, f64_resid)
                clock.mark("tail_resid")
        # the R-form increment d - R x: its error is bounded by the true residual
        increment = d64 - so2_np * x64
        if diag_pack is not None:
            sb_diag = dense._exact_sb_diag(so2_np, diag_pack, bd)
        elif direct is not None:
            # the host triangular inversion failed after the factorization:
            # the per-cell scalar-OI value, flagged by exact_diag = False
            sb_diag = np.where(bd + so2_np > 0, bd * so2_np / (bd + so2_np), 0.0)
        else:
            sb_diag = _woodbury_sb_diag(nys_u, nys_lam, sigma_o2, dtail, so2_np)
        clock.mark("diag")
    else:
        # colouring of the real cells only (padding rows share one location)
        rep_v, colors_v = _distance_coloring_cached(
            lat[valid], lon[valid], probe_sep_factor * L, cluster_radius_factor * L,
            prefer=sb_f64[valid] > 0)
        rep = np.full(n, -1, np.int64)
        rep[vidx] = vidx[rep_v]
        colors = np.full(n, -1, np.int64)
        colors[vidx] = colors_v
        ncolors = int(colors.max()) + 1
        is_rep = colors >= 0
        nreps = int(is_rep.sum())
        clock.mark("coloring")
        # [w | X] = A^-1 [innov | R P]; A^-1 B P = P - X; B [w | P - X] gives
        # the increment and diag(B A^-1 B) at the representatives
        quad_rep = np.zeros(n, np.float64)
        increment = None
        nchunks = max(1, -(-ncolors // max_colors))
        for ci in range(nchunks):
            c0, c1 = ci * max_colors, min((ci + 1) * max_colors, ncolors)
            sel = is_rep & (colors >= c0) & (colors < c1)
            cells = np.flatnonzero(sel)
            cols = colors[sel] - c0
            punit = np.zeros((n, c1 - c0), np.float32)
            punit[cells, cols] = 1.0
            prp = np.zeros((n, c1 - c0), np.float32)
            prp[cells, cols] = so2_np[cells]
            rhs = torch.as_tensor(prp, device=dev)
            lead = 1 if ci == 0 else 0
            if lead:
                rhs = torch.cat([innov[:, None], rhs], dim=1)
            x, iters, resid = _cg_solve_multi(u3, sigma_b, sigma_o2, rhs, L, block, cg_tol,
                                              cg_maxiter, mesh)
            iters_total += iters
            resid_max = max(resid_max, resid)
            clock.mark("pcg")
            tcols = torch.as_tensor(punit, device=dev) - x[:, lead:]
            s_all = _b_matmat(u3, sigma_b, torch.cat([x[:, :lead], tcols], dim=1), L, block,
                              mesh)
            s_all = s_all.cpu().numpy().astype(np.float64)
            if lead:
                increment = s_all[:, 0]
            quad_rep[cells] = s_all[cells, lead + cols]
            clock.mark("probe")
        # members inherit their representative's diagonal, rescaled by the
        # variance ratio
        quad = np.zeros(n, np.float64)
        vr = rep[vidx]
        scale = np.divide(bd[vidx], bd[vr], out=np.ones(vidx.size), where=bd[vr] > 0)
        quad[vidx] = quad_rep[vr] * scale
        sb_diag = bd - quad

    xb = np.asarray(xa, np.float64).ravel() + increment
    with np.errstate(invalid="ignore", divide="ignore"):
        ak = 1.0 - sb_diag / bd
    err = np.sqrt(np.maximum(sb_diag, 0.0))
    direct_ran = use_nystrom and solver.startswith("direct")
    info = {"cg_iters": iters_total, "cg_resid": resid_max,
            "ncolors": ncolors, "nchunks": nchunks, "nreps": nreps,
            "precond": ("direct" if direct_ran
                        else f"nystrom(k={k})" if use_nystrom else "jacobi"),
            "solver": (solver + ("+ir" if applied else "")) if use_nystrom else "pcg_f32",
            "exact_diag": bool(direct_ran and diag_pack is not None),
            "refine_passes": applied,
            "f64_resid": f64_resid,
            # ||inc - inc_true|| <= ||d - A x|| (R A^-1 is an SPD
            # contraction), reported where x was checked in float64
            "resid_abs": (resid_max * float(np.linalg.norm(d64))
                          if f64_resid is not None else None)}
    return xb[:n_in], ak[:n_in], increment[:n_in], err[:n_in], info
