"""Full-covariance OI, ``K = B (B + R)^-1`` with distance-decay B, on torch.

Counterpart of :mod:`oisat_tpu.ops.oi_full` (the ``oi_method: full``
analysis): its dense solves, exact float64 tail and grid front end are
here, its matrix-free half in :mod:`oisat_tpu_torch.ops.oi_full_matfree`.
With H = I on the analysis grid:

    A  = B + R                      (R = diag(sigma_o^2))
    w  = A^-1 (y - xa)              (Cholesky solve)
    xb = xa + B w
    Sb = B - B A^-1 B               (posterior covariance)
    AK = 1 - diag(Sb) / diag(B)     (averaging-kernel diagonal)

What replaces what:

* B comes from the hand-written CUDA kernel ``csrc/covariance.cu`` through
  :func:`oisat_tpu_torch.ops.kernels.covariance.build_covariance` (it
  replaces the Pallas ``covariance._cov_kernel``), or its plain version for
  CPU tensors.
* :func:`oi_full_dense` (``regularization_on=False``) and
  :func:`oi_full_dense_scan` (the 99-factor regularization scan: one
  ``eigh`` of ``D^-1 B D^-1``, two GEMMs, one ``(R, N) @ (N, N)`` product for
  the mean-AK curve, the Kneedle knee on the host from one 99-float pull)
  are the JAX functions of the same names, in float32 like them.
* :func:`_exact_tail` is ``_exact_tail_prog``: when the conditioning
  estimate ``(max sigma_b sqrt(r) / min sigma_o)^2`` exceeds 1e4 (the
  production regime, monthly-average sigma_b/sigma_o ~ 150-300), the
  innovation system and the exact posterior diagonal are solved again in
  float64 on the tensors' device -- true float64 on the H100, where the TPU
  emulated it.  The algebra is kept: the trailing-sub-triangle blocks
  (n^3/3), the ``L^-1 B = L^T - so^2 V`` identity for ``q = diag(B A^-1 B)``
  and both posterior forms picked per cell (:func:`_exact_sb_diag`).
  :func:`_sampled_resid_f64` checks the result on the host in float64 with
  the JAX seed, so it samples the same rows.
* :func:`oi_full` is the grid front end: the same validity rule, y < 0
  clamp, one-scale normalisation, compaction, conditioning gate and
  scatter-back.  Above ``DENSE_SCAN_MAX_CELLS`` (with the scan) or
  ``DENSE_MAX_CELLS`` (without) valid cells it takes :func:`_oi_full_large`:
  the SLQ knee and the matrix-free solve of the sibling module
  :mod:`oisat_tpu_torch.ops.oi_full_matfree`, whose public names this
  module re-exports.
* ``OISAT_EXACT_DEVICE=0`` (explicit opt-out only) takes the host LAPACK
  float64 solve (:func:`_direct_solve_f64`, :func:`_diag_pack_from_factor`)
  instead of the device tail.

TPU workarounds dropped: the padding of N to 128 lanes (the kernel masks
its ragged edge), the ``EXACT_TAIL_BUCKET`` padding of the tail (there is
no per-shape remote compile to amortise, so the last diagonal block may be
ragged and ``n % diag_block`` is not required) and the ``0 * x`` token that
serialised the tail's blocks (PyTorch runs them in order on one stream).

There is no silent fallback: a device tail that fails (non-finite output,
or a sampled residual above ``DEVICE_EXACT_RESID_GATE``) raises, where the
JAX package re-solves on the host.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.ops.kernels.covariance import EARTH_RADIUS_KM, build_covariance
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops.oi import regularization_grid
from oisat_tpu_torch.ops.oi_full_matfree import (  # the twin's names, importable here too
    NYSTROM_MIN_CELLS,
    REFINE_MAX_CELLS,
    _sphere_points,
    mean_ak_curve_slq,
    oi_full_matfree,
)
from oisat_tpu_torch.utils.stages import StageClock

__all__ = ["OIFullResult", "oi_full", "oi_full_dense", "oi_full_dense_scan",
           "oi_full_matfree", "mean_ak_curve_slq", "DENSE_MAX_CELLS",
           "DENSE_SCAN_MAX_CELLS", "REFINE_MAX_CELLS", "NYSTROM_MIN_CELLS",
           "DEVICE_EXACT_RESID_GATE"]

# The JAX package's limits, kept so both packages take the same branch at
# every n (they were sized for a 16 GB TPU; re-deriving them for 80 GB
# waits for the port's bench, ROADMAP queue 1 item 3.8).
DENSE_MAX_CELLS = 10_240
DENSE_SCAN_MAX_CELLS = 6_144
EXACT_DIAG_BLOCK = 2048  # identity columns per trailing solve of the tail
DEVICE_EXACT_RESID_GATE = 1e-5  # the JAX acceptance bar for the tail's
# host-f64 row-sampled true residual; true float64 lands orders below it
TIGHT_CONDITIONING = 1e4  # (max sb sqrt(r) / min so)^2 above which the tail runs
MATFREE_BLOCK = 1024  # rows of a covariance sweep's tile on the matrix-free path
SLQ_PROBES, SLQ_STEPS = 8, 60  # the matrix-free knee's probes and Lanczos steps
CG_WARN_RESID = 1e-4  # relative residual above which the convergence warning may print
_UNTIMED = StageClock(None, "cpu")


class OIFullResult(NamedTuple):
    xb: np.ndarray
    averaging_kernel: np.ndarray
    increment: np.ndarray
    error: np.ndarray
    info: dict = None  # the exact tail's solver, factor and residual


def oi_full_dense(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                  diag_block: int = 1024, *, cov_impl: str = "auto",
                  clock: StageClock = _UNTIMED):
    """Dense solve without the scan: 1-D float32 tensors of N finite cells on
    one device (``lat``/``lon`` in degrees).  Returns (xb, ak, increment, err).
    ``clock`` marks the stages "covariance" and "dense_solve".

    The posterior diagonal ``diag(B A^-1 B) = colsum(V * V)`` with
    ``V = L^-1 B`` is accumulated in column blocks of ``diag_block``: one
    triangular solve per block (N^3 over all blocks), never an N x N
    ``cholesky_solve``."""
    dev = xa.device
    b = build_covariance(lat, lon, sigma_b, length_scale_km, device=dev, impl=cov_impl)
    clock.mark("covariance")
    a = b + torch.diag(sigma_o.to(torch.float32) ** 2)
    chol = torch.linalg.cholesky(a)
    del a
    innov = (y - xa).to(torch.float32)
    w = torch.cholesky_solve(innov[:, None], chol)[:, 0]
    increment = b @ w
    xb = xa + increment
    n = b.shape[0]
    quad = torch.empty(n, dtype=b.dtype, device=dev)
    for s in range(0, n, diag_block):
        e = min(s + diag_block, n)
        v = torch.linalg.solve_triangular(chol, b[:, s:e], upper=False)
        quad[s:e] = torch.sum(v * v, dim=0)
    bd = torch.diagonal(b)
    sb_diag = bd - quad
    ak = 1.0 - sb_diag / bd
    err = torch.sqrt(torch.clamp(sb_diag, min=0.0))
    clock.mark("dense_solve")
    return xb, ak, increment, err


def oi_full_dense_scan(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                       regs, *, cov_impl: str = "auto", clock: StageClock = _UNTIMED):
    """Full-covariance OI with the reference's regularization scan, as
    :func:`oisat_tpu.ops.oi_full.oi_full_dense_scan`: whiten by R and
    eigendecompose once,

        C = D^-1 B D^-1 = Q diag(lam) Q^T,   (rB + R)^-1 = D^-1 Q diag(1/(r lam + 1)) Q^T D^-1,

    so with ``M = Q^T D^-1 B`` every factor's posterior diagonal is
    ``r diag(B) - r^2 colsum(coef_r * M^2)``.  All 99 factors' sums are one
    ``(R, N) @ (N, N)`` product.  Inputs as :func:`oi_full_dense`; ``regs``
    the float32 grid (R,).  Returns (xb, ak, increment, err, reg_index,
    curve), ``reg_index`` a host int.  ``clock`` marks the stages
    "covariance", "eigh", "scan_gemms" (the projections and the curve),
    "knee" (the pull and the host Kneedle) and "update"."""
    f32 = torch.float32
    dev = xa.device
    b = build_covariance(lat, lon, sigma_b, length_scale_km, device=dev, impl=cov_impl)
    clock.mark("covariance")
    dinv = 1.0 / sigma_o.to(f32)
    c = b * dinv[:, None] * dinv[None, :]
    lam, q = torch.linalg.eigh(c)
    del c
    clock.mark("eigh")
    innov = ((y - xa) * dinv).to(f32)
    t = q.T @ innov
    m = q.T @ (b * dinv[:, None])
    m2 = m * m
    del m
    bd = torch.diagonal(b)
    valid = bd > 0  # sigma_b = 0 cells stay out of the curve
    nvalid = torch.clamp(valid.sum(), min=1)
    regs_np = np.asarray(regs, np.float32)
    regs_t = torch.as_tensor(regs_np, device=dev)
    coef = 1.0 / (regs_t[:, None] * lam[None, :] + 1.0)  # (R, N)
    s = coef @ m2  # (R, N): s[r, j] = sum_i coef[r, i] M[i, j]^2
    bd_safe = torch.where(valid, bd, torch.ones_like(bd))
    ak_diag = torch.where(valid, regs_t[:, None] * s / bd_safe, torch.zeros_like(s))
    curve = ak_diag.sum(dim=1) / nvalid  # mean AK over the valid cells
    clock.mark("scan_gemms")
    # one 99-float device->host pull; the knee is host numpy
    reg_index = kneedle_index_np(regs_np.astype(np.float64),
                                 curve.cpu().numpy().astype(np.float64), fallback=0)
    clock.mark("knee")
    r = regs_t[reg_index]
    w = dinv * (q @ (coef[reg_index] * t))  # (rB + R)^-1 innovation
    increment = r * (b @ w)
    xb = xa + increment
    sb_diag = r * bd - r * r * s[reg_index]
    ak = torch.where(valid, 1.0 - sb_diag / torch.where(valid, r * bd, torch.ones_like(bd)),
                     torch.full_like(bd, math.nan))
    err = torch.sqrt(torch.clamp(sb_diag, min=0.0))
    clock.mark("update")
    return xb, ak, increment, err, reg_index, curve


# ---------------------------------------------------------------------------
# the exact float64 tail
# ---------------------------------------------------------------------------

def _kernel_block_f64(u3_64, s, e, kappa: float, out=None, full=None):
    """Rows [s:e) of the float64 correlation kernel exp(kappa (u.u - 1))
    against the columns of ``full`` (default ``u3_64``), numpy; the argument
    is clipped at -60 before exp, as on the device."""
    cols = u3_64 if full is None else full
    g = np.matmul(u3_64[s:e], cols.T, out=out)
    np.clip(g, -1.0, 1.0, out=g)
    g -= 1.0
    g *= kappa  # kappa (u.u - 1) = -0.5 kappa d2
    np.maximum(g, -60.0, out=g)
    np.exp(g, out=g)
    return g


def _exact_tail(u3, sb, so2, d, kappa: float, diag_block: int = EXACT_DIAG_BLOCK):
    """``_exact_tail_prog`` in float64 on the tensors' device: build the
    correlation kernel from unit vectors ``u3`` (N, 3), scale to
    ``A = D_b G D_b + D_o^2``, Cholesky-factor, solve ``A x = d``, and
    accumulate ``diag(A^-1)`` and ``q = diag(B A^-1 B)`` over blocks of
    ``diag_block`` identity columns.

    ``L^-1 e_j`` is zero above row j, so block j0 solves only the trailing
    (n - j0) sub-triangle (n^3/3 in all); the q columns come free of a
    second solve, ``L^-1 B[:, blk] = L^T[:, blk] - so2 * V`` with
    ``V = L^-1 I[:, blk]``, plus the row sums of squares of ``L[blk, :j0]``.
    Both diagonals are pure sums of squares.  The last block may be ragged.
    Returns (x, diag_ainv, q), float64 tensors."""
    g = u3 @ u3.T
    g.clamp_(-1.0, 1.0).sub_(1.0).mul_(kappa).clamp_(min=-60.0).exp_()
    g.mul_(sb[None, :] * sb[:, None])
    g.diagonal().add_(so2)
    chol = torch.linalg.cholesky(g)
    del g
    x = torch.cholesky_solve(d[:, None], chol)[:, 0]
    n = chol.shape[0]
    dainv = torch.empty(n, dtype=chol.dtype, device=chol.device)
    q = torch.empty_like(dainv)
    for j0 in range(0, n, diag_block):
        k = min(diag_block, n - j0)
        j1 = j0 + k
        eye = torch.eye(n - j0, k, dtype=chol.dtype, device=chol.device)
        v = torch.linalg.solve_triangular(chol[j0:, j0:], eye, upper=False)
        vb = chol[j0:j1, j0:].T - v * so2[j0:j1][None, :]
        head = chol[j0:j1, :j0]  # rows of L left of the sub-triangle
        dainv[j0:j1] = torch.sum(v * v, dim=0)
        q[j0:j1] = torch.sum(head * head, dim=1) + torch.sum(vb * vb, dim=0)
    return x, dainv, q


def _exact_sb_diag(so2_np, pack, bd):
    """Exact posterior diagonal from ``pack = (diag(A^-1), diag(B A^-1 B))``,
    the cancellation-free form per cell (numpy):

        diag(Sb) = so^2 - so^4 diag(A^-1)   (tight cells, so <= sb)
        diag(Sb) = diag(B) - diag(B A^-1 B) (loose cells, so > sb)

    clipped to [0, diag(B)]."""
    dainv, q = pack
    form1 = so2_np - so2_np * so2_np * dainv
    if q is not None:
        form1 = np.where(so2_np > bd, bd - q, form1)
    return np.clip(form1, 0.0, bd)


def _sampled_resid_f64(u3_64, sb_64, so2_64, x64, d64, kappa: float,
                       m: int = 512, seed: int = 1):
    """Row-sampled true relative residual ||d - A_f64 x|| / ||d|| on the host
    (numpy float64, the JAX seed and sample)."""
    n = u3_64.shape[0]
    m = min(m, n)
    rows = np.random.default_rng(seed).choice(n, size=m, replace=False)
    g_rows = _kernel_block_f64(np.ascontiguousarray(u3_64[rows]), 0, m, kappa, full=u3_64)
    r_rows = d64[rows] - (sb_64[rows] * (g_rows @ (sb_64 * x64))
                          + so2_64[rows] * x64[rows])
    dn = float(np.linalg.norm(d64))
    return float(np.sqrt(n / m) * np.linalg.norm(r_rows)) / dn if dn > 0 else 0.0


def _exact_device_wanted() -> bool:
    """``OISAT_EXACT_DEVICE=0`` opts out of the device tail (the host LAPACK
    float64 solve then serves)."""
    return os.environ.get("OISAT_EXACT_DEVICE", "1") != "0"


def _direct_solve_f64(u3_64, sb_64, so2_64, d64, kappa: float, row_block: int = 512,
                      want_diag: bool = False):
    """The host float64 innovation solve of ``OISAT_EXACT_DEVICE=0``, as the
    twin's: the dense kernel built in row blocks, scaled in place to
    ``A = D_b G D_b + D_o^2``, Cholesky-factored in place (LAPACK through
    scipy), solved.  ``want_diag`` also returns ``(diag(A^-1),
    diag(B A^-1 B))`` from the same factor.  Returns ``(x64, pack_or_None)``,
    or ``(None, None)`` when the factorization fails."""
    import scipy.linalg as sla

    n = u3_64.shape[0]
    g = np.empty((n, n))
    for s in range(0, n, row_block):
        _kernel_block_f64(u3_64, s, min(s + row_block, n), kappa, out=g[s:min(s + row_block, n)])
    g *= sb_64[None, :]
    g *= sb_64[:, None]
    g[np.arange(n), np.arange(n)] += so2_64
    try:
        # g is symmetric: g.T is an F-contiguous view LAPACK factors in place
        c = sla.cho_factor(g.T, lower=True, overwrite_a=True, check_finite=False)
        x = sla.cho_solve(c, d64, check_finite=False)
    except np.linalg.LinAlgError:
        return None, None
    if not want_diag:
        return x, None
    dainv, q = _diag_pack_from_factor(c[0], so2_64)
    return x, None if dainv is None else (dainv, q)


def _diag_pack_from_factor(l_lower, so2_64, blk: int = 512):
    """``(diag(A^-1), diag(B A^-1 B))`` from a lower Cholesky factor L, as the
    twin's: the strict row sums of squares of L before an in-place ``dtrtri``,
    then the column sums of squares of L^-1, masked block-wise (no (n, n)
    ``tril`` copy), combined in the cancellation-free form

        q_j = sum_{k<j} L[j,k]^2 + (L[j,j] - so2_j / L[j,j])^2 + so2_j^2 sum_{k>j} Linv[k,j]^2.

    Returns ``(None, None)`` if the triangular inversion fails (the twin
    returns a bare None there)."""
    from scipy.linalg import lapack

    n = l_lower.shape[0]
    d_l = np.ascontiguousarray(np.diagonal(l_lower)).copy()
    rowsq = np.zeros(n)
    for j0 in range(0, n, blk):
        j1 = min(j0 + blk, n)
        head = np.tril(np.ascontiguousarray(l_lower[j0:j1, j0:j1]), -1)
        rowsq[j0:j1] += np.einsum("ij,ij->i", head, head)
        below = l_lower[j1:, j0:j1]
        if below.size:
            rowsq[j1:] += np.einsum("ij,ij->i", below, below)
    linv, info = lapack.dtrtri(l_lower, lower=1, overwrite_c=1)
    if info != 0:
        return None, None
    dainv = np.empty(n)
    off = np.empty(n)
    for j0 in range(0, n, blk):
        j1 = min(j0 + blk, n)
        head = np.tril(np.ascontiguousarray(linv[j0:j1, j0:j1]), -1)
        s = np.einsum("ij,ij->j", head, head)
        below = linv[j1:, j0:j1]
        if below.size:
            s += np.einsum("ij,ij->j", below, below)
        off[j0:j1] = s
        dainv[j0:j1] = s + 1.0 / d_l[j0:j1] ** 2
    so2 = np.asarray(so2_64, np.float64)
    return dainv, rowsq + (d_l - so2 / d_l) ** 2 + so2 * so2 * off


def _exact_tail_solve(sbv, sov, d64, lat, lon, length_scale_km: float, device,
                      diag_block: int = EXACT_DIAG_BLOCK, clock: StageClock = _UNTIMED):
    """The exact tail for float64 host vectors: returns (x64, pack, f64_resid,
    solver) with ``pack = (diag_ainv, q)`` (None where the host triangular
    inversion failed) as numpy and ``solver`` "direct_f64_dev" (the device
    tail on ``device``) or "direct_f64" (the host LAPACK solve of
    ``OISAT_EXACT_DEVICE=0``).  The device tail raises when its result is not
    finite or its sampled residual exceeds the gate; the host solve raises
    when its factorization fails.  ``clock`` marks the stages "tail" (the
    solve and its pull) and "tail_resid" (the host residual check)."""
    kappa = (EARTH_RADIUS_KM / float(length_scale_km)) ** 2
    u3_64 = _sphere_points(lat, lon)
    so2 = sov ** 2
    if not _exact_device_wanted():
        x64, pack = _direct_solve_f64(u3_64, sbv, so2, d64, kappa, want_diag=True)
        clock.mark("tail")
        if x64 is None:
            raise FloatingPointError("oi_full: the host float64 factorization failed")
        rr = _sampled_resid_f64(u3_64, sbv, so2, x64, d64, kappa)
        clock.mark("tail_resid")
        return x64, pack, rr, "direct_f64"
    dev = resolve_device(device)

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

    x, dainv, q = _exact_tail(t64(u3_64), t64(sbv), t64(so2), t64(d64), kappa,
                              diag_block=diag_block)
    x64, dainv, q = (v.cpu().numpy() for v in (x, dainv, q))
    clock.mark("tail")
    if not (np.isfinite(x64).all() and np.isfinite(dainv).all() and np.isfinite(q).all()):
        raise FloatingPointError("oi_full: the float64 exact tail gave non-finite values")
    rr = _sampled_resid_f64(u3_64, sbv, so2, x64, d64, kappa)
    clock.mark("tail_resid")
    if not rr <= DEVICE_EXACT_RESID_GATE:
        raise FloatingPointError(f"oi_full: the exact tail's sampled float64 residual "
                                 f"{rr:.3e} exceeds the gate {DEVICE_EXACT_RESID_GATE:g}")
    return x64, (dainv, q), rr, "direct_f64_dev"


# ---------------------------------------------------------------------------
# grid front end
# ---------------------------------------------------------------------------

def _host64(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


class Compacted(NamedTuple):
    """The valid cells of one analysis, normalised by one scale (host
    float64, each (n,)), with what the scatter-back needs."""

    shape: tuple
    idx: np.ndarray  # flat indices of the valid cells
    scale: float
    xa: np.ndarray
    y: np.ndarray  # clamped at 0
    sb: np.ndarray
    so: np.ndarray
    lat: np.ndarray  # degrees
    lon: np.ndarray


def compact(xa2d, y2d, sigma_b2d, sigma_o2d, lat2d, lon2d) -> Compacted:
    """The front end of :func:`oisat_tpu.ops.oi_full.oi_full`: y < 0 -> 0;
    a cell is valid where all six inputs are finite and ``sigma_o > 0``;
    the four fields are divided by one characteristic scale (the largest
    valid magnitude) so the float32 scan cannot overflow at ~1e16-1e19 VCDs
    (the update is scale-equivariant)."""
    xa = _host64(xa2d)
    y = _host64(y2d).copy()
    y[y < 0] = 0.0  # reference semantics (optimal_interpolation.py:14)
    sb, so = _host64(sigma_b2d), _host64(sigma_o2d)
    lat, lon = _host64(lat2d), _host64(lon2d)
    valid = (np.isfinite(xa) & np.isfinite(y) & np.isfinite(sb) & np.isfinite(so)
             & (so > 0) & np.isfinite(lat) & np.isfinite(lon))
    idx = np.nonzero(valid.ravel())[0]
    scale = 1.0
    if idx.size:
        with np.errstate(invalid="ignore"):
            scale = max(float(np.max(np.abs(f.ravel()[idx]))) for f in (xa, y, sb, so))
        if not np.isfinite(scale) or scale <= 0:
            scale = 1.0

    def pick(f, s=1.0):
        return f.ravel()[idx] / s

    return Compacted(xa.shape, idx, scale, pick(xa, scale), pick(y, scale),
                     pick(sb, scale), pick(so, scale), pick(lat), pick(lon))


def oi_full(xa2d, y2d, sigma_b2d, sigma_o2d, lat2d, lon2d, length_scale_km: float,
            regularization_on: bool = False, *, device="cuda", cov_impl: str = "auto",
            stage_ms: dict | None = None, mesh=None):
    """Grid-shaped full-covariance OI on ``device`` (the card unless the
    caller asks for the CPU): compaction, normalisation, the solve, and
    scatter-back to float64 numpy grids (NaN off the valid cells).
    ``cov_impl`` picks the covariance engine of the dense branch (see
    :data:`oisat_tpu_torch.ops.kernels.covariance.COV_IMPLS`).

    Up to ``DENSE_SCAN_MAX_CELLS`` (``regularization_on``: the 99-factor
    scan) or ``DENSE_MAX_CELLS`` (without) valid cells: the dense solve and
    the conditioning-gated float64 exact tail; ``info`` is None unless the
    tail ran, then ``solver`` ("dense+direct_f64_dev", or "dense+direct_f64"
    under ``OISAT_EXACT_DEVICE=0``), ``reg``, ``f64_resid`` and
    ``exact_diag``.  Above: :func:`_oi_full_large` (the SLQ knee and
    :func:`oi_full_matfree`), whose ``info`` has the solver's keys plus
    ``stat_norm``, with ``resid_abs`` and ``stat_norm`` in the fields'
    physical units.

    With a ``stage_ms`` dict, the wall milliseconds of each stage (the device
    synchronised at each stage's end) are added to it under "oi_full.<stage>"
    and sum to the call's wall time: compact, then covariance, eigh,
    scan_gemms, knee, update (or dense_solve), pull, tail, tail_resid on the
    dense branch, or slq, nystrom, pcg, refine, tail, tail_resid, diag,
    coloring, probe (those the solve reaches) on the matrix-free one, then
    scatter.

    ``mesh``: the matrix-free branch shards its sweeps over the mesh's
    positions (:func:`oi_full_matfree`); the dense branch ignores it, and a
    mesh of one position is dropped, as in the twin."""
    dev = resolve_device(device)
    clock = StageClock(stage_ms, dev, prefix="oi_full.")
    cp = compact(xa2d, y2d, sigma_b2d, sigma_o2d, lat2d, lon2d)
    n = cp.idx.size
    if n == 0:
        nanf = np.full(cp.shape, np.nan)
        return OIFullResult(nanf, nanf.copy(), nanf.copy(), nanf.copy())

    def scatter(v, s=1.0):
        out = np.full(int(np.prod(cp.shape)), np.nan)
        out[cp.idx] = v * s
        return out.reshape(cp.shape)

    if n > (DENSE_SCAN_MAX_CELLS if regularization_on else DENSE_MAX_CELLS):
        clock.mark("compact")
        xb_v, ak_v, inc_v, err_v, info = _oi_full_large(
            cp, float(length_scale_km), regularization_on, dev, clock, mesh=mesh)
        # the solver saw normalised fields: the two field-scaled numbers
        # leave in physical units (the relative cg_resid is scale-free)
        for key in ("resid_abs", "stat_norm"):
            if info.get(key) is not None:
                info[key] = info[key] * cp.scale
    else:
        xb_v, ak_v, inc_v, err_v, info = _oi_full_dense_branch(
            cp, float(length_scale_km), regularization_on, dev, cov_impl, clock)
    res = OIFullResult(scatter(xb_v, cp.scale), scatter(ak_v), scatter(inc_v, cp.scale),
                       scatter(err_v, cp.scale), info)
    clock.mark("scatter")
    return res


def _oi_full_dense_branch(cp: Compacted, length_scale_km: float, regularization_on: bool,
                          dev, cov_impl: str, clock: StageClock):
    """The dense solve of the compacted cells and, at tight conditioning,
    the exact float64 tail: (xb, ak, increment, err, info) as compacted
    numpy vectors in the normalised units."""

    def take(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    args = (take(cp.xa), take(cp.y), take(cp.sb), take(cp.so), take(cp.lat),
            take(cp.lon), length_scale_km)
    clock.mark("compact")
    if regularization_on:
        grid = regularization_grid()
        xb_v, ak_v, inc_v, err_v, reg_index, _ = oi_full_dense_scan(
            *args, grid.astype(np.float32), cov_impl=cov_impl, clock=clock)
        r_chosen = float(grid[reg_index])
    else:
        xb_v, ak_v, inc_v, err_v = oi_full_dense(*args, cov_impl=cov_impl, clock=clock)
        r_chosen = 1.0
    xb_v, ak_v, inc_v, err_v = (_host64(v) for v in (xb_v, ak_v, inc_v, err_v))
    clock.mark("pull")

    # the float32 representation wall: at tight conditioning the dense
    # float32 increment drifts from the float64 solution, so the innovation
    # system and the posterior diagonal are solved again exactly
    sbv = cp.sb * np.sqrt(r_chosen)
    sov = cp.so
    info = None
    if (np.max(sbv) / np.min(sov)) ** 2 > TIGHT_CONDITIONING:
        d64 = cp.y - cp.xa
        x64, pack, rr, how = _exact_tail_solve(sbv, sov, d64, cp.lat, cp.lon,
                                               length_scale_km, dev, clock=clock)
        inc_v = d64 - sov ** 2 * x64
        xb_v = cp.xa + inc_v
        if pack is not None:  # else the float32 diagonal stands, as in the twin
            sbd = _exact_sb_diag(sov ** 2, pack, sbv ** 2)
            err_v = np.sqrt(sbd)
            with np.errstate(invalid="ignore", divide="ignore"):
                ak_v = 1.0 - sbd / (sbv ** 2)
        info = {"solver": "dense+" + how, "reg": r_chosen, "f64_resid": rr,
                "exact_diag": pack is not None}
    return xb_v, ak_v, inc_v, err_v, info


class Padded(NamedTuple):
    """The compacted cells padded to a sweep-block multiple as the
    matrix-free branch takes them (sigma_b = 0 / sigma_o = 1 rows)."""

    xa: np.ndarray
    y: np.ndarray
    sb: np.ndarray
    so: np.ndarray
    lat: np.ndarray
    lon: np.ndarray
    valid: np.ndarray


def pad_for_matfree(cp: Compacted, block: int = MATFREE_BLOCK) -> Padded:
    n = cp.idx.size
    npad = int(np.ceil(n / block)) * block

    def take(v, fill):
        out = np.full(npad, fill)
        out[:n] = v
        return out

    return Padded(take(cp.xa, 0.0), take(cp.y, 0.0), take(cp.sb, 0.0), take(cp.so, 1.0),
                  take(cp.lat, 0.0), take(cp.lon, 0.0), np.arange(npad) < n)


def slq_knee(pv: Padded, length_scale_km: float, device, block: int = MATFREE_BLOCK,
             n_probes: int = SLQ_PROBES, m: int = SLQ_STEPS, mesh=None):
    """(reg_index, curve): the Kneedle knee of the full-domain SLQ mean-AK
    curve (:func:`mean_ak_curve_slq`) over the regularization grid."""
    grid = regularization_grid()
    curve = mean_ak_curve_slq((pv.lat, pv.lon), pv.sb, pv.so, grid, length_scale_km,
                              block=block, n_probes=n_probes, m=m, valid=pv.valid,
                              device=device, mesh=mesh)
    with np.errstate(invalid="ignore"):
        return int(kneedle_index_np(grid, curve, fallback=0)), curve


def _oi_full_large(cp: Compacted, length_scale_km: float, regularization_on: bool, dev,
                   clock: StageClock = _UNTIMED, block: int = MATFREE_BLOCK, mesh=None):
    """The matrix-free branch of :func:`oi_full`, as the twin's
    ``_oi_full_large``: the compacted cells padded to a ``block`` multiple;
    with ``regularization_on`` the knee of the full-domain SLQ mean-AK curve
    (:func:`slq_knee`) picks the factor r and sigma_b is scaled by sqrt(r);
    then :func:`oi_full_matfree`.  Sets ``info["stat_norm"]`` (the
    posterior-std norm) and prints the twin's WARNING when the solve did not
    converge and its field-error bound ``resid_abs`` is not well under
    ``stat_norm``.  Returns (xb, ak, increment, err, info), compacted, in the
    normalised units."""
    n = cp.idx.size
    pv = pad_for_matfree(cp, block)
    sb_v = pv.sb
    if regularization_on:
        reg_index, _ = slq_knee(pv, length_scale_km, dev, block, mesh=mesh)
        # r B = (sqrt(r) sigma_b) C (sqrt(r) sigma_b)
        sb_v = sb_v * np.sqrt(float(regularization_grid()[reg_index]))
        clock.mark("slq")
    xb_v, ak_v, inc_v, err_v, info = oi_full_matfree(
        pv.xa, pv.y, sb_v, pv.so, pv.lat, pv.lon, length_scale_km, block=block,
        valid=pv.valid, device=dev, clock=clock, mesh=mesh)
    # numerics against statistics: the solve's field-error bound resid_abs
    # against the posterior-std norm the analysis is determined to
    stat = float(np.linalg.norm(err_v[:n]))
    num = info.get("resid_abs")
    info["stat_norm"] = stat
    if info["cg_resid"] > CG_WARN_RESID and (num is None or num > 0.3 * stat):
        print(f"WARNING: oi_full matrix-free CG did not fully converge "
              f"(residual {info['cg_resid']:.2e} after {info['cg_iters']} "
              f"iterations; field-error bound "
              f"{f'{num:.2e}' if num is not None else 'n/a'} vs "
              f"posterior-std norm {stat:.2e}); posterior fields are "
              f"correspondingly approximate")
    return xb_v[:n], ak_v[:n], inc_v[:n], err_v[:n], info
