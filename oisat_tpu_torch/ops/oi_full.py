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
  are the JAX functions of the same names, in float32 like them.  With
  ``regularization_on`` the dense branch runs :func:`oi_full_dense_scan_f64`
  instead, the same scan in float64 from C = D^-1 B D^-1 up (on a card C
  comes from ``csrc/covariance.cu``'s float64 kernel): at a monthly
  sigma_b/sigma_o of ~100 the float32 curve's rounding is the size of its
  differences near the knee, so only the float64 curve picks the float64
  reference's factor.  The float32 scan stays as the JAX package's twin.
* :func:`_exact_tail` is ``_exact_tail_prog``: when the conditioning
  estimate ``(max sigma_b sqrt(r) / min sigma_o)^2`` exceeds 1e4 (the
  production regime, monthly-average sigma_b/sigma_o ~ 150-300), the
  innovation system and the exact posterior diagonal are solved again in
  float64 on the tensors' device -- true float64 on the H100, where the TPU
  emulated it -- in one N x N buffer built, scaled and factored in place.
  The algebra is kept: the trailing-sub-triangle blocks (n^3/3), the
  ``L^-1 B = L^T - so^2 V`` identity for ``q = diag(B A^-1 B)`` and both
  posterior forms picked per cell (:func:`_exact_sb_diag`).
  :func:`_sampled_resid_f64` checks the result on the host in float64 with
  the JAX seed, so it samples the same rows.
* :func:`oi_full` is the grid front end: the same validity rule, y < 0
  clamp, one-scale normalisation, compaction, conditioning gate and
  scatter-back.  Above ``DENSE_SCAN_MAX_CELLS`` (with the scan) or
  ``DENSE_MAX_CELLS`` (without) valid cells it takes :func:`_oi_full_large`.
  There, from ``NYSTROM_MIN_CELLS`` up to the exact limit
  (:func:`~oisat_tpu_torch.ops.oi_full_matfree.exact_max_cells`: the JAX
  package's ``REFINE_MAX_CELLS`` = 16,384 off CUDA; on a CUDA card the
  largest multiple of 1,024 whose float64 N x N takes at most half the
  card's total memory, 72,704 on an 80 GB H100), :func:`_oi_full_exact`
  runs the whole analysis in float64 in one N x N buffer
  (:func:`_exact_system`): the correlation G, the knee of the float64 SLQ
  curve on G (:func:`mean_ak_curve_slq_dense`, the port's own: the twin
  takes its float32 knee), then ``A = r D_b G D_b + R`` in place, the
  blocked in-place Cholesky (:func:`_cholesky_`), the solve and both
  diagonals.  Beyond the limit, the float32 SLQ knee and the Nystrom PCG
  with the Woodbury posterior diagonal of the sibling module
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
from typing import NamedTuple

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device, to_device, to_host
from oisat_tpu_torch.ops.kernels.covariance import (EARTH_RADIUS_KM, build_covariance,
                                                    whitened_correlation)
from oisat_tpu_torch.ops.kernels.covariance import correlation_plain as _correlation
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops.oi import regularization_grid
from oisat_tpu_torch.ops import oi_full_matfree as matfree
from oisat_tpu_torch.ops.oi_full_matfree import (  # the twin's names, importable here too
    NYSTROM_MIN_CELLS,
    REFINE_MAX_CELLS,
    _exact_device_wanted,
    _sphere_points,
    mean_ak_curve_slq,
    mean_ak_curve_slq_dense,
    oi_full_matfree,
)
from oisat_tpu_torch.utils.profiling import StageClock, count

__all__ = ["OIFullResult", "oi_full", "oi_full_dense", "oi_full_dense_scan",
           "oi_full_dense_scan_f64", "oi_full_matfree", "mean_ak_curve_slq",
           "DENSE_MAX_CELLS", "DENSE_SCAN_MAX_CELLS", "REFINE_MAX_CELLS", "NYSTROM_MIN_CELLS",
           "DEVICE_EXACT_RESID_GATE"]

# The JAX package's dense limits, kept so both packages take the same branch
# at every n (sized for a 16 GB TPU).  The exact float64 branch's limit is
# the JAX package's REFINE_MAX_CELLS off CUDA only: on a CUDA card it comes
# from the card's total memory (oi_full_matfree.exact_max_cells).
DENSE_MAX_CELLS = 10_240
DENSE_SCAN_MAX_CELLS = 6_144
EXACT_DIAG_BLOCK = 2048  # identity columns per trailing solve of the tail
EXACT_FACTOR_BLOCK = 2048  # rows and columns per block of the tail's factor and solves
DEVICE_EXACT_RESID_GATE = 1e-5  # the JAX acceptance bar for the tail's
# host-f64 row-sampled true residual; true float64 lands orders below it
TIGHT_CONDITIONING = 1e4  # (max sb sqrt(r) / min so)^2 above which the tail runs
MATFREE_BLOCK = 1024  # rows of a covariance sweep's tile on the matrix-free path
SLQ_PROBES, SLQ_STEPS = 8, 60  # the matrix-free knee's probes and Lanczos steps
CG_WARN_RESID = 1e-4  # relative residual above which the convergence warning may print


class OIFullResult(NamedTuple):
    xb: np.ndarray
    averaging_kernel: np.ndarray
    increment: np.ndarray
    error: np.ndarray
    info: dict = None  # the exact tail's solver, factor and residual


def oi_full_dense(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                  diag_block: int = 1024, *, clock: StageClock | None = None):
    """Dense solve without the scan: 1-D float32 tensors of N finite cells on
    one device (``lat``/``lon`` in degrees).  Returns (xb, ak, increment, err).
    ``clock`` marks the stages "covariance" and "dense_solve".

    The posterior diagonal ``diag(B A^-1 B) = colsum(V * V)`` with
    ``V = L^-1 B`` is accumulated in column blocks of ``diag_block``: one
    triangular solve per block (N^3 over all blocks), never an N x N
    ``cholesky_solve``."""
    clock = clock or StageClock(None, "cpu")
    dev = xa.device
    b = build_covariance(lat, lon, sigma_b, length_scale_km, device=dev)
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
                       regs, *, clock: StageClock | None = None):
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
    clock = clock or StageClock(None, "cpu")
    f32 = torch.float32
    dev = xa.device
    b = build_covariance(lat, lon, sigma_b, length_scale_km, device=dev)
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


def oi_full_dense_scan_f64(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                           regs, *, clock: StageClock | None = None):
    """:func:`oi_full_dense_scan` in float64, the dense branch's scan.  One
    N x N buffer takes ``C = D^-1 B D^-1 = diag(s) G diag(s)``,
    ``s = sigma_b / sigma_o``, G the correlation of the cells' unit vectors
    (:func:`~oisat_tpu_torch.ops.kernels.covariance.whitened_correlation`:
    ``csrc/covariance.cu``'s float64 kernel on a card, its plain version on
    the CPU); one ``eigh`` gives ``C = Q diag(lam) Q^T``.  Then, with
    ``B = D Q diag(lam) Q^T D``, nothing needs B again:

        meanAK(r) = (r / Nv) sum_i lam_i^2 w_i / (r lam_i + 1),
                    w_i = sum_j Q_ji^2 sigma_o_j^2 / sigma_b_j^2   (the valid j)
        increment = d - sigma_o Q (Q^T (d / sigma_o) / (r lam + 1))   (0 where sigma_b = 0)
        diag(Sb)_j = sigma_o_j^2 sum_i Q_ji^2 r lam_i / (r lam_i + 1)

    the reference's curve term by term (a sum of positive terms), and a
    posterior diagonal free of the float32 scan's cancellation
    ``r diag(B) - r^2 s``.  Inputs: (N,) tensors on one device (degrees for
    ``lat``/``lon``), taken in float64; ``regs`` the float64 grid (R,).
    Returns (xb, ak, increment, err, reg_index, curve) as
    :func:`oi_full_dense_scan` does, in float64.  ``clock`` marks its stages
    "covariance", "eigh", "scan_gemms", "knee" and "update"."""
    clock = clock or StageClock(None, "cpu")
    f64 = torch.float64
    xa, y, sb, so, lat, lon = (t.to(f64) for t in (xa, y, sigma_b, sigma_o, lat, lon))
    la, lo = torch.deg2rad(lat), torch.deg2rad(lon)
    cl = torch.cos(la)
    u3 = torch.stack([cl * torch.cos(lo), cl * torch.sin(lo), torch.sin(la)], dim=1)
    c = whitened_correlation(u3, sb / so, (EARTH_RADIUS_KM / float(length_scale_km)) ** 2)
    clock.mark("covariance")
    lam, q = torch.linalg.eigh(c)
    del c
    clock.mark("eigh")
    bd = sb * sb
    valid = bd > 0  # sigma_b = 0 cells stay out of the curve
    q2 = q.square()
    w = q2.T @ torch.where(valid, so * so / torch.where(valid, bd, 1.0), 0.0)
    regs_np = np.asarray(regs, np.float64)
    regs_t = torch.as_tensor(regs_np, device=xa.device)
    coef = 1.0 / (regs_t[:, None] * lam[None, :] + 1.0)  # (R, N)
    curve = regs_t * (coef @ (lam * lam * w)) / torch.clamp(valid.sum(), min=1)
    clock.mark("scan_gemms")
    reg_index = kneedle_index_np(regs_np, to_host(curve), fallback=0)
    clock.mark("knee")
    r = float(regs_np[reg_index])
    d = y - xa
    # a sigma_b = 0 cell's row of the gain is 0: its increment is exactly 0
    increment = torch.where(valid, d - so * (q @ (coef[reg_index] * (q.T @ (d / so)))), 0.0)
    sb_diag = torch.minimum(torch.clamp(so * so * (q2 @ (r * lam * coef[reg_index])), min=0.0),
                            r * bd)
    ak = torch.where(valid, 1.0 - sb_diag / torch.where(valid, r * bd, 1.0),
                     torch.full_like(bd, math.nan))
    clock.mark("update")
    return xa + increment, ak, increment, torch.sqrt(sb_diag), reg_index, curve


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


def _cholesky_(a, block: int = EXACT_FACTOR_BLOCK) -> torch.Tensor:
    """Factor the SPD ``a`` (N, N) in place, right-looking by ``block``
    columns in torch operations: each diagonal block factored, its panel
    solved, the lower trailing block columns updated by GEMMs.  ``a``'s
    lower triangle becomes L with ``a = L L^T``; the upper triangle outside
    the diagonal blocks keeps its values, and nothing reads it.  The
    workspace is one (N, block) panel.  On an H100 at N = 64,261 this takes
    2.4 s where cuSOLVER's own in-place potrf (``torch.linalg.cholesky_ex``
    on the column-major view) takes 17.7 s.  Raises ``FloatingPointError``
    when a diagonal block is not positive definite."""
    n = a.shape[0]
    bad = torch.zeros((), dtype=torch.int32, device=a.device)
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        d, info = torch.linalg.cholesky_ex(a[k0:k1, k0:k1])
        bad = torch.maximum(bad, info)
        a[k0:k1, k0:k1] = d
        if k1 == n:
            break
        panel = torch.linalg.solve_triangular(d.T, a[k1:, k0:k1], upper=True, left=False)
        a[k1:, k0:k1] = panel
        for j0 in range(k1, n, block):
            j1 = min(j0 + block, n)
            a[j0:, j0:j1].addmm_(panel[j0 - k1:], panel[j0 - k1:j1 - k1].T, alpha=-1.0)
    count("syncs")
    if int(bad):
        raise FloatingPointError("oi_full: the float64 factorization failed")
    return a


def _forward_(lf, x, start: int = 0, block: int = EXACT_FACTOR_BLOCK) -> torch.Tensor:
    """Solve ``L[start:, start:] X = x`` in place (x: (N - start, K)) from the
    lower triangle of ``lf``, by row blocks: one GEMM against the rows
    solved so far and one small triangular solve each.  Every view of
    ``lf`` is read where it lies."""
    n = lf.shape[0]
    for i0 in range(start, n, block):
        i1 = min(i0 + block, n)
        r0, r1 = i0 - start, i1 - start
        if r0:
            x[r0:r1].addmm_(lf[i0:i1, start:i0], x[:r0], alpha=-1.0)
        x[r0:r1] = torch.linalg.solve_triangular(lf[i0:i1, i0:i1], x[r0:r1], upper=False)
    return x


def _backward_(lf, x, block: int = EXACT_FACTOR_BLOCK) -> torch.Tensor:
    """Solve ``L^T X = x`` in place from the lower triangle of ``lf``."""
    n = lf.shape[0]
    for i0 in reversed(range(0, n, block)):
        i1 = min(i0 + block, n)
        if i1 < n:
            x[i0:i1].addmm_(lf[i1:, i0:i1].T, x[i1:], alpha=-1.0)
        x[i0:i1] = torch.linalg.solve_triangular(lf[i0:i1, i0:i1].T, x[i0:i1], upper=True)
    return x


def _inverse_diags(lf, so2, diag_block: int = EXACT_DIAG_BLOCK,
                   block: int = EXACT_FACTOR_BLOCK):
    """``(diag(A^-1), q = diag(B A^-1 B))`` from the factor L in ``lf``'s lower
    triangle, over blocks of ``diag_block`` identity columns.

    ``L^-1 e_j`` is zero above row j, so block j0 solves only the trailing
    (N - j0) sub-triangle (N^3/3 in all); the q columns come free of a
    second solve, ``L^-1 B[:, blk] = L^T[:, blk] - so2 * V`` with
    ``V = L^-1 I[:, blk]``, plus the row sums of squares of ``L[blk, :j0]``.
    Both diagonals are pure sums of squares.  The last block may be ragged;
    the workspace is (N, diag_block)."""
    n = lf.shape[0]
    dainv = torch.empty(n, dtype=lf.dtype, device=lf.device)
    q = torch.empty_like(dainv)
    for j0 in range(0, n, diag_block):
        j1 = min(j0 + diag_block, n)
        k = j1 - j0
        v = _forward_(lf, torch.eye(n - j0, k, dtype=lf.dtype, device=lf.device), j0, block)
        dainv[j0:j1] = v.square().sum(dim=0)
        v.mul_(-so2[j0:j1])  # L^T[j0:, blk] - so2 V: L^T is zero below the block's rows
        v[:k] += torch.tril(lf[j0:j1, j0:j1]).T
        q[j0:j1] = lf[j0:j1, :j0].square().sum(dim=1) + v.square().sum(dim=0)
    return dainv, q


def _exact_system(u3, sb, so2, d, kappa: float, diag_block: int = EXACT_DIAG_BLOCK, *,
                  knee=None, clock: StageClock | None = None):
    """``_exact_tail_prog`` in float64 on the tensors' device, in one N x N
    buffer: the correlation G of the unit vectors ``u3`` (N, 3); with
    ``knee`` the factor ``r = knee(G)`` (a function that reads G, such as
    the float64 SLQ curve and its knee), else r = 1; then in place
    ``A = r D_b G D_b + D_o^2``, its Cholesky factor (:func:`_cholesky_`),
    the solve ``A x = d`` and ``diag(A^-1)``, ``q = diag(B A^-1 B)`` with
    ``B = r D_b G D_b`` (:func:`_inverse_diags`).  The workspace besides the
    buffer is O(N x diag_block), and the buffer is freed on return.
    ``clock`` marks "curve" (G and the knee; "covariance" without one),
    "factor" (the scaling and the factor), "solve" and "diag".  Returns
    (x, diag_ainv, q, r): three float64 tensors and a float."""
    clock = clock or StageClock(None, "cpu")
    a = _correlation(u3, kappa)
    r = 1.0 if knee is None else float(knee(a))
    clock.mark("covariance" if knee is None else "curve")
    s = sb * math.sqrt(r)
    a.mul_(s[:, None]).mul_(s[None, :])
    a.diagonal().add_(so2)
    _cholesky_(a)
    clock.mark("factor")
    x = d[:, None].clone(memory_format=torch.contiguous_format)
    x = _backward_(a, _forward_(a, x))[:, 0]
    clock.mark("solve")
    dainv, q = _inverse_diags(a, so2, diag_block)
    clock.mark("diag")
    return x, dainv, q, r


def _exact_tail(u3, sb, so2, d, kappa: float, diag_block: int = EXACT_DIAG_BLOCK):
    """:func:`_exact_system` without a knee: build ``A = D_b G D_b + D_o^2``
    from unit vectors ``u3`` (N, 3), factor it, solve ``A x = d`` and
    accumulate ``diag(A^-1)`` and ``q = diag(B A^-1 B)`` over blocks of
    ``diag_block`` identity columns, all in one float64 N x N buffer.
    Returns (x, diag_ainv, q), float64 tensors."""
    return _exact_system(u3, sb, so2, d, kappa, diag_block)[:3]


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
                      diag_block: int = EXACT_DIAG_BLOCK, clock: StageClock | None = None):
    """The exact tail for float64 host vectors: returns (x64, pack, f64_resid,
    solver) with ``pack = (diag_ainv, q)`` (None where the host triangular
    inversion failed) as numpy and ``solver`` "direct_f64_dev" (the device
    tail on ``device``) or "direct_f64" (the host LAPACK solve of
    ``OISAT_EXACT_DEVICE=0``).  The device tail raises when its result is not
    finite or its sampled residual exceeds the gate; the host solve raises
    when its factorization fails.  ``clock`` marks the stages "tail" (the
    solve and its pull) and "tail_resid" (the host residual check)."""
    clock = clock or StageClock(None, "cpu")
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
        return to_device(np.ascontiguousarray(a), dev, torch.float64)

    x, dainv, q = _exact_tail(t64(u3_64), t64(sbv), t64(so2), t64(d64), kappa,
                              diag_block=diag_block)
    x64, dainv, q, rr = _checked_pull(x, dainv, q, u3_64, sbv, so2, d64, kappa, clock, "tail")
    return x64, (dainv, q), rr, "direct_f64_dev"


def _checked_pull(x, dainv, q, u3_64, sbv, so2, d64, kappa: float, clock: StageClock,
                  stage: str):
    """The device tail's (x, diag(A^-1), q) pulled in one copy (the stage
    ``stage``) and held to the no-fallback rule: a non-finite value, or a
    sampled float64 residual of x (the stage "tail_resid") above
    ``DEVICE_EXACT_RESID_GATE``, raises.  Returns (x64, dainv, q, resid)."""
    x64, dainv, q = to_host(torch.stack([x, dainv, q]))
    clock.mark(stage)
    if not (np.isfinite(x64).all() and np.isfinite(dainv).all() and np.isfinite(q).all()):
        raise FloatingPointError("oi_full: the float64 exact tail gave non-finite values")
    rr = _sampled_resid_f64(u3_64, sbv, so2, x64, d64, kappa)
    clock.mark("tail_resid")
    if not rr <= DEVICE_EXACT_RESID_GATE:
        raise FloatingPointError(f"oi_full: the exact tail's sampled float64 residual "
                                 f"{rr:.3e} exceeds the gate {DEVICE_EXACT_RESID_GATE:g}")
    return x64, dainv, q, rr


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
            regularization_on: bool = False, *, device="cuda", stage_ms: dict | None = None,
            mesh=None):
    """Grid-shaped full-covariance OI on ``device`` (the card unless the
    caller asks for the CPU): compaction, normalisation, the solve, and
    scatter-back to float64 numpy grids (NaN off the valid cells).  The
    dense solve's B, the dense scan's float64 C and the matrix-free
    branch's B.V sweeps run on the hand-written kernels on the card and on
    their plain versions on the CPU.

    Up to ``DENSE_SCAN_MAX_CELLS`` (``regularization_on``: the 99-factor
    scan) or ``DENSE_MAX_CELLS`` (without) valid cells: the dense solve and
    the conditioning-gated float64 exact tail; ``info`` is None unless the
    tail ran, then ``solver`` ("dense+direct_f64_dev", or "dense+direct_f64"
    under ``OISAT_EXACT_DEVICE=0``), ``reg``, ``f64_resid`` and
    ``exact_diag``.  Above: :func:`_oi_full_large` (the exact float64 branch
    with its float64 knee, or beyond it the SLQ knee and
    :func:`oi_full_matfree`), whose ``info`` has the solver's keys plus
    ``stat_norm``, with ``resid_abs`` and ``stat_norm`` in the fields'
    physical units (and ``reg``, the factor, where the exact branch ran).

    With a ``stage_ms`` dict, the wall milliseconds of each stage (the device
    synchronised at each stage's end) are added to it under "oi_full.<stage>"
    and sum to the call's wall time: compact, then covariance, eigh,
    scan_gemms, knee, update (or dense_solve), pull, tail, tail_resid on the
    dense branch; curve (or covariance), factor, solve, diag, pull and
    tail_resid on the large branch's exact one; or slq, nystrom, pcg,
    refine, tail, tail_resid, diag, coloring, probe (those the solve
    reaches) on the matrix-free one; then scatter.

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
            cp, float(length_scale_km), regularization_on, dev, clock)
    res = OIFullResult(scatter(xb_v, cp.scale), scatter(ak_v), scatter(inc_v, cp.scale),
                       scatter(err_v, cp.scale), info)
    clock.mark("scatter")
    return res


def _oi_full_dense_branch(cp: Compacted, length_scale_km: float, regularization_on: bool,
                          dev, clock: StageClock):
    """The dense solve of the compacted cells and, at tight conditioning,
    the exact float64 tail: (xb, ak, increment, err, info) as compacted
    numpy vectors in the normalised units.  With ``regularization_on`` the
    float64 scan (:func:`oi_full_dense_scan_f64`, its inputs in one copy),
    without it the float32 dense solve.  Counts
    ``oi_full.dense_cells`` (the cells) and ``oi_full.dense_tails`` (1 where
    the tail ran)."""
    count("oi_full.dense_cells", cp.idx.size)
    grid = regularization_grid()
    if regularization_on:
        args = to_device(np.stack([cp.xa, cp.y, cp.sb, cp.so, cp.lat, cp.lon]), dev,
                         torch.float64)
        clock.mark("compact")
        *fields, reg_index, _ = oi_full_dense_scan_f64(*args, length_scale_km, grid,
                                                       clock=clock)
    else:
        args = [torch.as_tensor(a.astype(np.float32), device=dev)
                for a in (cp.xa, cp.y, cp.sb, cp.so, cp.lat, cp.lon)]
        clock.mark("compact")
        fields, reg_index = oi_full_dense(*args, length_scale_km, clock=clock), None
    r_chosen = 1.0 if reg_index is None else float(grid[reg_index])
    xb_v, ak_v, inc_v, err_v = to_host(torch.stack(fields).to(torch.float64))
    clock.mark("pull")

    # the float32 representation wall: at tight conditioning the dense
    # float32 increment drifts from the float64 solution, so the innovation
    # system and the posterior diagonal are solved again exactly
    sbv = cp.sb * np.sqrt(r_chosen)
    sov = cp.so
    info = None
    if (np.max(sbv) / np.min(sov)) ** 2 > TIGHT_CONDITIONING:
        count("oi_full.dense_tails")
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
                   clock: StageClock | None = None, block: int = MATFREE_BLOCK, mesh=None):
    """The large branch of :func:`oi_full`, as the twin's ``_oi_full_large``:
    the compacted cells padded to a ``block`` multiple.  Where the padded
    count is in the exact float64 branch's range (``NYSTROM_MIN_CELLS`` up to
    :func:`~oisat_tpu_torch.ops.oi_full_matfree.exact_max_cells`, the device
    tail wanted), :func:`_oi_full_exact`: the knee from the float64 curve
    and the exact posterior, in one N x N buffer.  Elsewhere, with
    ``regularization_on`` the knee of the full-domain float32 SLQ mean-AK
    curve (:func:`slq_knee`) picks the factor r and sigma_b is scaled by
    sqrt(r); then :func:`oi_full_matfree`.  Sets ``info["stat_norm"]`` (the
    posterior-std norm) and prints the twin's WARNING when the solve did not
    converge and its field-error bound ``resid_abs`` is not well under
    ``stat_norm``.  Returns (xb, ak, increment, err, info), compacted, in the
    normalised units."""
    clock = clock or StageClock(None, "cpu")
    n = cp.idx.size
    pv = pad_for_matfree(cp, block)
    if (matfree.NYSTROM_MIN_CELLS <= pv.xa.size <= matfree.exact_max_cells(dev, block)
            and _exact_device_wanted()):
        xb_v, ak_v, inc_v, err_v, info = _oi_full_exact(cp, length_scale_km, regularization_on,
                                                        dev, clock, block)
    else:
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


def _oi_full_exact(cp: Compacted, length_scale_km: float, regularization_on: bool, dev,
                   clock: StageClock, block: int = MATFREE_BLOCK):
    """The exact float64 branch of :func:`_oi_full_large` on the n compacted
    cells (unpadded): one copy of the unit vectors, sigma_b, sigma_o^2 and
    the innovation to ``dev``; :func:`_exact_system`, whose knee (with
    ``regularization_on``) is the Kneedle knee of the float64 SLQ curve on
    the system's own correlation buffer (:func:`mean_ak_curve_slq_dense`,
    with the float32 sweep's probes over n padded to ``block``, and its
    steps); one pull of x and both diagonals; then the checks and the
    posterior of :func:`_exact_tail_solve`'s callers: a non-finite result
    or a sampled float64 residual above ``DEVICE_EXACT_RESID_GATE`` raises.
    Counts ``oi_full.exact_cells`` (n) and ``oi_full.exact_bytes`` (the
    buffer's bytes).  ``clock`` marks "curve" (or "covariance"), "factor",
    "solve", "diag", "pull" and "tail_resid".  Returns (xb, ak, increment,
    err, info) as compacted numpy vectors in the normalised units, ``info``
    with :func:`oi_full_matfree`'s keys for its exact branch and ``reg``."""
    n = cp.idx.size
    kappa = (EARTH_RADIUS_KM / float(length_scale_km)) ** 2
    u3_64 = _sphere_points(cp.lat, cp.lon)
    so2 = cp.so ** 2
    d64 = cp.y - cp.xa
    count("oi_full.exact_cells", n)
    count("oi_full.exact_bytes", 8 * n * n)
    knee = None
    if regularization_on:
        grid = regularization_grid()

        def knee(g):
            curve = mean_ak_curve_slq_dense(g, cp.sb, cp.so, grid, block=block,
                                            n_probes=SLQ_PROBES, m=SLQ_STEPS)
            with np.errstate(invalid="ignore"):
                return grid[int(kneedle_index_np(grid, curve, fallback=0))]

    t = to_device(np.concatenate([u3_64, np.stack([cp.sb, so2, d64], axis=1)], axis=1), dev,
                  torch.float64)
    x, dainv, q, r = _exact_system(t[:, :3], t[:, 3], t[:, 4], t[:, 5], kappa, knee=knee,
                                   clock=clock)
    sbv = cp.sb * math.sqrt(r)
    x64, dainv, q, rr = _checked_pull(x, dainv, q, u3_64, sbv, so2, d64, kappa, clock, "pull")
    bd = sbv ** 2
    increment = d64 - so2 * x64
    sb_diag = _exact_sb_diag(so2, (dainv, q), bd)
    with np.errstate(invalid="ignore", divide="ignore"):
        ak = 1.0 - sb_diag / bd
    info = {"cg_iters": 0, "cg_resid": rr, "ncolors": 0, "nchunks": 0, "nreps": 0,
            "precond": "direct", "solver": "direct_f64_dev", "exact_diag": True,
            "refine_passes": 0, "f64_resid": rr,
            "resid_abs": rr * float(np.linalg.norm(d64)), "reg": float(r)}
    return cp.xa + increment, ak, increment, np.sqrt(np.maximum(sb_diag, 0.0)), info
