"""The full-covariance OI of the plain reference, in plain PyTorch.

Independent of the program: it imports neither ``oisat_tpu_torch`` nor
``oisat_tpu`` nor ``jax``.  It is written from the definitions of the
``oi_method: full`` analysis (a distance-decay background covariance, H = I
on the analysis grid), on the month's averaged fields:

* inputs: ``xa`` the CTM average, ``y`` the bias-corrected satellite
  average clamped at 0, ``sigma_b = xa * ctm_error / 100``, ``sigma_o`` the
  averaged observation error, and the grid's latitude and longitude;
* a cell is valid where all six are finite and ``sigma_o > 0``; every
  other cell comes back NaN;
* ``B_ij = sigma_b_i sigma_b_j exp(-kappa (1 - u_i . u_j))``, ``kappa =
  (6371 km / L)^2``, ``u`` the unit vector of a cell on the sphere;
  ``R = diag(sigma_o^2)`` and ``A = r B + R``;
* ``r``: the Kneedle knee (:func:`benchmark.reference.kneedle_index`) of
  the mean-AK curve over the 99 factors of ``REGS``, the mean taken over
  the valid cells with ``sigma_b > 0``:
  ``meanAK(r) = (r / Nv) sum_j (B A^-1 B)_jj / B_jj``;
* ``xb = xa + r B A^-1 (y - xa)``, computed as ``y - R A^-1 (y - xa)``
  (``r B A^-1 = I - R A^-1``);
  ``diag(Sb) = sigma_o^2 - sigma_o^4 diag(A^-1)`` (equal to
  ``diag(rB) - diag(rB A^-1 rB)``), ``AK = 1 - diag(Sb) / diag(rB)``, the
  error ``sqrt(diag(Sb))``.

The knee's curve: up to ``DENSE_CURVE_MAX_CELLS`` valid cells it is exact,
from one eigendecomposition ``R^-1/2 B R^-1/2 = Q diag(lam) Q^T``:
``meanAK(r) = (r / Nv) sum_i lam_i^2 w_i / (r lam_i + 1)`` with
``w_i = sum_j Q_ji^2 sigma_o_j^2 / sigma_b_j^2``.  Above it the curve is the
stochastic Lanczos quadrature estimate of the same trace with the
program's probes: ``SLQ_PROBES`` Rademacher columns drawn by
``np.random.default_rng(0)`` over the cell count padded to a multiple of
``SLQ_PAD`` (the rows of the valid cells kept), ``SLQ_STEPS`` Lanczos steps
of ``R^-1/2 B R^-1/2`` from each polarised start vector, and Gauss
quadrature of ``1 / (r lam + 1)``.  That is a stated departure from an
exact curve: the exact curve at 64,261 cells needs a 64k eigendecomposition,
which does not fit a run.

Memory: one N x N matrix of the precision.  B is built in place, serves
the curve, is turned into ``A`` in place once ``r`` is chosen (B is not
needed again), and ``A`` is factored in place by a blocked Cholesky of
plain torch operations; the solve and ``diag(A^-1)`` (column blocks of
``L^-1``, each from the trailing sub-triangle) read the factor where it
lies.  The workspace is O(N x block).  Every step computes in the dtype it
is given: float64 for the reference, float32 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import REGS, kneedle_index

__all__ = ["EARTH_RADIUS_KM", "DENSE_CURVE_MAX_CELLS", "BLOCK", "full_oi", "covariance",
           "exact_curve", "slq_curve", "cholesky_", "forward_", "backward_", "inverse_diag"]

EARTH_RADIUS_KM = 6371.0
# the most valid cells whose curve is exact (the program's dense-scan limit)
DENSE_CURVE_MAX_CELLS = 6144
SLQ_PROBES, SLQ_STEPS, SLQ_PAD = 8, 60, 1024
BLOCK = 1024  # rows and columns of a block of the factor and of its solves


def covariance(lat, lon, sigma_b, length_scale_km: float) -> torch.Tensor:
    """The N x N B of (N,) degrees and ``sigma_b``, in their dtype and on
    their device, built in place."""
    la, lo = torch.deg2rad(lat), torch.deg2rad(lon)
    u = torch.stack([torch.cos(la) * torch.cos(lo), torch.cos(la) * torch.sin(lo),
                     torch.sin(la)], dim=1)
    b = u @ u.T
    b.sub_(1.0).mul_((EARTH_RADIUS_KM / float(length_scale_km)) ** 2).exp_()
    b.mul_(sigma_b[:, None]).mul_(sigma_b[None, :])
    return b


def _mean_ak(regs, num) -> np.ndarray:
    return np.asarray(regs * num.double().cpu().numpy(), np.float64)


def exact_curve(b, sigma_o, on_curve) -> np.ndarray:
    """meanAK(r) over ``REGS`` from one eigendecomposition of
    ``R^-1/2 B R^-1/2``; ``on_curve`` marks the cells the mean counts."""
    oin = 1.0 / sigma_o
    lam, q = torch.linalg.eigh(b * oin[:, None] * oin[None, :])
    bd = torch.diagonal(b)
    v = torch.where(on_curve, sigma_o ** 2 / torch.where(on_curve, bd, 1.0), 0.0)
    w = (q * q).T @ v
    regs = torch.as_tensor(REGS, device=b.device).to(b.dtype)
    coef = lam[None, :] ** 2 / (regs[:, None] * lam[None, :] + 1.0)
    nv = max(int(on_curve.sum()), 1)
    return _mean_ak(REGS, coef @ w / nv)


def slq_curve(b, sigma_o, on_curve, n_probes: int = SLQ_PROBES, steps: int = SLQ_STEPS,
              pad: int = SLQ_PAD) -> np.ndarray:
    """meanAK(r) over ``REGS`` by stochastic Lanczos quadrature: the trace
    ``tr(D^-1 B A^-1 B)`` (D = diag(B) on the curve's cells) estimated with
    Rademacher probes z, each ``z^T D^-1 B A^-1 B z = x^T f(C) y`` with
    ``C = R^-1/2 B R^-1/2``, ``f = 1 / (r C + 1)``, ``x = R^-1/2 B D^-1 z``,
    ``y = R^-1/2 B z``, polarised into ``((x+y)^T f (x+y) - (x-y)^T f (x-y)) / 4``
    and each quadratic form priced by ``steps`` Lanczos steps."""
    n = b.shape[0]
    npad = -(-n // pad) * pad
    z = np.random.default_rng(0).choice([-1.0, 1.0], size=(npad, n_probes))[:n]
    dt, dev = b.dtype, b.device
    z = torch.as_tensor(z, device=dev).to(dt) * on_curve[:, None]
    bd = torch.diagonal(b)
    zd = z / torch.where(on_curve, bd, 1.0)[:, None]
    bz = b @ torch.cat([zd, z], dim=1)
    oin = 1.0 / sigma_o
    x, y = bz[:, :n_probes] * oin[:, None], bz[:, n_probes:] * oin[:, None]
    q = torch.cat([x + y, x - y], dim=1)
    norms = torch.sqrt(torch.sum(q * q, dim=0))
    q = q / torch.where(norms > 0, norms, 1.0)
    q_prev = torch.zeros_like(q)
    beta = torch.zeros(q.shape[1], dtype=dt, device=dev)
    alphas, betas = [], []
    for _ in range(steps):
        w = oin[:, None] * (b @ (oin[:, None] * q)) - beta[None, :] * q_prev
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha[None, :] * q
        beta = torch.sqrt(torch.sum(w * w, dim=0))
        q_prev, q = q, w / torch.where(beta > 0, beta, 1.0)[None, :]
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, dim=1)  # (2 probes, steps)
    off = torch.stack(betas, dim=1)[:, :-1]
    t = torch.diag_embed(a) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    theta, vecs = torch.linalg.eigh(t)
    w2 = vecs[:, 0, :] ** 2 * (norms ** 2)[:, None]  # (2 probes, steps)
    regs = torch.as_tensor(REGS, device=dev).to(dt)
    g = (w2[None] / (regs[:, None, None] * torch.clamp(theta, min=0.0)[None] + 1.0)).sum(2)
    sign = torch.cat([torch.ones(n_probes), -torch.ones(n_probes)]).to(device=dev, dtype=dt)
    nv = max(int(on_curve.sum()), 1)
    return _mean_ak(REGS, 0.25 * (g @ sign) / n_probes / nv)


def cholesky_(a, block: int = BLOCK) -> torch.Tensor:
    """Factor the SPD ``a`` in place, right-looking by ``block`` columns:
    its lower triangle becomes L (``a = L L^T``); what lies above the
    diagonal blocks is left as it was and never read."""
    n = a.shape[0]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        d = torch.linalg.cholesky(a[k0:k1, k0:k1])
        a[k0:k1, k0:k1] = d
        if k1 == n:
            break
        panel = torch.linalg.solve_triangular(d.T, a[k1:, k0:k1], upper=True, left=False)
        a[k1:, k0:k1] = panel
        for j0 in range(k1, n, block):  # the trailing lower block columns
            j1 = min(j0 + block, n)
            a[j0:, j0:j1].addmm_(panel[j0 - k1:], panel[j0 - k1:j1 - k1].T, alpha=-1.0)
    return a


def forward_(lf, x, start: int = 0, block: int = BLOCK) -> torch.Tensor:
    """Solve ``L[start:, start:] X = x`` in place (x: (n - start, k)),
    reading L's lower triangle of ``lf`` by blocks."""
    n = lf.shape[0]
    for i0 in range(start, n, block):
        i1 = min(i0 + block, n)
        r0, r1 = i0 - start, i1 - start
        if r0:
            x[r0:r1] -= lf[i0:i1, start:i0] @ x[:r0]
        x[r0:r1] = torch.linalg.solve_triangular(lf[i0:i1, i0:i1], x[r0:r1], upper=False)
    return x


def backward_(lf, x, block: int = BLOCK) -> torch.Tensor:
    """Solve ``L^T X = x`` in place, reading L's lower triangle by blocks."""
    n = lf.shape[0]
    for i0 in reversed(range(0, n, block)):
        i1 = min(i0 + block, n)
        if i1 < n:
            x[i0:i1] -= lf[i1:, i0:i1].T @ x[i1:]
        x[i0:i1] = torch.linalg.solve_triangular(lf[i0:i1, i0:i1].T, x[i0:i1], upper=True)
    return x


def inverse_diag(lf, block: int = BLOCK) -> torch.Tensor:
    """``diag(A^-1)`` from the factor: the column sums of squares of L^-1,
    one block of columns at a time; ``L^-1 e_j`` is zero above row j, so
    each block solves only the trailing sub-triangle."""
    n = lf.shape[0]
    out = torch.empty(n, dtype=lf.dtype, device=lf.device)
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        v = forward_(lf, torch.eye(n - j0, j1 - j0, dtype=lf.dtype, device=lf.device), j0,
                     block)
        out[j0:j1] = torch.sum(v * v, dim=0)
    return out


def full_oi(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float, dtype,
            dense_max: int | None = None, block: int = BLOCK):
    """The full OI of grid-shaped fields (tensors; ``lat``/``lon`` degrees,
    tensors or arrays) in ``dtype`` on the fields' device.  Returns (xb, ak,
    increment, error, info): grids in ``dtype``, NaN off the valid cells,
    and ``info`` with the knee index ``knee``, the factor ``reg``, the valid
    cells ``n`` and the curve's kind ``curve`` ("exact" or "slq").  The curve
    is exact up to ``dense_max`` valid cells (default
    ``DENSE_CURVE_MAX_CELLS``)."""
    dev = xa.device
    shape = xa.shape
    xa, y, sigma_b, sigma_o = (t.to(dtype).reshape(-1) for t in (xa, y, sigma_b, sigma_o))
    lat, lon = (torch.as_tensor(np.asarray(t, np.float64), device=dev).to(dtype).reshape(-1)
                for t in (lat, lon))
    y = torch.where(y < 0, torch.zeros_like(y), y)
    valid = (torch.isfinite(xa) & torch.isfinite(y) & torch.isfinite(sigma_b)
             & torch.isfinite(sigma_o) & (sigma_o > 0) & torch.isfinite(lat)
             & torch.isfinite(lon))
    idx = torch.nonzero(valid).reshape(-1)
    n = int(idx.numel())
    outs = [torch.full((xa.numel(),), math.nan, dtype=dtype, device=dev) for _ in range(4)]
    info = {"knee": 0, "reg": float(REGS[0]), "n": n, "curve": "none"}
    if n == 0:
        return (*(o.reshape(shape) for o in outs), info)
    xv, yv, sb, so = (t[idx] for t in (xa, y, sigma_b, sigma_o))
    # one scale for the four fields: the update is scale-equivariant, and the
    # control's float32 then holds so^4 at any column unit
    scale = max(float(t.abs().max()) for t in (xv, yv, sb, so))  # >= sigma_o > 0
    xv, yv, sb, so = xv / scale, yv / scale, sb / scale, so / scale
    b = covariance(lat[idx], lon[idx], sb, length_scale_km)
    bd = torch.diagonal(b).clone()
    on_curve = bd > 0
    if n <= (DENSE_CURVE_MAX_CELLS if dense_max is None else dense_max):
        curve, kind = exact_curve(b, so, on_curve), "exact"
    else:
        curve, kind = slq_curve(b, so, on_curve), "slq"
    knee = kneedle_index(REGS, curve, fallback=0)
    r = float(REGS[knee])
    a = b.mul_(r)  # B is not needed again: A = r B + R in its place
    del b
    so2 = so * so
    a.diagonal().add_(so2)
    cholesky_(a, block)
    d = yv - xv
    x = backward_(a, forward_(a, d[:, None].clone(), 0, block), block)[:, 0]
    dainv = inverse_diag(a, block)
    del a
    sbd = torch.clamp(so2 - so2 * so2 * dainv, min=0.0)
    inc = d - so2 * x
    vals = (xv + inc, 1.0 - sbd / (r * bd), inc, torch.sqrt(sbd))
    for o, v, s in zip(outs, vals, (scale, 1.0, scale, scale)):
        o[idx] = v * s
    info.update(knee=knee, reg=r, curve=kind)
    return (*(o.reshape(shape) for o in outs), info)
