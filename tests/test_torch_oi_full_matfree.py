"""The port's matrix-free full OI (oisat_tpu_torch.ops.oi_full_matfree and
the large branch of oisat_tpu_torch.ops.oi_full) against the JAX package's
oisat_tpu.ops.oi_full on the same numpy inputs, on the CPU, at the sizes and
bounds of tests/test_oi_full.py.

Tolerances, each against the field's largest magnitude unless said:

* ``_b_matmat``: 1e-5 in float32 (the exp and the sums round in another
  order), 1e-12 in float64;
* CG / PCG solutions and the Jacobi posterior: the bounds of
  ``test_matfree_matches_dense`` against the dense solve (xb 2e-4,
  increment 5e-4, AK / err 2e-3), and 1e-4 against the JAX solve (two
  float32 CGs that stop at cg_tol 1e-7 / 1e-6);
* Nystrom with the JAX sketch fed in: solution and diagonal 1e-4 (two float32
  eigensolvers; eigenvector signs are free, so U is not compared);
* the SLQ curve: rtol 1e-3 of the JAX curve with the same knee, rtol 0.04
  of the dense scan's (the JAX test's trace-noise bound);
* the exact float64 branch: 1e-9 (the increment on the scale of xb, since it
  crosses zero), ``exact_diag`` True;
* refinement: ``f64_resid`` within 10x of the JAX one and below the
  unrefined solve's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu.ops import oi_full as J
from oisat_tpu.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.ops import oi_full_matfree as M
from tests.test_oi_full import _random_domain

torch.set_num_threads(1)

FIELDS = ("xb", "ak", "increment", "err")
GRID_FIELDS = ("xb", "averaging_kernel", "increment", "error")


def _args(H, W, seed, L=300.0):
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=seed)
    return (xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(), lat.ravel(), lon.ravel(), L)


def _tight(seed=5, so_value=0.5 / 300.0 * 0.8, mixed=False, y_range=(0.9, 1.2)):
    """tests/test_oi_full.py's 16 x 32 production-conditioning domain (sb/so
    ~ 300 by default), and its float64 truth (increment, posterior
    variance)."""
    H, W = 16, 32
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(*y_range, (H, W))).ravel()
    sb = 0.5 * xa
    so = sb * 10.0 ** rng.uniform(-3, 2, H * W) if mixed else np.full(H * W, so_value)
    u3 = M._sphere_points(lat.ravel(), lon.ravel())
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    A = B + np.diag(so ** 2)
    inc_t = B @ np.linalg.solve(A, y - xa)
    sbd_t = sb ** 2 - np.einsum("ij,ji->i", B, np.linalg.solve(A, B))
    return (xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0), inc_t, sbd_t


def _jax_sketch(n, k):
    return torch.as_tensor(np.array(jax.random.normal(jax.random.key(0), (n, k),
                                                        jnp.float32)))


def _close(got, want, tol, name="", scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    scale = np.nanmax(np.abs(want)) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, equal_nan=True,
                               err_msg=name)


# ---- 1: the sweep ---------------------------------------------------------

def test_unit_vectors_match_jax():
    rng = np.random.default_rng(0)
    lat, lon = rng.uniform(-89, 89, 500), rng.uniform(-180, 180, 500)
    got = M._unit_vectors(lat, lon, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(J._unit_vectors(lat, lon)), rtol=0, atol=2e-7)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("block", [128, 512])
def test_b_matmat_matches_jax(dtype, tol, block):
    rng = np.random.default_rng(1)
    n, k = 512, 5
    u3 = M._sphere_points(rng.uniform(20, 60, n), rng.uniform(-30, 20, n)).astype(dtype)
    sb = np.abs(rng.normal(1.0, 0.3, n)).astype(dtype)
    sb[::17] = 0.0  # padding-like rows
    v = rng.standard_normal((n, k)).astype(dtype)
    got = M._b_matmat(*(torch.as_tensor(a) for a in (u3, sb, v)), 300.0, block).numpy()
    want = np.asarray(J._b_matmat(jnp.asarray(u3), jnp.asarray(sb), jnp.asarray(v), 300.0,
                                  block))
    assert got.dtype == dtype
    _close(got, want, tol)
    if dtype == np.float64:  # and the dense float64 product
        kappa = (6371.0 / 300.0) ** 2
        d2 = ((u3[:, None, :] - u3[None, :, :]) ** 2).sum(-1)
        B = sb[:, None] * np.exp(-0.5 * kappa * d2) * sb[None, :]
        _close(got, B @ v, tol)


def test_b_matmat_refuses_a_ragged_block():
    with pytest.raises(ValueError, match="multiple"):
        M._b_matmat(torch.zeros(10, 3), torch.ones(10), torch.ones(10, 1), 300.0, 4)


# ---- 2: CG -----------------------------------------------------------------

def test_cg_solve_multi_matches_jax():
    xa, y, sb, so, lat, lon, L = _args(16, 16, 5)
    u3 = np.array(J._unit_vectors(lat, lon))
    rng = np.random.default_rng(2)
    rhs = np.column_stack([y - xa, rng.standard_normal((256, 3)), np.zeros(256)])
    rhs = rhs.astype(np.float32)
    sb32, so2 = sb.astype(np.float32), (so.astype(np.float32)) ** 2
    got_x, got_k, got_r = M._cg_solve_multi(*(torch.as_tensor(a) for a in (u3, sb32, so2, rhs)),
                                            L, 256, 1e-7, 400)
    want_x, want_k, want_r = J._cg_solve_multi(*(jnp.asarray(a) for a in (u3, sb32, so2, rhs)),
                                               L, 256, 1e-7, 400)
    assert got_r < 1e-6 and float(want_r) < 1e-6
    assert abs(got_k - int(want_k)) <= 5
    _close(got_x.numpy(), np.asarray(want_x), 1e-4)
    assert not got_x[:, -1].any()  # a zero column starts converged and stays 0


def test_cg_loop_freezes_a_stalled_column():
    """A column whose residual cannot fall (an operator that is 0 on it)
    freezes after the stall window; the loop ends before maxiter."""
    rhs = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    x, k, resid = M._cg_loop(lambda p: p * torch.tensor([[1.0, 0.0], [1.0, 0.0]]),
                             lambda r: r, rhs, 1e-7, 400, stall=5)
    assert k < 400 and resid > 0.5
    torch.testing.assert_close(x[:, 0], torch.tensor([1.0, 1.0]))


# ---- 3: colouring ------------------------------------------------------------

@pytest.mark.parametrize("where", ["regional", "polar"])
def test_distance_coloring_equals_jax(where):
    rng = np.random.default_rng(17)
    if where == "regional":
        lat, lon = rng.uniform(30, 50, 500), rng.uniform(-30, 10, 500)
        sep, radius, prefer = 500.0, 10.0, None
    else:
        lon2, lat2 = np.meshgrid(np.arange(-179.0, 180.0, 2.0), np.arange(76.5, 90.0, 1.0))
        lat, lon = lat2.ravel(), lon2.ravel()
        sep, radius = 1200.0, 75.0
        prefer = rng.random(lat.size) > 0.1
    rep, colors = M._distance_coloring(lat, lon, sep, radius, prefer=prefer)
    jrep, jcolors = J._distance_coloring(lat, lon, sep, radius, prefer=prefer)
    np.testing.assert_array_equal(rep, jrep)
    np.testing.assert_array_equal(colors, jcolors)
    np.testing.assert_array_equal(M._cluster_reps(M._sphere_points(lat, lon), radius, prefer),
                                  J._cluster_reps(J._sphere_points(lat, lon), radius, prefer))
    again = M._distance_coloring_cached(lat, lon, sep, radius, prefer=prefer)
    assert M._distance_coloring_cached(lat, lon, sep, radius, prefer=prefer) is again
    np.testing.assert_array_equal(again[1], jcolors)


# ---- 4: the Jacobi branch -------------------------------------------------------

def test_matfree_jacobi_matches_dense_and_jax():
    args = _args(16, 16, 5)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = J.oi_full_dense(*(f(a) for a in args[:6]), length_scale_km=300.0)
    kw = dict(block=256, cg_tol=1e-7, probe_sep_factor=6.0)
    got = M.oi_full_matfree(*args, device="cpu", **kw)
    want = J.oi_full_matfree(*args, **kw)
    info = got[4]
    assert info["cg_resid"] < 1e-6 and info["precond"] == "jacobi"
    for key in ("ncolors", "nchunks", "nreps", "precond", "solver", "exact_diag",
                "refine_passes", "f64_resid", "resid_abs"):
        assert info[key] == want[4][key], key
    dense = [np.asarray(r, np.float64) for r in ref]
    np.testing.assert_allclose(got[0], dense[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2], dense[2], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[1], dense[1], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[3], dense[3], rtol=0, atol=2e-3)
    for name, g, w in zip(FIELDS, got[:4], want[:4]):
        _close(g, w, 1e-4, name)


def test_matfree_jacobi_in_chunks_of_colors_matches_jax():
    """More colours than ``max_colors``: the probes run in several CG
    chunks (the first one carrying the innovation)."""
    args = _args(12, 16, 3)
    kw = dict(block=192, cg_tol=1e-7, max_colors=40)
    got = M.oi_full_matfree(*args, device="cpu", **kw)
    want = J.oi_full_matfree(*args, **kw)
    assert got[4]["nchunks"] == want[4]["nchunks"] > 1
    for name, g, w in zip(FIELDS, got[:4], want[:4]):
        _close(g, w, 1e-4, name)


def test_matfree_polar_crowding_no_negative_variance():
    """tests/test_oi_full.py's polar case at its bounds, on a narrower band
    (8 rows x 3 degrees, 960 cells: the CPU test's time)."""
    lon, lat = np.meshgrid(np.arange(-179.0, 180.0, 3.0), np.arange(82.5, 90.0, 1.0))
    rng = np.random.default_rng(23)
    shape = lat.shape
    xa = np.abs(rng.normal(3, 1, shape))
    y = xa * rng.uniform(0.8, 1.3, shape)
    sigb = np.abs(rng.normal(1.0, 0.2, shape))
    sigo = np.abs(rng.normal(0.6, 0.1, shape))
    xb, ak, inc, err, info = M.oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(), lat.ravel(), lon.ravel(), 300.0,
        block=512, cg_maxiter=300, device="cpu")
    assert info["nreps"] < lat.size
    assert np.isfinite(xb).all()
    assert (ak > -0.05).all() and (ak < 1.05).all()
    assert (err >= 0).all()
    tight = (sigo < 0.5 * sigb).ravel()
    assert (err[tight] < sigb.ravel()[tight]).mean() > 0.9


# ---- 5: Nystrom ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 3])
def test_nystrom_pcg_with_the_jax_sketch_matches_jax(seed):
    args = _args(8, 16, seed)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0)
    got = M.oi_full_matfree(*args, device="cpu", omega=_jax_sketch(128, 128), **kw)
    want = J.oi_full_matfree(*args, **kw)
    assert got[4]["precond"] == want[4]["precond"] == "nystrom(k=128)"
    assert not got[4]["exact_diag"]
    for name, g, w in zip(FIELDS, got[:4], want[:4]):
        _close(g, w, 1e-4, name)
    # each solve's own float32 floor, sampled against the float64 operator
    assert 0.5 < got[4]["f64_resid"] / want[4]["f64_resid"] < 2.0


def test_nystrom_factor_reconstructs_the_jax_prior():
    """U diag(lam) U^T from the same sketch: the factor itself up to the
    eigenvectors' signs."""
    xa, y, sb, so, lat, lon, L = _args(8, 16, 7)
    u3 = np.array(J._unit_vectors(lat, lon))
    om = _jax_sketch(128, 128)
    u, lam = M._nystrom_factor(torch.as_tensor(u3), torch.as_tensor(sb.astype(np.float32)),
                               om, L, 128)
    ju, jlam = J._nystrom_factor(jnp.asarray(u3), jnp.asarray(sb.astype(np.float32)),
                                 jax.random.key(0), 128, L, 128)
    _close(lam.numpy(), np.asarray(jlam), 1e-4, "lam")
    bh = (u * lam[None]) @ u.T
    jb = (np.asarray(ju) * np.asarray(jlam)[None]) @ np.asarray(ju).T
    _close(bh.numpy(), jb, 1e-4, "U lam U^T")


def test_nystrom_default_sketch_is_seeded_and_reproducible():
    args = _args(8, 16, 7)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0, device="cpu")
    a = M.oi_full_matfree(*args, **kw)
    b = M.oi_full_matfree(*args, **kw)
    for x, z in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, z)
    want = J.oi_full_matfree(*args, **{k: v for k, v in kw.items() if k != "device"})
    for name, g, w in zip(FIELDS, a[:4], want[:4]):
        _close(g, w, 1e-3, name)  # another sketch, the same deflated solve


def test_nystrom_tight_obs_at_the_jax_bounds():
    """tests/test_oi_full.py's production regime: the exact branch by
    default, and the PCG + Woodbury estimates with refinement pinned off."""
    args, inc_t, sbd_t = _tight(so_value=0.0027, y_range=(0.1, 0.2))  # sb/so ~ 150
    sb = args[2]
    ak_t = 1.0 - sbd_t / sb ** 2
    kw = dict(block=512, precond="nystrom", nystrom_k=256, device="cpu")
    xb, ak, inc, err, info = M.oi_full_matfree(*args, **kw)
    assert info["precond"] == "direct" and info["exact_diag"] and info["cg_resid"] < 1e-3
    assert np.sqrt(np.mean((inc - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2)) < 0.05
    np.testing.assert_allclose(ak, ak_t, atol=2e-4)
    np.testing.assert_allclose(err, np.sqrt(np.maximum(sbd_t, 0)), rtol=1e-6, atol=1e-10)
    _, ak2, _, err2, info2 = M.oi_full_matfree(*args, refine=0, omega=_jax_sketch(512, 256),
                                               **kw)
    assert info2["precond"].startswith("nystrom") and not info2["exact_diag"]
    np.testing.assert_allclose(ak2, ak_t, atol=2e-4)
    assert (err2 >= 0).all() and (err2 <= sb * (1 + 1e-6)).all()
    assert np.median(err2) < 5 * np.median(np.sqrt(np.maximum(sbd_t, 0)))


def test_nystrom_cholesky_fallback(monkeypatch):
    """The Woodbury inner Cholesky failing: the eigen-clip form gives the
    same diagonal (tests/test_oi_full.py's bounds)."""
    import scipy.linalg

    args = _args(8, 16, 7)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0, device="cpu",
              omega=_jax_sketch(128, 128))
    _, ak_ref, inc_ref, err_ref, _ = M.oi_full_matfree(*args, **kw)

    def boom(*a, **k):
        raise np.linalg.LinAlgError("forced indefinite for the test")

    monkeypatch.setattr(scipy.linalg, "cholesky", boom)
    _, ak_fb, inc_fb, err_fb, info = M.oi_full_matfree(*args, **kw)
    assert info["precond"] == "nystrom(k=128)"
    np.testing.assert_allclose(ak_fb, ak_ref, atol=1e-5)
    np.testing.assert_allclose(err_fb, err_ref, atol=1e-5)
    np.testing.assert_allclose(inc_fb, inc_ref, rtol=0, atol=1e-6)


def test_nystrom_auto_threshold_matches_jax():
    args = _args(8, 16, 3)
    for kw in (dict(block=128), dict(block=128, precond="nystrom", nystrom_k=100, refine=0)):
        got = M.oi_full_matfree(*args, device="cpu", **kw)[4]["precond"]
        assert got == J.oi_full_matfree(*args, **kw)[4]["precond"]
    assert got == "nystrom(k=128)"  # the rank rounds up to 128, as in the twin


# ---- 6: SLQ ------------------------------------------------------------------------

@pytest.mark.parametrize("block", [192, 256])
def test_slq_curve_matches_jax_and_the_dense_scan(block):
    xa, y, sb, so, lat, lon, L = _args(16, 16, 5)
    grid = T.regularization_grid()
    kw = dict(block=block, n_probes=64, m=40, seed=1)
    got = T.mean_ak_curve_slq((lat, lon), sb, so, grid, L, device="cpu", **kw)
    want = J.mean_ak_curve_slq((lat, lon), sb, so, grid, L, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert kneedle_index_np(grid, got) == kneedle_index_np(grid, want)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    *_, reg_index, curve = J.oi_full_dense_scan(*(f(a) for a in (xa, y, sb, so, lat, lon)), L,
                                                grid.astype(np.float32))
    np.testing.assert_allclose(got, np.asarray(curve, np.float64), rtol=0.04)
    assert kneedle_index_np(grid, got) == int(reg_index)


def test_slq_valid_mask_and_unit_vector_input_match_jax():
    xa, y, sb, so, lat, lon, L = _args(10, 12, 4)
    valid = np.random.default_rng(0).random(sb.size) > 0.1
    grid = T.regularization_grid()
    u3 = np.array(J._unit_vectors(lat, lon))
    got = T.mean_ak_curve_slq(torch.as_tensor(u3), sb, so, grid, L, block=128, valid=valid)
    want = J.mean_ak_curve_slq(jnp.asarray(u3), sb, so, grid, L, block=128, valid=valid)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# ---- 7: the exact branch inside the matrix-free path ---------------------------------

def test_direct_branch_matches_jax_and_the_float64_truth():
    args, inc_t, sbd_t = _tight()
    kw = dict(block=128, precond="nystrom", nystrom_k=256)
    got = M.oi_full_matfree(*args, device="cpu", **kw)
    want = J.oi_full_matfree(*args, **kw)
    assert got[4]["solver"] == want[4]["solver"] == "direct_f64_dev"
    assert got[4]["exact_diag"] and got[4]["precond"] == "direct"
    assert got[4]["f64_resid"] == got[4]["cg_resid"] < 1e-7
    xb_scale = np.max(np.abs(want[0]))
    for name, g, w in zip(FIELDS, got[:4], want[:4]):
        _close(g, w, 1e-9, name, scale=xb_scale if name == "increment" else None)
    assert np.sqrt(np.mean((got[2] - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2)) < 1e-6


@pytest.mark.parametrize("device_exact", [True, False])
def test_exact_diag_mixed_noise_regimes(device_exact, monkeypatch):
    """Tight and loose cells in one month, on both exact paths (the device
    tail and the OISAT_EXACT_DEVICE=0 host solve) against the float64 truth
    and the JAX package."""
    monkeypatch.setenv("OISAT_EXACT_DEVICE", "1" if device_exact else "0")
    args, _, sbd_t = _tight(seed=13, mixed=True)
    sb = args[2]
    kw = dict(block=128, precond="nystrom", nystrom_k=256)
    got = M.oi_full_matfree(*args, device="cpu", **kw)
    want = J.oi_full_matfree(*args, **kw)
    assert got[4]["exact_diag"]
    assert got[4]["solver"] == want[4]["solver"] == ("direct_f64_dev" if device_exact
                                                     else "direct_f64")
    np.testing.assert_allclose(got[3], np.sqrt(np.maximum(sbd_t, 0.0)), rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(got[1], 1.0 - sbd_t / sb ** 2, rtol=1e-6, atol=1e-8)
    for name, g, w in zip(FIELDS, got[:4], want[:4]):
        _close(g, w, 1e-9, name, scale=np.max(np.abs(want[0])) if name == "increment" else None)


def test_a_failed_tail_raises_inside_the_matrix_free_path(monkeypatch):
    """Where the JAX package re-solves a tail that fails its gate on the
    host, the port raises."""
    args, _, _ = _tight()

    def garbage(u3, sb, so2, d, kappa, diag_block=T.EXACT_DIAG_BLOCK):
        return torch.ones_like(d), torch.ones_like(d), torch.ones_like(d)

    monkeypatch.setattr(T, "_exact_tail", garbage)
    with pytest.raises(FloatingPointError, match="gate"):
        M.oi_full_matfree(*args, block=128, precond="nystrom", nystrom_k=256, device="cpu")


def test_refinement_passes_match_jax():
    """refine=2: the true float64 residual within 10x of the JAX package's
    and below the unrefined solve's; refine=0 reports its true residual."""
    args, inc_t, _ = _tight()
    kw = dict(block=128, precond="nystrom", nystrom_k=256)
    om = _jax_sketch(512, 256)
    r0 = M.oi_full_matfree(*args, refine=0, omega=om, device="cpu", **kw)[4]
    got = M.oi_full_matfree(*args, refine=np.int64(2), omega=om, device="cpu", **kw)
    want = J.oi_full_matfree(*args, refine=2, **kw)[4]
    info = got[4]
    assert r0["refine_passes"] == 0 and r0["f64_resid"] > 1e-3
    assert info["refine_passes"] == want["refine_passes"] == 2
    assert info["solver"] == want["solver"] == "pcg_f32+ir"
    assert info["f64_resid"] == info["cg_resid"] < r0["f64_resid"]
    assert want["f64_resid"] / 10 < info["f64_resid"] < want["f64_resid"] * 10
    rms = np.sqrt(np.mean((got[2] - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2))
    assert rms < 5e-2
    with pytest.raises(TypeError):
        M.oi_full_matfree(*args, refine=1.5, device="cpu", **kw)


def test_refine_helpers_match_jax():
    args, _, _ = _tight()
    xa, y, sb, so, lat, lon, _ = args
    u3 = M._sphere_points(lat, lon)
    kappa = (6371.0 / 300.0) ** 2
    x = np.random.default_rng(0).standard_normal(sb.size)
    got = M._make_apply_a_f64(u3, sb, so ** 2, kappa)(x)
    want = J._make_apply_a_f64(u3, sb, so ** 2, kappa)(x)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


# ---- 8: the grid front end's large branch -------------------------------------------

def _both_large(monkeypatch, reg_on, limit=64):
    for mod in (J, T):
        monkeypatch.setattr(mod, "DENSE_MAX_CELLS", limit)
        monkeypatch.setattr(mod, "DENSE_SCAN_MAX_CELLS", limit)


def test_oi_full_auto_switches_to_matfree(monkeypatch):
    """tests/test_oi_full.py's front-end case: the large branch with the
    NaN cells compacted out and scattered back, at its bounds against the
    dense result, and against the JAX large branch."""
    xa, y, sigb, sigo, lat, lon = _random_domain(20, 26, seed=9)
    xa[3, 4] = np.nan
    y[10, 20] = np.nan
    args = (xa, y, sigb, sigo, lat, lon, 250.0)
    ref = T.oi_full(*args, device="cpu")
    assert ref.info is None
    _both_large(monkeypatch, False)
    got = T.oi_full(*args, device="cpu")
    want = J.oi_full(*args)
    m = np.isfinite(ref.xb)
    np.testing.assert_array_equal(m, np.isfinite(got.xb))
    np.testing.assert_allclose(got.xb[m], ref.xb[m], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.error[m], ref.error[m], rtol=0, atol=3e-3)
    assert np.isnan(got.xb[3, 4]) and np.isnan(got.xb[10, 20])
    for name in GRID_FIELDS:
        _close(getattr(got, name), getattr(want, name), 1e-4, name)
    assert set(got.info) == set(want.info)
    assert got.info["precond"] == want.info["precond"] == "jacobi"
    np.testing.assert_allclose(got.info["stat_norm"], want.info["stat_norm"], rtol=1e-4)


def test_oi_full_matfree_with_regularization(monkeypatch):
    """The large branch with the SLQ knee: the same factor as the JAX
    package, and tests/test_oi_full.py's bounds against the dense scan."""
    xa, y, sigb, sigo, lat, lon = _random_domain(16, 16, seed=13)
    args = (xa, y, sigb, sigo, lat, lon, 250.0)
    ref = T.oi_full(*args, regularization_on=True, device="cpu")
    _both_large(monkeypatch, True)
    stage_ms = {}
    got = T.oi_full(*args, regularization_on=True, device="cpu", stage_ms=stage_ms)
    want = J.oi_full(*args, regularization_on=True)
    m = np.isfinite(ref.xb)
    np.testing.assert_allclose(got.xb[m], ref.xb[m], rtol=5e-2, atol=1e-2)
    np.testing.assert_allclose(got.error[m], ref.error[m], rtol=0, atol=3e-2)
    for name in GRID_FIELDS:
        _close(getattr(got, name), getattr(want, name), 1e-4, name)
    assert set(stage_ms) == {f"oi_full.{s}" for s in
                             ("compact", "slq", "coloring", "pcg", "probe", "scatter")}


@pytest.mark.parametrize("reg_on", [False, True])
def test_the_same_branch_at_every_n(monkeypatch, reg_on):
    """Both packages route each n alike around the dense limit: spies on
    each package's large branch count the same calls."""
    calls = {"jax": [], "port": []}
    real_j, real_t = J._oi_full_large, T._oi_full_large
    monkeypatch.setattr(J, "_oi_full_large",
                        lambda *a, **k: calls["jax"].append(a[6].size) or real_j(*a, **k))
    monkeypatch.setattr(T, "_oi_full_large",
                        lambda *a, **k: calls["port"].append(a[0].idx.size) or real_t(*a, **k))
    _both_large(monkeypatch, reg_on, limit=96)
    for w in (8, 12, 13):  # 64, 96 and 104 cells
        args = _args(8, w, 3, L=250.0)
        grid = [a.reshape(8, w) for a in args[:6]]
        T.oi_full(*grid, 250.0, regularization_on=reg_on, device="cpu")
        J.oi_full(*grid, 250.0, regularization_on=reg_on)
    assert calls["port"] == calls["jax"] == [104]


def test_matfree_info_scaled_to_physical_units(monkeypatch):
    """tests/test_oi_full.py's stub case: resid_abs and stat_norm leave the
    large branch in the fields' physical units, cg_resid as it is, None
    passes through."""
    xa, y, sigb, sigo, lat, lon = _random_domain(8, 16, seed=9)
    scale = 1e15
    captured = {}

    def fake_large(cp, L, reg_on, dev, clock=None, **kw):
        captured["max"] = max(float(np.max(np.abs(v))) for v in (cp.xa, cp.y, cp.sb, cp.so))
        ones = np.ones(cp.idx.size)
        return ones, ones, ones, ones, {"cg_resid": 1e-5, "resid_abs": 2.0, "stat_norm": 3.0,
                                        "f64_resid": None}

    monkeypatch.setattr(T, "_oi_full_large", fake_large)
    monkeypatch.setattr(T, "DENSE_MAX_CELLS", 4)
    res = T.oi_full(xa * scale, y * scale, sigb * scale, sigo * scale, lat, lon, 300.0,
                    device="cpu")
    assert captured["max"] <= 1.0 + 1e-12
    assert res.info["cg_resid"] == 1e-5
    assert res.info["resid_abs"] / 2.0 == res.info["stat_norm"] / 3.0 >= scale
    assert res.info["f64_resid"] is None


def test_large_branch_with_the_nystrom_tail_and_its_warning(monkeypatch, capsys):
    """The production path of a large month at a small size: the SLQ knee,
    then (npad >= NYSTROM_MIN_CELLS) the exact float64 solve; forced onto
    the Nystrom PCG (REFINE_MAX_CELLS lowered) it converges only roughly and
    prints the JAX WARNING text, with resid_abs / stat_norm in physical
    units."""
    for mod in (M, J):
        monkeypatch.setattr(mod, "NYSTROM_MIN_CELLS", 256)
    _both_large(monkeypatch, True)
    args, _, _ = _tight()
    xa, y, sb, so, lat, lon, L = args
    scale = 1e16
    grid = [a.reshape(16, 32) for a in (xa * scale, y * scale, sb * scale, so * scale, lat, lon)]
    got = T.oi_full(*grid, L, regularization_on=True, device="cpu")
    assert got.info["solver"] == "direct_f64_dev" and got.info["exact_diag"]
    assert got.info["resid_abs"] < 1e-6 * got.info["stat_norm"]
    assert "WARNING" not in capsys.readouterr().out
    for mod in (M, J):
        monkeypatch.setattr(mod, "REFINE_MAX_CELLS", 256)
    got = T.oi_full(*grid, L, regularization_on=True, device="cpu")
    said = capsys.readouterr().out
    assert got.info["precond"] == "nystrom(k=256)" and not got.info["exact_diag"]
    assert said.startswith("WARNING: oi_full matrix-free CG did not fully converge")
    assert got.info["stat_norm"] > scale * 1e-3 and got.info["resid_abs"] > scale * 1e-3
    assert np.isfinite(got.xb).all() and (got.error >= 0).all()


# ---- 9: the host LAPACK opt-out --------------------------------------------------------

def test_host_solve_pieces_match_jax():
    args, _, _ = _tight(seed=13, mixed=True)
    xa, y, sb, so, lat, lon, _ = args
    u3 = M._sphere_points(lat, lon)
    kappa = (6371.0 / 300.0) ** 2
    got = T._direct_solve_f64(u3, sb, so ** 2, y - xa, kappa, want_diag=True)
    want = J._direct_solve_f64(u3, sb, so ** 2, y - xa, kappa, want_diag=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    assert T._direct_solve_f64(u3, sb, so ** 2, y - xa, kappa)[1] is None


def test_diag_pack_failure_is_a_pair(monkeypatch):
    """The twin returns a bare None when dtrtri fails; the port a pair, and
    the direct solve then no pack."""
    from scipy.linalg import lapack

    monkeypatch.setattr(lapack, "dtrtri", lambda a, **k: (a, 1))
    assert T._diag_pack_from_factor(np.eye(3), np.ones(3)) == (None, None)
    u3 = M._sphere_points(np.array([40.0, 41.0]), np.array([0.0, 1.0]))
    x, pack = T._direct_solve_f64(u3, np.ones(2), np.ones(2), np.ones(2), 450.0,
                                  want_diag=True)
    assert x is not None and pack is None


@pytest.mark.parametrize("reg_on", [False, True])
def test_host_opt_out_on_the_dense_front_end_matches_jax(monkeypatch, reg_on):
    from tests.test_torch_oi_full import _domain

    monkeypatch.setenv("OISAT_EXACT_DEVICE", "0")
    args = _domain(12, 16, so=0.02)
    got = T.oi_full(*args, 300.0, regularization_on=reg_on, device="cpu")
    want = J.oi_full(*args, 300.0, regularization_on=reg_on)
    assert got.info["solver"] == want.info["solver"] == "dense+direct_f64"
    assert got.info["exact_diag"] and got.info["reg"] == want.info["reg"]
    for name in GRID_FIELDS:
        _close(getattr(got, name), getattr(want, name), 1e-7, name)
