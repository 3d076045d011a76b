"""The port's full-covariance OI (oisat_tpu_torch.ops.oi_full) against the
JAX package's oisat_tpu.ops.oi_full on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: the Pallas covariance kernel in
interpret mode and the exact tail in float64 on JAX's CPU backend (x64 on).
Tolerances (field values; ``atol`` is the same fraction of the field's
largest magnitude, since increments cross zero):

* dense solve, mild conditioning: rtol 1e-4 (two float32 Cholesky
  factorisations);
* dense scan: the knee index identical, fields within 5e-4 (two float32
  eigensolvers order near-degenerate pairs differently);
* exact float64 tail: increments, error and AK within 1e-7 (two float64
  solves of a system with cond(A) up to ~1e9), and within the JAX test's
  own bounds of the NumPy float64 truth (rms 1e-6, rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu.ops import oi_full as J
from oisat_tpu.ops.knee import kneedle_index as jax_kneedle_index
from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.ops.knee import kneedle_index_np

torch.set_num_threads(1)

FIELDS = ("xb", "averaging_kernel", "increment", "error")
REGS = T.regularization_grid().astype(np.float32)


def _domain(H=8, W=16, seed=3, so=None):
    """xa, y, sigma_b, sigma_o, lat, lon on a regional 0.5-1.4 deg grid;
    ``so`` a constant observation error (default: drawn, mild)."""
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 41, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.7, 1.4, (H, W))
    sb = 0.5 * xa
    sigo = np.abs(rng.normal(0.8, 0.2, (H, W))) if so is None else np.full((H, W), so)
    return xa, y, sb, sigo, lat, lon


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    atol = tol * np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, equal_nan=True, err_msg=name)


def _pair(args, reg_on, L=300.0):
    port = T.oi_full(*args, L, regularization_on=reg_on, device="cpu")
    ref = J.oi_full(*args, L, regularization_on=reg_on)
    return port, ref


def _vectors(args):
    """The compacted, normalised float32 vectors both scans take."""
    cp = T.compact(*args)
    return cp, [v.astype(np.float32) for v in (cp.xa, cp.y, cp.sb, cp.so, cp.lat, cp.lon)]


def test_dense_without_scan_matches_jax():
    port, ref = _pair(_domain(12, 16), False)
    assert port.info is None and ref.info is None
    for name in FIELDS:
        _close(getattr(port, name), getattr(ref, name), 1e-4, name)


@pytest.mark.parametrize("seed", [3, 8])
def test_dense_scan_matches_jax(seed):
    args = _domain(12, 16, seed=seed)
    port, ref = _pair(args, True)
    assert port.info is None and ref.info is None
    for name in FIELDS:
        _close(getattr(port, name), getattr(ref, name), 5e-4, name)
    # the knee, from the two scans on the same 128 cells
    _, vec = _vectors(_domain(8, 16, seed=seed))
    p = T.oi_full_dense_scan(*(torch.as_tensor(v) for v in vec), 300.0, REGS)
    j = J.oi_full_dense_scan(*(jnp.asarray(v) for v in vec), 300.0, REGS)
    assert p[4] == int(j[4])
    _close(p[5].numpy(), j[5], 1e-5, "curve")
    for name, g, w in zip(FIELDS, p[:4], j[:4]):
        _close(g.numpy(), w, 5e-4, name)


@pytest.mark.parametrize("so", [0.02, 0.05, 0.2, 0.8])
def test_host_knee_equals_jax_device_knee_on_scan_curves(so):
    """The port picks the knee with kneedle_index_np on the host from the
    99-float curve; the JAX scan calls the device kneedle_index.  On the
    scan's own curves (weak to tight conditioning) the two agree."""
    _, vec = _vectors(_domain(8, 16, seed=3, so=so))
    p = T.oi_full_dense_scan(*(torch.as_tensor(v) for v in vec), 300.0, REGS)
    j = J.oi_full_dense_scan(*(jnp.asarray(v) for v in vec), 300.0, REGS)
    for curve in (np.asarray(j[5]), p[5].numpy()):
        want = int(jax_kneedle_index(jnp.asarray(REGS), jnp.asarray(curve), fallback=0))
        assert kneedle_index_np(REGS.astype(np.float64), curve.astype(np.float64)) == want
    assert p[4] == int(j[4])


@pytest.mark.parametrize("reg_on", [False, True])
def test_exact_tail_matches_jax(reg_on):
    """Tight conditioning ((sb/so)^2 ~ 1e4, with a clear knee): both sides
    re-solve in float64 on their device ("dense+direct_f64_dev")."""
    port, ref = _pair(_domain(12, 16, so=0.02), reg_on)
    assert port.info["solver"] == ref.info["solver"] == "dense+direct_f64_dev"
    assert port.info["reg"] == ref.info["reg"]
    assert port.info["exact_diag"] and ref.info["exact_diag"]
    assert port.info["f64_resid"] <= T.DEVICE_EXACT_RESID_GATE
    for name in FIELDS:
        _close(getattr(port, name), getattr(ref, name), 1e-7, name)


@pytest.mark.parametrize("reg_on", [False, True])
def test_stage_times_cover_every_stage_and_leave_the_result_unchanged(reg_on):
    """``stage_ms`` names each stage of the call once (the tail included)
    and changes no output."""
    args = _domain(12, 16, so=0.02)
    stage_ms = {}
    timed = T.oi_full(*args, 300.0, regularization_on=reg_on, device="cpu",
                      stage_ms=stage_ms)
    untimed = T.oi_full(*args, 300.0, regularization_on=reg_on, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(timed, name), getattr(untimed, name))
    assert timed.info == untimed.info
    solve = ("eigh", "scan_gemms", "knee", "update") if reg_on else ("dense_solve",)
    stages = ("compact", "covariance", *solve, "pull", "tail", "tail_resid", "scatter")
    assert set(stage_ms) == {f"oi_full.{s}" for s in stages}
    assert all(v >= 0.0 for v in stage_ms.values())


def test_exact_tail_matches_numpy_truth():
    """tests/test_oi_full.py's dense-path check at sb/so ~ 300 against the
    float64 NumPy solve, at its bounds."""
    H, W = 8, 16
    rng = np.random.default_rng(5)
    lon2, lat2 = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W)))
    y = xa * rng.uniform(0.9, 1.2, (H, W))
    sb = 0.5 * xa
    so = np.full((H, W), 0.5 / 300.0 * 0.8)
    u3 = T._sphere_points(lat2.ravel(), lon2.ravel())
    kappa = (6371.0 / 300.0) ** 2
    B = sb.ravel()[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb.ravel()[None, :]
    A = B + np.diag(so.ravel() ** 2)
    inc_t = B @ np.linalg.solve(A, (y - xa).ravel())
    Sb_t = np.einsum("ij,ji->i", B, np.linalg.solve(A, B))

    res = T.oi_full(xa, y, sb, so, lat2, lon2, 300.0, regularization_on=False, device="cpu")
    assert res.info["solver"] == "dense+direct_f64_dev" and res.info["exact_diag"]
    rms = np.sqrt(np.mean((res.increment.ravel() - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2))
    assert rms < 1e-6
    err_t = np.sqrt(np.maximum(sb.ravel() ** 2 - Sb_t, 0.0))
    np.testing.assert_allclose(res.error.ravel(), err_t, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(res.averaging_kernel.ravel(),
                               1.0 - (sb.ravel() ** 2 - Sb_t) / sb.ravel() ** 2,
                               rtol=1e-6, atol=1e-8)
    # mild conditioning keeps the float32 dense path
    assert T.oi_full(xa, y, sb, np.full((H, W), 0.4), lat2, lon2, 300.0,
                     device="cpu").info is None


@pytest.mark.parametrize("n,block", [(700, 256), (700, 700), (513, 512)])
def test_exact_tail_blocks_with_a_ragged_last_block(n, block):
    """The trailing-sub-triangle loop at n > diag_block with a ragged last
    block (no n % diag_block requirement) against NumPy float64, at the JAX
    multiblock test's bounds (tests/test_oi_full.py:780)."""
    rng = np.random.default_rng(21)
    lat = rng.uniform(20, 60, n)
    lon = rng.uniform(-20, 10, n)
    u3 = T._sphere_points(lat, lon)
    sb = np.abs(rng.normal(0.4, 0.05, n))
    so2 = (sb * 10.0 ** rng.uniform(-2, 2, n)) ** 2  # mixed regimes
    d = rng.normal(0, 0.1, n)
    kappa = (6371.0 / 300.0) ** 2
    x, dainv, q = (v.numpy() for v in T._exact_tail(
        *(torch.as_tensor(a) for a in (u3, sb, so2, d)), kappa, diag_block=block))
    B = sb[:, None] * np.exp(np.maximum(kappa * (np.clip(u3 @ u3.T, -1, 1) - 1.0),
                                        -60.0)) * sb[None, :]
    A = B + np.diag(so2)
    np.testing.assert_allclose(x, np.linalg.solve(A, d), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(dainv, np.diag(np.linalg.inv(A)), rtol=1e-6)
    np.testing.assert_allclose(q, np.einsum("ij,ji->i", B, np.linalg.solve(A, B)),
                               rtol=1e-6, atol=1e-12)


def test_exact_tail_matches_jax_tail_prog():
    """_exact_tail against the JAX _exact_tail_prog on the same float64
    inputs (one 256-column block each side)."""
    n = 256
    rng = np.random.default_rng(2)
    u3 = T._sphere_points(rng.uniform(30, 45, n), rng.uniform(-10, 10, n))
    sb = np.abs(rng.normal(0.5, 0.1, n))
    so2 = (sb * 10.0 ** rng.uniform(-2, 1, n)) ** 2
    d = rng.normal(0, 0.2, n)
    kappa = (6371.0 / 250.0) ** 2
    got = T._exact_tail(*(torch.as_tensor(a) for a in (u3, sb, so2, d)), kappa)
    with jax.enable_x64(True):
        want = J._exact_tail_prog(*(jnp.asarray(a) for a in (u3, sb, so2, d)),
                                  jnp.float64(kappa), diag_block=n)
    for name, g, w in zip(("x", "diag_ainv", "q"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, err_msg=name)


def test_exact_sb_diag_matches_jax():
    rng = np.random.default_rng(3)
    n = 512
    sb = np.abs(rng.normal(1.0, 0.2, n))
    so2 = (sb * 10.0 ** rng.uniform(-3, 3, n)) ** 2
    bd = sb ** 2
    pack = (1.0 / (bd + so2), bd * bd / (bd + so2))
    np.testing.assert_array_equal(T._exact_sb_diag(so2, pack, bd),
                                  J._exact_sb_diag(so2, pack, bd))


def test_physical_vcd_magnitudes_do_not_overflow():
    """~8e18 fields through the float32 scan (cf. tests/test_oi_full.py:336)."""
    rng = np.random.default_rng(0)
    H, W = 12, 16
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 41, H))
    xa = np.abs(rng.normal(8e18, 5e17, (H, W)))
    y = xa * rng.uniform(0.9, 1.1, (H, W))
    sigma_o = np.abs(rng.normal(5e16, 5e15, (H, W)))
    res = T.oi_full(xa, y, xa * 0.5, sigma_o, lat, lon, 200.0, regularization_on=True,
                    device="cpu")
    assert np.isfinite(res.xb).all() and np.isfinite(res.averaging_kernel).all()
    assert (res.error > 0).all() and (res.averaging_kernel > 0.1).all()
    s = 8e18
    unit = T.oi_full(xa / s, y / s, xa * 0.5 / s, sigma_o / s, lat, lon, 200.0,
                     regularization_on=True, device="cpu")
    np.testing.assert_allclose(res.xb, unit.xb * s, rtol=1e-4)
    np.testing.assert_allclose(res.averaging_kernel, unit.averaging_kernel, rtol=1e-4)


def test_degenerate_cells_are_masked_not_poisoning():
    """A zero observation error, a NaN latitude and an all-NaN field mark
    their cells only (cf. tests/test_oi_full.py:362)."""
    xa, y, sb, so, lat, lon = _domain(10, 12, seed=1)
    so[2, 3] = 0.0
    lat[5, 7] = np.nan
    xa[0, 0] = np.nan
    y[1, 1] = -2.0  # clamped to 0, still valid
    res = T.oi_full(xa, y, sb, so, lat, lon, 200.0, regularization_on=True, device="cpu")
    ref = J.oi_full(xa, y, sb, so, lat, lon, 200.0, regularization_on=True)
    bad = np.zeros(xa.shape, bool)
    bad[2, 3] = bad[5, 7] = bad[0, 0] = True
    for name in FIELDS:
        got = getattr(res, name)
        assert np.isnan(got[bad]).all() and np.isfinite(got[~bad]).all(), name
        _close(got, getattr(ref, name), 5e-4, name)
    empty = T.oi_full(np.full((3, 4), np.nan), y[:3, :4], sb[:3, :4], so[:3, :4],
                      lat[:3, :4], lon[:3, :4], 200.0, device="cpu")
    assert empty.info is None
    for name in FIELDS:
        assert np.isnan(getattr(empty, name)).all()


@pytest.mark.parametrize("reg_on,limit", [(True, "DENSE_SCAN_MAX_CELLS"),
                                          (False, "DENSE_MAX_CELLS")])
def test_above_the_dense_limit_raises(monkeypatch, reg_on, limit):
    monkeypatch.setattr(T, limit, 50)
    with pytest.raises(NotImplementedError, match="item 10"):
        T.oi_full(*_domain(8, 8), 300.0, regularization_on=reg_on, device="cpu")
    T.oi_full(*_domain(5, 10), 300.0, regularization_on=reg_on, device="cpu")


def test_host_opt_out_is_not_ported(monkeypatch):
    monkeypatch.setenv("OISAT_EXACT_DEVICE", "0")
    with pytest.raises(NotImplementedError, match="item 10"):
        T.oi_full(*_domain(so=0.02), 300.0, device="cpu")
    T.oi_full(*_domain(), 300.0, device="cpu")  # mild: no tail, no error


def test_a_failed_tail_raises_instead_of_falling_back(monkeypatch):
    n_calls = []

    def garbage(u3, sb, so2, d, kappa, diag_block=T.EXACT_DIAG_BLOCK):
        n_calls.append(1)
        return torch.ones_like(d), torch.ones_like(d), torch.ones_like(d)

    monkeypatch.setattr(T, "_exact_tail", garbage)
    with pytest.raises(FloatingPointError, match="gate"):
        T.oi_full(*_domain(so=0.02), 300.0, device="cpu")

    def nonfinite(u3, sb, so2, d, kappa, diag_block=T.EXACT_DIAG_BLOCK):
        return torch.full_like(d, np.nan), torch.ones_like(d), torch.ones_like(d)

    monkeypatch.setattr(T, "_exact_tail", nonfinite)
    with pytest.raises(FloatingPointError, match="non-finite"):
        T.oi_full(*_domain(so=0.02), 300.0, device="cpu")
    assert n_calls == [1]
