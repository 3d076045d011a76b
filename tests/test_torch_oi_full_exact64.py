"""The exact float64 branch of the port's full OI in one N x N buffer
(oisat_tpu_torch.ops.oi_full._oi_full_exact / _exact_system and the float64
curve oi_full_matfree.mean_ak_curve_slq_dense), on the CPU in float64.

* against the benchmark's plain reference (benchmark/reference_full_oi.py,
  float64, its SLQ curve with dense_max=0 so that both price the same
  probes): the same knee, and xb, increment, AK and error within 1e-9;
* the in-place blocked factor and both diagonals against torch.linalg's
  dense float64 results, to 1e-12;
* the float64 curve against the same SLQ run with an explicit C, to 1e-10;
* the branch limit: the CPU keeps the JAX package's limits and branch at
  every n, a CUDA card's limit comes from its total memory;
* no fallback: a failed or non-finite factor raises, and nothing keeps
  the buffer.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from scipy.linalg import eigh_tridiagonal

from benchmark import reference_full_oi as RF
from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.ops import oi_full_matfree as M
from oisat_tpu_torch.utils import profiling
from oisat_tpu_torch.utils.profiling import StageClock

torch.set_num_threads(1)

CPU = torch.device("cpu")
KAPPA = (6371.0 / 300.0) ** 2


def _month(n, seed, ratio=6.4):
    """A MOPITT-like month of n cells on a 1 deg grid patch: sigma_b = 10%
    of xa, sigma_b / sigma_o ~ ``ratio`` (the 1 deg month's median is 6.44),
    as (H, W) grids with NaN past the n-th cell."""
    rng = np.random.default_rng(seed)
    w = 60
    h = -(-n // w)
    lon, lat = np.meshgrid(np.arange(-30.0, 30.0, 1.0), 20.0 + np.arange(h, dtype=float))
    xa = np.abs(rng.normal(2.0, 0.4, h * w))
    y = xa * rng.uniform(0.8, 1.25, h * w)
    sb = 0.1 * xa
    so = sb / np.abs(rng.normal(ratio, 1.5, h * w)).clip(1.0)
    for f in (xa, y):
        f[n:] = np.nan
    return [f.reshape(h, w) for f in (xa, y, sb, so)] + [lat, lon]


def _exact(fields, regularization_on=True, stage_ms=None):
    cp = T.compact(*fields)
    clock = StageClock(stage_ms, CPU, prefix="oi_full.")
    return cp, T._oi_full_exact(cp, 300.0, regularization_on, CPU, clock)


def _system(n, seed, ratio=6.4):
    rng = np.random.default_rng(seed)
    u3 = T._sphere_points(rng.uniform(10, 60, n), rng.uniform(-40, 40, n))
    sb = np.abs(rng.normal(0.2, 0.04, n))
    so2 = (sb / ratio * 10.0 ** rng.uniform(-0.5, 0.5, n)) ** 2
    d = rng.normal(0.0, 0.1, n)
    return u3, sb, so2, d


def _dense(u3, sb, so2):
    g = T._correlation(torch.as_tensor(u3), KAPPA)
    b = torch.as_tensor(sb)[:, None] * g * torch.as_tensor(sb)[None, :]
    return g, b, b + torch.diag(torch.as_tensor(so2))


# ---- 1: against the benchmark's plain float64 reference -----------------------------

@pytest.mark.parametrize("n,seed", [(300, 1), (1500, 2), (3000, 3)])
def test_exact_branch_with_its_knee_matches_the_float64_reference(n, seed):
    fields = _month(n, seed)
    cp, (xb, ak, inc, err, info) = _exact(fields)
    want = RF.full_oi(*(torch.as_tensor(f) for f in fields[:4]), fields[4], fields[5], 300.0,
                      torch.float64, dense_max=0)
    rinfo = want[4]
    assert rinfo["curve"] == "slq" and rinfo["n"] == n == cp.idx.size
    assert info["reg"] == rinfo["reg"]
    assert info["solver"] == "direct_f64_dev" and info["exact_diag"]
    assert info["f64_resid"] <= T.DEVICE_EXACT_RESID_GATE
    xb_scale = np.max(np.abs(xb)) * cp.scale
    for name, got, ref, s in (("xb", xb, want[0], cp.scale), ("ak", ak, want[1], 1.0),
                              ("increment", inc, want[2], cp.scale),
                              ("error", err, want[3], cp.scale)):
        ref = ref.numpy().ravel()[cp.idx]
        scale = xb_scale if name == "increment" else np.max(np.abs(ref))
        np.testing.assert_allclose(got * s, ref, rtol=1e-9, atol=1e-9 * scale, err_msg=name)


def test_the_knee_is_the_references_at_several_ratios():
    """The float64 curve's knee is the reference's across the ratios where
    the knee moves (the 1 deg MOPITT month sits near 6.4)."""
    for ratio in (2.0, 6.4, 20.0):
        fields = _month(900, 7, ratio)
        _, got = _exact(fields)
        want = RF.full_oi(*(torch.as_tensor(f) for f in fields[:4]), fields[4], fields[5], 300.0,
                          torch.float64, dense_max=0)[4]
        assert got[4]["reg"] == want["reg"], ratio


# ---- 2: the in-place factor and diagonals ----------------------------------------------

@pytest.mark.parametrize("n,block,diag_block", [(700, 256, 256), (700, 128, 300), (1031, 2048, 2048),
                                                (513, 512, 100)])
def test_in_place_factor_and_diagonals_equal_dense_float64(n, block, diag_block):
    u3, sb, so2, _ = _system(n, n)
    _, b, a_dense = _dense(u3, sb, so2)
    want_l = torch.linalg.cholesky(a_dense)
    a = a_dense.clone()
    ptr = a.data_ptr()
    T._cholesky_(a, block)
    assert a.data_ptr() == ptr
    got_l = torch.tril(a)
    assert float((got_l - want_l).abs().max()) <= 1e-12 * float(want_l.abs().max())
    dainv, q = T._inverse_diags(a, torch.as_tensor(so2), diag_block, block)
    want_dainv = torch.diagonal(torch.cholesky_inverse(want_l))
    want_q = torch.diagonal(b @ torch.linalg.solve(a_dense, b))
    np.testing.assert_allclose(dainv.numpy(), want_dainv.numpy(), rtol=1e-12)
    np.testing.assert_allclose(q.numpy(), want_q.numpy(), rtol=1e-12)


def test_exact_system_solve_and_diagonals_equal_dense_float64():
    u3, sb, so2, d = _system(900, 5)
    _, b, a_dense = _dense(u3 * 1.0, sb * np.sqrt(1.3), so2)
    x, dainv, q, r = T._exact_system(*(torch.as_tensor(v) for v in (u3, sb, so2, d)), KAPPA,
                                     diag_block=256, knee=lambda g: 1.3)
    assert r == 1.3
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(a_dense, torch.as_tensor(d)).numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dainv.numpy(),
                               torch.diagonal(torch.linalg.inv(a_dense)).numpy(), rtol=1e-12)
    np.testing.assert_allclose(q.numpy(), torch.diagonal(b @ torch.linalg.solve(a_dense, b)).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_tiny_systems(n):
    u3, sb, so2, d = _system(n, 11)
    _, b, a_dense = _dense(u3, sb, so2)
    x, dainv, q = T._exact_tail(*(torch.as_tensor(v) for v in (u3, sb, so2, d)), KAPPA)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a_dense.numpy(), d), rtol=1e-12)
    np.testing.assert_allclose(dainv.numpy(), np.diag(np.linalg.inv(a_dense.numpy())), rtol=1e-12)


# ---- 3: the float64 curve -----------------------------------------------------------------

def _slq_explicit(c, bm, sb, so, grid, m, npad=2048, n_probes=8):
    """The SLQ curve with dense products of explicit float64 C and B (numpy),
    the probes of ``np.random.default_rng(0)`` over ``npad`` rows cut to n."""
    n = c.shape[0]
    valid = sb ** 2 > 0
    z = np.random.default_rng(0).choice([-1.0, 1.0], size=(npad, n_probes))[:n]
    z[~valid] = 0.0
    zd = z / np.where(valid, sb ** 2, 1.0)[:, None]
    bz = bm @ np.concatenate([zd, z], axis=1)
    xs, ys = bz[:, :n_probes] / so[:, None], bz[:, n_probes:] / so[:, None]
    q = np.concatenate([xs + ys, xs - ys], axis=1)
    norms = np.sqrt((q * q).sum(0))
    q = q / norms
    q_prev = np.zeros_like(q)
    beta = np.zeros(2 * n_probes)
    alphas, betas = [], []
    for _ in range(m):
        w = c @ q - beta * q_prev
        alpha = (q * w).sum(0)
        w = w - alpha * q
        beta = np.sqrt((w * w).sum(0))
        q_prev, q = q, w / np.where(beta > 0, beta, 1.0)
        alphas.append(alpha)
        betas.append(beta)
    alphas, betas = np.array(alphas), np.array(betas)
    curve = np.zeros(grid.size)
    for j in range(2 * n_probes):
        theta, vecs = eigh_tridiagonal(alphas[:, j], betas[:-1, j])
        w2 = vecs[0] ** 2 * norms[j] ** 2
        g_r = (w2[None] / (grid[:, None] * np.maximum(theta, 0.0)[None] + 1.0)).sum(1)
        curve += (1.0 if j < n_probes else -1.0) * 0.25 * g_r
    return grid * curve / n_probes / int(valid.sum())


@pytest.mark.parametrize("m,rtol", [(20, 1e-10), (60, 1e-5)])
def test_float64_curve_equals_slq_with_an_explicit_c(m, rtol):
    """The same probes and steps against explicit float64 C and B.  Without
    reorthogonalisation the recurrence loses orthogonality once a Ritz value
    converges, and then rounding moves the curve: a 1e-15 relative change of
    G moves the 60-step curve by 1e-9 at these 1,300 cells (5e-6 at 3,000),
    the 20-step one by 1e-14.  So two orders of the same products agree to
    1e-10 at 20 steps and to 1e-5, with the same knee, at the program's 60."""
    n = 1300
    u3, sb, so2, _ = _system(n, 4)
    so = np.sqrt(so2)
    sb[17] = 0.0  # a cell off the curve
    g, b, _ = _dense(u3, sb, so2)
    grid = T.regularization_grid()
    got = M.mean_ak_curve_slq_dense(g, sb, so, grid, block=1024, m=m)
    bm = b.numpy()
    want = _slq_explicit(bm / so[:, None] / so[None, :], bm, sb, so, grid, m)
    np.testing.assert_allclose(got, want, rtol=rtol)
    knee = T.kneedle_index_np(grid, got, fallback=0)
    assert knee == T.kneedle_index_np(grid, want, fallback=0) > 0
    # it reads the buffer and leaves it as it was
    np.testing.assert_array_equal(g.numpy(), T._correlation(torch.as_tensor(u3), KAPPA).numpy())


def test_float64_curve_matches_the_float32_sweep_curve():
    """The float64 curve and the float32 sweep's (mean_ak_curve_slq) price
    the same probes: they agree to float32's trace noise."""
    n = 700
    u3, sb, so2, _ = _system(n, 9)
    so = np.sqrt(so2)
    rng = np.random.default_rng(9)
    lat, lon = rng.uniform(10, 60, n), rng.uniform(-40, 40, n)
    u3 = T._sphere_points(lat, lon)
    grid = T.regularization_grid()
    g = T._correlation(torch.as_tensor(u3), KAPPA)
    got = M.mean_ak_curve_slq_dense(g, sb, so, grid, block=128)
    want = M.mean_ak_curve_slq((lat, lon), sb, so, grid, 300.0, block=128, device="cpu")
    np.testing.assert_allclose(got, want, rtol=2e-3)


# ---- 4: the branch and its limit ------------------------------------------------------------

class _Props:
    def __init__(self, total):
        self.total_memory = total


@pytest.mark.parametrize("total,want", [(85_017_493_504, 72_704), (17_179_869_184, 32_768),
                                        (4 << 30, M.REFINE_MAX_CELLS)])
def test_the_cuda_limit_comes_from_the_cards_total_memory(monkeypatch, total, want):
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props(total))
    got = M.exact_max_cells(torch.device("cuda", 0))
    assert got == want and got % 1024 == 0
    assert 8 * got ** 2 <= M.EXACT_MEMORY_SHARE * total or got == M.REFINE_MAX_CELLS
    if total > 80e9:
        assert got >= 64_512  # the 1 deg globe, padded
    monkeypatch.setenv("OISAT_EXACT_DEVICE", "0")
    assert M.exact_max_cells(torch.device("cuda", 0)) == M.REFINE_MAX_CELLS


def test_the_cpu_keeps_the_jax_limits():
    from oisat_tpu.ops import oi_full as J

    assert M.exact_max_cells(CPU) == M.REFINE_MAX_CELLS == J.REFINE_MAX_CELLS == 16_384
    assert M.NYSTROM_MIN_CELLS == J.NYSTROM_MIN_CELLS
    assert (T.DENSE_MAX_CELLS, T.DENSE_SCAN_MAX_CELLS) == (J.DENSE_MAX_CELLS,
                                                           J.DENSE_SCAN_MAX_CELLS)


def _small_limits(monkeypatch, mods):
    for mod in mods:
        monkeypatch.setattr(mod, "NYSTROM_MIN_CELLS", 256)
    monkeypatch.setattr(T, "DENSE_MAX_CELLS", 64)
    monkeypatch.setattr(T, "DENSE_SCAN_MAX_CELLS", 64)


@pytest.mark.parametrize("reg_on", [False, True])
def test_the_front_end_takes_the_exact_branch_up_to_the_cuda_limit(monkeypatch, reg_on):
    """A CUDA limit of 2,048 (patched): npad 1,024 and 2,048 take the exact
    branch, 3,072 the Nystrom PCG."""
    _small_limits(monkeypatch, (M,))
    monkeypatch.setattr(M, "exact_max_cells", lambda dev, block=1024: 2048)
    calls = []
    real = T._oi_full_exact
    monkeypatch.setattr(T, "_oi_full_exact",
                        lambda cp, *a, **k: calls.append(cp.idx.size) or real(cp, *a, **k))
    for n, exact in ((900, True), (2000, True), (2100, False)):
        res = T.oi_full(*_month(n, 3), 300.0, regularization_on=reg_on, device="cpu")
        assert (res.info["solver"] == "direct_f64_dev") == exact, n
        assert res.info["precond"] == ("direct" if exact else "nystrom(k=768)"), n
        assert np.isfinite(res.xb).sum() == n
    assert calls == [900, 2000]


@pytest.mark.parametrize("reg_on", [False, True])
def test_on_the_cpu_the_branch_at_every_n_is_the_jax_one(monkeypatch, reg_on):
    from oisat_tpu.ops import oi_full as J

    _small_limits(monkeypatch, (M, J))
    for mod in (J, M):
        monkeypatch.setattr(mod, "REFINE_MAX_CELLS", 1024)
    monkeypatch.setattr(J, "DENSE_MAX_CELLS", 64)
    monkeypatch.setattr(J, "DENSE_SCAN_MAX_CELLS", 64)
    for n in (900, 1100):  # npad 1,024: exact; 2,048: Nystrom
        fields = _month(n, 4)
        port = T.oi_full(*fields, 300.0, regularization_on=reg_on, device="cpu")
        jax = J.oi_full(*fields, 300.0, regularization_on=reg_on)
        assert port.info["precond"] == jax.info["precond"], n
        assert port.info["solver"] == jax.info["solver"], n


def test_stages_counters_and_counted_copies():
    fields = _month(1200, 6)
    stage_ms = {}
    profiling.take()
    profiling.enable(True)
    try:
        cp, _ = _exact(fields, stage_ms=stage_ms)
        _, counters = profiling.take()
    finally:
        profiling.enable(False)
    assert set(stage_ms) == {f"oi_full.{s}" for s in
                             ("curve", "factor", "solve", "diag", "pull", "tail_resid")}
    n = cp.idx.size
    assert counters["oi_full.exact_cells"] == n
    assert counters["oi_full.exact_bytes"] == 8 * n * n
    # the one copy of (u3, sigma_b, sigma_o^2, d) and the curve's probes and scales
    assert counters["h2d.bytes"] == 8 * n * 6 + 8 * n * (3 + 16)
    assert counters["syncs"] == 5  # two copies, two pulls, the factor's check
    stage_ms = {}
    _exact(fields, regularization_on=False, stage_ms=stage_ms)
    assert "oi_full.covariance" in stage_ms and "oi_full.curve" not in stage_ms


# ---- 5: no fallback, no kept buffer ----------------------------------------------------------

def test_a_non_finite_factor_raises(monkeypatch):
    real = T._cholesky_

    def poisoned(a, block=T.EXACT_FACTOR_BLOCK):
        real(a, block)
        a[5, 3] = np.nan
        return a

    monkeypatch.setattr(T, "_cholesky_", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite"):
        _exact(_month(600, 2))


def test_a_failed_factorization_raises():
    u3, sb, so2, d = _system(400, 8)
    so2 = -np.full_like(so2, 10.0)  # A is not positive definite
    with pytest.raises(FloatingPointError, match="factorization failed"):
        T._exact_tail(*(torch.as_tensor(v) for v in (u3, sb, so2, d)), KAPPA)


def test_a_residual_above_the_gate_raises(monkeypatch):
    monkeypatch.setattr(T, "_backward_", lambda lf, x, block=T.EXACT_FACTOR_BLOCK: x * 0.5)
    with pytest.raises(FloatingPointError, match="gate"):
        _exact(_month(600, 2))


def test_nothing_keeps_the_buffer(monkeypatch):
    made = []
    real = T._correlation

    def spy(u3, kappa):
        g = real(u3, kappa)
        made.append(weakref.ref(g))
        return g

    monkeypatch.setattr(T, "_correlation", spy)
    cp, res = _exact(_month(800, 5))
    gc.collect()
    assert len(made) == 1 and made[0]() is None
    assert all(isinstance(v, np.ndarray) for v in res[:4])
