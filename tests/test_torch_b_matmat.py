"""The matrix-free B.V sweep's engines (``oisat_tpu_torch.ops.kernels.b_matmat``)
and the ``cov_impl`` choice through the matrix-free solves, on the CPU.

The plain engine is the torch-op body that ``_b_matmat`` held before the
sweep got its CUDA kernel, moved unchanged: it is held bitwise to a copy of
that body kept here.  The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, marked ``gpu``; ``chip_smoke.py``).

Tolerances: bitwise where the same torch ops run in the same order; the
one-hot columns of B within 1e-6 of max |B| of a float64 evaluation of the
same chordal formula on the same float32 unit vectors (each float32 element
is a few ulp off it).
"""

import numpy as np
import pytest
import torch

from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.ops import oi_full_matfree as M
from oisat_tpu_torch.ops.kernels import b_matmat as BM
from oisat_tpu_torch.ops.kernels.covariance import EARTH_RADIUS_KM
from oisat_tpu_torch.parallel.mesh import make_mesh, sum_in_order

torch.set_num_threads(1)

L_KM = 300.0


def _old_b_matmat(u3, sigma_b, v, length_scale_km, block, mesh=None):
    """``_b_matmat`` as it was before the kernel: the reference of the plain
    engine's bitwise tests."""
    kappa = (EARTH_RADIUS_KM / length_scale_km) ** 2
    n = u3.shape[0]
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
            c = d2.mul_(-0.5 * kappa).exp_()
            rows.append(torch.bmm(c, dv3_d).sum(dim=0))
            del c, d2, t
        parts.append(torch.cat(rows).to(u3.device))
    return sigma_b[:, None] * sum_in_order(parts)


def _inputs(n, k, dtype=np.float32, seed=0, spread=(20, 60, -30, 20)):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(spread[0], spread[1], n)
    lon = rng.uniform(spread[2], spread[3], n)
    u3 = M._unit_vectors(lat, lon, "cpu").to(torch.float64 if dtype == np.float64 else torch.float32)
    sb = np.abs(rng.normal(1.0, 0.3, n)).astype(dtype)
    sb[::13] = 0.0  # padding-like rows
    v = rng.standard_normal((n, k)).astype(dtype)
    return u3.contiguous(), torch.as_tensor(sb), torch.as_tensor(v)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,block,k", [(512, 128, 1), (512, 128, 5), (768, 256, 16),
                                       (1024, 512, 130)])
def test_plain_engine_is_the_old_sweep_bitwise(n, block, k, dtype):
    u3, sb, v = _inputs(n, k, dtype)
    want = _old_b_matmat(u3, sb, v, L_KM, block)
    for impl in ("auto", "plain"):
        got = M._b_matmat(u3, sb, v, L_KM, block, impl=impl)
        assert got.dtype == want.dtype and torch.equal(got, want), impl
    dv = sb[:, None] * v
    inner = BM.b_matmat_plain(u3, dv, L_KM, block, 0, n // block)
    assert torch.equal(sb[:, None] * inner, want)


@pytest.mark.parametrize("positions", [2, 3, 8])
def test_plain_engine_over_a_mesh_is_the_old_sweep_bitwise(positions):
    u3, sb, v = _inputs(512, 8)
    mesh = make_mesh(positions, devices=["cpu"] * positions)
    want = _old_b_matmat(u3, sb, v, L_KM, 128, mesh)
    assert torch.equal(M._b_matmat(u3, sb, v, L_KM, 128, mesh), want)
    assert torch.equal(M._b_matmat(u3, sb, v, L_KM, 128, mesh, "plain"), want)


@pytest.mark.parametrize("k", [1, 4, 17])
@pytest.mark.parametrize("positions", [3, 8])
def test_plain_engine_chunk_ranges_add_up_in_order(k, positions):
    """The plain engine over split chunk ranges, summed in range order, is
    the sweep over a mesh of that many positions bitwise, and the
    full-range call to rounding: torch's CPU sum over the chunk axis is not
    a left-to-right sum (a vectorised cascade), so the two association
    orders differ in the last bits."""
    n, block = 1024, 128
    u3, sb, v = _inputs(n, k, seed=k)
    dv = sb[:, None] * v
    nchunks = n // block
    full = BM.b_matmat_plain(u3, dv, L_KM, block, 0, nchunks)
    ranges = [(int(c[0]), int(c[-1]) + 1)
              for c in torch.arange(nchunks).tensor_split(positions) if c.numel()]
    parts = [BM.b_matmat_plain(u3, dv, L_KM, block, c0, c1) for c0, c1 in ranges]
    split = sum_in_order(parts)
    mesh = make_mesh(positions, devices=["cpu"] * positions)
    assert torch.equal(sb[:, None] * split, M._b_matmat(u3, sb, v, L_KM, block, mesh))
    assert float((split - full).abs().max()) <= 1e-6 * float(full.abs().max())


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_one_hot_columns_are_b_against_float64(impl):
    n, block = 640, 128
    rng = np.random.default_rng(3)
    u3, sb, _ = _inputs(n, 1, seed=3, spread=(35, 45, -5, 5))
    cols = np.sort(rng.choice(n, 24, replace=False))
    onehot = torch.zeros((n, cols.size), dtype=torch.float32)
    onehot[cols, np.arange(cols.size)] = 1.0
    got = M._b_matmat(u3, sb, onehot, L_KM, block, impl=impl).numpy().astype(np.float64)
    u64 = u3.numpy().astype(np.float64)
    s64 = sb.numpy().astype(np.float64)
    kappa = (EARTH_RADIUS_KM / L_KM) ** 2
    d2 = ((u64[:, None, :] - u64[None, cols, :]) ** 2).sum(-1)
    want = s64[:, None] * np.exp(-0.5 * kappa * d2) * s64[None, cols]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_neg_half_kappa_is_the_float32_constant():
    kappa = (EARTH_RADIUS_KM / L_KM) ** 2
    assert BM.neg_half_kappa(L_KM) == float(np.float32(-0.5 * kappa))
    # torch's mul_ by the Python float applies that float32 constant
    x = torch.linspace(0.0, 1e-3, 101)
    assert torch.equal(x.clone().mul_(-0.5 * kappa), x * torch.tensor(BM.neg_half_kappa(L_KM)))


def test_the_kernel_refuses_cpu_tensors_and_bad_engines():
    u3, sb, v = _inputs(256, 2)
    with pytest.raises(ValueError, match="CUDA"):
        M._b_matmat(u3, sb, v, L_KM, 128, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        BM.b_matmat_kernel(u3, sb[:, None] * v, L_KM, 128, 0, 2)
    with pytest.raises(ValueError, match="impl must be one of"):
        M._b_matmat(u3, sb, v, L_KM, 128, impl="fast")
    assert set(BM.B_MATMAT_IMPLS) == {"auto", "kernel", "plain"}
    assert BM.b_matmat_kernel.launches == 0  # nothing launched on the CPU


def _small_args(n_side=16):
    rng = np.random.default_rng(7)
    lon, lat = np.meshgrid(np.linspace(-4, 4, 2 * n_side), np.linspace(36, 44, n_side))
    xa = np.abs(rng.normal(3, 1, lat.shape))
    y = xa * rng.uniform(0.8, 1.3, lat.shape)
    sigb = np.abs(rng.normal(1.0, 0.2, lat.shape))
    sigo = np.abs(rng.normal(0.6, 0.1, lat.shape))
    return [a.ravel() for a in (xa, y, sigb, sigo, lat, lon)]


@pytest.mark.parametrize("precond,kw", [("nystrom", dict(refine=0, nystrom_k=128)),
                                        ("jacobi", dict(probe_sep_factor=6.0))])
def test_oi_full_matfree_plain_engine_is_the_default_bitwise(precond, kw):
    args = _small_args()
    base = M.oi_full_matfree(*args, L_KM, block=128, precond=precond, device="cpu", **kw)
    plain = M.oi_full_matfree(*args, L_KM, block=128, precond=precond, device="cpu",
                              cov_impl="plain", **kw)
    for a, b in zip(base[:4], plain[:4]):
        assert np.array_equal(a, b, equal_nan=True)
    assert base[4] == plain[4]


def test_unknown_cov_impl_raises():
    args = _small_args(8)
    with pytest.raises(ValueError, match="cov_impl must be one of"):
        M.oi_full_matfree(*args, L_KM, block=128, device="cpu", cov_impl="fast")
    with pytest.raises(ValueError, match="impl must be one of"):
        M.mean_ak_curve_slq((args[4], args[5]), args[2], args[3], np.array([1.0, 2.0]), L_KM,
                            block=128, m=4, device="cpu", cov_impl="fast")
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        M.oi_full_matfree(*args, L_KM, block=128, device="cpu", cov_impl="kernel")


def test_cov_impl_reaches_every_sweep_of_the_large_branch(monkeypatch):
    """``oi_full``'s matrix-free branch (forced at a small size) sends every
    sweep of the SLQ knee and the solve to the engine ``cov_impl`` names, and
    the plain engine's result is the default's, bitwise."""
    calls = []

    def spy(name):
        real = BM.B_MATMAT_IMPLS[name]

        def engine(*a):
            calls.append(name)
            return real(*a)
        return engine

    monkeypatch.setattr(M, "B_MATMAT_IMPLS", {name: spy(name) for name in BM.B_MATMAT_IMPLS})
    monkeypatch.setattr(T, "DENSE_SCAN_MAX_CELLS", 64)
    xa, y, sigb, sigo, lat, lon = (a.reshape(16, 32) for a in _small_args())
    res = {}
    for impl in ("auto", "plain"):
        calls.clear()
        res[impl] = T.oi_full(xa, y, sigb, sigo, lat, lon, L_KM, regularization_on=True,
                              device="cpu", cov_impl=impl)
        # 1 + SLQ_STEPS sweeps for the curve, then the solve's
        assert len(calls) > 1 + T.SLQ_STEPS and set(calls) == {impl}
    for f in ("xb", "averaging_kernel", "increment", "error"):
        assert np.array_equal(getattr(res["auto"], f), getattr(res["plain"], f), equal_nan=True)
