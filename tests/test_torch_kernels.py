"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (the CPU tier-1 run).  Run on a GPU host with
``python -m pytest tests/test_torch_kernels.py -q``; ``chip_smoke.py`` runs
the same comparisons at the main path's shapes.

Tolerances: the kernel sums in double in a fixed order, the plain version in
the input dtype in torch's order, so the curves agree to rtol 1e-5 (float32)
and 1e-12 (float64); the knee index must be identical.
"""

import numpy as np
import pytest
import torch

from oisat_tpu_torch.ops.kernels import oi_scan
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops.oi import curve_inputs, oi, regularization_grid

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _variances(n, seed=0, nan_frac=0.2):
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(3.0, 1.0, n))
    sa = (xa * 0.5) ** 2
    so = np.abs(rng.normal(0.4, 0.1, n)) ** 2
    bad = rng.random(n) < nan_frac
    sa[bad] = np.nan
    so[bad] = np.nan
    return sa, so


def _curves(sa, so, regs_np, dtype, device):
    sa_t = torch.as_tensor(sa, dtype=dtype, device=device)
    so_t = torch.as_tensor(so, dtype=dtype, device=device)
    regs = torch.as_tensor(regs_np, dtype=dtype, device=device)
    u, valid = curve_inputs(sa_t, so_t)
    count = valid.sum().item()
    k = oi_scan.ak_curve_sums_kernel(u.contiguous(), regs)
    p = oi_scan.ak_curve_sums_plain(u, regs)
    torch.cuda.synchronize()
    div = count if count else float("nan")
    return (k.cpu().numpy() / div), (p.double().cpu().numpy() / div)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_at_headline_size(cuda, dtype):
    sa, so = _variances(1440 * 2880)
    regs = regularization_grid()
    k, p = _curves(sa, so, regs, dtype, cuda)
    np.testing.assert_allclose(k, p, rtol=RTOL[dtype], atol=0)
    assert kneedle_index_np(regs, k) == kneedle_index_np(regs, p)


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 5 * 2048 + 3])
@pytest.mark.parametrize("nfac", [1, 7, 99, 128])
def test_kernel_edge_shapes(cuda, n, nfac):
    sa, so = _variances(n, seed=n + nfac, nan_frac=0.1)
    regs = np.linspace(0.1, 9.9, nfac)
    k, p = _curves(sa, so, regs, torch.float64, cuda)
    if n == 0:
        assert np.isnan(k).all() and np.isnan(p).all()
    else:
        np.testing.assert_allclose(k, p, rtol=1e-12, atol=0)


def test_kernel_all_invalid_gives_nan_curve(cuda):
    sa = np.full(5000, np.nan)
    so = np.full(5000, 1.0)
    k, p = _curves(sa, so, regularization_grid(), torch.float32, cuda)
    assert np.isnan(k).all() and np.isnan(p).all()


def test_kernel_is_deterministic(cuda):
    sa, so = _variances(300_001, seed=3)
    regs = regularization_grid()
    a, _ = _curves(sa, so, regs, torch.float32, cuda)
    b, _ = _curves(sa, so, regs, torch.float32, cuda)
    assert np.array_equal(a, b)


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    u = torch.rand(100, device=cuda)
    regs = torch.as_tensor(regularization_grid(), dtype=torch.float32, device=cuda)
    before = oi_scan.ak_curve_sums_kernel.launches
    oi_scan.ak_curve_sums_kernel(u, regs)
    assert oi_scan.ak_curve_sums_kernel.launches == before + 1
    with pytest.raises(ValueError):
        oi_scan.ak_curve_sums_kernel(u, torch.ones(129, device=cuda))
    with pytest.raises(TypeError):
        oi_scan.ak_curve_sums_kernel(u.half(), regs.half())
    with pytest.raises(ValueError):
        oi_scan.ak_curve_sums_kernel(u[::2], regs)
    assert oi_scan.ak_curve_sums_kernel.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_oi_kernel_engine_matches_plain(cuda, dtype):
    rng = np.random.default_rng(5)
    shape = (181, 288)
    xa = rng.uniform(0.0, 8.0, shape)
    y = rng.uniform(-0.5, 8.0, shape)
    sa = (xa * 0.5) ** 2
    so = rng.uniform(0.0, 4.0, shape) ** 2
    for f in (xa, y, sa, so):
        f[rng.random(shape) < 0.15] = np.nan
    args = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in (xa, y, sa, so)]
    rk = oi(*args, curve_impl="kernel")
    rp = oi(*args, curve_impl="plain")
    assert int(rk.reg_index) == int(rp.reg_index)
    for name in ("xb", "averaging_kernel", "increment", "error"):
        np.testing.assert_allclose(getattr(rk, name).cpu().numpy(),
                                   getattr(rp, name).cpu().numpy(),
                                   rtol=RTOL[dtype], atol=0, equal_nan=True,
                                   err_msg=name)
