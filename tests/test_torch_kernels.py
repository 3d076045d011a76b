"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (the CPU tier-1 run).  Run on a GPU host with
``python -m pytest tests/test_torch_kernels.py -q``; ``chip_smoke.py`` runs
the same comparisons at the main path's shapes.

Tolerances: the kernel sums in double in a fixed order (float32 terms in
runs of up to 8 before each conversion), the plain version in the input
dtype in torch's order, so the curves agree to rtol 1e-5 (float32) and 1e-12
(float64); the knee index must be identical, and two kernel runs bitwise
equal.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from oisat_tpu_torch.ops.kernels import _build, oi_scan
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.ops.oi import curve_inputs, curve_of_shards, oi, regularization_grid

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
@pytest.mark.parametrize("nfac", [1, 3, 5, 7, 99, 127, 128])
def test_kernel_edge_shapes(cuda, n, nfac):
    sa, so = _variances(n, seed=n + nfac, nan_frac=0.1)
    regs = np.linspace(0.1, 9.9, nfac)
    k, p = _curves(sa, so, regs, torch.float64, cuda)
    if n == 0:
        assert np.isnan(k).all() and np.isnan(p).all()
    else:
        np.testing.assert_allclose(k, p, rtol=1e-12, atol=0)


PATTERNS = ("all-valid", "all-invalid", "alternating", "last-only", "run-across-tiles")


def _valid(pattern, n):
    """Which of ``n`` cells are valid; the invalid run crosses two of the
    kernel's staged-tile boundaries."""
    tile = oi_scan.TILE_CELLS
    valid = np.ones(n, bool)
    if pattern == "all-invalid":
        valid[:] = False
    elif pattern == "alternating":
        valid[1::2] = False
    elif pattern == "last-only":
        valid[:-1] = False
    elif pattern == "run-across-tiles":
        valid[tile - 100:2 * tile + 100] = False
    return valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nfac", [1, 3, 5, 99, 127, 128])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_kernel_validity_patterns(cuda, pattern, nfac, dtype):
    """The kernel sums only the cells with u != +inf; whatever the pattern of
    invalid cells and whether R is a multiple of the 4 factors a thread
    holds, it matches the plain version and repeats bitwise."""
    n = 5 * oi_scan.TILE_CELLS + 37  # a ragged last tile
    sa, so = _variances(n, seed=nfac, nan_frac=0.0)
    sa[~_valid(pattern, n)] = np.nan
    regs = np.linspace(0.1, 9.9, nfac)
    k, p = _curves(sa, so, regs, dtype, cuda)
    k2, _ = _curves(sa, so, regs, dtype, cuda)
    assert np.array_equal(k, k2, equal_nan=True)
    if pattern == "all-invalid":
        assert np.isnan(k).all() and np.isnan(p).all()
    else:
        np.testing.assert_allclose(k, p, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", ["curve", "wide"])
def test_kernel_terms_are_ieee_divisions(cuda, scale, dtype):
    """With one cell each sum is the single term r / (r + u), which the
    kernel must round as the IEEE division does: float32 runs a branch-free
    form of it for operands in [2^-60, 2^60] and the division itself
    elsewhere ("wide" spans both, factors included)."""
    rng = np.random.default_rng(9)
    if scale == "curve":
        regs = rng.uniform(0.1, 9.9, 128)
        cells = np.concatenate([[0.0], 10.0 ** rng.uniform(-6, 6, 299)])
    else:
        regs = 2.0 ** rng.uniform(-70, 64, 128)
        cells = np.concatenate([[0.0, 2.0 ** -140, 2.0 ** 59, 2.0 ** 60],
                                2.0 ** rng.uniform(-80, 70, 296)])
    regs_t = torch.as_tensor(regs, dtype=dtype, device=cuda)
    for cell in cells:
        u = torch.full((1,), cell, dtype=dtype, device=cuda)
        got = oi_scan.ak_curve_sums_kernel(u, regs_t)
        want = (regs_t / (regs_t + u)).double()
        assert torch.equal(got, want), f"u = {cell!r}"


FAST_PATHS_CHECK = r"""
#include "HEADER"

__device__ unsigned mix(unsigned x) {  // lowbias32
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}

// |a|, |b| in [2^-60, 2^60): exponent field 67..186, any significand
__device__ float in_range(unsigned h, unsigned sign) {
  return __uint_as_float(sign << 31 | (67u + (h >> 23) % 120u) << 23 | (h & 0x7fffffu));
}

__global__ void check(unsigned long long* bad) {
  const unsigned long long first = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long division = 0;
  for (unsigned long long k = first; k < (1ull << 30); k += stride) {
    const unsigned h = mix((unsigned)k);
    const float a = in_range(mix(h), h & 1u), b = in_range(mix(h ^ 0x9e3779b9u), 0u);
    division += __float_as_uint(__fdiv_rn(a, b)) != __float_as_uint(oisat_fast::div_in_range(a, b));
  }
  atomicAdd(bad, division);
}

extern "C" int run_check(void* bad) {
  check<<<132 * 16, 256>>>(static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_fast_paths_match_cuda_math(cuda, tmp_path):
    """The branch-free division in csrc/fast_paths.cuh that the float32
    curve kernel uses is bitwise CUDA's own: div_in_range equals the IEEE
    division on 2^30 pairs across its range."""
    src = tmp_path / "check.cu"
    src.write_text(FAST_PATHS_CHECK.replace("HEADER", str(_build.CSRC_DIR / "fast_paths.cuh")))
    lib = tmp_path / "libcheck.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run = ctypes.CDLL(str(lib)).run_check
    run.argtypes = [ctypes.c_void_p]
    run.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert run(bad.data_ptr()) == 0
    assert bad.item() == 0, "division mismatches"


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


def test_kernel_on_a_second_stream(cuda):
    """Each stream has its own ticket: a launch on a side stream gives the
    same sums as one on the default stream."""
    sa, so = _variances(100_003, seed=4)
    u, _ = curve_inputs(torch.as_tensor(sa, device=cuda), torch.as_tensor(so, device=cuda))
    regs = torch.as_tensor(regularization_grid(), device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        a = oi_scan.ak_curve_sums_kernel(u, regs)
    b = oi_scan.ak_curve_sums_kernel(u, regs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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
    before = oi_scan.ak_curve_sums_kernel.launches
    rk = oi(*args)
    assert oi_scan.ak_curve_sums_kernel.launches == before + 1
    # the same update with the plain curve on the card, through the curve hook
    rp = oi(*args, curve_fn=lambda a, o, r: curve_of_shards([a], [o], r,
                                                             oi_scan.ak_curve_sums_plain))
    assert oi_scan.ak_curve_sums_kernel.launches == before + 1
    assert int(rk.reg_index) == int(rp.reg_index)
    for name in ("xb", "averaging_kernel", "increment", "error"):
        np.testing.assert_allclose(getattr(rk, name).cpu().numpy(),
                                   getattr(rp, name).cpu().numpy(),
                                   rtol=RTOL[dtype], atol=0, equal_nan=True,
                                   err_msg=name)


# ---- the sharded curve (the mesh path's engine) ------------------------------------

def _sharded(sa, so, regs_np, dtype, mesh, engine):
    from oisat_tpu_torch.ops.kernels.oi_scan import ak_curve_sharded

    sa_t, so_t = (torch.as_tensor(a, dtype=dtype, device=mesh.devices[0][0]) for a in (sa, so))
    regs = torch.as_tensor(regs_np, dtype=dtype, device=sa_t.device)
    return ak_curve_sharded(sa_t, so_t, regs, mesh, engine=engine)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_kernel_matches_sharded_plain_and_one_launch(cuda, n_dev, dtype):
    """Logical shards on the card: one kernel launch per grid shard, the
    sharded plain version within the kernel tolerance, the one-launch
    kernel's knee, and a bitwise repeat."""
    from oisat_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_dev, devices=[cuda] * n_dev)
    grid_shards = mesh.shape["grid"]
    sa, so = _variances(1_000_003, seed=n_dev)
    regs = regularization_grid()
    before = oi_scan.ak_curve_sums_kernel.launches
    k = _sharded(sa, so, regs, dtype, mesh, oi_scan.ak_curve_sums).cpu().numpy()
    assert oi_scan.ak_curve_sums_kernel.launches == before + grid_shards
    p = _sharded(sa, so, regs, dtype, mesh, oi_scan.ak_curve_sums_plain).cpu().numpy()
    assert oi_scan.ak_curve_sums_kernel.launches == before + grid_shards
    one, _ = _curves(sa, so, regs, dtype, cuda)
    np.testing.assert_allclose(k, p, rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(k, one, rtol=RTOL[dtype], atol=0)
    assert kneedle_index_np(regs, k) == kneedle_index_np(regs, one) == kneedle_index_np(regs, p)
    again = _sharded(sa, so, regs, dtype, mesh, oi_scan.ak_curve_sums).cpu().numpy()
    assert np.array_equal(k, again)


def test_sharded_kernel_with_empty_and_all_invalid_shards(cuda):
    """3 rows over 4 grid shards (the last is empty: the kernel's n = 0) and
    an all-invalid shard add nothing; all cells invalid gives NaN."""
    from oisat_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, devices=[cuda] * 8)  # 2 x 4
    sa, so = _variances(3 * 4099, seed=3, nan_frac=0.1)
    sa, so = sa.reshape(3, 4099), so.reshape(3, 4099)
    sa[1] = np.nan
    regs = regularization_grid()
    k = _sharded(sa, so, regs, torch.float64, mesh, oi_scan.ak_curve_sums).cpu().numpy()
    one, _ = _curves(sa.ravel(), so.ravel(), regs, torch.float64, cuda)
    np.testing.assert_allclose(k, one, rtol=1e-12, atol=0)
    nan = _sharded(np.full_like(sa, np.nan), so, regs, torch.float64, mesh,
                   oi_scan.ak_curve_sums)
    assert torch.isnan(nan).all()


def test_sharded_kernel_on_two_streams(cuda):
    """Each stream finds its own ticket counter: the same sharded curve on
    two streams at once gives the same sums bitwise."""
    from oisat_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, devices=[cuda] * 4)
    sa, so = _variances(2_000_003, seed=9)
    regs = regularization_grid()
    ref = _sharded(sa, so, regs, torch.float32, mesh, oi_scan.ak_curve_sums)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        a = _sharded(sa, so, regs, torch.float32, mesh, oi_scan.ak_curve_sums)
    with torch.cuda.stream(s2):
        b = _sharded(sa, so, regs, torch.float32, mesh, oi_scan.ak_curve_sums)
    torch.cuda.synchronize()
    assert torch.equal(a, ref) and torch.equal(b, ref)


# ---- the matrix-free B.V sweep (csrc/b_matmat.cu) --------------------------------

def _sweep_inputs(n, k, cuda, seed=0):
    from oisat_tpu_torch.ops.oi_full_matfree import _unit_vectors

    rng = np.random.default_rng(seed)
    u3 = _unit_vectors(rng.uniform(20, 60, n), rng.uniform(-140, -60, n), cuda).contiguous()
    sb = torch.as_tensor(np.abs(rng.normal(1.0, 0.3, n)).astype(np.float32), device=cuda)
    v = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32), device=cuda)
    return u3, sb, v


@pytest.mark.parametrize("n,block,k", [
    *((n, block, k) for k in (1, 3, 16, 130, 256)
      for n, block in ((2048, 1024), (4096, 1024), (4096, 2048), (2048, 128))),
    (4096, 1024, 2048), (4096, 2048, 2048)])
def test_b_matmat_kernel_matches_plain(cuda, n, block, k):
    """One-hot V: each output is one product, so C itself must agree bitwise;
    random V: within 1e-5 of max |Y| of the plain version, no further from
    the float64 product than twice the plain version's distance; a repeat
    is bitwise."""
    from oisat_tpu_torch.ops.kernels import b_matmat as BM

    u3, sb, v = _sweep_inputs(n, k, cuda, seed=n + k)
    nchunks = n // block
    cols = torch.as_tensor(np.random.default_rng(k).choice(n, k, replace=False), device=cuda)
    onehot = torch.zeros((n, k), dtype=torch.float32, device=cuda)
    onehot[cols, torch.arange(k, device=cuda)] = 1.0
    got = BM.b_matmat_kernel(u3, onehot, 300.0, block, 0, nchunks)
    want = BM.b_matmat_plain(u3, onehot, 300.0, block, 0, nchunks)
    assert torch.equal(got, want)
    dv = sb[:, None] * v
    got = BM.b_matmat_kernel(u3, dv, 300.0, block, 0, nchunks)
    want = BM.b_matmat_plain(u3, dv, 300.0, block, 0, nchunks)
    ref = BM.b_matmat_reference(u3, dv, 300.0, block, 0, nchunks)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((got - ref).abs().max()) <= 2.0 * float((want - ref).abs().max())
    assert torch.equal(got, BM.b_matmat_kernel(u3, dv, 300.0, block, 0, nchunks))
    # a chunk range of its own, as a mesh position sweeps it
    part = BM.b_matmat_kernel(u3, dv, 300.0, block, nchunks // 2, nchunks)
    pref = BM.b_matmat_reference(u3, dv, 300.0, block, nchunks // 2, nchunks)
    assert float((part - pref).abs().max()) <= 1e-5 * float(pref.abs().max())


def test_b_matmat_auto_launches_the_kernel_on_cuda(cuda):
    from oisat_tpu_torch.ops import oi_full_matfree as M
    from oisat_tpu_torch.ops.kernels import b_matmat as BM
    from oisat_tpu_torch.parallel.mesh import make_mesh

    u3, sb, v = _sweep_inputs(4096, 8, cuda)
    before = BM.b_matmat_kernel.launches
    got = M._b_matmat(u3, sb, v, 300.0, 1024)
    assert BM.b_matmat_kernel.launches == before + 1
    plain = M._b_matmat(u3, sb, v, 300.0, 1024, engine=BM.b_matmat_plain)
    assert BM.b_matmat_kernel.launches == before + 1
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    mesh = make_mesh(3, devices=[cuda] * 3)  # 4 chunks over 3 positions
    sharded = M._b_matmat(u3, sb, v, 300.0, 1024, mesh)
    assert BM.b_matmat_kernel.launches == before + 4
    assert float((sharded - got).abs().max()) <= 1e-5 * scale
    assert torch.equal(sharded, M._b_matmat(u3, sb, v, 300.0, 1024, mesh))


def test_b_matmat_kernel_rejects_bad_input(cuda):
    from oisat_tpu_torch.ops.kernels import b_matmat as BM

    u3, sb, v = _sweep_inputs(1024, 2, cuda)
    dv = sb[:, None] * v
    with pytest.raises(ValueError, match="multiple of 128"):
        BM.b_matmat_kernel(u3, dv, 300.0, 96, 0, 1)
    with pytest.raises(ValueError, match="at most"):
        BM.b_matmat_kernel(torch.zeros((4096, 3), device=cuda),
                           torch.zeros((4096, 1), device=cuda), 300.0, 4096, 0, 1)
    with pytest.raises(ValueError, match="chunk range"):
        BM.b_matmat_kernel(u3, dv, 300.0, 256, 2, 5)
    with pytest.raises(TypeError, match="float32"):
        BM.b_matmat_kernel(u3.double(), dv, 300.0, 256, 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        BM.b_matmat_kernel(u3, dv.t().contiguous().t(), 300.0, 256, 0, 4)
