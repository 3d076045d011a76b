"""The matrix-free B.V sweep's engines (``oisat_tpu_torch.ops.kernels.b_matmat``)
and the device-picked engine through the matrix-free solves, on the CPU.

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
    got = M._b_matmat(u3, sb, v, L_KM, block)
    assert got.dtype == want.dtype and torch.equal(got, want)
    dv = sb[:, None] * v
    inner = BM.b_matmat_plain(u3, dv, L_KM, block, 0, n // block)
    assert torch.equal(sb[:, None] * inner, want)


@pytest.mark.parametrize("positions", [2, 3, 8])
def test_plain_engine_over_a_mesh_is_the_old_sweep_bitwise(positions):
    u3, sb, v = _inputs(512, 8)
    mesh = make_mesh(positions, devices=["cpu"] * positions)
    want = _old_b_matmat(u3, sb, v, L_KM, 128, mesh)
    assert torch.equal(M._b_matmat(u3, sb, v, L_KM, 128, mesh), want)
    assert torch.equal(M._b_matmat(u3, sb, v, L_KM, 128, mesh, engine=BM.b_matmat_plain), want)


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


def test_one_hot_columns_are_b_against_float64():
    n, block = 640, 128
    rng = np.random.default_rng(3)
    u3, sb, _ = _inputs(n, 1, seed=3, spread=(35, 45, -5, 5))
    cols = np.sort(rng.choice(n, 24, replace=False))
    onehot = torch.zeros((n, cols.size), dtype=torch.float32)
    onehot[cols, np.arange(cols.size)] = 1.0
    got = M._b_matmat(u3, sb, onehot, L_KM, block).numpy().astype(np.float64)
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
        M._b_matmat(u3, sb, v, L_KM, 128, engine=BM.b_matmat_kernel)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        BM.b_matmat_kernel(u3, sb[:, None] * v, L_KM, 128, 0, 2)
    # the device-picked engine takes the plain version for CPU tensors
    assert torch.equal(BM.b_matmat(u3, sb[:, None] * v, L_KM, 128, 0, 2),
                       BM.b_matmat_plain(u3, sb[:, None] * v, L_KM, 128, 0, 2))
    assert BM.b_matmat_kernel.launches == 0  # nothing launched on the CPU


def _small_args(n_side=16):
    rng = np.random.default_rng(7)
    lon, lat = np.meshgrid(np.linspace(-4, 4, 2 * n_side), np.linspace(36, 44, n_side))
    xa = np.abs(rng.normal(3, 1, lat.shape))
    y = xa * rng.uniform(0.8, 1.3, lat.shape)
    sigb = np.abs(rng.normal(1.0, 0.2, lat.shape))
    sigo = np.abs(rng.normal(0.6, 0.1, lat.shape))
    return [a.ravel() for a in (xa, y, sigb, sigo, lat, lon)]


def test_every_sweep_of_the_large_branch_goes_through_the_device_picked_engine(monkeypatch):
    """``oi_full``'s matrix-free branch (forced at a small size) sends every
    sweep of the SLQ knee and the solve through the one device-picked engine
    (:func:`~oisat_tpu_torch.ops.kernels.b_matmat.b_matmat`), and a repeat is
    bitwise."""
    calls = []

    def engine(*a):
        calls.append(a[0].device.type)
        return BM.b_matmat(*a)

    monkeypatch.setitem(M._b_matmat.__kwdefaults__, "engine", engine)
    monkeypatch.setattr(T, "DENSE_SCAN_MAX_CELLS", 64)
    xa, y, sigb, sigo, lat, lon = (a.reshape(16, 32) for a in _small_args())
    res = []
    for _ in range(2):
        calls.clear()
        res.append(T.oi_full(xa, y, sigb, sigo, lat, lon, L_KM, regularization_on=True,
                             device="cpu"))
        # 1 + SLQ_STEPS sweeps for the curve, then the solve's
        assert len(calls) > 1 + T.SLQ_STEPS and set(calls) == {"cpu"}
    for f in ("xb", "averaging_kernel", "increment", "error"):
        assert np.array_equal(getattr(res[0], f), getattr(res[1], f), equal_nan=True)
    assert BM.b_matmat_kernel.launches == 0


# ---- the wide shape's six-product bf16 split (csrc/b_matmat.cu, K > 32) ------------

def _bits_sample(kind, rng):
    """float32 samples of one kind for the split's exactness."""
    if kind == "unit":  # C's range
        x = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
        return np.concatenate([x[x > 0], np.float32([1.0, np.nextafter(1.0, 0.0)])])
    if kind == "signed":  # dv: sigma_b * v, both signs, 1.0 and zeros
        x = (np.abs(rng.normal(1.0, 0.3, 4096)) * rng.standard_normal(4096)).astype(np.float32)
        return np.concatenate([x, np.float32([1.0, -1.0, 0.0, -0.0])])
    if kind == "exponents":  # every normal binade from 2^-110 to 2^126, random bits
        e = rng.integers(-110, 127, 4096)
        m = rng.integers(0, 1 << 23, 4096)
        x = np.ldexp(1.0 + m / float(1 << 23), e) * rng.choice([-1.0, 1.0], 4096)
        return x.astype(np.float32)
    # float32 subnormals: random mantissas and the smallest ones
    m = np.concatenate([rng.integers(1, 1 << 23, 4096), np.arange(1, 65),
                        np.arange(1, 128) << 16])  # the last: multiples of 2^-133
    return (m.astype(np.uint32).view(np.float32)).copy()


@pytest.mark.parametrize("kind", ["unit", "signed", "exponents", "subnormal_scaled"])
def test_split_bf16x3_is_exact(kind):
    """x0 + x1 + x2 == x bitwise, each piece a bf16, each difference exact:
    C's values, dv's, every binade from 2^-110 up, and float32 subnormals
    at the kernel's scale of C (2^24)."""
    x = torch.as_tensor(_bits_sample(kind.replace("_scaled", ""), np.random.default_rng(5)))
    if kind == "subnormal_scaled":
        assert bool((x.abs() < torch.finfo(torch.float32).tiny).all())
        x = x * BM.C_SPLIT_SCALE
        assert bool((x.abs() >= torch.finfo(torch.float32).tiny).all())  # exact, normal
    x0, x1, x2 = BM.split_bf16x3(x)
    assert x0.dtype == x1.dtype == x2.dtype == torch.bfloat16
    total = (x0.float() + x1.float()) + x2.float()
    nz = x != 0  # -0.0 splits into (-0, +0, +0): its sum is +0
    assert torch.equal(total[nz].view(torch.int32), x[nz].view(torch.int32))
    assert bool((total[~nz] == 0).all())
    # the pieces fall in weight: |x1| <= 2^-8 |x0|, |x2| <= 2^-8 |x1|
    assert bool((x1.float().abs() <= x0.float().abs() * 2.0 ** -8).all())
    assert bool((x2.float().abs() <= x1.float().abs() * 2.0 ** -8).all())


def test_split_bf16x3_subnormals_as_documented():
    """Unscaled float32 subnormals keep their multiple of 2^-133 (bf16's
    smallest subnormal) nearest to them: within 2^-134, and exact where x
    is such a multiple; non-float32 input raises."""
    x = torch.as_tensor(_bits_sample("subnormal", np.random.default_rng(6)))
    x0, x1, x2 = BM.split_bf16x3(x)
    total = (x0.float() + x1.float()) + x2.float()
    assert float((total.double() - x.double()).abs().max()) <= 2.0 ** -134
    on_grid = torch.remainder(x.double(), 2.0 ** -133) == 0
    assert bool(on_grid.any()) and torch.equal(total[on_grid], x[on_grid])
    with pytest.raises(TypeError, match="float32"):
        BM.split_bf16x3(x.double())


def _c_rows(u3, block):
    """C (N, N) in float32 exactly as ``b_matmat_plain`` builds it: the same
    torch ops on the same (chunks, block, block) tiles, rows laid side by
    side (the CPU's vectorised exp then rounds every element alike)."""
    kappa = (EARTH_RADIUS_KM / L_KM) ** 2
    n = u3.shape[0]
    u3c = u3.reshape(n // block, block, 3)
    rows = []
    for s in range(0, n, block):
        ub = u3[s:s + block]
        d2 = None
        for k in range(3):
            t = (ub[None, :, None, k] - u3c[:, None, :, k]).square_()
            d2 = t if d2 is None else d2.add_(t)
        rows.append(d2.mul_(-0.5 * kappa).exp_().permute(1, 0, 2).reshape(block, n))
    return torch.cat(rows)


def _six_product_sweep(u3, dv, block):
    """The wide shape's arithmetic in plain float32: 2^24 C and dv split
    into bf16 pieces, cast back (each product of two pieces is exact in
    float32), per 128-column run hi = c0 d0 and lo = c2 d0 + c1 d0 + c1 d1 +
    c0 d1 + c0 d2 each summed from zero, the run (hi + lo) 2^-24 added to its
    chunk's sum, the chunks to the total in order."""
    n = u3.shape[0]
    c = [p.float() for p in BM.split_bf16x3(_c_rows(u3, block) * BM.C_SPLIT_SCALE)]
    d = [p.float() for p in BM.split_bf16x3(dv)]
    out = None
    for j0 in range(0, n, block):
        part = None
        for r0 in range(j0, j0 + block, 128):
            s = slice(r0, r0 + 128)
            hi = c[0][:, s] @ d[0][s]
            lo = c[2][:, s] @ d[0][s]
            for a, b in ((1, 0), (1, 1), (0, 1), (0, 2)):
                lo = lo + c[a][:, s] @ d[b][s]
            run = (hi + lo) * (1.0 / BM.C_SPLIT_SCALE)
            part = run if part is None else part + run
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("n,block,k", [(512, 128, 33), (1024, 256, 33), (768, 256, 130),
                                       (1024, 128, 130), (512, 128, 256), (1024, 256, 256)])
def test_six_product_split_against_float64(n, block, k):
    """The kernel's scheme, emulated: no further from the float64 product
    than twice the plain engine's distance, and one-hot V returns C bitwise
    (subnormal elements of C among them: the points span ~4,000 km+)."""
    rng = np.random.default_rng(n + k)
    u3 = M._unit_vectors(rng.uniform(20, 60, n), rng.uniform(-140, -60, n), "cpu")
    u3 = u3.to(torch.float32).contiguous()
    sb = torch.as_tensor(np.abs(rng.normal(1.0, 0.3, n)).astype(np.float32))
    dv = sb[:, None] * torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32))
    got = _six_product_sweep(u3, dv, block)
    plain = BM.b_matmat_plain(u3, dv, L_KM, block, 0, n // block)
    ref = BM.b_matmat_reference(u3, dv, L_KM, block, 0, n // block)
    assert float((got.double() - ref).abs().max()) <= 2.0 * float((plain.double() - ref).abs().max())
    cols = rng.choice(n, k, replace=False)
    onehot = torch.zeros((n, k), dtype=torch.float32)
    onehot[cols, np.arange(k)] = 1.0
    c_cols = BM.b_matmat_plain(u3, onehot, L_KM, block, 0, n // block)
    tiny = torch.finfo(torch.float32).tiny
    assert bool(((c_cols > 0) & (c_cols < tiny)).any())
    assert torch.equal(_six_product_sweep(u3, onehot, block), c_cols)
