"""The port's covariance builder (oisat_tpu_torch.ops.kernels.covariance)
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
NumPy float64 golden, and the CUDA kernel against the plain version on the
card (``gpu``-marked tests, which skip without a CUDA device; run them on a
GPU host with ``python -m pytest --noconftest tests/test_torch_covariance.py
-q -m gpu``).

Tolerances: rtol 2e-4 / atol 1e-6 * max sigma^2 against the JAX kernel and
the golden -- the JAX test's own bounds (tests/test_oi_full.py:19), which
cover float32 sin/exp.  On the card the kernel and the plain version round
operation by operation alike, so they are bitwise equal; B is bitwise
symmetric, which lets the kernel compute one triangle and mirror it.

The float64 whitened correlation C = diag(s) G diag(s) of the dense scan:
its plain version against the float64 golden B / (sigma_o_i sigma_o_j) to
rtol 1e-11 (the chordal distance from the unit vectors' dot product, whose
rounding kappa ~ 451 multiplies; pairs past the exponent's -60 floor take
exp(-60) s_i s_j), and on the card the kernel against the
plain version to rtol 1e-12 (the same formula; only the K = 3 dot
product's order differs from cuBLAS's), bitwise symmetric.
"""

import numpy as np
import pytest
import torch

from oisat_tpu_torch.ops.kernels import covariance as cov

torch.set_num_threads(1)

RTOL = 2e-4


def _coords(n, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(20, 60, n)
    lon = rng.uniform(-130, -60, n)
    sig = np.abs(rng.normal(1.5, 0.3, n))
    return lat, lon, sig


def _assert_close(got, want, sig):
    atol = 1e-6 * max(float(np.max(np.asarray(sig) ** 2)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_plain_matches_jax_pallas_kernel_and_golden():
    import jax.numpy as jnp

    from oisat_tpu.ops.kernels.covariance import build_covariance as jax_build
    from oisat_tpu.ops.kernels.covariance import build_covariance_reference

    lat, lon, sig = _coords(256)
    got = cov.build_covariance(lat, lon, sig, 300.0, device="cpu").numpy()
    want = np.asarray(jax_build(jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(sig),
                                300.0, tile=128))
    ref = build_covariance_reference(lat, lon, sig, 300.0)
    assert got.dtype == np.float32 and got.shape == (256, 256)
    _assert_close(got, want, sig)
    _assert_close(got, ref, sig)
    np.testing.assert_array_equal(cov.build_covariance_reference(lat, lon, sig, 300.0), ref)
    # symmetric with sigma^2 on the diagonal
    np.testing.assert_allclose(got, got.T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(got), sig ** 2, rtol=2e-6)


@pytest.mark.parametrize("n", [1, 131, 300])
def test_plain_takes_any_n(n):
    """No N % tile requirement: N = 1 and N off the 128-lane tile agree with
    the golden and with the JAX kernel run on sigma = 0 padding."""
    import jax.numpy as jnp

    from oisat_tpu.ops.kernels.covariance import build_covariance as jax_build

    lat, lon, sig = _coords(n, seed=n)
    got = cov.build_covariance(lat, lon, sig, 250.0, device="cpu").numpy()
    assert got.shape == (n, n)
    _assert_close(got, cov.build_covariance_reference(lat, lon, sig, 250.0), sig)
    npad = -(-n // 128) * 128
    pad = npad - n
    padded = jax_build(jnp.asarray(np.concatenate([lat, np.zeros(pad)])),
                       jnp.asarray(np.concatenate([lon, np.zeros(pad)])),
                       jnp.asarray(np.concatenate([sig, np.zeros(pad)])), 250.0, tile=128)
    _assert_close(got, np.asarray(padded)[:n, :n], sig)


def test_all_zero_sigma_gives_zero_matrix():
    lat, lon, _ = _coords(77, seed=4)
    got = cov.build_covariance(lat, lon, np.zeros(77), 300.0, device="cpu")
    assert torch.equal(got, torch.zeros(77, 77))


@pytest.mark.parametrize("n, seed", [(500, 0), (1500, 1)])
def test_plain_is_bitwise_symmetric(n, seed):
    """B[j, i] rounds exactly as B[i, j] (the CUDA kernel computes the upper
    triangle and mirrors it): the coordinate differences negate exactly,
    sin is odd, only its square enters, and the products commute."""
    lat, lon, sig = _coords(n, seed=seed)
    b = cov.build_covariance(lat, lon, sig, 300.0, device="cpu")
    assert torch.equal(b, b.T)


def test_sin_is_odd_on_float32_half_differences():
    """The property the mirror rests on, on its own: torch.sin(-x) is
    exactly -torch.sin(x) over the half-differences of radians B takes."""
    x = torch.as_tensor(np.random.default_rng(2).uniform(-3.2, 3.2, 100_000),
                        dtype=torch.float32)
    assert torch.equal(torch.sin(-x), -torch.sin(x))


def test_radians_follow_the_jax_rounding():
    """Degrees are cast to float32 first, then scaled by float32(pi/180), as
    ``jnp.deg2rad(jnp.asarray(deg, jnp.float32))`` does."""
    import jax.numpy as jnp

    deg = np.random.default_rng(3).uniform(-180, 180, 1000)
    got = cov.radians_f32(deg, "cpu").numpy()
    want = np.asarray(jnp.deg2rad(jnp.asarray(deg, jnp.float32)))
    np.testing.assert_array_equal(got, want)
    assert torch.equal(cov.radians_f32(torch.as_tensor(deg), "cpu"), torch.as_tensor(got))


def _plain(lat, lon, sig, length_scale_km, device):
    """The plain version on the float32 radians and sigma that
    ``build_covariance`` hands its engine."""
    sig32 = torch.as_tensor(np.asarray(sig)).to(device).to(torch.float32)
    return cov.build_covariance_plain(cov.radians_f32(lat, device), cov.radians_f32(lon, device),
                                      sig32, float(length_scale_km))


def test_cpu_tensors_take_the_plain_version():
    lat, lon, sig = _coords(40, seed=5)
    before = cov.build_covariance_kernel.launches
    a = cov.build_covariance(lat, lon, sig, 300.0, device="cpu")
    b = _plain(lat, lon, sig, 300.0, "cpu")
    assert torch.equal(a, b)
    assert cov.build_covariance_kernel.launches == before
    lat_r, lon_r = cov.radians_f32(lat, "cpu"), cov.radians_f32(lon, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cov.build_covariance_kernel(lat_r, lon_r, torch.ones_like(lat_r), 300.0)


def _unit_vectors(lat, lon, device="cpu"):
    la, lo = (torch.deg2rad(torch.as_tensor(v, dtype=torch.float64, device=device))
              for v in (lat, lon))
    return torch.stack([torch.cos(la) * torch.cos(lo), torch.cos(la) * torch.sin(lo),
                        torch.sin(la)], dim=1)


def _kappa(length_scale_km):
    return (cov.EARTH_RADIUS_KM / length_scale_km) ** 2


def _assert_golden(got, lat, lon, sb, so, length_scale_km):
    """C against the float64 golden B / (so_i so_j), the pairs whose
    exponent is below -60 against exp(-60) s_i s_j."""
    ss = np.outer(sb / so, sb / so)
    want = cov.build_covariance_reference(lat, lon, sb, length_scale_km) / np.outer(so, so)
    near = want > np.exp(-60.0) * ss * (1.0 + 1e-9)
    np.testing.assert_allclose(got[near], want[near], rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(got[~near], np.exp(-60.0) * ss[~near], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("n, length_scale_km", [(1, 300.0), (200, 300.0), (700, 150.0)])
def test_whitened_correlation_plain_matches_golden(n, length_scale_km):
    lat, lon, sb = _coords(n, seed=20 + n)
    so = sb / np.random.default_rng(n).uniform(20.0, 200.0, n)
    got = cov.correlation_plain(_unit_vectors(lat, lon), _kappa(length_scale_km),
                                torch.as_tensor(sb / so)).numpy()
    _assert_golden(got, lat, lon, sb, so, length_scale_km)


def test_whitened_correlation_takes_the_plain_version_on_the_cpu():
    lat, lon, sb = _coords(50, seed=21)
    u3, s = _unit_vectors(lat, lon), torch.as_tensor(sb)
    before = cov.whitened_correlation_kernel.launches
    c = cov.whitened_correlation(u3, s, _kappa(300.0))
    assert c.dtype == torch.float64
    assert torch.equal(c, cov.correlation_plain(u3, _kappa(300.0), s))
    assert cov.whitened_correlation_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cov.whitened_correlation_kernel(u3, s, _kappa(300.0))


def test_correlation_without_s_is_the_correlation():
    lat, lon, _ = _coords(64, seed=22)
    u3 = _unit_vectors(lat, lon)
    g = cov.correlation_plain(u3, _kappa(300.0))
    ones = cov.correlation_plain(u3, _kappa(300.0), torch.ones(64, dtype=torch.float64))
    assert torch.equal(g, ones)
    np.testing.assert_allclose(torch.diagonal(g).numpy(), 1.0, rtol=1e-12)  # kappa x 2 ulp


# -- the CUDA kernel against the plain version, on the card ------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _both(lat, lon, sig, length_scale_km, device):
    before = cov.build_covariance_kernel.launches
    k = cov.build_covariance(lat, lon, sig, length_scale_km, device=device)
    assert cov.build_covariance_kernel.launches == before + 1
    p = _plain(lat, lon, sig, length_scale_km, device)
    torch.cuda.synchronize()
    return k.cpu().numpy(), p.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 1000, 5643, 6144])
def test_kernel_matches_plain(cuda, n):
    """Every n, including ragged diagonal tiles of 32- and 64-cell tiles:
    kernel and plain bitwise equal and bitwise symmetric, and within the
    golden's bounds."""
    lat, lon, sig = _coords(n, seed=n)
    k, p = _both(lat, lon, sig, 300.0, cuda)
    assert np.array_equal(p, p.T)
    assert np.array_equal(k, k.T)
    assert np.array_equal(k, p)
    _assert_close(k, cov.build_covariance_reference(lat, lon, sig, 300.0), sig)


@pytest.mark.gpu
def test_kernel_is_bitwise_equal_to_plain(cuda):
    """The kernel rounds operation by operation as the plain version does
    on the card, so the full OI's knee cannot move between the two."""
    lat, lon, sig = _coords(1000, seed=11)
    k, p = _both(lat, lon, sig, 300.0, cuda)
    assert np.array_equal(k, p)


@pytest.mark.gpu
def test_kernel_all_zero_sigma_and_repeatable(cuda):
    lat, lon, sig = _coords(2049, seed=7)
    k, _ = _both(lat, lon, np.zeros(2049), 300.0, cuda)
    assert not k.any()
    a, _ = _both(lat, lon, sig, 300.0, cuda)
    b, _ = _both(lat, lon, sig, 300.0, cuda)
    assert np.array_equal(a, b)


@pytest.mark.gpu
def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    lat = torch.rand(64, device=cuda)
    before = cov.build_covariance_kernel.launches
    cov.build_covariance_kernel(lat, lat, lat, 300.0)
    assert cov.build_covariance_kernel.launches == before + 1
    with pytest.raises(TypeError):
        cov.build_covariance_kernel(lat.double(), lat.double(), lat.double(), 300.0)
    with pytest.raises(ValueError):
        cov.build_covariance_kernel(lat[::2], lat[::2], lat[::2], 300.0)
    with pytest.raises(ValueError):
        cov.build_covariance_kernel(lat, lat[:10], lat, 300.0)
    with pytest.raises(ValueError):
        cov.build_covariance_kernel(lat, lat, lat.cpu(), 300.0)
    assert cov.build_covariance_kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 63, 64, 65, 1000, 5643, 6144])
def test_whitened_correlation_kernel_matches_plain(cuda, n):
    """Every n, ragged diagonal tiles included: the float64 kernel within
    rtol 1e-12 of the plain version, bitwise symmetric and repeatable, and
    within the golden's rtol 1e-11."""
    lat, lon, sb = _coords(n, seed=30 + n)
    so = sb / np.random.default_rng(n).uniform(20.0, 200.0, n)
    u3 = _unit_vectors(lat, lon, cuda)
    s = torch.as_tensor(sb / so, device=cuda)
    before = cov.whitened_correlation_kernel.launches
    k = cov.whitened_correlation(u3, s, _kappa(300.0))
    k2 = cov.whitened_correlation_kernel(u3, s, _kappa(300.0))
    assert cov.whitened_correlation_kernel.launches == before + 2
    p = cov.correlation_plain(u3, _kappa(300.0), s)
    torch.cuda.synchronize()
    k, k2, p = k.cpu().numpy(), k2.cpu().numpy(), p.cpu().numpy()
    assert np.array_equal(k, k2)
    assert np.array_equal(k, k.T)
    np.testing.assert_allclose(k, p, rtol=1e-12, atol=0.0)
    _assert_golden(k, lat, lon, sb, so, 300.0)


@pytest.mark.gpu
def test_whitened_correlation_kernel_rejects_bad_input(cuda):
    u3 = torch.rand(64, 3, dtype=torch.float64, device=cuda)
    s = torch.rand(64, dtype=torch.float64, device=cuda)
    before = cov.whitened_correlation_kernel.launches
    assert cov.whitened_correlation_kernel(u3[:0], s[:0], 1.0).shape == (0, 0)
    with pytest.raises(TypeError):
        cov.whitened_correlation_kernel(u3.float(), s.float(), 1.0)
    with pytest.raises(ValueError):
        cov.whitened_correlation_kernel(u3.T.contiguous(), s, 1.0)
    with pytest.raises(ValueError):
        cov.whitened_correlation_kernel(u3[::2], s[::2], 1.0)
    with pytest.raises(ValueError):
        cov.whitened_correlation_kernel(u3, s.cpu(), 1.0)
    assert cov.whitened_correlation_kernel.launches == before
