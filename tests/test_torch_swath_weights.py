"""Structured-swath plans, bitwise: the swath plan kernel
(``csrc/swath_plan.cu``) against the port's host builder on the card, and
that host builder against the JAX package's on the CPU.

Each case is one geometry.  The ``gpu`` tests build its plan with
:func:`oisat_tpu_torch.ops.kernels.swath_plan.build_plan_structured_kernel`
and hold its ``idx``, ``w`` (bit for bit, signed zeros included) and
``mask`` equal to ``plan_to_torch(build_plan_structured(...))``, the host
builder the CPU device takes, for methods 1, 2 and 4 at far factors 1 and 2.
They take the ``cuda`` fixture, which skips when no CUDA device is present;
run them on a GPU host with
``python -m pytest --noconftest -m gpu tests/test_torch_swath_weights.py -q``.
The CPU tests hold that host builder bitwise equal to
``oisat_tpu.ops.weights.build_plan_structured`` in the same cases, so the
kernel's plans are the reference's.  The JAX package is imported only
there, never on the card.
"""

import numpy as np
import pytest
import torch

from oisat_tpu_torch.convert import plan_to_torch
from oisat_tpu_torch.entry import merra2_gmi_grid, synthetic_orbit
from oisat_tpu_torch.ops.kernels.swath_plan import build_plan_structured_kernel, targets_on
from oisat_tpu_torch.ops.weights import build_plan_structured, fine_grid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fine(grid_size):
    """The fine grid the regrid interpolates onto, from the MERRA2-GMI grid
    (0.25 deg: 721 x 1,439 targets)."""
    return fine_grid(*merra2_gmi_grid(), grid_size)


def orbit(seed, center_lon, **kw):
    """(lon, lat) of one OMI-shaped orbit (1644 x 60 px unless ``kw`` says
    otherwise)."""
    g = synthetic_orbit(seed, center_lon, nz=1, **kw)
    return g.longitude_center, g.latitude_center


def omi_orbit():
    """A full-size OMI orbit (1644 x 60 px) and the 0.25 deg fine grid."""
    return *orbit(7, 37.0), *_fine(0.25), 0.25


def antimeridian():
    """An orbit centred on 178 E with its longitudes wrapped to [-180, 180):
    the quads that straddle the antimeridian are skipped."""
    lon, lat = orbit(8, 178.0, ny=600, lat_range=(-40.0, 40.0))
    return (lon + 180.0) % 360.0 - 180.0, lat, *_fine(0.25), 0.25


def lattice_edges():
    """Pixels on an exact, sheared dyadic lattice and targets at every
    eighth of its pitch: targets on pixels, on quad edges, on the diagonal
    that two triangles share, and at points equidistant from several pixels
    (nearest-pixel ties go to the lowest id)."""
    j, i = np.meshgrid(np.arange(24.0), np.arange(40.0))
    lon = 0.5 * j + 0.25 * i
    lat = 0.5 * i
    tlon, tlat = np.meshgrid(np.arange(-1.0, 23.0, 0.125), np.arange(-1.0, 21.0, 0.125))
    return lon, lat, tlon, tlat, 0.5


def all_far():
    """A swath whose every target lies beyond the cutoff."""
    j, i = np.meshgrid(np.linspace(100.0, 110.0, 30), np.linspace(-10.0, 10.0, 80))
    tlon, tlat = np.meshgrid(np.arange(-60.0, -40.0, 0.25), np.arange(-20.0, 20.0, 0.25))
    return j, i + 0.01 * j, tlon, tlat, 0.25


def mopitt_l3():
    """A 1 deg L3 day of MOPITT's shape (float32, stored longitude first,
    360 x 180) onto the 1 deg fine grid."""
    lon, lat = np.meshgrid(np.arange(-179.5, 180.0, 1.0, dtype=np.float32),
                           np.arange(-89.5, 90.0, 1.0, dtype=np.float32))
    return lon.T, lat.T, *_fine(1.0), 1.0


def swath_targets():
    """Targets that are not a grid (an orbit's own pixels, as the CTM ->
    satellite map has them)."""
    return *orbit(9, -20.0, ny=400, nx=30), *orbit(10, -18.0, ny=300, nx=20), 0.3


CASES = {f.__name__: f for f in (omi_orbit, antimeridian, lattice_edges, all_far, mopitt_l3,
                                  swath_targets)}


def assert_plans_bitwise(got, want, what):
    assert got.out_shape == want.out_shape and got.npix == want.npix, what
    assert got.idx.dtype == torch.int64 and got.w.dtype == torch.float64, what
    assert got.mask.dtype == torch.bool, what
    assert torch.equal(got.idx.cpu(), want.idx.cpu()), what
    assert torch.equal(got.w.cpu().view(torch.int64), want.w.cpu().view(torch.int64)), what
    assert torch.equal(got.mask.cpu(), want.mask.cpu()), what


@pytest.mark.parametrize("far_factor", [1.0, 2.0])
@pytest.mark.parametrize("method", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_plan_is_bitwise_the_reference_plan(case, method, far_factor):
    from oisat_tpu.ops import weights as reference

    lon, lat, tlon, tlat, threshold = CASES[case]()
    kw = dict(threshold=threshold, far_factor=far_factor, method=method)
    want = reference.build_plan_structured(lon, lat, tlon, tlat, **kw)
    got = build_plan_structured(lon, lat, tlon, tlat, **kw)
    assert want is not None and got is not None
    assert_plans_bitwise(plan_to_torch(got, "cpu"), plan_to_torch(want, "cpu"),
                         (case, method, far_factor))


def test_host_plans_of_a_non_finite_coordinate_are_none_as_in_the_reference():
    from oisat_tpu.ops import weights as reference

    lon, lat, tlon, tlat, threshold = lattice_edges()
    lat[3, 4] = np.nan
    assert reference.build_plan_structured(lon, lat, tlon, tlat, threshold=threshold) is None
    assert build_plan_structured(lon, lat, tlon, tlat, threshold=threshold) is None


@pytest.mark.gpu
@pytest.mark.parametrize("far_factor", [1.0, 2.0])
@pytest.mark.parametrize("method", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_plan_is_bitwise_the_host_plan(cuda, case, method, far_factor):
    lon, lat, tlon, tlat, threshold = CASES[case]()
    want = plan_to_torch(build_plan_structured(lon, lat, tlon, tlat, threshold=threshold,
                                               far_factor=far_factor, method=method), "cpu")
    kw = dict(threshold=threshold, far_factor=far_factor, method=method, device=cuda)
    before = build_plan_structured_kernel.launches
    got = build_plan_structured_kernel(lon, lat, tlon, tlat, **kw)
    # the targets already on the card, as the regrid hands over its fine grid
    held = build_plan_structured_kernel(lon, lat, tlon, tlat,
                                        targets=targets_on(tlon, tlat, cuda), **kw)
    torch.cuda.synchronize()
    assert build_plan_structured_kernel.launches == before + 2
    assert got.idx.device == cuda
    assert_plans_bitwise(got, want, (case, method, far_factor))
    assert_plans_bitwise(held, want, (case, method, far_factor, "targets on the card"))
    if case == "all_far":
        assert got.mask.all()
    elif case == "omi_orbit":
        assert 0 < int((~got.mask).sum()) < got.mask.numel() // 5


@pytest.mark.gpu
def test_a_non_finite_coordinate_gives_no_plan(cuda):
    lon, lat, tlon, tlat, threshold = lattice_edges()
    for bad in (np.nan, np.inf):
        lat_bad = lat.copy()
        lat_bad[3, 4] = bad
        assert build_plan_structured(lon, lat_bad, tlon, tlat, threshold=threshold) is None
        assert build_plan_structured_kernel(lon, lat_bad, tlon, tlat, threshold=threshold,
                                            device=cuda) is None


@pytest.mark.gpu
def test_two_builds_are_bitwise_equal(cuda):
    lon, lat, tlon, tlat, threshold = antimeridian()
    a = build_plan_structured_kernel(lon, lat, tlon, tlat, threshold=threshold, device=cuda)
    b = build_plan_structured_kernel(lon, lat, tlon, tlat, threshold=threshold, device=cuda)
    assert_plans_bitwise(a, b, "repeat")


# ---- the native builder at the antimeridian (tests/test_native.py's properties) ----

def test_native_pixel_hash_reaches_antimeridian_isolated_pixels():
    """The nearest-pixel scan walks a pixel hash, not quad corners: in a
    2-column swath straddling the antimeridian, where every quad wraps and
    is skipped, a target's nearest pixel is still found, as in the twin."""
    from oisat_tpu import native as reference
    from oisat_tpu_torch import native

    lats = np.linspace(0.0, 10.0, 8)
    lon2d = np.tile(np.array([179.5, -179.5]), (8, 1))
    lat2d = np.tile(lats[:, None], (1, 2))
    got = native.structured_weights(lon2d, lat2d, np.array([-179.4]), np.array([5.0]))
    assert got is not None
    _, _, dist, nn, _ = got
    # the nearest pixel is in the -179.5 column at lat ~5.0 (flat ids 1, 3, 5, ..)
    assert nn[0] % 2 == 1 and dist[0] < 0.8
    want = reference.structured_weights(lon2d, lat2d, np.array([-179.4]), np.array([5.0]))
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_native_antimeridian_quads_do_not_claim_local_targets():
    """A quad crossing the antimeridian spans ~360 deg of unwrapped
    longitude; its sliver triangles overlap the swath elsewhere and must not
    interpolate a local target: wrapped quads are skipped and the local
    column pair wins, with the twin's plan bitwise."""
    from oisat_tpu.ops import weights as reference

    lats = np.linspace(0.0, 10.0, 12)
    lon2d = np.tile(np.array([-1.0, 1.0, 179.0, -179.0]), (12, 1))  # the last pair wraps
    lat2d = np.tile(lats[:, None], (1, 4))
    tlon, tlat = np.meshgrid(np.array([0.0]), np.linspace(1.0, 9.0, 7))
    kw = dict(threshold=3.0, method=1)
    plan = build_plan_structured(lon2d, lat2d, tlon, tlat, **kw)
    assert plan is not None
    got = plan_to_torch(plan, "cpu")
    inside = ~got.mask
    assert bool(inside.any())  # local targets are inside the (-1, 1) column pair
    cols = set(torch.unique(got.idx[inside] % 4).tolist())
    assert cols <= {0, 1}, "an antimeridian sliver claimed a local target"
    want = reference.build_plan_structured(lon2d, lat2d, tlon, tlat, **kw)
    assert_plans_bitwise(got, plan_to_torch(want, "cpu"), "antimeridian quads")
